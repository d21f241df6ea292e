"""Per-shard field I/O on the rank mesh (port of tlab_tpu/io/sharded.py;
reference MPI-IO subarrays, src/base/io_fields.f90 IO_Create_Subarray_XOZ
with collective read/write).

Each rank writes its block to its own file and rank 0 writes a JSON
manifest of the global shape and of every shard's index slab, so that a
restart can be reassembled on any rank count, or read back block by block
without the whole field on one host.  The layout is tlab_tpu's, so that
each package reads the other's files:

    <path>.manifest.json   {"shape", "dtype", "n_shards", "params",
                            "shards": [{"file", "index", "device"}, ...]}
    <path>.shard<k>.npy    shard k, a C-contiguous NumPy slab

Shard k is rank k's block, index [[x0, x1], [0, ny], [z0, z1]] (leading
axes whole).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch


def _index(px: int, pz: int, rank: int, shape) -> list:
    """Rank `rank`'s slab of a global array of `shape` on a (px, pz)
    mesh."""
    ix, iz = divmod(rank, pz)
    nxl, nzl = shape[-3] // px, shape[-1] // pz
    lead = [[0, n] for n in shape[:-3]]
    return lead + [[ix * nxl, (ix + 1) * nxl], [0, shape[-2]],
                   [iz * nzl, (iz + 1) * nzl]]


def write_sharded(path: str, mesh, block, params: dict | None = None
                  ) -> None:
    """Every rank writes its block as <path>.shard<rank>.npy; rank 0 the
    manifest.  A collective: every rank calls it (the barrier keeps a
    reader from seeing a manifest before its shards)."""
    data = block.detach().cpu().numpy()
    shape = list(data.shape[:-3]) + [data.shape[-3] * mesh.px,
                                     data.shape[-2],
                                     data.shape[-1] * mesh.pz]
    np.save(f"{path}.shard{mesh.rank}.npy", np.ascontiguousarray(data))
    if mesh.root:
        shards = [{"file": os.path.basename(f"{path}.shard{r}.npy"),
                   "index": _index(mesh.px, mesh.pz, r, shape),
                   "device": f"rank{r}:{mesh.device}"}
                  for r in range(mesh.size)]
        manifest = {"shape": shape, "dtype": str(data.dtype),
                    "n_shards": mesh.size, "params": params or {},
                    "shards": shards}
        with open(f"{path}.manifest.json", "w") as fh:
            json.dump(manifest, fh, indent=1)
    mesh.barrier()


def read_sharded(path: str) -> tuple:
    """(the global array reassembled from the shard slabs, params)."""
    with open(f"{path}.manifest.json") as fh:
        man = json.load(fh)
    out = np.empty(tuple(man["shape"]), dtype=np.dtype(man["dtype"]))
    base = os.path.dirname(path)
    for rec in man["shards"]:
        idx = tuple(slice(a, b) for a, b in rec["index"])
        out[idx] = np.load(os.path.join(base, rec["file"]))
    return out, man["params"]


def read_sharded_to(path: str, mesh, dtype=None):
    """This rank's block of a sharded file on its device: the shard itself
    where the manifest's layout is the mesh's, else the block cut from the
    reassembled array."""
    with open(f"{path}.manifest.json") as fh:
        man = json.load(fh)
    want = _index(mesh.px, mesh.pz, mesh.rank, man["shape"])
    base = os.path.dirname(path)
    for rec in man["shards"]:
        if rec["index"] == want:
            a = np.load(os.path.join(base, rec["file"]))
            break
    else:
        full, _ = read_sharded(path)
        a = full[tuple(slice(lo, hi) for lo, hi in want)]
    t = torch.as_tensor(np.ascontiguousarray(a))
    return t.to(mesh.device, dtype or t.dtype)


def write_state_sharded(prefix: str, itime: int, state, rtime: float,
                        visc: float, mesh) -> None:
    """Sharded restart of this rank's blocks: flow.<it>.{1,2,3} and
    scal.<it>.<i> prefixes (the reference's file per variable,
    io_fields.f90:534)."""
    params = {"rtime": float(rtime), "visc": float(visc),
              "itime": int(itime)}
    for tag, comp in (("1", state.u), ("2", state.v), ("3", state.w)):
        write_sharded(f"{prefix}flow.{itime}.{tag}", mesh, comp, params)
    for i in range(state.s.shape[0]):
        write_sharded(f"{prefix}scal.{itime}.{i + 1}", mesh, state.s[i],
                      params)
