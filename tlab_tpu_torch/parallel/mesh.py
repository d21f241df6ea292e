"""The (x, z) rank grid of the pencil decomposition on torch.distributed
(port of tlab_tpu/parallel/mesh.py, after the reference's x-z processor
grid, src/base/tlab_mpi_procs.f90:76-94).

tlab_tpu runs its mesh in one process over many devices (shard_map); the
port runs one process a rank (SPMD): every rank holds its block
(nx/px, ny, nz/pz) of every field, P('x', None, 'z') in tlab_tpu's words,
and y is never decomposed.  Rank r sits at (ix, iz) with r = ix pz + iz,
the order of tlab_tpu's devices.reshape(px, pz).  The x group of a rank is
the ranks with its iz, ordered by ix; the z group the ranks with its ix,
ordered by iz; a group rank is then ix (x group) or iz (z group).

The collectives of tlab_tpu map as follows:
  lax.all_to_all(tiled=True)  Mesh.all_to_all: the split axis unflattened
                              into (p, n/p), the chunk axis moved first,
                              dist.all_to_all_single over the group (chunk i
                              to group rank i), the received chunks moved in
                              front of the concat axis and flattened (peer
                              order)
  lax.pmax / lax.pmean        Mesh.all_reduce (MAX; SUM over the ranks
                              divided by their number: the blocks are equal)
  lax.ppermute ring shifts    Mesh.shift: dist.batch_isend_irecv
  lax.axis_index              Mesh.ix, Mesh.iz

The backend follows one rule, printed on a run's first log line
(Mesh.describe): NCCL where every rank has a card of its own, gloo where
ranks share a card, gloo on the CPU.  Under gloo the collectives of CUDA
tensors go through host memory: each block is copied to the host, the
collective runs there and the result is copied back (what gloo's own CUDA
collectives do, made explicit so that point-to-point sends take the same
path); the arithmetic stays on the card.

GSPMD (tlab_tpu's gspmd_shardings, the compiler's auto-parallel path) has
no PyTorch counterpart and is not ported: the explicit pencil engine
computes the same numbers.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from tlab_tpu_torch import device as _device

# a rank that stops makes the others fail after this long instead of hang
TIMEOUT_S = 600.0
# the thread counts a spawned rank starts with
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def backend_rule(n_ranks: int, device) -> str:
    """The backend of a world of `n_ranks` on `device`: NCCL where every
    rank has a card of its own, gloo where ranks share a card, gloo on the
    CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and n_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device, rank: int) -> torch.device:
    """The device of `rank`: the CPU, or card rank % (the number of cards)
    (ranks share the cards where there are more ranks than cards)."""
    dev = _device.resolve(device)
    if dev.type != "cuda":
        return dev
    if dev.index is not None:
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_world(rank: int, world: int, store_path: str, backend: str,
               device, timeout_s: float = TIMEOUT_S) -> None:
    """Join the world of `world` ranks whose rendezvous is the FileStore at
    `store_path`; a collective that waits longer than timeout_s raises."""
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))


@dataclasses.dataclass
class Mesh:
    """This rank's place on the (px, pz) grid, its groups and device."""

    px: int
    pz: int
    rank: int
    device: torch.device
    backend: str
    groups: dict                 # "x", "z", "world" -> process group

    @property
    def ix(self) -> int:
        return self.rank // self.pz

    @property
    def iz(self) -> int:
        return self.rank % self.pz

    @property
    def size(self) -> int:
        return self.px * self.pz

    @property
    def shape(self) -> dict:
        return {"x": self.px, "z": self.pz}

    @property
    def root(self) -> bool:
        return self.rank == 0

    @property
    def staged(self) -> bool:
        """Collectives of CUDA tensors go through host memory (gloo)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def describe(self) -> str:
        share = ("every rank on its own card" if self.backend == "nccl"
                 else "ranks share a card, collectives staged through host "
                 "memory" if self.staged else "on the CPU")
        return (f"mesh {self.px}x{self.pz}: {self.size} ranks, backend "
                f"{self.backend} ({share})")

    def _global(self, axis: str, group_rank: int) -> int:
        """The world rank of group rank `group_rank` of this rank's group
        along `axis`."""
        if axis == "x":
            return group_rank * self.pz + self.iz
        return self.ix * self.pz + group_rank

    # -- collectives ------------------------------------------------------

    def _host(self, t):
        return t.cpu() if self.staged else t

    def _back(self, t):
        return t.to(self.device) if self.staged else t

    def all_to_all(self, a, axis: str, split: int, concat: int):
        """tlab_tpu's lax.all_to_all(a, axis, split, concat, tiled=True)
        over this rank's `axis` group: chunk i of the split axis goes to
        group rank i; the chunks received are concatenated along the concat
        axis in group order.  A contiguous tensor."""
        n = self.shape[axis]
        cplx = a.is_complex()
        a = a.unflatten(split, (n, a.shape[split] // n)).movedim(split, 0)
        a = a.contiguous()
        if cplx:
            a = torch.view_as_real(a)
        a = self._host(a)
        out = torch.empty_like(a)
        dist.all_to_all_single(out, a, group=self.groups[axis])
        out = self._back(out)
        if cplx:
            out = torch.view_as_complex(out)
        return out.movedim(0, concat).flatten(concat, concat + 1) \
            .contiguous()

    def all_reduce(self, t, op: str = "max"):
        """The world's MAX, MIN or SUM of t (a new tensor)."""
        ops = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
               "sum": dist.ReduceOp.SUM}
        buf = self._host(t).clone()
        dist.all_reduce(buf, op=ops[op], group=self.groups["world"])
        return self._back(buf)

    def mean(self, t):
        """The mean over the ranks of per-block means (tlab_tpu's pmean over
        'x' then 'z'; the blocks are equal)."""
        return self.all_reduce(t, "sum") / self.size

    def shift(self, t, axis: str, offset: int):
        """tlab_tpu's ppermute ring shift: t goes to group rank
        (i + offset) % n, and what group rank (i - offset) % n sent comes
        back (a new tensor)."""
        n = self.shape[axis]
        if n == 1:
            return t.clone()
        i = self.ix if axis == "x" else self.iz
        send = self._host(t.contiguous())
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send,
                          self._global(axis, (i + offset) % n),
                          self.groups[axis]),
               dist.P2POp(dist.irecv, recv,
                          self._global(axis, (i - offset) % n),
                          self.groups[axis])]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return self._back(recv)

    def barrier(self) -> None:
        dist.barrier(group=self.groups["world"])

    # -- blocks of global arrays -----------------------------------------

    def block(self, a, x_axis: int = -3, z_axis: int = -1):
        """This rank's block of a global array or tensor (..., nx, ny, nz):
        rows ix nx/px.. along x, iz nz/pz.. along z."""
        x_axis %= a.ndim
        z_axis %= a.ndim
        nxl = a.shape[x_axis] // self.px
        nzl = a.shape[z_axis] // self.pz
        idx = [slice(None)] * a.ndim
        idx[x_axis] = slice(self.ix * nxl, (self.ix + 1) * nxl)
        idx[z_axis] = slice(self.iz * nzl, (self.iz + 1) * nzl)
        return a[tuple(idx)]

    def gather_list(self, t):
        """Every rank's t (one shape on all ranks) on rank 0, in rank order,
        on rank 0's device (None on the other ranks)."""
        t = self._host(t.contiguous())
        parts = [torch.empty_like(t) for _ in range(self.size)] \
            if self.root else None
        dist.gather(t, parts, dst=0, group=self.groups["world"])
        return [self._back(x) for x in parts] if self.root else None

    def gather(self, block):
        """The global tensor (..., nx, ny, nz) on rank 0 from every rank's
        block (None on the other ranks); on rank 0's device."""
        parts = self.gather_list(block)
        if parts is None:
            return None
        rows = [torch.cat(parts[ix * self.pz:(ix + 1) * self.pz], dim=-1)
                for ix in range(self.px)]
        return torch.cat(rows, dim=-3)

    def scatter(self, full, like):
        """This rank's block of the global tensor `full` held by rank 0
        (None elsewhere); `like` gives the block's shape and dtype."""
        recv = self._host(torch.empty_like(like))
        parts = None
        if self.root:
            src = self._host(full)
            parts = []
            for r in range(self.size):
                ix, iz = divmod(r, self.pz)
                nxl = src.shape[-3] // self.px
                nzl = src.shape[-1] // self.pz
                parts.append(src[..., ix * nxl:(ix + 1) * nxl, :,
                                 iz * nzl:(iz + 1) * nzl].contiguous())
        dist.scatter(recv, parts, src=0, group=self.groups["world"])
        return self._back(recv)


def make_mesh(px: int, pz: int, device="cuda", backend=None) -> Mesh:
    """The Mesh of this process on a (px, pz) grid (the counterpart of
    tlab_tpu's make_mesh(px, pz, devices)).  The process must have joined
    a world of px pz ranks (init_world, spawn, or torch.distributed.run's
    environment); every rank creates every group in the same order, as
    dist.new_group requires.  backend=None applies backend_rule."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: join a world of px*pz ranks first "
                           "(parallel.mesh.spawn or torch.distributed.run)")
    world = dist.get_world_size()
    if world != px * pz:
        raise ValueError(f"mesh {px}x{pz} needs {px * pz} ranks, the world "
                         f"has {world}")
    rank = dist.get_rank()
    backend = backend or dist.get_backend()
    groups = {"world": dist.group.WORLD}
    for iz in range(pz):
        g = dist.new_group([ix * pz + iz for ix in range(px)])
        if rank % pz == iz:
            groups["x"] = g
    for ix in range(px):
        g = dist.new_group([ix * pz + iz for iz in range(pz)])
        if rank // pz == ix:
            groups["z"] = g
    return Mesh(px=px, pz=pz, rank=rank, device=rank_device(device, rank),
                backend=str(backend), groups=groups)


def scatter_field(mesh: Mesh, field, dtype=None):
    """This rank's block, on its device, of the global NumPy array `field`
    (..., nx, ny, nz) held by rank 0 (None elsewhere).  The other ranks
    learn its shape and dtype from rank 0."""
    meta = [None]
    if mesh.root:
        meta = [(tuple(field.shape), str(field.dtype))]
    dist.broadcast_object_list(meta, src=0, group=mesh.groups["world"])
    shape, np_dtype = meta[0]
    tdt = dtype or torch.from_numpy(np.zeros(1, np_dtype)).dtype
    shape = shape[:-3] + (shape[-3] // mesh.px, shape[-2],
                          shape[-1] // mesh.pz)
    like = torch.empty(shape, dtype=tdt, device=mesh.device)
    full = torch.as_tensor(np.ascontiguousarray(field)).to(tdt) \
        if mesh.root else None
    return mesh.scatter(full, like)


def gather_field(mesh: Mesh, block):
    """The global NumPy array of every rank's block on rank 0 (None
    elsewhere)."""
    full = mesh.gather(block)
    return None if full is None else full.cpu().numpy()


def _rank_main(index, fn, px, pz, device, backend, store_path, timeout_s,
               result_dir, args):
    """One spawned rank: join the world, build the mesh, run fn, keep its
    result for the parent."""
    torch.set_num_threads(1)
    init_world(index, px * pz, store_path, backend, device, timeout_s)
    try:
        mesh = make_mesh(px, pz, device, backend)
        out = fn(mesh, *args)
        if result_dir:
            torch.save(out, os.path.join(result_dir, f"rank{index}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, px: int, pz: int, device, *args, store_dir: str,
          timeout_s: float = TIMEOUT_S, results: bool = True):
    """Run fn(mesh, *args) on px pz new processes (the 'spawn' start
    method), one a rank, joined through a FileStore in `store_dir`, on the
    backend of backend_rule.
    Returns the ranks' return values in rank order (results=True), or
    None.  A rank that fails makes spawn raise (the others are ended); a
    job that runs past timeout_s is ended and raises TimeoutError."""
    import torch.multiprocessing as tmp
    n = px * pz
    backend = backend_rule(n, device)
    os.makedirs(store_dir, exist_ok=True)
    work = tempfile.mkdtemp(prefix="mesh_", dir=store_dir)
    store = os.path.join(work, "store")
    # one host thread a rank (BLAS and OpenMP read these at start-up): the
    # ranks share the host's cores
    saved = {k: os.environ.get(k) for k in THREAD_VARS}
    os.environ.update({k: "1" for k in THREAD_VARS})
    try:
        try:
            ctx = tmp.start_processes(
                _rank_main, args=(fn, px, pz, str(device), backend, store,
                                  timeout_s, work if results else "", args),
                nprocs=n, join=False, start_method="spawn")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                raise TimeoutError(f"mesh job of {n} ranks ran past "
                                   f"{timeout_s} s")
        if results:
            return [torch.load(os.path.join(work, f"rank{r}.pt"),
                               weights_only=False) for r in range(n)]
        return None
    finally:
        shutil.rmtree(work, ignore_errors=True)
