"""Particle restart files and trajectory accumulation (port of
tlab_tpu/particles/io.py; reference src/particles/io_particle.f90,
src/tools/dns/particle_trajectories.f90).

Format: int64 header (n_part, n_props, itime) + int64 tags + float64
positions (np, 3) + velocities (np, 3) + props.
"""
from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np
import torch

from tlab_tpu_torch import device as _device
from tlab_tpu_torch.particles.core import (ParticleState,
                                           interpolate_to_particles)

_HDR = struct.Struct("<3q")


def _host(t, dtype=np.float64) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy(), dtype)


def write_particles(path: str, pstate: ParticleState, itime: int = 0) -> None:
    x, v, props = (_host(t) for t in (pstate.x, pstate.v, pstate.props))
    tags = _host(pstate.tags, np.int64)
    with open(path, "wb") as fh:
        fh.write(_HDR.pack(x.shape[0], props.shape[1], itime))
        fh.write(tags.tobytes())
        fh.write(x.tobytes())
        fh.write(v.tobytes())
        fh.write(props.tobytes())


def read_particles(path: str, dtype=torch.float64, device="cuda"):
    """(ParticleState on `device` in `dtype`, itime) of a particle file."""
    with open(path, "rb") as fh:
        data = fh.read()
    n, nprops, itime = _HDR.unpack_from(data, 0)
    off = _HDR.size
    tags = np.frombuffer(data, "<i8", n, off)
    off += 8 * n
    x = np.frombuffer(data, "<f8", 3 * n, off).reshape(n, 3)
    off += 24 * n
    v = np.frombuffer(data, "<f8", 3 * n, off).reshape(n, 3)
    off += 24 * n
    props = np.frombuffer(data, "<f8", nprops * n, off).reshape(n, nprops)

    dev = _device.resolve(device)

    def t(a, dt=dtype):
        return torch.as_tensor(np.array(a), dtype=dt, device=dev)

    st = ParticleState(x=t(x), v=t(v), props=t(props),
                       tags=t(tags, torch.int64))
    return st, itime


@dataclasses.dataclass
class TrajectoryAccumulator:
    """Buffered trajectories of tagged particles, flushed with restarts."""

    tag_ids: np.ndarray
    buffer: list = dataclasses.field(default_factory=list)

    def accumulate(self, itime: int, rtime: float, pstate: ParticleState):
        idx = np.asarray(self.tag_ids)
        if idx.size == 0:
            self.buffer.append((itime, rtime, np.zeros((0, 3)),
                                np.zeros((0, 3))))
            return
        # fast path: gather the tagged ROWS on the device (a copy of the
        # tagged rows only) and fall back to the tag search where the
        # positional identity does not hold (reordered or padded slots)
        if pstate.tags is not None and idx.max() < pstate.tags.shape[0]:
            rows = torch.as_tensor(idx, device=pstate.x.device)
            if np.array_equal(pstate.tags[rows].cpu().numpy(), idx):
                xv = torch.stack([pstate.x[rows], pstate.v[rows]]).cpu()
                self.buffer.append((itime, rtime, xv[0].numpy(),
                                    xv[1].numpy()))
                return
        tags = pstate.tags.cpu().numpy() if pstate.tags is not None \
            else None
        x_all = pstate.x.cpu().numpy()
        v_all = pstate.v.cpu().numpy()
        if tags is not None and (idx.max() >= tags.shape[0]
                                 or not np.array_equal(tags[idx], idx)):
            # owner-sharded migration reorders/pads the SoA: look the
            # tagged particles up by tag (particle_trajectories.f90 tag
            # search); tags absent this step (culled/remote) keep NaN
            order = np.argsort(tags, kind="stable")
            pos = np.searchsorted(tags, idx, sorter=order)
            pos = np.minimum(pos, tags.shape[0] - 1)
            idx2 = order[pos]
            found = tags[idx2] == idx
            x = np.full((idx.shape[0], 3), np.nan)
            v = np.full((idx.shape[0], 3), np.nan)
            x[found] = x_all[idx2[found]]
            v[found] = v_all[idx2[found]]
            self.buffer.append((itime, rtime, x, v))
            return
        self.buffer.append((itime, rtime, x_all[idx].copy(),
                            v_all[idx].copy()))

    def flush(self, outdir: str) -> None:
        if not self.buffer:
            return
        it0, itN = self.buffer[0][0], self.buffer[-1][0]
        np.savez_compressed(
            os.path.join(outdir, f"trajectories.{it0}-{itN}.npz"),
            itimes=np.array([b[0] for b in self.buffer]),
            rtimes=np.array([b[1] for b in self.buffer]),
            x=np.stack([b[2] for b in self.buffer]),
            v=np.stack([b[3] for b in self.buffer]),
            tags=self.tag_ids)
        self.buffer.clear()


def particle_pdfs(pstate, prop_index, y_edges, vmin: float, vmax: float,
                  nbins: int = 64):
    """Per-y-slab histograms of one particle property (reference
    src/particles/particle_pdf.f90): returns (n_slabs, nbins) counts and
    the value bin edges."""
    y = pstate.x[:, 1].cpu().numpy()
    if prop_index < 0:          # velocity magnitude convenience
        vals = np.linalg.norm(pstate.v.cpu().numpy(), axis=1)
    else:
        vals = pstate.props[:, prop_index].cpu().numpy()
    n_slabs = len(y_edges) - 1
    counts = np.zeros((n_slabs, nbins), np.int64)
    edges = np.linspace(vmin, vmax, nbins + 1)
    for j in range(n_slabs):
        sel = (y >= y_edges[j]) & (y < y_edges[j + 1])
        counts[j], _ = np.histogram(vals[sel], bins=edges)
    return counts, edges


def particle_pdf_reference(grid, pstate, scal_field, locate,
                           subdomain, pdf_max: float, pdf_interval: float,
                           path: str) -> None:
    """The reference's in-run PARTICLE_PDF (particle_pdf.f90): histograms
    of (1) the LAST scalar field interpolated to the particle positions
    and (2,3) the first two particle property columns, restricted to the
    scale-normalized subdomain (x0,x1,y0,y1[,z0,z1]); bins of width
    pdf_interval on [0, pdf_max); ASCII rows 'value c1 c2 c3'
    (written at the statistics cadence, dns_statistics.f90:212-214).  The
    gather runs on the device; the binning on the host."""
    nb = max(int(pdf_max / pdf_interval), 1)
    vals = interpolate_to_particles(scal_field,
                                    locate(pstate.x)).cpu().numpy()
    xs = pstate.x.cpu().numpy()
    sub = list(subdomain) + [0.0] * (6 - len(subdomain))
    scales = (grid.x.scale, grid.y.scale,
              grid.z.scale if grid.z.size > 1 else 1.0)
    sel = np.ones(xs.shape[0], bool)
    for d in range(3):
        lo, hi = sub[2 * d], sub[2 * d + 1]
        if hi > lo:
            xn = xs[:, d] / scales[d]
            sel &= (xn >= lo) & (xn <= hi)
    cols = [vals]
    props = pstate.props.cpu().numpy() if pstate.props is not None else None
    for ip in range(2):
        cols.append(props[:, ip] if props is not None
                    and props.shape[1] > ip else np.zeros_like(vals))
    bins = np.zeros((nb, 3), np.int64)
    for ic, cv in enumerate(cols):
        # reference binning j = 1 + int(v/interval) TRUNCATES toward
        # zero, so values in (-interval, interval) share the first bin
        # (particle_pdf.f90:77-83)
        j = np.trunc(cv[sel] / pdf_interval).astype(int)
        j = j[(j >= 0) & (j < nb)]
        np.add.at(bins[:, ic], j, 1)
    with open(path, "w") as fh:
        for i in range(nb):
            fh.write(f"{i * pdf_interval:6.3f} {bins[i, 0]:20d} "
                     f"{bins[i, 1]:20d} {bins[i, 2]:20d}\n")


def write_particle_pdfs(path: str, counts, edges, itime: int) -> None:
    np.savez(path, counts=counts, edges=edges, itime=itime)


def assemble_trajectories(outdir: str, iterations, tags):
    """Offline trajectory assembly from saved particle restarts (reference
    tools/particles/particle_pos_trajec.f90 / particle_trajec.f90):
    positions of the tagged particles across the snapshot series, sorted
    by tag. Returns (n_times, n_tags, 3) plus the iteration list."""
    tags = np.asarray(sorted(tags))
    out = np.full((len(iterations), tags.size, 3), np.nan)
    for it_idx, it in enumerate(iterations):
        ps, _ = read_particles(os.path.join(outdir, f"part.{it}"),
                               device="cpu")
        ptags = ps.tags.numpy()
        pos = ps.x.numpy()
        idx = {int(t): i for i, t in enumerate(ptags)}
        for j, t in enumerate(tags):
            if int(t) in idx:
                out[it_idx, j] = pos[idx[int(t)]]
    return out, list(iterations)
