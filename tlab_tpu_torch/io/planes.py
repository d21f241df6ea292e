"""Plane and tower extraction (port of tlab_tpu/io/planes.py; reference
src/tools/dns/planes.f90, dns_tower.f90), written in the REFERENCE binary
layouts (io/reference_formats.py) so scripts/python/{Planes2nc,tower2nc,
PlotTowers}.py consume them unmodified.

Planes: strided i/j/k-plane slices of [u, v, w, scalars..., pressure]
stacked var-major into ONE planesI/J/K.<it> float32 file per direction.
Towers: strided (i, j, k) columns + horizontal means accumulated every
step, flushed with the restart cadence into per-column raw files.

The slices and the means are taken on the device (torch.index_select, a
strided view, a mean over x and z); only they come to the host, one copy a
plane direction or a tower step, never a whole field.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tlab_tpu_torch.io import reference_formats as rf

_AXIS = {"i": 0, "j": 1, "k": 2}


@dataclasses.dataclass
class PlaneSpec:
    axis: str              # 'i' | 'j' | 'k'
    indices: tuple         # node indices (0-based)


def extract_plane(field: torch.Tensor, spec: PlaneSpec) -> torch.Tensor:
    """The planes of `spec` of one (nx, ny, nz) field, on its device."""
    idx = torch.as_tensor(list(spec.indices), device=field.device)
    return torch.index_select(field, _AXIS[spec.axis], idx)


def write_planes(outdir: str, itime: int, state, specs,
                 pressure=None) -> None:
    """Reference planesI/J/K.<it> subarray files: every plane set carries
    flow + scalars + PRESSURE (planes.f90 PLANES_INITIALIZE var count)."""
    fields = [state.u, state.v, state.w]
    fields += [state.s[i] for i in range(state.s.shape[0])]
    if pressure is not None:
        fields.append(pressure)
    for spec in specs:
        small = torch.stack([extract_plane(f, spec) for f in fields])
        rf.write_planes_file(outdir, itime, spec.axis,
                             list(small.cpu().numpy()),
                             range(len(spec.indices)))


@dataclasses.dataclass
class TowerAccumulator:
    """Strided-column time series, buffered in memory and flushed with
    restarts (reference dns_tower.f90:22-34).  stride = (si, sj, sk) --
    ALL three components of [SaveTowers] Stride, including the y stride
    the tower records are subsampled with."""

    stride: tuple          # (si, sj, sk)
    buffer: list = dataclasses.field(default_factory=list)

    def accumulate(self, itime: int, rtime: float, state, pressure=None):
        """Strided columns + horizontal means, reduced on the device: two
        small copies a step (the reference tower module moved the full
        fields, dns_tower.f90)."""
        si, sj, sk = self.stride[:3]
        ordered = [(1, state.u), (2, state.v), (3, state.w)]
        if pressure is not None:
            ordered.append((4, pressure))
        if state.s.shape[0]:
            ordered.append((5, state.s[0]))
        keys = [k for k, _ in ordered]
        cols = torch.stack([f[::si, ::sj, ::sk] for _, f in ordered])
        means = torch.stack([f[:, ::sj, :].mean(dim=(0, 2))
                             for _, f in ordered])
        cols, means = cols.cpu().numpy(), means.cpu().numpy()
        self.buffer.append((itime, rtime, dict(zip(keys, cols)),
                            dict(zip(keys, means))))
        self._nx = state.u.shape[0]
        self._nz = state.u.shape[2]

    def flush(self, outdir: str) -> None:
        if not self.buffer:
            return
        si, sj, sk = self.stride[:3]
        times = [b[1] for b in self.buffer]
        itimes = [b[0] for b in self.buffer]
        columns = {iv: np.stack([b[2][iv] for b in self.buffer])
                   for iv in self.buffer[0][2]}
        means = {iv: np.stack([b[3][iv] for b in self.buffer])
                 for iv in self.buffer[0][3]}
        ipos = tuple(range(1, self._nx + 1, si))       # 1-based global
        kpos = tuple(range(1, self._nz + 1, sk))
        rf.write_tower_files(outdir, times, itimes, columns, means,
                             ipos, kpos)
        self.buffer.clear()
