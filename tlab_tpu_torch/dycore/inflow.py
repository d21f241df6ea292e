"""Unsteady inflow for the spatial mode (port of tlab_tpu/dycore/inflow.py,
after the reference's src/tools/dns/boundary_inflow.f90): a stored
temporal-simulation box is swept past the inflow plane with Taylor's
hypothesis, providing the time-dependent target planes for the Imin buffer
strip.

Reference semantics covered (boundary_inflow.f90:194-433):
- full 3-D (y, z) inflow planes sampled from the stored box (not just
  z-means), cubic (Catmull-Rom) interpolation in the sweep direction
  (the reference uses periodic cubic B-splines, BSPLINES3P);
- periodic box reuse (InflowMode 2) and box-file sequences (InflowMode 3,
  the box is swapped when u_convect*t crosses the box length);
- transient adaptation ramp vmult = min(t/adapt, 1) (inflow_adapt);
- y-centering of a smaller inflow grid into the target plane (joffset =
  (jmax - jmax_inf)/2).

The planes are made on the host (NumPy, as tlab_tpu's) and copied to the
run's device once a step.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tlab_tpu_torch import device as _device
from tlab_tpu_torch.io import fields_io


def _catmull_rom_weights(w):
    """4-point cubic interpolation weights at fraction w in [0,1)."""
    w2 = w * w
    w3 = w2 * w
    return (-0.5 * w3 + w2 - 0.5 * w,
            1.5 * w3 - 2.5 * w2 + 1.0,
            -1.5 * w3 + 2.0 * w2 + 0.5 * w,
            0.5 * w3 - 0.5 * w2)


@dataclasses.dataclass
class InflowBox:
    """fields: name -> stored box, (nx_i, ny[, nz]); u_convect: sweep
    speed (reference qbg(1)%mean); lx: box streamwise extent; adapt:
    transient ramp time; boxes: optional file-sequence list of field
    dicts (InflowMode 3)."""

    fields: dict
    u_convect: float
    lx: float
    adapt: float = 0.0
    boxes: list = None

    def planes_at(self, t: float, ny: int = None) -> dict:
        """Interpolated inflow plane at time t on the host: name -> (1, ny,
        nz|1) float64 arrays."""
        fields = self.fields
        if self.boxes:
            ifield = int(self.u_convect * t / self.lx) % len(self.boxes)
            fields = self.boxes[ifield]
        vmult = 1.0
        if self.adapt > 0.0 and t <= self.adapt:
            vmult = t / self.adapt

        out = {}
        for name, box in fields.items():
            box = np.asarray(box)
            nx_i = box.shape[0]
            # sweep position (reference: distance measured from the box
            # END, boundary_inflow.f90:252-258)
            xaux = self.u_convect * t
            xaux = xaux - int(xaux / self.lx) * self.lx
            xaux = self.lx - xaux
            xi = xaux / self.lx * nx_i
            i1 = int(np.floor(xi)) % nx_i
            w = xi - np.floor(xi)
            i0 = (i1 - 1) % nx_i
            i2 = (i1 + 1) % nx_i
            i3 = (i1 + 2) % nx_i
            c0, c1, c2, c3 = _catmull_rom_weights(w)
            plane = (c0 * box[i0] + c1 * box[i1]
                     + c2 * box[i2] + c3 * box[i3]) * vmult
            if plane.ndim == 1:
                plane = plane[:, None]           # (ny,) -> (ny, 1)
            if ny is not None and plane.shape[0] < ny:
                # center a smaller inflow grid in y (reference joffset)
                pad = ny - plane.shape[0]
                lo = pad // 2
                plane = np.pad(plane, ((lo, pad - lo), (0, 0)),
                               mode="edge")
            out[name] = np.asarray(plane, np.float64)[None, :, :]
        return out

    def refs_at(self, t: float, dtype=torch.float64, ny: int = None,
                device="cuda") -> dict:
        """planes_at(t) as tensors of the run on `device`: the step's
        aux["refs_x"]."""
        dev = _device.resolve(device)
        return {k: torch.as_tensor(v).to(dev, dtype)
                for k, v in self.planes_at(t, ny).items()}


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def from_temporal_snapshot(state, u_convect: float, lx: float,
                           adapt: float = 0.0,
                           z_mean: bool = False) -> InflowBox:
    """Build an inflow box from a temporal-simulation state (tensors on any
    device, or arrays). By default the FULL 3-D box is stored (reference
    q_inf(nx,ny,nz)); z_mean=True keeps z-means only."""
    def red(a):
        a = _host(a)
        return a.mean(axis=2) if z_mean else a

    fields = {"u": red(state.u), "v": red(state.v), "w": red(state.w)}
    for i in range(state.s.shape[0]):
        fields[f"s{i}"] = red(state.s[i])
    return InflowBox(fields=fields, u_convect=u_convect, lx=lx,
                     adapt=adapt)


def from_restart_files(prefix_flow: str, prefix_scal: str, itimes,
                       n_scalars: int, u_convect: float, lx: float,
                       adapt: float = 0.0) -> InflowBox:
    """Load an inflow box (sequence) from reference-format restart files
    (the reference's InflowMode 2/3 machinery, BOUNDARY_INFLOW_INITIALIZE:
    fields flow.inf.* read on the inflow grid). itimes: one iteration
    number (mode 2) or a list (mode 3 sequence)."""
    if np.isscalar(itimes):
        itimes = [itimes]
    boxes = []
    for it in itimes:
        u, v, w, s, _, _ = fields_io.read_state(prefix_flow, prefix_scal,
                                                int(it), n_scalars)
        fields = {"u": np.asarray(u), "v": np.asarray(v),
                  "w": np.asarray(w)}
        for i in range(n_scalars):
            fields[f"s{i}"] = np.asarray(s[i])
        boxes.append(fields)
    return InflowBox(fields=boxes[0], u_convect=u_convect, lx=lx,
                     adapt=adapt, boxes=boxes if len(boxes) > 1 else None)
