"""Buffer/sponge zones: relaxation toward reference profiles near walls
(port of tlab_tpu/dycore/buffer.py, after the reference's
src/tools/dns/boundary_buffer.f90).

tau(y) = strength * ((y - y_edge)/width)^sigma on PointsJmin/PointsJmax
strips; the tendency gains  h -= tau(y) (q - q_ref(y))  before the pressure
projection (reference BOUNDARY_BUFFER_RELAX_FLOW called at
rhs_global_incompressible_1.f90:172).  In spatial mode the Imin/Imax strips
relax toward the inflow plane (tau_x(x), refs_x), which an unsteady inflow
replaces every step (aux["refs_x"], dycore/inflow.py).

The filter-type sponge (reference BOUNDARY_BUFFER_FILTER) blends the state
toward its filtered self after each step inside the Imin/Imax strips.

The profiles are NumPy copies of tlab_tpu's; the tables live on the run's
device (the plan's "buffer" entry).  On the pencil mesh `localize` cuts the
x-extended tables to the rank's block.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tlab_tpu_torch import device as _device
from tlab_tpu_torch.ops.filter import filter_state


@dataclasses.dataclass(frozen=True)
class BufferSpec:
    type: str = "none"           # none | relaxation | filter | both
    points_jmin: int = 0
    points_jmax: int = 0
    points_imin: int = 0         # streamwise strips (spatial mode)
    points_imax: int = 0
    strength: float = 1.0
    sigma: float = 2.0


def tau_profile(y: np.ndarray, spec: BufferSpec) -> np.ndarray:
    """(ny,) relaxation rate, zero outside the strips."""
    ny = y.shape[0]
    tau = np.zeros(ny)
    if spec.points_jmin > 1:
        n = spec.points_jmin
        width = y[n - 1] - y[0]
        xi = (y[n - 1] - y[:n]) / width
        tau[:n] = spec.strength * xi ** spec.sigma
    if spec.points_jmax > 1:
        n = spec.points_jmax
        width = y[-1] - y[-n]
        xi = (y[-n:] - y[-n]) / width
        tau[-n:] = spec.strength * xi ** spec.sigma
    return tau


def tau_profile_x(x: np.ndarray, spec: BufferSpec) -> np.ndarray:
    """(nx,) relaxation rate for the Imin/Imax strips (spatial mode)."""
    nx = x.shape[0]
    tau = np.zeros(nx)
    if spec.points_imin > 1:
        n = spec.points_imin
        width = x[n - 1] - x[0]
        xi = (x[n - 1] - x[:n]) / width
        tau[:n] = spec.strength * xi ** spec.sigma
    if spec.points_imax > 1:
        n = spec.points_imax
        width = x[-1] - x[-n]
        xi = (x[-n:] - x[-n]) / width
        tau[-n:] = spec.strength * xi ** spec.sigma
    return tau


def _tensor(a, dtype, dev) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dev, dtype)
    return torch.as_tensor(np.asarray(a, np.float64)).to(dev, dtype)


def build_buffer(y: np.ndarray, spec: BufferSpec, ref_profiles: dict,
                 dtype=torch.float64, x: np.ndarray = None,
                 ref_inflow: dict = None, device="cuda"):
    """The plan's "buffer" entry, or None where no strip is active:
    {"tau": (1, ny, 1), "refs": name -> (1, ny, 1)} for the Jmin/Jmax
    strips and {"tau_x": (nx, 1, 1), "refs_x": name -> (1, ny, 1)} for the
    Imin/Imax strips (spatial mode, where `x` is given).  ref_profiles:
    name -> (ny,) plane-averaged reference (from the ICs); ref_inflow: name
    -> (ny,) inflow-plane profile targeted by the Imin/Imax strips (else
    ref_profiles)."""
    has_j = spec.points_jmin > 1 or spec.points_jmax > 1
    has_i = x is not None and (spec.points_imin > 1 or spec.points_imax > 1)
    if spec.type == "none" or not (has_j or has_i):
        return None
    dev = _device.resolve(device)
    buf = {}
    if has_j:
        buf["tau"] = _tensor(tau_profile(y, spec), dtype, dev)[None, :, None]
        buf["refs"] = {k: _tensor(v, dtype, dev)[None, :, None]
                       for k, v in ref_profiles.items()}
    if has_i:
        buf["tau_x"] = _tensor(tau_profile_x(x, spec), dtype,
                               dev)[:, None, None]
        refs = ref_inflow if ref_inflow is not None else ref_profiles
        buf["refs_x"] = {k: _tensor(v, dtype, dev)[None, :, None]
                         for k, v in refs.items()}
    return buf


def localize(buf, comm):
    """The buffer tables of this rank's block on the pencil mesh (comm, the
    plan's mesh descriptor): the x profile tau_x and the x/z-extended
    reference planes sliced (y is never split); buf itself without a mesh.
    Makes the Imin/Imax strips and the unsteady-inflow planes run on the
    mesh (the reference relaxes its rank-local strips,
    boundary_buffer.f90)."""
    if buf is None or comm is None:
        return buf
    mesh = comm["mesh"]
    px, pz, ix, iz = mesh.px, mesh.pz, mesh.ix, mesh.iz
    if px == 1 and pz == 1:
        return buf
    out = dict(buf)
    if "tau_x" in buf and px > 1:
        t = buf["tau_x"]
        nxl = t.shape[0] // px
        out["tau_x"] = t[ix * nxl:(ix + 1) * nxl]
    if "refs_x" in buf:
        rx = {}
        for k, v in buf["refs_x"].items():
            if v.shape[0] > 1 and px > 1:
                nxl = v.shape[0] // px
                v = v[ix * nxl:(ix + 1) * nxl]
            if v.shape[2] > 1 and pz > 1:
                nzl = v.shape[2] // pz
                v = v[:, :, iz * nzl:(iz + 1) * nzl]
            rx[k] = v
        out["refs_x"] = rx
    return out


def relax(buf, name: str, q, h):
    """h -= tau (q - ref), over the active strips, in place on h (a row of
    the step's tendency); returns h."""
    if buf is None:
        return h
    if "tau" in buf:
        ref = buf["refs"].get(name)
        if ref is not None:
            h.sub_(buf["tau"] * (q - ref))
    if "tau_x" in buf:
        ref = buf["refs_x"].get(name)
        if ref is not None:
            h.sub_(buf["tau_x"] * (q - ref))
    return h


def relax_stack(buf, Q, H) -> None:
    """relax on every row of the stacked carry: Q, H (3+ns, nx, ny, nz),
    rows u, v, w, s0.. (the reference names of the scalars count from 0)."""
    names = ("u", "v", "w") + tuple(f"s{i}" for i in range(Q.shape[0] - 3))
    for i, name in enumerate(names):
        relax(buf, name, Q[i], H[i])


# ---------------------------------------------------------------------------
# Filter-type sponge (reference BOUNDARY_BUFFER_FILTER,
# src/tools/dns/boundary_buffer.f90:627-760 -- stubbed DNS_ERROR_UNDEVELOP
# there; tlab_tpu's working implementation of the blend its dead code
# describes: q := (1-amp) q + amp F(q), amp = (1+tanh(eta/2 delta))/2 with
# delta = L_buffer/16 centered mid-strip)
# ---------------------------------------------------------------------------

def filter_sponge_amp(x: np.ndarray, points_imin: int, points_imax: int,
                      dtype=torch.float64, device="cuda"):
    """(nx,1,1) blend amplitude over the Imin/Imax strips, zero elsewhere."""
    nx = x.shape[0]
    amp = np.zeros(nx)
    if points_imax > 1:
        i0 = nx - points_imax
        delta = (x[-1] - x[i0]) / 16.0
        eta = x[i0:] - 0.5 * (x[-1] + x[i0])
        amp[i0:] = 0.5 * (1.0 + np.tanh(0.5 * eta / delta))
    if points_imin > 1:
        i1 = points_imin - 1
        delta = (x[i1] - x[0]) / 16.0
        eta = x[: points_imin] - 0.5 * (x[0] + x[i1])
        amp[: points_imin] = np.maximum(
            amp[: points_imin], 0.5 * (1.0 - np.tanh(0.5 * eta / delta)))
    return _tensor(amp, dtype, _device.resolve(device))[:, None, None]


def apply_filter_sponge(amp, filt_mats, state):
    """Post-step blend toward the filtered state inside the strips; a new
    State."""
    return blend_sponge(amp, state, filter_state(filt_mats, state))


def blend_sponge(amp, state, f):
    """(1 - amp) state + amp f, field by field: the sponge's blend of a
    state and its filtered self (on a mesh, the rank's blocks)."""
    def blend(q, qf):
        return (1.0 - amp) * q + amp * qf

    return type(state)(u=blend(state.u, f.u), v=blend(state.v, f.v),
                       w=blend(state.w, f.w), s=blend(state.s, f.s),
                       sfc=state.sfc)
