"""Carry the JAX package's plans and states across to the port.

The parity tests build a plan or an initial state with tlab_tpu and hand it
to the port through these functions, so that both packages compute on the
same inputs.  The JAX side delivers host arrays, and every leaf goes through
np.asarray first; nothing here imports JAX.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from tlab_tpu_torch import device as _device
from tlab_tpu_torch import ibm as ibmmod
from tlab_tpu_torch.dycore.incompressible import (check_main_path,
                                                  scalar_bounds)
from tlab_tpu_torch.dycore.state import State
from tlab_tpu_torch.ops import elliptic_factorize as fac
from tlab_tpu_torch.ops import thomas

_MATRIX = re.compile(r"^(d1|d12|iod)[xyz]$")
_ELLIPTIC = ("ell", "ell_dd", "ell_stag")       # direct eigen Poisson plans
_UNUSED = ("dtype",)


def plans_from_jax(P_np: dict, device, dtype, bodyforce=None) -> dict:
    """The port's plan dict from a tlab_tpu build_device_plans/
    Simulation plan.

    tlab_tpu's "bodyforce" is a function of JAX arrays and cannot cross: a
    plan that has one needs the port's own hook in `bodyforce`
    (runtime.make_sources of the same case).  Raises NotImplementedError
    for keys that select a path the port lacks (check_main_path), and
    KeyError for keys it does not know."""
    dev = _device.resolve(device)

    def t(a):
        return torch.as_tensor(np.array(a, np.float64)).to(dev, dtype)

    P = {}
    for key, val in P_np.items():
        if _MATRIX.match(key):
            P[key] = t(val)
        elif key == "rk":
            P[key] = dict(val)
        elif key in ("visc", "diffusion_constant"):
            P[key] = float(val)
        elif key in ("diff", "sizes"):
            P[key] = tuple(val)
        elif key == "bc_rows":
            P[key] = {c: _rows(val[c], t) for c in ("u", "v", "w")}
            P[key]["s"] = tuple(_rows(r, t) for r in val["s"])
        elif key in ("wall_bc_types", "wall_refs"):
            P[key] = dict(val)
        elif key == "ell_fac":
            arrays = {k: v for k, v in val.items() if k not in ("dft",
                                                                 "sing")}
            P[key] = fac.device_plan_from_arrays(arrays, dtype, dev)
        elif key == "scal_bounds":
            if val is not None:
                P[key] = scalar_bounds(val[0], val[1], dtype, dev)
        elif key in _ELLIPTIC:
            P[key] = {k: float(v) if k == "shift" else t(v)
                      for k, v in val.items() if k not in ("dft",
                                                           "shardings")}
        elif key in ("stag", "dealias"):
            P[key] = {k: None if v is None else t(v) for k, v in val.items()}
        elif key == "pfilter":
            if val is None or "helmholtz_alpha" in val:
                P[key] = val
            else:
                P[key] = {k: None if v is None else t(v)
                          for k, v in val.items()}
        elif key in ("adv_form", "remove_divergence"):
            P[key] = val
        elif key == "anelastic":
            if val is not None:
                P[key] = {k: t(val[k]) for k in ("rho", "rho_inv")}
        elif key == "ibm":
            if val is not None:
                P[key] = _ibm(val, t, dtype, dev)
        elif key == "buffer":
            if val is not None:
                P[key] = {k: ({n: t(r) for n, r in v.items()}
                              if isinstance(v, dict) else t(v))
                          for k, v in val.items()}
        elif key == "surface_bc":
            if val is not None:
                P[key] = {k: tuple(v) for k, v in val.items()}
        elif key == "bodyforce":
            if val is not None and bodyforce is None:
                raise ValueError(
                    "the tlab_tpu plan has a bodyforce hook: pass the "
                    "port's own (runtime.make_sources) as `bodyforce`")
            P[key] = bodyforce if val is not None else None
        elif key in _UNUSED:
            continue
        elif key.endswith("_banded"):
            P[key] = thomas.device_plan(val, dtype, dev)
        elif key == "y_periodic":
            P[key] = bool(val)
        else:
            raise KeyError(f"unknown tlab_tpu plan key {key!r}")
    check_main_path(P)
    return P


def _ibm(val, t, dtype, dev) -> dict:
    """tlab_tpu's "ibm" entry in the port's layout: eps, fluid (and the
    scalar values) as tensors, the dense fill tables as the solid points'
    sparse ones (ibm.fill_from_dense)."""
    out = {k: t(v) for k, v in val.items() if k != "fills"}
    if "fills" in val:
        out["fills"] = {name: ibmmod.fill_from_dense(fill, "xyz".index(name),
                                                     dtype, dev)
                        for name, fill in val["fills"].items()}
    return out


def _rows(rows, t):
    if rows is None:
        return None
    return {k: None if rows[k] is None else t(rows[k]) for k in ("nb", "nt")}


def state_from_numpy(u, v, w, s, device, dtype, sfc=None) -> State:
    """State of tensors from array-likes: u, v, w (nx, ny, nz), s
    (ns, nx, ny, nz), and the surface state sfc (2, ns, nx, nz) or None."""
    dev = _device.resolve(device)

    def t(a):
        return torch.as_tensor(np.array(a, np.float64)).to(dev, dtype)

    return State(u=t(u), v=t(v), w=t(w), s=t(s),
                 sfc=None if sfc is None else t(sfc))


def state_to_numpy(state, sfc: bool = False) -> tuple:
    """(u, v, w, s) float64 arrays on the host from a State of tensors on
    any device (the inverse of state_from_numpy; array-likes pass through
    np.asarray, so a tlab_tpu State converts too); with `sfc`, the surface
    state (or None) is the fifth."""
    def a(t):
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu().numpy()
        return np.asarray(t, np.float64)

    out = (a(state.u), a(state.v), a(state.w), a(state.s))
    if sfc:
        out += (None if state.sfc is None else a(state.sfc),)
    return out
