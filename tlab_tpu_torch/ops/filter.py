"""3-D field filtering (reference src/operators/opr_filter.f90), port of
tlab_tpu/ops/filter.py.

One dense line-filter matrix per active direction; the 3-D filter is their
composition, each one product (ops/derivative.py::apply_along).  Used for
the domain filter (every [Filter] Step iterations), dealiasing, and pressure
filtering.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tlab_tpu_torch import device as _device
from tlab_tpu_torch.dycore.state import State
from tlab_tpu_torch.fdm import filters as flt
from tlab_tpu_torch.fdm.plan import FdmPlan
from tlab_tpu_torch.ops.derivative import apply_along


@dataclasses.dataclass(frozen=True)
class FilterSpec:
    type: str = "none"       # none|compact|explicit6|explicit4|tophat|adm|helmholtz
    parameters: tuple = (0.49,)
    active: tuple = (True, True, True)
    step: int = 0            # domain-filter cadence (0 = off)
    # y-direction wall closure (reference BcsJmin/BcsJmax,
    # opr_filter.f90:160-185): 'biased' (default) | 'zero'
    bcs_j: tuple = ("biased", "biased")


def adm_matrix(nodes, periodic):
    """Approximate deconvolution (ADM) regularization: G3 = 3G - 3G^2 + G^3
    applied to the top-hat kernel (reference DNS_FILTER_ADM family)."""
    G = flt.tophat_matrix(nodes, 2, periodic)
    G2 = G @ G
    return 3.0 * G - 3.0 * G2 + G2 @ G


def build_filter_matrices(fdm: FdmPlan, spec: FilterSpec,
                          dtype=torch.float32, device="cuda"):
    """dict axis -> matrix on `device` (None for inactive/size-1
    directions)."""
    dev = _device.resolve(device)
    out = {}
    for name, plan, on in (("x", fdm.x, spec.active[0]),
                           ("y", fdm.y, spec.active[1]),
                           ("z", fdm.z, spec.active[2])):
        if not on or plan.size == 1 or spec.type == "none":
            out[name] = None
            continue
        if spec.type == "compact":
            bcs = spec.bcs_j if name == "y" else ("biased", "biased")
            M = flt.compact4_matrix(plan.nodes, spec.parameters[0],
                                    plan.periodic, bcs=bcs)
        elif spec.type == "explicit6":
            M = flt.explicit6_matrix(plan.size, plan.periodic)
        elif spec.type == "explicit4":
            M = flt.explicit4_matrix(plan.nodes, plan.periodic)
        elif spec.type == "tophat":
            M = flt.tophat_matrix(plan.nodes,
                                  int(spec.parameters[0]) if spec.parameters else 2,
                                  plan.periodic)
        elif spec.type == "adm":
            M = adm_matrix(plan.nodes, plan.periodic)
        elif spec.type in ("spectralband", "spectralerf"):
            if not plan.periodic:
                out[name] = None          # spectral filters: periodic only
                continue
            M = flt.spectral_matrix(plan.size,
                                    "band" if spec.type.endswith("band")
                                    else "erf", spec.parameters)
        else:
            raise NotImplementedError(f"filter type {spec.type}")
        out[name] = torch.as_tensor(np.asarray(M, np.float64)).to(dev, dtype)
    return out


def build_helmholtz_filter(ell_dev: dict, width: float):
    """3-D Helmholtz filter: (1 - w^2/24 Lap) uf = u (reference
    DNS_FILTER_HELMHOLTZ): one implicit elliptic solve per field."""
    from tlab_tpu_torch.ops import elliptic
    alpha = -24.0 / max(width, 1e-30) ** 2

    def apply(a):
        return elliptic.helmholtz(ell_dev, alpha * a, alpha)

    return apply


def apply_filter(mats, a):
    if callable(mats):
        return mats(a)
    for name, axis in (("x", 0), ("y", 1), ("z", 2)):
        M = mats.get(name)
        if M is not None:
            a = apply_along(M, a, axis)
    return a


def filter_state(mats, state: State) -> State:
    s = state.s
    if s.shape[0]:
        s = torch.stack([apply_filter(mats, s[i]) for i in range(s.shape[0])])
    return State(u=apply_filter(mats, state.u),
                 v=apply_filter(mats, state.v),
                 w=apply_filter(mats, state.w),
                 s=s, sfc=state.sfc)
