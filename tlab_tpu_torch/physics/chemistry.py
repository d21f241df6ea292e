"""Chemistry-like scalar sources (reference src/physics/chemistry.f90), port
of tlab_tpu/physics/chemistry.py: quadratic/quadratic3 reactions, ozone,
layered relaxation. The Damkohler number is PER SCALAR ([Parameters]
Damkohler list, navierstokes.f90) and selects the active scalars
(chemistry.f90:78-81)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ChemistryProps:
    type: str = "none"        # none|quadratic|quadratic3|ozone|layeredrelaxation
    damkohler: tuple = ()     # per-scalar Da (zero => inactive)
    parameters: tuple = (1.0,)
    scalar: int = 0           # legacy single-scalar selector
    ymean: tuple = ()         # per-scalar profile ymean (layeredrelaxation)


def active_scalars(props: ChemistryProps, ns: int):
    """Scalars with nonzero Damkohler (chemistry.f90:78-81)."""
    return [i for i in range(ns)
            if i < len(props.damkohler) and abs(props.damkohler[i]) > 0]


def source(props: ChemistryProps, s, i, y=None):
    """Source for scalar i from the full stack s (ns, nx, ny, nz)
    (reference Chemistry_Source, chemistry.f90:102-155; 1-based scalar
    indices there map to 0-based here).  y: the (ny,) nodes (array or
    tensor), for layeredrelaxation."""
    ns = s.shape[0]
    da = props.damkohler[i] if i < len(props.damkohler) else 0.0
    par = props.parameters

    def p(k):
        return par[k] if k < len(par) else 0.0

    if props.type == "quadratic":
        # Da(is)*parameters(is) * s2*s3
        if ns < 3:
            # two-scalar fallback: logistic reaction on the scalar itself
            return da * p(i) * s[i] * (1.0 - s[i])
        return da * p(i) * s[1] * s[2]
    if props.type == "quadratic3":
        if i < 3:
            pair = s[1] * s[2]
        elif i < 6:
            pair = s[3] * s[4]
        else:
            pair = s[6] * s[7]
        return da * p(i) * pair
    if props.type == "ozone":
        # chemistry.f90:137-150: photolysis-type rate from s1
        rate = torch.exp(-p(0) / (1.0 + p(1) * s[0]))
        if i == 3:
            return -da * ((1.0 + p(2)) * s[3] - rate * s[1] * s[2])
        return da * (s[3] - rate * s[1] * s[2])
    if props.type == "layeredrelaxation":
        # relaxation_strength (chemistry.f90:82-95): tanh profile with
        # mean 0.5, delta 1, thick -p3/2, centered at the scalar's ymean
        # and evaluated at y - p2:
        #   strength(y) = 0.5*(1 + tanh((y - p2 - ymean)/p3))
        # source = -Da(is)/p1 * strength * s_is (chemistry.f90:117-120)
        ym = props.ymean[i] if i < len(props.ymean) else 0.0
        yt = torch.as_tensor(y).to(s.device, s.dtype)
        strength = 0.5 * (1.0 + torch.tanh(
            (yt[None, :, None] - p(1) - ym) / p(2)))
        return -da / p(0) * strength * s[i]
    return torch.zeros_like(s[i])
