"""Low-storage Runge-Kutta coefficients and the diffusion-number constant.

A copy of tlab_tpu/dycore/timemarch.py:15-78: that module is pure NumPy,
but importing it runs tlab_tpu/dycore/__init__.py, which imports JAX.

Schemes as in the reference TIME module (src/tools/dns/time.f90:85-137):
- Williamson (1980) 3rd-order, 3 stages
- Carpenter & Kennedy (1994) 4th-order, 5 stages
Low-storage update per substep i:  q += dt*kdt[i]*h;  h *= kco[i].
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class RKScheme:
    name: str
    kdt: tuple
    ktime: tuple
    kco: tuple


RK3 = RKScheme(
    name="RungeKuttaExplicit3",
    kdt=(1.0 / 3.0, 15.0 / 16.0, 8.0 / 15.0),
    ktime=(0.0, 1.0 / 3.0, 3.0 / 4.0),
    kco=(-5.0 / 9.0, -153.0 / 128.0),
)

RK4 = RKScheme(
    name="RungeKuttaExplicit4",
    kdt=(1432997174477.0 / 9575080441755.0,
         5161836677717.0 / 13612068292357.0,
         1720146321549.0 / 2090206949498.0,
         3134564353537.0 / 4481467310338.0,
         2277821191437.0 / 14882151754819.0),
    ktime=(0.0,
           1432997174477.0 / 9575080441755.0,
           2526269341429.0 / 6820363962896.0,
           2006345519317.0 / 3224310063776.0,
           2802321613138.0 / 2924317926251.0),
    kco=(-567301805773.0 / 1357537059087.0,
         -2404267990393.0 / 2016746695238.0,
         -3550918686646.0 / 2091501179385.0,
         -1275806237668.0 / 842570457699.0),
)


def get_scheme(name: str) -> RKScheme:
    key = name.lower()
    if "3" in key:
        return RK3
    if "4" in key:
        return RK4
    raise ValueError(f"unknown RK scheme {name!r}")


def diffusion_constant(fdm, nsp) -> float:
    """schmidtfactor * max(1/dx^2+1/dy^2+1/dz^2), cf. time.f90:139-178."""
    sf = max(1.0, 1.0 / nsp.prandtl,
             1.0 / min(nsp.schmidt) if nsp.schmidt else 1.0) * nsp.visc
    dx2i = 0.0
    terms = []
    for plan in (fdm.x, fdm.y, fdm.z):
        if plan.size > 1:
            terms.append(1.0 / plan.jac ** 2)
    if terms:
        # pointwise max over the grid of the per-direction sum (the
        # reference's TIME_COURANT), exact on stretched grids too
        grids = np.meshgrid(*[t for t in terms], indexing="ij")
        dx2i = float(np.max(sum(grids)))
    return sf * dx2i
