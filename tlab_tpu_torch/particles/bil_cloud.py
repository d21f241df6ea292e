"""Two-phase cloud-droplet particles ("bilinearcloud" types; port of
tlab_tpu/particles/bil_cloud.py).

The reference's PART_TYPE_BIL_CLOUD_3/4 machinery
(src/tools/dns/rhs_part_1.f90:56-140, particle_time_residence.f90,
particle_time_liquid_clipping.f90): particles carry two prognostic droplet
scalars (diffusive / non-diffusive liquid) driven by Eulerian source fields
evaluated once per substep on the grid and trilinearly interpolated to the
particles:

  xi      = 1 - th1 s1 - th2 s2                (mixture fraction variable)
  src_a   = -visc (th1 Lap s1 + th2 Lap s2) + th2 (-radiation)
  src_gr  =  visc |grad xi|^2
  src_rad =  th2 (-radiation)

  d l4/dt = -src_a  / (1 + exp(xi/d0))
  d l5/dt = -src_rad/ (1 + exp(xi/d0)) - src_gr d4 / cosh^2(xi d2)

with d0 = th1 th3, d2 = -1/(2 th1 th3), d4 = -1/(4 th1 th3).  Variant 4
additionally tracks residence times above two y-levels (cloud top /
cloud base) with memory loss below the base.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tlab_tpu_torch.dycore import incompressible as dyn
from tlab_tpu_torch.particles.core import interpolate_to_particles


@dataclasses.dataclass(frozen=True)
class BilCloudParams:
    thermo: tuple = (1.0, 1.0, 1.0)     # (th1, th2, th3) = thermo_param(1:3)
    y_lambda: float = 0.0               # cloud-top level (residence)
    y_base: float = 0.0                 # cloud-base level (residence)
    variant: int = 3                    # 3 | 4 (4 adds residence times)


def eulerian_sources(P, s, visc: float, params: BilCloudParams,
                     radiation=None):
    """The four source fields on the grid, stacked (4, nx, ny, nz):
    [src_a, xi, src_gr, src_rad] (reference rhs_part_1.f90 txc(:,1..4))."""
    th1, th2, _ = params.thermo

    def lap(a):
        # the compact second derivative (OPR_P2): Burgers with conv=0,
        # diff=1
        return (dyn._d2(P, "x", 0, a) + dyn._d2(P, "y", 1, a)
                + dyn._d2(P, "z", 2, a))

    src_a = -visc * (th1 * lap(s[0]) + th2 * lap(s[1]))
    xi = 1.0 - th1 * s[0] - th2 * s[1]
    gx = dyn._d1(P, "x", 0, xi)
    gy = dyn._d1(P, "y", 1, xi)
    gz = dyn._d1(P, "z", 2, xi)
    src_gr = visc * (gx * gx + gy * gy + gz * gz)
    if radiation is not None:
        src_rad = th2 * (-radiation)
        src_a = src_a + src_rad
    else:
        src_rad = torch.zeros_like(xi)
    return torch.stack([src_a, xi, src_gr, src_rad])


def droplet_rhs(params: BilCloudParams, sources, loc, interp=None):
    """d/dt of the two droplet properties at the particles: (np, 2).

    `interp(field, loc)` overrides the gather (tlab_tpu's pencil engine
    passes a halo-extended block interpolator)."""
    if interp is None:
        interp = interpolate_to_particles
    th1, _, th3 = params.thermo
    inv0 = 1.0 / (th1 * th3)
    inv2 = -0.5 * inv0
    inv4 = -0.25 * inv0
    src_a = interp(sources[0], loc)
    xi = interp(sources[1], loc)
    src_gr = interp(sources[2], loc)
    src_rad = interp(sources[3], loc)
    sig = 1.0 / (1.0 + torch.exp(xi * inv0))
    d4 = -src_a * sig
    d5 = -src_rad * sig - src_gr * inv4 / torch.cosh(xi * inv2) ** 2
    return torch.stack([d4, d5], dim=-1)


def residence_update(params: BilCloudParams, dtime, y_pos, res):
    """res (np, 2): [time above y_lambda, time above y_base]; droplets
    falling below y_base lose both clocks (reference
    particle_time_residence.f90:26-36)."""
    above_top = y_pos > params.y_lambda
    above_base = y_pos > params.y_base
    r0 = torch.where(above_top, res[:, 0] + dtime, res[:, 0])
    r1 = torch.where(above_base, res[:, 1] + dtime, res[:, 1])
    r0 = r0.masked_fill(~above_base, 0.0)
    r1 = r1.masked_fill(~above_base, 0.0)
    return torch.stack([r0, r1], dim=-1)


def liquid_clip(props):
    """Negative droplet liquid is unphysical -> clip at zero (reference
    particle_time_liquid_clipping.f90)."""
    return torch.clamp(props, min=0.0)


def residence_pdf(res, t_max: float, nbins: int = 100):
    """Histogram of residence times (reference PARTICLE_RESIDENCE_PDF), on
    the host."""
    res = res.detach().cpu().numpy() if isinstance(res, torch.Tensor) \
        else np.asarray(res)
    out = []
    for k in range(res.shape[1]):
        counts, edges = np.histogram(res[:, k], bins=nbins,
                                     range=(0.0, t_max))
        out.append((counts, edges))
    return out
