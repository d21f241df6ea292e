"""Offline pressure recovery (reference FI_PRESSURE_BOUSSINESQ,
src/physics/fi_pressure_boussinesq.f90; port of tlab_tpu/dycore/
pressure.py): rebuild the momentum tendency divergence from a snapshot and
solve the Poisson equation -- used by the statistics tools for pressure
moments when p is not stored.

decomposition selects which tendency pieces feed the Poisson forcing
(the reference's DCMP_* menu, consumed by visuals.x through
[PostProcessing] PressureDecomposition, visuals.f90:136-149):
  total      advection + diffusion + all sources  (default)
  advdiff    advection + diffusion only
  advection  advection only (full Burgers minus the zero-velocity pass)
  diffusion  diffusion only
  coriolis   Coriolis tendency only
  buoyancy   buoyancy tendency only
  resolved   as total

The Burgers terms go through dycore.incompressible._burgers_all, so a
float32 velocity stack on the card launches the hand kernels K1-K3 (three
fields; the diffusion-only pass with a zero convecting velocity).  The
Poisson solve is the direct eigen plan P["ell"] with the wall-normal
tendency as Neumann data, as tlab_tpu's.
"""
from __future__ import annotations

import torch

from tlab_tpu_torch.dycore import incompressible as dyn
from tlab_tpu_torch.ops import elliptic


def _burgers_sum(P, fields, u, v, w, nu):
    return (dyn._burgers_all(P, "x", 0, fields, u, nu)
            + dyn._burgers_all(P, "y", 1, fields, v, nu)
            + dyn._burgers_all(P, "z", 2, fields, w, nu))


def pressure_boussinesq(P, state, decomposition: str = "total"):
    """Diagnostic pressure from the current state."""
    div, bcs_b, bcs_t = pressure_forcing(P, state, decomposition)
    return elliptic.poisson(P["ell"], div, bcs_b=bcs_b, bcs_t=bcs_t)


def pressure_forcing(P, state, decomposition: str = "total"):
    """(div h, h2 at the bottom wall, h2 at the top wall): the Poisson
    forcing and the Neumann data of the diagnostic pressure."""
    u, v, w, s = state.u, state.v, state.w, state.s
    dcmp = decomposition.lower()
    fields = torch.stack([u, v, w])
    nu = torch.full((3, 1, 1, 1), P["visc"], dtype=fields.dtype,
                    device=fields.device)

    if dcmp in ("total", "advdiff", "advection", "resolved"):
        h = _burgers_sum(P, fields, u, v, w, nu)
    else:
        h = torch.zeros_like(fields)
    if dcmp in ("advection", "diffusion"):
        # diffusion-only Burgers: zero advecting velocity
        # (fi_pressure_boussinesq.f90:116-156)
        z = torch.zeros_like(u)
        diff = _burgers_sum(P, fields, z, z, z, nu)
        h = h - diff if dcmp == "advection" else diff
    bf = P.get("bodyforce")
    if dcmp in ("coriolis", "buoyancy"):
        hook = "coriolis_only" if dcmp == "coriolis" else "buoyancy_only"
        fn = getattr(bf, hook, None)
        if fn is None:
            what = "[Rotation]" if dcmp == "coriolis" \
                else "[Gravity]/[BodyForce]"
            raise ValueError(f"PressureDecomposition={dcmp} needs an "
                             f"active {what} term")
        z = torch.zeros_like(u)
        h = torch.stack([r + z for r in fn(state)])

    h1, h2, h3 = h[0], h[1], h[2]
    if dcmp in ("total", "resolved") and bf is not None:
        # the hook adds its sources into the rows of h in place
        h1, h2, h3, _ = bf(P, state, h1, h2, h3, torch.zeros_like(s))
    return dyn.divergence(P, h1, h2, h3), h2[:, 0, :], h2[:, -1, :]
