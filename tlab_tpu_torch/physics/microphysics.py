"""Microphysics: droplet sedimentation sources (reference
src/physics/microphysics.f90), port of tlab_tpu/physics/microphysics.py.

Two formulations, selected by [Sedimentation] Type:

- ``airwater`` (TYPE_SED_AIRWATER, microphysics.f90:141-160): per-scalar
  flux f_is built from the driving liquid field l = s_active, then
  source = d/dy f_is.  Water scalars (is = 2, 3 in the reference's
  1-based convention) use f = p_is (1 - s_is) l^(1+e); the energy scalar
  uses f = p_is L(s) l^(1+e) with L the liquid static energy
  (Thermo_Anelastic_STATIC_L, thermo_anelastic.f90:258).
- ``airwatersimplified`` (TYPE_SED_AIRWATERSIMPLIFIED,
  microphysics.f90:162-180): derivative-first form that avoids
  oscillations at sharp gradients,
  source = p_is (1+e) (dl/dy) l^e.

The per-scalar parameters are pre-multiplied by the settling number at
read time (microphysics.f90:96-101); every scalar is affected for the
airwater mixtures (microphysics.f90:74-76).  The driving field s_active
is the LAST scalar of the array stack (the diagnostic liquid,
microphysics.f90:93), density-weighted in anelastic mode
(microphysics.f90:133-135); the anelastic tendency is weighted back by
1/rho by the caller (tlab_sources.f90:176-177).
"""
from __future__ import annotations

import dataclasses

import torch

from tlab_tpu_torch.dycore import incompressible as dyn


@dataclasses.dataclass(frozen=True)
class MicrophysicsProps:
    type: str = "none"            # none | airwater | airwatersimplified
    parameters: tuple = ()        # per-scalar, PRE-scaled by settling
    exponent: float = 0.0         # flux ~ l^(1+exponent)


def param(props: MicrophysicsProps, isc: int) -> float:
    """Per-scalar parameter; reference defaults unread entries to
    1.0*settling (microphysics.f90:79-84,96-97)."""
    if isc < len(props.parameters):
        return props.parameters[isc]
    return props.parameters[-1] if props.parameters else 0.0


def _pow_active(s_active, expo):
    if expo == 0.0:
        return s_active
    return torch.pow(torch.clamp(s_active, min=0.0), expo)


def sedimentation_simplified(props: MicrophysicsProps, P, isc: int,
                             s_active):
    """source = p_is (1+e) (d s_active/dy) s_active^e
    (microphysics.f90:172-180)."""
    e = props.exponent
    dsdy = dyn._d1(P, "y", 1, s_active)
    if e > 0.0:
        dsdy = dsdy * _pow_active(s_active, e)
    return param(props, isc) * (1.0 + e) * dsdy


def sedimentation_airwater(props: MicrophysicsProps, P, isc: int, s,
                           s_active, static_l=None):
    """source = d/dy f_is with the flux of microphysics.f90:141-158.
    isc is 0-based: reference case(2,3) -> isc in (1, 2)."""
    e = props.exponent
    lw = _pow_active(s_active, 1.0 + e) if e > 0.0 else s_active
    if isc in (1, 2):
        flux = param(props, isc) * (1.0 - s[isc]) * lw
    else:
        flux = param(props, isc) * static_l * lw
    return dyn._d1(P, "y", 1, flux)


def liquid_static_energy(tp, h, T, ep):
    """Thermo_Anelastic_STATIC_L (thermo_anelastic.f90:258-308):
    Cl*T + ep - Lv0 - h.  T is the temperature of the current state;
    the reference recomputes it from (h, qt, ql) with the stored
    (equilibrium) ql, which equals the equilibrium T the caller already
    holds from diagnostic_fields."""
    return tp.Cl * T + ep - tp.Lv0 - h
