"""Large-scale and special forcing terms (reference
src/physics/largescaleforcing.f90, specialforcing.f90), port of the
time-independent part of tlab_tpu/physics/forcing.py.

- Subsidence (ConstantDivergenceLocal): w_LS(y) = D*y; the scalar/momentum
  source is w_LS * d a/dy (reference LargeScaleForcing_Subsidence:79-120).
- Homogeneous forcing: a constant body force.

The sinusoidal wavemaker needs the step's time (aux["rtime"]) and is not
ported yet (ROADMAP A9).
"""
from __future__ import annotations

import dataclasses

from tlab_tpu_torch.dycore import incompressible as dyn


@dataclasses.dataclass(frozen=True)
class SubsidenceProps:
    type: str = "none"        # none | constantdivergencelocal
    divergence: float = 0.0   # D (1/time)


def subsidence_source(props: SubsidenceProps, P, y, a):
    """w_LS * da/dy with w_LS = D*y, added to a's tendency.  y: the (ny,)
    node tensor on a's device."""
    w_ls = (props.divergence * y)[None, :, None]
    return w_ls * dyn._d1(P, "y", 1, a)


def homogeneous_from_ini(ini):
    """[SpecialForcing] Type=Homogeneous: constant body force
    Parameters(1) on the components with nonzero Vector entries
    (specialforcing.f90:103,215-216; tlab_sources.f90:114-123). Returns
    (fx, fy, fz) or None."""
    if ini.get("SpecialForcing", "Type", "none").lower() != "homogeneous":
        return None
    pars = ini.get_floats("SpecialForcing", "Parameters", (1.0,))
    vec = ini.get_floats("SpecialForcing", "Vector", (1.0, 0.0, 0.0))
    vec = tuple(vec) + (0.0,) * (3 - len(vec))
    return tuple(pars[0] if abs(v) > 0 else 0.0 for v in vec[:3])
