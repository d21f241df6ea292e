"""Caloric / thermal / transport equations of state for the compressible
core (a copy of tlab_tpu/physics/eos.py; only its import differs).

Equivalents of the reference's thermo_caloric.f90, thermo_thermal.f90 and
thermo_viscosity.f90 (nondimensional formulation, thermodynamics.f90):
single-species ideal gas with constant cp is the compressible workhorse;
the transport law mu(T) is runtime-selectable via [Thermodynamics]
Transport = none | powerlaw | sutherland (reference
thermodynamics.f90:176-180 -- note the reference's 'sutherland' branch is
a stub returning 1; here it is the actual Sutherland law).  The functions
take tensors.

Nondimensionalization (reference dns_const.h conventions):
    p = rho T / (gamma M^2)         thermal EOS
    e = T / (gamma (gamma-1) M^2)   caloric EOS (constant cv)
    c^2 = T / M^2                   sound speed
    mu = mu(T)                      transport law, mu(T_ref=1) = 1
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class GasParams:
    gamma: float = 1.4
    mach: float = 0.3
    transport: str = "none"      # none | powerlaw | sutherland
    sutherland_s: float = 0.404  # S/T_ref (air: 110.4 K / 273 K)


def temperature_from_e(gas: GasParams, e):
    """Caloric EOS inverse: T(e) (reference THERMO_CALORIC_TEMPERATURE,
    thermo_caloric.f90, constant-cp single species)."""
    return e * gas.gamma * (gas.gamma - 1.0) * gas.mach ** 2


def energy_from_t(gas: GasParams, T):
    return T / (gas.gamma * (gas.gamma - 1.0) * gas.mach ** 2)


def pressure(gas: GasParams, rho, T):
    """Thermal EOS (reference THERMO_THERMAL_PRESSURE)."""
    return rho * T / (gas.gamma * gas.mach ** 2)


def density(gas: GasParams, p, T):
    """Thermal EOS inverse (reference THERMO_THERMAL_DENSITY)."""
    return p * gas.gamma * gas.mach ** 2 / T


def temperature_from_rho_p(gas: GasParams, rho, p):
    return p * gas.gamma * gas.mach ** 2 / rho


def sound_speed2(gas: GasParams, T):
    return T / gas.mach ** 2


def viscosity(gas: GasParams, T):
    """mu(T) (reference THERMO_VISCOSITY, thermo_viscosity.f90:7-30)."""
    if gas.transport == "powerlaw":
        return T ** 0.7
    if gas.transport == "sutherland":
        s = gas.sutherland_s
        return T ** 1.5 * (1.0 + s) / (T + s)
    return torch.ones_like(T)
