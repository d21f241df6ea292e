"""The compressible shear layer's initial fields: the velocity and scalar
of initial/shear_broadband.py (the case's tanh mean profiles of u and the
scalars plus the broadband, solenoidal perturbation of its [IniFields]
ThickIniK, [Broadband] f0 and [IniFields] NormalizeK) with a uniform
density rho = 1 and pressure p = 1/(gamma M^2), so T = 1, as
tools/initialize.compressible_initial_state sets them for a case with no
density or pressure profile; v is 0 on the walls.  Returned as the
internal-energy set's conservative stack (rho, rho u, rho v, rho w,
rho e, rho s1..) with e = T / (gamma (gamma - 1) M^2)."""
from __future__ import annotations

import torch

from harness.spec import BENCH_DIR, load_module


def make(case, params, seed, device, dtype):
    shear = load_module(BENCH_DIR / "initial" / "shear_broadband.py",
                        "initial")
    q = shear.make(case, params, seed, device, torch.float64)
    q[1, :, 0, :] = 0.0
    q[1, :, -1, :] = 0.0
    gamma = case.float("Thermodynamics", "HeatCapacityRatio",
                       case.float("Parameters", "Gamma", 1.4))
    mach = case.float("Parameters", "Mach", 0.3)
    rho = torch.ones_like(q[0])
    p = torch.full_like(q[0], 1.0 / (gamma * mach ** 2))
    T = gamma * mach ** 2 * p / rho
    e = T / (gamma * (gamma - 1.0) * mach ** 2)
    out = torch.cat([rho[None], rho * q[:3], (rho * e)[None], rho * q[3:]])
    return out.to(dtype)
