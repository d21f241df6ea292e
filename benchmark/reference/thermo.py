"""Plain float64 AirWater thermodynamics of the anelastic formulation
(tlab's Thermo_Anelastic_PH, Thermo_Anelastic_BUOYANCY and
Gravity_Hydrostatic_Enthalpy), nondimensional as tlab's anelastic cases.

Scalars: s1 = h (moist static energy per Cp_d T_ref), s2 = q_t.  The
equilibrium (T, q_l) solves h = cp(q_t, q_l) T - q_l L_v0 + ep(y) with
q_v at saturation (Flatau et al. 1992's polynomial for p_sat) by Newton
iterations on the polynomial that h - ... = 0 becomes times (p - p_sat);
the buoyancy is (rho_bar - p_bar / (R T)) / rho_bar.  Everything here is
float64: the polynomial cancels catastrophically in float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch

RGAS, WGHT_V, WGHT_D, LV_273 = 8314.0, 18.015, 28.9644, 2501600.0
CPD, CPV, CL = 1007.0, 1870.0, 4217.6
FLATAU = (0.611213476e+3, 0.444007856e+2, 0.143064234e+1,
          0.264461437e-1, 0.305930558e-3, 0.196237241e-5,
          0.892344772e-8, -0.373208410e-10, 0.209339997e-13)


def psat_coeffs(T_ref=298.0, p_ref=1.0e5):
    """Flatau's fit re-expanded in powers of T (T_ref units), p_ref
    units."""
    n = len(FLATAU)
    t0 = 273.15
    a = np.zeros(n)
    for ip in range(1, n + 1):
        for i in range(ip, n + 1):
            tmp = 1.0
            for j in range(i - 1, i - ip, -1):
                tmp *= float(j)
            a[ip - 1] += FLATAU[i - 1] * t0 ** (i - 1) * tmp \
                * (-1.0) ** (i - ip)
        a[ip - 1] /= math.factorial(ip - 1) * t0 ** (ip - 1)
    a /= p_ref
    return tuple(a[i] * T_ref ** i for i in range(n))


class AirWater:
    """The nondimensional constants (Cp_d = 1, R scaled by Cp_d)."""

    def __init__(self, scale_height: float, T_ref=298.0, p_ref=1.0e5):
        self.eps = WGHT_V / WGHT_D
        self.Cd, self.Cdv = 1.0, (CPV - CPD) / CPD
        self.Cvl, self.Cdl = (CL - CPV) / CPD, (CL - CPD) / CPD
        self.Rd = (RGAS / WGHT_D) / CPD
        self.Rv = self.Rd / self.eps
        self.Lv0 = (LV_273 + (CL - CPV) * 273.15) / (CPD * T_ref)
        self.g = 1.0 / scale_height if scale_height > 0 else 0.0
        self.cf = psat_coeffs(T_ref, p_ref)

    def psat(self, T):
        p = torch.zeros_like(T) + self.cf[-1]
        for c in self.cf[-2::-1]:
            p = p * T + c
        return p

    def R_hat(self, qt, ql):
        """The mixture's gas constant over R_d."""
        return (self.Rd + qt * (self.Rv - self.Rd) - ql * self.Rv) / self.Rd

    def equilibrium(self, h, qt, p, ep, n_newton=8, with_err=False):
        """(T, ql[, the last Newton step's max relative size over the
        saturated points])."""
        H = h - ep
        T0 = H / (self.Cd + qt * self.Cdv)
        eps = self.eps
        r0 = eps / (p / self.psat(T0) - 1.0)
        saturated = r0 / (1.0 + r0) < qt
        cf = self.cf
        alpha = (eps * self.Lv0 + qt * self.Lv0 * (1.0 - eps) + H) / p
        beta = (eps * self.Cvl + self.Cd + qt * (self.Cdl - eps * self.Cvl)) \
            / p
        b = [H + qt * self.Lv0 - cf[0] * alpha]
        b += [cf[i - 1] * beta - cf[i] * alpha for i in range(1, 9)]
        b[1] = b[1] - self.Cd - qt * self.Cdl
        b.append(cf[8] * beta)
        T = T0
        for _ in range(max(n_newton, 5)):
            F, D = b[-1], torch.zeros_like(T)
            for i in range(len(b) - 2, -1, -1):
                F = F * T + b[i]
                D = D * T + b[i + 1] * (i + 1)
            step = F / D
            T = T - step
            err = torch.abs(step) / torch.abs(T)
        ql_sat = qt - eps / (p / self.psat(T) - 1.0) * (1.0 - qt)
        Tq = torch.where(saturated, T, T0)
        ql = torch.where(saturated,
                         torch.minimum(torch.clamp(ql_sat, min=0.0), qt), 0.0)
        if with_err:
            return Tq, ql, torch.max(torch.where(saturated, err, 0.0))
        return Tq, ql


def background(tw: AirWater, y, h_prof, qt_prof, d1y, p_ref, y_ref,
               niter=10):
    """The hydrostatic background, host float64: p, rho, ep (ny,).
    d ln p / dy = -g / (R_hat T), integrated from y[0] by the compact
    first derivative with its first row replaced by F(y0) = 0, then
    scaled to p(y_ref) = p_ref."""
    ep = tw.Rd * tw.g * (y - y_ref)
    D = np.array(d1y, dtype=np.float64)
    D[0, :] = 0.0
    D[0, 0] = 1.0
    h, qt = torch.as_tensor(h_prof), torch.as_tensor(qt_prof)
    p = np.full(y.shape, p_ref)
    for _ in range(niter):
        # the density below takes the last pass's T and ql, as tlab's
        T, ql = tw.equilibrium(h, qt, torch.as_tensor(p), torch.as_tensor(ep))
        rT = (tw.R_hat(qt, ql) * T).numpy()
        rhs = -tw.g / rT
        rhs[0] = 0.0
        p = np.exp(np.linalg.solve(D, rhs))
        p *= p_ref / np.interp(y_ref, y, p)
    return {"p": p, "rho": p / rT, "ep": ep}


def buoyancy(tw: AirWater, s, bg):
    """(rho_bar - p_bar / (R_hat T)) / rho_bar of the scalars s (2, ...),
    with bg's (ny,) profiles as (1, ny, 1) tensors."""
    p, rho = bg["p"], bg["rho"]
    T, ql = tw.equilibrium(s[0], s[1], p, bg["ep"])
    return (rho - p / (tw.R_hat(s[1], ql) * T)) / rho
