"""Anelastic moist thermodynamics (reference src/thermodynamics/*), port of
the anelastic half of tlab_tpu/physics/thermo.py.

Mixtures: dry air ('air'), unsaturated moist air ('airvapor'), moist air
with liquid via saturation adjustment ('airwater') -- the reference's
MIXT_TYPE_* families (thermodynamics.f90:34-48, thermo_anelastic.f90,
thermo_airwater.f90) -- and the linearized stratocumulus mixture
('airwaterlinear').

Nondimensional convention (as tlab_tpu's):
  - temperature scaled by T_ref, pressure by p_ref, heights by L_ref
  - specific heats scaled by Cp_dry  => Cd = 1
  - gas constants scaled by Cp_dry   => Rd = (gamma-1)/gamma
  - latent heat scaled by Cp_dry*T_ref
State scalars in anelastic mode: s1 = h (moist static energy, cp T + g y
- Lv0 ql per unit Cp T_ref), s2 = q_t (total water), diagnostic q_l.

  T = (h - ep(y) + ql Lv0) / (Cd + qt Cdv + ql Cvl)
  b = (rho_bar - p_bar/(R_mix T)) / rho_bar        (EQNS_BOD_EXPLICIT)

Saturation adjustment solves ql >= 0 with qv <= qsat(T, p) by masked Newton
iterations with a fixed count (a data-dependent stop would make the host
wait on the card every substep), the equivalent of THERMO_AIRWATER_PH
(thermo_airwater.f90:25-33).

Precision: the saturation-pressure polynomial in powers of T and the
Newton polynomial built on it cancel catastrophically in float32 (terms of
~1e3 summing to ~3e-2: T off by 3e-3, the buoyancy by 90%; NewtonRs reads
2e-3).  So psat, dpsat, the saturation adjustment and the explicit
buoyancy evaluate in float64 whatever the run's dtype, as the reference's
Fortran does, and as tlab_tpu does with x64 on (its float64 NumPy
constants promote), and return the caller's dtype.  In a float64 run this
changes nothing.

psat_coeffs and ThermoParams' constants are host NumPy/float, copied from
tlab_tpu; the field functions take torch tensors on any device.  The
background profiles (bg) may be tensors or host arrays: they are moved to
the field's dtype and device where they are used.

The compressible half (the AirWater inversions from (rho, p), (rho, e) and
(p, h), the thermal and caloric equations of state, the compressible units
and the compressible hydrostatic background) keeps the same rule: the
saturation Newton and psat run in float64 and return the caller's dtype.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from tlab_tpu_torch.utils import trace as _trace

# Reference property data (Iribarne & Godson 1981, thermodynamics.f90:
# 270-283, 420-422): molar masses in kg/kmol, heat capacities in J/kg/K,
# latent heat of vaporization at 273.15 K in J/kg
RGAS = 8314.0
WGHT_V = 18.015                    # water vapor
WGHT_D = 28.9644                   # dry air
LV_273 = 2501600.0

# Flatau et al. (1992) saturation-pressure polynomial, powers of
# (T - 273.15), Pa (thermodynamics.f90:459-470)
FLATAU = (0.611213476e+3, 0.444007856e+2, 0.143064234e+1,
          0.264461437e-1, 0.305930558e-3, 0.196237241e-5,
          0.892344772e-8, -0.373208410e-10, 0.209339997e-13)


@functools.lru_cache(maxsize=8)
def psat_coeffs(T_ref: float = 298.0, p_ref: float = 1.0e5):
    """Nondimensional THERMO_PSAT(9): the Flatau fit re-expanded from
    powers of (T-273.15) to powers of T (thermodynamics.f90:473-489),
    then scaled by p_ref with T in T_ref units (:539-542).
    p_sat(T) = sum_i a_i T^{i-1}."""
    n = len(FLATAU)
    t0 = 273.15
    a = np.zeros(n)
    for ipsat in range(1, n + 1):
        for i in range(ipsat, n + 1):
            tmp1 = 1.0
            for j in range(i - 1, i - ipsat, -1):
                tmp1 *= float(j)
            a[ipsat - 1] += FLATAU[i - 1] * t0 ** (i - 1) * tmp1 \
                * (-1.0) ** (i - ipsat)
        tmp2 = 1.0
        for j in range(ipsat - 1, 0, -1):
            tmp2 *= float(j)
        a[ipsat - 1] /= tmp2 * t0 ** (ipsat - 1)
    # nondimensionalization: p by p_ref, T by T_ref
    a /= p_ref
    for ipsat in range(n):
        a[ipsat] *= T_ref ** ipsat
    return tuple(a)


def _wide(x):
    """x in float64 (the precision of the moist thermodynamics)."""
    return x.to(torch.float64)


def psat_polynomial(coeffs, T):
    """Horner evaluation of p_sat(T) (reference Thermo_Psat_Polynomial),
    in float64."""
    T64 = _wide(T)
    p = torch.zeros_like(T64) + coeffs[-1]
    for c in coeffs[-2::-1]:
        p = p * T64 + c
    return p.to(T.dtype)


def dpsat_polynomial(coeffs, T):
    """dp_sat/dT (reference Thermo_dPsat_Polynomial), in float64."""
    T64 = _wide(T)
    n = len(coeffs)
    d = torch.zeros_like(T64) + coeffs[-1] * (n - 1)
    for i in range(n - 2, 0, -1):
        d = d * T64 + coeffs[i] * i
    return d.to(T.dtype)


@dataclasses.dataclass(frozen=True)
class ThermoParams:
    mixture: str = "airwater"      # air | airvapor | airwater | airwaterlinear
    gamma: float = 1.4
    rd_ov_rv: float = WGHT_V / WGHT_D   # Rd/Rv (molar-mass ratio water/air)
    T_ref: float = 298.0           # K
    p_ref: float = 1.0e5           # Pa
    L_ref: float = 100.0           # m, height scale
    scale_height_inv: float = 0.0  # g L_ref / (Cp_d T_ref); 0 => Boussinesq-like
    # dimensional property table (reference values, thermodynamics.f90)
    Cpd_dim: float = 1007.0        # J/kg/K
    Cpv_dim: float = 1870.0
    Cl_dim: float = 4217.6
    Lv0_dim: float = LV_273        # J/kg at 273.15 K
    Rd_dim: float = RGAS / WGHT_D
    psat_mode: str = "polynomial"  # polynomial (reference Flatau) | bolton
    dsmooth: float = 0.0           # saturation-adjustment smoothing factor
    cratio_inv: float = 1.0        # (gama0-1) M^2 (compressible); 1 else
    # Compressible nondimensionalization (thermodynamics.f90:543-549):
    # pressure scaled by the dynamic rho0 U0^2 instead of p0, so the gas
    # constants and the psat table are multiplied by
    # RRATIO = p0/(rho0 U0^2) = 1/(gama0 M^2). 0.0 = anelastic/dimensional
    # convention (fields R in cp units, psat in p_ref units).
    rratio: float = 0.0
    thermo_param: tuple = ()       # [Thermodynamics] Parameters (linear mix)
    # [Thermodynamics] Nondimensional: when False the reference keeps the
    # property tables in SI units (thermodynamics.f90:518-556 skipped,
    # GRATIO = 1): T in K, p in Pa, h in J/kg, psat dimensional, and
    # ScaleHeight = 1/g so scale_height_inv = g
    nondimensional: bool = True

    def __post_init__(self):
        # the fields stay those of tlab_tpu's class; the options below have
        # no ported caller
        if self.psat_mode != "polynomial":
            raise NotImplementedError(
                f"psat_mode={self.psat_mode!r}: only the reference's Flatau "
                "polynomial is ported (no case file selects another)")

    # -- constants (cp-scaled nondimensional, or SI when Nondimensional=no)
    @property
    def _cp_norm(self):
        return self.Cpd_dim if self.nondimensional else 1.0

    @property
    def Cd(self):
        return self.Cpd_dim / self._cp_norm

    @property
    def Cdv(self):
        return (self.Cpv_dim - self.Cpd_dim) / self._cp_norm

    @property
    def Cvl(self):
        return (self.Cl_dim - self.Cpv_dim) / self._cp_norm

    @property
    def Cl(self):
        return self.Cl_dim / self._cp_norm

    @property
    def Rd(self):
        if self.rratio:
            # compressible units: Rd/Rref = 1, scaled by RRATIO
            # (thermodynamics.f90:548 THERMO_R *= RRATIO)
            return self.rratio
        return self.Rd_dim / self._cp_norm

    @property
    def gratio(self):
        """GRATIO (thermodynamics.f90:517,554): R0/Cp0 in the
        nondimensional anelastic formulation, 1 in the dimensional one."""
        return self.Rd_dim / self.Cpd_dim if self.nondimensional else 1.0

    @property
    def R_norm(self):
        """Gas-constant normalization: reference THERMO_R is divided by
        RREF = Rd only in the nondimensional formulation
        (thermodynamics.f90:519)."""
        return self.Rd if self.nondimensional else 1.0

    @property
    def Rv(self):
        return self.Rd / self.rd_ov_rv

    @property
    def Rdv(self):
        return self.Rv - self.Rd

    @property
    def Cdl(self):
        return (self.Cl_dim - self.Cpd_dim) / self._cp_norm

    @property
    def Lv0(self):
        # latent heat at T = 0 (linear Kirchhoff extrapolation), scaled;
        # equals the reference's -THERMO_AI(6,1,3) (thermodynamics.f90:580)
        L0 = self.Lv0_dim + (self.Cl_dim - self.Cpv_dim) * 273.15
        if not self.nondimensional:
            return L0
        return L0 / (self.Cpd_dim * self.T_ref)

    @property
    def psat_cf(self):
        """THERMO_PSAT in the active units (dimensional Pa/K when
        Nondimensional=no, thermodynamics.f90:537-542 skipped)."""
        if not self.nondimensional:
            return psat_coeffs(1.0, 1.0)
        cf = psat_coeffs(self.T_ref, self.p_ref)
        if self.rratio:
            # compressible: psat in rho0 U0^2 units
            # (thermodynamics.f90:547 THERMO_PSAT *= RRATIO)
            cf = tuple(c * self.rratio for c in cf)
        return cf

    # formation-enthalpy differences (airwater family: Lv = Ld = Ldv = 0,
    # Lvl = Ldl = -Lv0, thermodynamics.f90:580-585)
    @property
    def Lv(self):
        return 0.0

    @property
    def Ld(self):
        return 0.0

    @property
    def Ldv(self):
        return 0.0

    @property
    def Lvl(self):
        return -self.Lv0

    @property
    def Ldl(self):
        return -self.Lv0

    def psat(self, T):
        """Saturation pressure, nondimensional (T in T_ref units, p in
        p_ref): the reference's Flatau et al. (1992) polynomial
        (thermodynamics.f90:459-489)."""
        return psat_polynomial(self.psat_cf, T)

    def dpsat(self, T):
        """dp_sat/dT, consistent with psat()."""
        return dpsat_polynomial(self.psat_cf, T)

    def qsat(self, T, p):
        """Saturation specific humidity over total moist air."""
        ps = self.psat(T)
        r = self.rd_ov_rv * ps / torch.clamp(p - ps, min=1e-10)
        return r / (1.0 + r)


def _col(a, like):
    """A (ny,) background profile as a (1, ny, 1) tensor of `like`'s dtype
    and device."""
    return torch.as_tensor(a).to(like.device, like.dtype)[None, :, None]


def _h_qt(s):
    """(h, qt) of the state scalars, in float64."""
    h = _wide(s[0])
    return h, (_wide(s[1]) if s.shape[0] > 1 else torch.zeros_like(h))


# ---------------------------------------------------------------------------
# Equilibrium (saturation adjustment)
# ---------------------------------------------------------------------------

def temperature_unsaturated(tp: ThermoParams, h, qt, ep):
    return (h - ep) / (tp.Cd + qt * tp.Cdv)


@_trace.span("physics.thermo")
def equilibrium_newton_error(tp: ThermoParams, s, bg: dict):
    """The reference's NEWTONRAPHSON_ERROR for the dns.out NewtonRs
    column (thermo_anelastic.f90:176, dns_main.f90:483-493): the final
    Newton step ratio |F/F'|/T of the saturation adjustment, maxed over
    the SATURATED points (unsaturated points never enter the Newton).
    A 0-d tensor of s's dtype and device."""
    h, qt = _h_qt(s)
    _, _, err = equilibrium_T_ql(tp, h, qt, _col(bg["p"], h),
                                 _col(bg["ep"], h), with_err=True)
    return err.to(s.dtype)


def _newton_psat_poly(coeffs_mod, T, nr=3):
    """Newton iterations on sum_i b_i T^{i-1} = 0 with per-point
    coefficient tensors (the reference's B_LOC pattern)."""
    err = None
    for _ in range(nr):
        F = coeffs_mod[-1]
        D = torch.zeros_like(T)
        for i in range(len(coeffs_mod) - 2, -1, -1):
            F = F * T + coeffs_mod[i]
            D = D * T + coeffs_mod[i + 1] * (i + 1)
        step = F / D
        T = T - step
        err = torch.abs(step) / torch.abs(T)
    return T, err


def equilibrium_T_ql(tp: ThermoParams, h, qt, p, ep, n_newton: int = 8,
                     with_err: bool = False):
    """(T, ql) from (h, qt) at pressure p: airwater saturation adjustment,
    the reference's Thermo_Anelastic_PH (thermo_anelastic.f90:75-200)
    vectorized as a masked Newton with the exact polynomial formulation:
    multiplying h = cp(qt,ql(T)) T - ql(T) Lv0 through by (p - psat(T))
    gives a polynomial in T whose coefficients combine THERMO_PSAT with
    (alpha, beta); the equilibrium vapor uses the exact per-total-mass
    convention q_v = eps psat/(p - psat) (1 - qt).

    Evaluated in float64; T, ql (and the error) come back in h's dtype.
    """
    dtype = h.dtype
    h, qt, p, ep = (_wide(torch.as_tensor(a, device=h.device))
                    for a in (h, qt, p, ep))
    out = _equilibrium_T_ql(tp, h, qt, p, ep, n_newton, with_err)
    return tuple(a.to(dtype) for a in out)


def _equilibrium_T_ql(tp: ThermoParams, h, qt, p, ep, n_newton, with_err):
    if tp.mixture in ("air", "airvapor"):
        T = temperature_unsaturated(tp, h, qt * (tp.mixture == "airvapor"),
                                    ep)
        if with_err:
            return T, torch.zeros_like(T), torch.zeros((), dtype=T.dtype,
                                                       device=T.device)
        return T, torch.zeros_like(T)

    H = h - ep
    T0 = H / (tp.Cd + qt * tp.Cdv)
    eps = tp.rd_ov_rv
    ps0 = tp.psat(T0)
    # a Python number over a tensor is its reciprocal times the number in
    # torch: a 0-d tensor numerator divides as NumPy (and tlab_tpu) does
    eps_t = H.new_tensor(eps)
    r0 = eps_t / (p / ps0 - 1.0)
    qsat0 = r0 / (1.0 + r0)
    saturated = qsat0 < qt

    # reference B_LOC polynomial (thermo_anelastic.f90:156-177)
    cf = tp.psat_cf
    alpha = (eps * tp.Lv0 + qt * tp.Lv0 * (1.0 - eps) + H) / p
    beta = (eps * tp.Cvl + tp.Cd + qt * (tp.Cdl - eps * tp.Cvl)) / p
    b = [None] * 10
    b[0] = H + qt * tp.Lv0 - cf[0] * alpha
    for i in range(1, 9):
        b[i] = cf[i - 1] * beta - cf[i] * alpha
    b[1] = b[1] - tp.Cd - qt * tp.Cdl
    b[9] = cf[8] * beta
    T_sat, nerr = _newton_psat_poly(b, T0, nr=max(n_newton, 5))
    ps = tp.psat(T_sat)
    ql_sat = qt - eps_t / (p / ps - 1.0) * (1.0 - qt)
    T = torch.where(saturated, T_sat, T0)
    ql = torch.where(saturated,
                     torch.minimum(torch.clamp(ql_sat, min=0.0), qt), 0.0)
    if with_err:
        return T, ql, torch.max(torch.where(saturated, nerr, 0.0))
    return T, ql


# ---------------------------------------------------------------------------
# Anelastic background + buoyancy
# ---------------------------------------------------------------------------

def mixture_R(tp: ThermoParams, qt, ql):
    return tp.Rd + qt * tp.Rdv - ql * tp.Rv


def _cumulative_integral(y: np.ndarray, d1y: np.ndarray = None):
    """f -> its integral from y[0] (host float64): the compact cumulative
    integral (FDM_Int1_Solve BCS_MIN: the dense D1 matrix d1y with its
    first row replaced by the condition F(y0) = 0), or the trapezoid rule
    without d1y."""
    if d1y is not None:
        D = np.array(d1y, dtype=np.float64)
        D[0, :] = 0.0
        D[0, 0] = 1.0

        def cumint(f):
            rhs = np.array(f, dtype=np.float64)
            rhs[0] = 0.0
            return np.linalg.solve(D, rhs)
    else:
        dy_ = np.diff(y)

        def cumint(f):
            out = np.zeros_like(f)
            out[1:] = np.cumsum(0.5 * (f[1:] + f[:-1]) * dy_)
            return out
    return cumint


def hydrostatic_background(tp: ThermoParams, y: np.ndarray,
                           h_prof: np.ndarray, qt_prof: np.ndarray,
                           p_ref: float = 1.0, y_ref: float = None,
                           d1y: np.ndarray = None, niter: int = 10):
    """Hydrostatic anelastic background, the reference
    Gravity_Hydrostatic_Enthalpy (gravity.f90:121-227):

    - ep = (y - yref) * GRATIO * scaleheightinv. GRATIO = R0/Cp0
      (thermodynamics.f90:554) converts the R-based scale height
      ([Thermodynamics] ScaleHeight = Rd T0/(g L)) to the cp-normalized
      enthalpy units of the scalar; in our Cd=1 convention GRATIO = tp.Rd.
    - fixed-point iteration (niter=10): T from equilibrium at the current
      p, then integrate d ln p/dy = -scaleheightinv/(R_hat T) with
      R_hat = R_mix/Rd (reference-normalized gas constant, =1 for dry
      air) by the compact cumulative integral (FDM_Int1_Solve BCS_MIN;
      d1y: dense D1 matrix; trapezoid fallback), then normalize so
      p(yref) = pref by linear interpolation (gravity.f90:187-195).
    - rho = p/(R_hat T), the reference Thermo_Anelastic_DENSITY
      normalization (rho0 = p0/(Rd T0)).

    Host work in float64 whatever the run's dtype: the equilibrium runs as
    float64 tensors on the CPU.  Returns dict of (ny,) float64 NumPy
    profiles: p, T, rho, ql, ep, rho_inv.
    """
    g_nd = tp.scale_height_inv
    ny = y.shape[0]
    if y_ref is None:
        y_ref = float(y[0])
    ep = tp.gratio * g_nd * (y - y_ref)

    cumint = _cumulative_integral(y, d1y)

    def t64(a):
        return torch.as_tensor(np.asarray(a, np.float64))

    h64 = np.asarray(h_prof, np.float64)
    qt64 = np.asarray(qt_prof, np.float64)
    p = np.full(ny, p_ref, dtype=np.float64)
    T = np.zeros(ny)
    ql = np.zeros(ny)
    for _ in range(max(niter, 1)):
        Tj, qlj = equilibrium_T_ql(tp, t64(h64), t64(qt64), t64(p), t64(ep))
        T = Tj.numpy()
        ql = qlj.numpy()
        R_hat = mixture_R(tp, qt64, ql) / tp.R_norm
        lnp = cumint(-g_nd / (R_hat * T))
        p = np.exp(lnp)
        p *= p_ref / np.interp(y_ref, y, p)
    R_hat = mixture_R(tp, qt64, ql) / tp.R_norm
    rho = p / (R_hat * T)
    return {"p": p, "T": T, "rho": rho, "ql": ql, "ep": ep,
            "rho_inv": 1.0 / rho}


@_trace.span("physics.thermo")
def buoyancy_explicit(tp: ThermoParams, s, bg: dict):
    """b = (rho_bar - p_bar/(R_hat T))/rho_bar from state scalars, with
    R_hat = R_mix/Rd the reference-normalized gas constant (reference
    Thermo_Anelastic_BUOYANCY, thermo_anelastic.f90:312-374): the
    difference of two O(1) densities, taken in float64 and returned in
    s's dtype."""
    h, qt = _h_qt(s)
    p = _col(bg["p"], h)
    rho = _col(bg["rho"], h)
    T, ql = equilibrium_T_ql(tp, h, qt, p, _col(bg["ep"], h))
    R_hat = mixture_R(tp, qt, ql) / tp.R_norm
    return ((rho - p / (R_hat * T)) / rho).to(s.dtype)


@_trace.span("physics.thermo")
def equilibrium_state(tp: ThermoParams, s, bg: dict):
    """(T, ql) of the state scalars s on the background bg, in s's
    dtype."""
    h, qt = _h_qt(s)
    T, ql = equilibrium_T_ql(tp, h, qt, _col(bg["p"], h), _col(bg["ep"], h))
    return T.to(s.dtype), ql.to(s.dtype)


def diagnostic_fields(tp: ThermoParams, s, bg: dict):
    """T, ql, relative buoyancy for statistics/visuals."""
    T, ql = equilibrium_state(tp, s, bg)
    return {"T": T, "ql": ql, "b": buoyancy_explicit(tp, s, bg)}


# ---------------------------------------------------------------------------
# Airwater equilibrium at given (p, T) (reference thermo_airwater.f90:39-68)
# ---------------------------------------------------------------------------

def airwater_pt(tp: ThermoParams, qt, p, T):
    """ql from (p, T, qt) (THERMO_AIRWATER_PT, thermo_airwater.f90:39-68):
    qsat as vapor content 1/(p/psat - 1) rd_ov_rv (1 - qt); optional
    dsmooth softplus smoothing of the phase transition."""
    ps = tp.psat(T)
    qvsat = 1.0 / (p / ps - 1.0) * tp.rd_ov_rv * (1.0 - qt)
    ql = torch.where(qvsat >= qt, 0.0, qt - qvsat)
    if tp.dsmooth > 0.0:
        qs_r = qvsat / (1.0 - qt)
        dqldqt = 1.0 + qs_r
        qs_true = qs_r / (1.0 + qs_r)
        dsl = tp.dsmooth * qs_true
        x = (qt - qs_true) / dsl
        ql = dsl * dqldqt * torch.logaddexp(x, torch.zeros_like(x))
    return ql


# ---------------------------------------------------------------------------
# The compressible AirWater thermodynamics (reference thermo_airwater.f90,
# thermo_thermal.f90, thermo_caloric.f90 with MIXT_TYPE_AIRWATER): T and ql
# from the conservative state, in the compressible units of
# compressible_airwater_params.  The Newton polynomials run in float64.
# ---------------------------------------------------------------------------

def _wide_all(*arrays):
    """The arrays as float64 tensors on the first tensor's device, and the
    dtype of the first tensor among them (float64 if there is none)."""
    like = next((a for a in arrays if isinstance(a, torch.Tensor)), None)
    dev = like.device if like is not None else None
    dtype = like.dtype if like is not None else torch.float64
    return tuple(torch.as_tensor(a, dtype=torch.float64, device=dev)
                 for a in arrays), dtype


def airwater_rp(tp: ThermoParams, qt, p, rho, nr: int = 3):
    """(T, ql, err) from (rho, p, qt) via the thermal EOS
    (THERMO_AIRWATER_RP, thermo_airwater.f90:74-209, dsmooth=0 branch).

    Unsaturated: T = p/(rho R(qt, 0)); saturated points re-solve
    psat(T) = p - (1-qt) rho Rd T (Newton on the polynomial).  Evaluated in
    float64; returned in the dtype of the first tensor argument."""
    (qt, p, rho), dtype = _wide_all(qt, p, rho)
    cf = tp.psat_cf
    Rd, Rv, Rdv = tp.Rd, tp.Rv, tp.Rdv
    T0 = p / (rho * (Rd + qt * Rdv))
    qsat0 = psat_polynomial(cf, T0) / (rho * T0 * Rv)
    saturated = qsat0 <= qt
    # saturated branch: polynomial root with modified b1, b2
    b = [torch.full_like(T0, c) for c in cf]
    b[0] = b[0] - p
    b[1] = b[1] + (1.0 - qt) * rho * Rd
    T_sat, err = _newton_psat_poly(b, T0, nr=nr)
    qsat_sat = psat_polynomial(cf, T_sat) / (rho * T_sat * Rv)
    T = torch.where(saturated, T_sat, T0)
    ql = torch.where(saturated, qt - qsat_sat, 0.0)
    return T.to(dtype), ql.to(dtype), err.to(dtype)


def _airwater_re64(tp: ThermoParams, qt, e, rho, nr: int):
    """airwater_re on float64 tensors."""
    cf = tp.psat_cf
    ci = tp.cratio_inv
    Cd, Cdv, Cvl, Cdl = tp.Cd, tp.Cdv, tp.Cvl, tp.Cdl
    Rd, Rv, Rdv = tp.Rd, tp.Rv, tp.Rdv
    Ld, Ldv, Lvl, Ldl = tp.Ld, tp.Ldv, tp.Lvl, tp.Ldl

    cpm = Cd + qt * Cdv
    rm = Rd + qt * Rdv
    T0 = (e - (Ld + qt * Ldv)) / (cpm - rm * ci)
    qsat0 = psat_polynomial(cf, T0) / (rho * T0 * Rv)
    saturated = qsat0 < qt

    # saturated: B = psat*Lvl (+ shifted HEAT_CAPACITY_LV) + rho Rv terms
    hc_lv = Cvl + ci * Rv
    hc_ld = Cdl + ci * Rd
    n = len(cf)
    b = [torch.full_like(T0, c * Lvl) for c in cf] + [torch.zeros_like(T0)]
    for i in range(1, n + 1):
        b[i] = b[i] + cf[i - 1] * hc_lv
    b[1] = b[1] + rho * Rv * (e - qt * Ldl - Ld)
    b[2] = b[2] - rho * Rv * (qt * hc_ld + Cd - ci * Rd)
    T_sat, err = _newton_psat_poly(b, T0, nr=nr)
    qsat_sat = psat_polynomial(cf, T_sat) / (rho * T_sat * Rv)
    T = torch.where(saturated, T_sat, T0)
    ql = torch.where(saturated, qt - qsat_sat, 0.0)
    # NEWTONRAPHSON_ERROR only tracks points that took the saturated
    # Newton branch (thermo_airwater.f90:266, 300-325)
    err = torch.where(saturated, err, 0.0)
    return T, ql, err


@_trace.span("physics.thermo")
def airwater_re(tp: ThermoParams, qt, e, rho, nr: int = 3):
    """(T, ql, err) from (rho, e, qt) via the caloric EOS
    (THERMO_AIRWATER_RE, thermo_airwater.f90:254-425, dsmooth=0 branch).

    Unsaturated: T = (e - Ld - qt Ldv)/(Cv_mix); saturated points solve
    psat(T) (Lvl + HEAT_CAPACITY_LV T) + rho Rv T [...] = 0.  err is the
    last Newton step over T at the saturated points, 0 elsewhere.
    Evaluated in float64; returned in the dtype of the first tensor
    argument."""
    (qt, e, rho), dtype = _wide_all(qt, e, rho)
    return tuple(a.to(dtype) for a in _airwater_re64(tp, qt, e, rho, nr))


def thermal_density(tp: ThermoParams, qt, ql, p, T):
    """rho = p/(R_mix T) (THERMO_THERMAL_DENSITY)."""
    return p / (mixture_R(tp, qt, ql) * T)


def thermal_pressure(tp: ThermoParams, qt, ql, rho, T):
    """p = rho R_mix T (THERMO_THERMAL_PRESSURE, airwater branch)."""
    return rho * mixture_R(tp, qt, ql) * T


def caloric_enthalpy(tp: ThermoParams, qt, ql, T):
    """h(T, q) = (Cd + qt Cdv + ql Cvl) T + Ld + qt Ldv + ql Lvl
    (THERMO_CALORIC_ENTHALPY airwater branch, thermo_caloric.f90)."""
    return ((tp.Cd + qt * tp.Cdv + ql * tp.Cvl) * T
            + tp.Ld + qt * tp.Ldv + ql * tp.Lvl)


def caloric_energy(tp: ThermoParams, qt, ql, T):
    """e(T, q) = h(T, q) - CRATIO_INV R_mix T (THERMO_CALORIC_ENERGY
    airwater branch): internal energy in the reference's cp T0 units."""
    return (caloric_enthalpy(tp, qt, ql, T)
            - tp.cratio_inv * mixture_R(tp, qt, ql) * T)


def compressible_airwater_params(mach: float, dsmooth: float = 0.0,
                                 **kw) -> ThermoParams:
    """ThermoParams in the reference's compressible-AirWater units
    (thermodynamics.f90:543-549): gama0 = Cpd/(Cpd - Rd) from the
    property tables (overrides any INI HeatCapacityRatio when a mixture
    is selected, :505-507), gas constants and psat scaled by
    RRATIO = 1/(gama0 M^2), CRATIO_INV = (gama0-1) M^2."""
    base = ThermoParams(**kw)
    gama0 = base.Cpd_dim / (base.Cpd_dim - base.Rd_dim)
    return dataclasses.replace(
        base, mixture="airwater", dsmooth=dsmooth,
        rratio=1.0 / (gama0 * mach ** 2),
        cratio_inv=(gama0 - 1.0) * mach ** 2)


def hydrostatic_background_compressible(tp: ThermoParams, y: np.ndarray,
                                        h_prof: np.ndarray,
                                        qt_prof: np.ndarray,
                                        p_ref: float, y_ref: float,
                                        g2: float, d1y: np.ndarray = None,
                                        niter: int = 10):
    """Compressible-branch Gravity_Hydrostatic_Enthalpy
    (gravity.f90:121-227, THERMO_TYPE_COMPRESSIBLE path): iterate
    T, ql = AIRWATER_PH_RE(qt, p, h); integrate d ln p/dy = g2/(R T)
    with the same cumulative-integral operator as the anelastic branch;
    normalize p(yref) = pref. g2 = buoyancy vector y-component / Froude
    (negative for downward gravity).  Host work in float64 (the
    inversions as float64 tensors on the CPU).  Returns (ny,) NumPy
    profiles p, T, rho, ql."""
    ny = y.shape[0]
    cumint = _cumulative_integral(y, d1y)

    def t64(a):
        return torch.as_tensor(np.asarray(a, np.float64))

    h64 = np.asarray(h_prof, np.float64)
    qt64 = np.asarray(qt_prof, np.float64)
    p = np.full(ny, p_ref, dtype=np.float64)
    T = np.ones(ny)
    ql = np.zeros(ny)
    for _ in range(max(niter, 1)):
        Tj, qlj, _ = airwater_ph_re(tp, t64(qt64), t64(p), t64(h64))
        T = Tj.numpy()
        ql = qlj.numpy()
        # r_aux = g2 * (1/(R T)) (THERMO_THERMAL_DENSITY at p=1)
        R = np.asarray(mixture_R(tp, qt64, ql), np.float64)
        lnp = cumint(g2 / (R * T))
        p = np.exp(lnp)
        p *= p_ref / np.interp(y_ref, y, p)
    R = np.asarray(mixture_R(tp, qt64, ql), np.float64)
    rho = p / (R * T)
    return {"p": p, "T": T, "rho": rho, "ql": ql}


def airwater_ph_re(tp: ThermoParams, qt, p, h, niter: int = 5,
                   nr: int = 3):
    """(T, ql, err) from (p, h, qt): iterative (rho, e) method
    (THERMO_AIRWATER_PH_RE, thermo_airwater.f90:213-249).  Evaluated in
    float64 (one vectorised pass over every point); returned in the dtype
    of the first tensor argument."""
    (qt, p, h), dtype = _wide_all(qt, p, h)
    ci = tp.cratio_inv
    ql = torch.zeros_like(h)
    T = (h - tp.Ld - qt * tp.Ldv) / (tp.Cd + qt * tp.Cdv)
    err = None
    for _ in range(niter):
        rho = thermal_density(tp, qt, ql, p, T)
        e = h - ci * p / rho
        T, ql, err = _airwater_re64(tp, qt, e, rho, nr)
    return T.to(dtype), ql.to(dtype), err.to(dtype)


# ---------------------------------------------------------------------------
# Linearized stratocumulus thermodynamics (MIXT_TYPE_AIRWATER_LINEAR,
# reference THERMO_AIRWATER_LINEAR, thermo_airwater.f90:483-516): the
# normalized liquid from the mixing variables chi (s1) and psi (s2).
# ---------------------------------------------------------------------------

def _linear_xi(thermo_param, s):
    """xi = 1 + c1 chi [+ c2 psi] and the smoothing factor
    thermo_param(inb_scal + 1) -- indexed by the PROGNOSTIC scalar count
    even when xi only uses the first two (thermo_airwater.f90:500-506)."""
    xi = 1.0 + thermo_param[0] * s[0]
    if min(s.shape[0], 2) > 1 and len(thermo_param) > 1:
        xi = xi + thermo_param[1] * s[1]
    i_smooth = s.shape[0]
    dsm = thermo_param[i_smooth] if len(thermo_param) > i_smooth else 0.0
    return xi, dsm


def airwater_linear(thermo_param, s):
    """l = max(1 + c1 chi [+ c2 psi], 0), optionally softplus-smoothed by
    c_{n+1} (s: (ns, ...) stacked scalars)."""
    xi, dsm = _linear_xi(thermo_param, s)
    if abs(dsm) < 1e-30:
        return torch.clamp(xi, min=0.0)
    x = xi / dsm
    return dsm * torch.logaddexp(x, torch.zeros_like(x))


def airwater_linear_source(thermo_param, s):
    """(xi, dl/dxi, d2l/dxi2-like smoothing weight) for the linearized
    evaporative source (THERMO_AIRWATER_LINEAR_SOURCE,
    thermo_airwater.f90:520-560)."""
    xi, dsm = _linear_xi(thermo_param, s)
    if abs(dsm) < 1e-30:
        der1 = torch.where(xi <= 0.0, 0.0, torch.ones_like(xi))
        der2 = torch.zeros_like(xi)
    else:
        sig = 1.0 / (1.0 + torch.exp(-xi / dsm))
        der1 = sig
        der2 = sig * (1.0 - sig) / dsm
    return xi, der1, der2
