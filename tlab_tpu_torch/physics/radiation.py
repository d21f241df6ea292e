"""Infrared radiation: 1-D two-stream RTE along y
(reference src/physics/radiation.f90), port of tlab_tpu/physics/radiation.py.

Three formulations, matching the reference's types:

- grayliquid (IR_RTE1_OnlyLiquid, radiation.f90:401-444): absorption-only,
  a = kappa rho_bar q_l; no mean-direction factor, no emission.
- gray (IR_RTE1_Incremental/Global, radiation.f90:448-712): emission
  b = sigma T^4, absorption a = rho_bar (kappa_l ql + kappa_v qv + kappa_g)
  divided by the mean direction mu = (1/sqrt(3)+1/sqrt(2))/2
  (radiation.f90:204), incremental level-to-level flux recurrences.
- band (TYPE_IR_BAND, radiation.f90:322-372): per-band absorption tables
  kappa(comp, band) and quadratic-in-T emission fractions beta(:, band),
  per-band top fluxes; band sources add.

The level recurrences F(j) = T(j) F(j+1) + 0.5 dy (ab_j + T(j) ab_{j+1})
are two loops over j on (nx, nz) planes, in tlab_tpu's order, written
WITHOUT any exp(+tau) factor so optically thick layers cannot overflow in
f32 (the reference's f64 form divides by the transmission, radiation.f90:
493-496, algebraically identical).

The band tables and the integration matrices are host NumPy, copied from
tlab_tpu; the sources take torch tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tlab_tpu_torch.ops.derivative import apply_along
from tlab_tpu_torch.ops.elliptic_factorize import build_int1_pencil

# mean direction of the two-stream closure, in (1/sqrt(3), 1/sqrt(2))
# (reference radiation.f90:204)
MU_REFERENCE = 0.5 * (1.0 / np.sqrt(3.0) + 1.0 / np.sqrt(2.0))

# Stefan-Boltzmann constant, W/m^2/K^4 (radiation.f90:57); the gray/band
# emission b = sigma T^4 is dimensional in the reference (those types are
# only exercised with [Thermodynamics] Nondimensional=no)
SIGMA = 5.67037442e-8

# default Jeevanjee (2023) emission-fraction polynomials for the first two
# vapor bands (reference radiation.f90:142-143); the last band is derived
# from sum_b beta_b(T) = 1
BETA_DEFAULT_BAND1 = (2.6774e-1, -1.3344e-3, 1.8017e-6)
BETA_DEFAULT_BAND2 = (-2.2993e-2, 8.7439e-5, 1.4744e-7)


@dataclasses.dataclass(frozen=True)
class RadiationProps:
    type: str = "none"            # none | grayliquid | gray | band
    scalar: int = 0               # index of the heated scalar (h)
    ql_scalar: int = -1           # index of liquid-water scalar; -1 => diagnostic
    kappa: float = 1.0            # liquid mass absorption coefficient (nondim)
    kappa_v: float = 0.0          # vapor absorption (gray variant)
    kappa_g: float = 0.0          # background-gas absorption (gray variant)
    beta: float = 1.0             # emission scale (sigma T_ref^4 nondim)
    emissivity: float = 1.0       # surface emissivity at ymin
    flux_top: float = 1.0         # downward flux at ymax
    flux_bottom: float = 0.0      # upward flux at ymin (grayliquid only)
    mu: float = MU_REFERENCE      # mean direction (gray/band; 1 to disable)
    # band variant (reference-layout tables)
    nbands: int = 1
    kappa_table: tuple = ()       # (ncomps, nbands) rows = (liquid,vapor,const)
    beta_table: tuple = ()        # (nbands, 3) per-band polynomial coeffs
    bcs_top: tuple = ()           # (nbands,) downward fluxes at ymax


def derive_band_tables(bcs_list, absorption_components, beta_rows):
    """Reference [Infrared] parsing layout (radiation.f90:117-163):

    - bcs_list: the BoundaryConditions values; the LAST is the surface
      emissivity, the first nbands are per-band downward top fluxes.
    - absorption_components: list over components c=1.. of per-band kappa
      lists (AbsorptionComponent<c>), each of length nbands.
    - beta_rows: list over coefficient index ic=1..3 of per-band values
      (BetaCoefficient<ic>), each of length nbands-1 (the last band is
      derived from sum_b beta_b = 1); empty -> Jeevanjee defaults.

    Returns (nbands, epsilon, bcs_top, kappa_table, beta_table)."""
    bcs = tuple(float(v) for v in bcs_list) if bcs_list else (1.0, 1.0)
    nbands = max(len(bcs) - 1, 1)
    epsilon = bcs[-1]
    bcs_top = bcs[:nbands]

    kappa_table = tuple(tuple(float(v) for v in comp[:nbands])
                        + (0.0,) * (nbands - len(comp))
                        for comp in absorption_components)

    # coefficient-major beta input -> per-band rows
    beta = np.zeros((3, max(nbands, 2)))
    beta[:, 0] = BETA_DEFAULT_BAND1
    if max(nbands, 2) > 1:
        beta[:, 1] = BETA_DEFAULT_BAND2
    for ic, row in enumerate(beta_rows[:3]):
        if row:
            vals = [float(v) for v in row]
            beta[ic, : len(vals)] = vals
    beta = beta[:, :nbands].copy()
    if nbands > 1:
        beta[:, -1] = np.array([1.0, 0.0, 0.0]) - beta[:, :-1].sum(axis=1)
    else:
        beta[:, 0] = [1.0, 0.0, 0.0]
    beta_table = tuple(tuple(beta[:, b]) for b in range(nbands))
    return nbands, epsilon, bcs_top, kappa_table, beta_table


def cumulative_matrices(y: np.ndarray):
    """(J_from_top, J_from_bottom): lower/upper triangular trapezoid
    integration matrices; (J_top @ a)[j] = int_{y_j}^{y_top} a dy."""
    ny = y.shape[0]
    dy = np.diff(y)
    Jb = np.zeros((ny, ny))
    for j in range(1, ny):
        Jb[j, :] = Jb[j - 1, :]
        Jb[j, j - 1] += 0.5 * dy[j - 1]
        Jb[j, j] += 0.5 * dy[j - 1]
    total = Jb[-1:, :]
    Jt = total - Jb               # int_y^top = int_bot^top - int_bot^y
    return Jt, Jb


def int1_cumulative_matrices(plan_y):
    """Compact-integral matrices from the reference's FDM_Int1 system
    (fdm_integral.f90; what IR_RTE1_* integrates tau with): (Jt, Jb),
    (Jt f)[j] = int_y^top f, (Jb f)[j] = int_bot^y f, 6th-order."""
    M0, _M1, R = build_int1_pencil(plan_y, "max")
    T = np.linalg.solve(M0, R)
    T[:, -1] = 0.0                     # the bc slot carries u(top) = 0
    Jt = -T                            # solve gives -int_y^top
    M0b, _M1b, Rb = build_int1_pencil(plan_y, "min")
    Tb = np.linalg.solve(M0b, Rb)
    Tb[:, 0] = 0.0
    return Jt, Tb


def infrared_source(props: RadiationProps, Jt, Jb, ql, rho_bar):
    """Heating-rate field from liquid water (ql: (nx, ny, nz)); the
    reference's IR_RTE1_OnlyLiquid (no mean-direction factor,
    radiation.f90:401-432): p_tau = exp(-int_y^top a); the upward flux
    uses the RATIO p_tau(bottom)/p_tau(y) exactly as the reference (one
    integral, not a second one).  Jt: (ny, ny) tensor on ql's device."""
    a = props.kappa * ql * rho_bar[None, :, None]
    ptau = torch.exp(-apply_along(Jt, a, 1))
    if abs(props.flux_bottom) > 0:
        src = a * (ptau * props.flux_top
                   + (ptau[:, :1, :] / ptau) * props.flux_bottom)
    else:
        src = a * (props.flux_top * ptau)
    return src


def infrared_gray_source(props: RadiationProps, y, a, b,
                         emissivity: float = 1.0, return_fluxes=False,
                         flux_top=None):
    """Gray two-stream RTE with emission (reference IR_RTE1_Incremental,
    radiation.f90:448-541): absorption field a(x,y,z) (scaled by 1/mu as
    in the reference), emission function b = sigma T^4 (already scaled);
    downward flux from flux_top at ymax, upward flux from the surface
    (emissivity-mixed reflection); source S = a (F_up + F_down) - 2 a b.

    The level-to-level recurrences run as two loops over j, each step one
    (nx, nz) plane, in the overflow-safe form
    F(j) = tr F(j+1) + 0.5 dy (ab_j + tr ab_{j+1}).
    flux_top may be an (nx, nz) tensor (per-band boundary reuse).
    """
    yv = torch.as_tensor(y).to(a.device, a.dtype)
    dy = yv[1:] - yv[:-1]                            # (ny-1,)
    a = a / torch.as_tensor(props.mu, dtype=a.dtype, device=a.device)
    ab = a * b                                       # absorption * emission
    # incremental optical depth (trapezoid) and transmission factors
    tau_inc = 0.5 * (a[:, 1:, :] + a[:, :-1, :]) * dy[None, :, None]
    half_dy = 0.5 * dy[None, :, None]
    # planes j = 0..ny-2 leading, so that each step of the loops reads and
    # writes contiguous (nx, nz) planes
    trans = torch.exp(-tau_inc).transpose(0, 1).contiguous()   # I_{j-1,j}
    em_lo = (half_dy * ab[:, :-1, :]).transpose(0, 1).contiguous()
    em_hi = (half_dy * ab[:, 1:, :]).transpose(0, 1).contiguous()
    ny = a.shape[1]

    if flux_top is None:
        f_top = torch.full_like(a[:, 0, :], props.flux_top)
    else:
        f_top = torch.broadcast_to(
            torch.as_tensor(flux_top, dtype=a.dtype, device=a.device),
            a[:, 0, :].shape)
    # downward: F(j) = tr(j) F(j+1) + 0.5 dy (ab_j + tr(j) ab_{j+1})
    flux_dn = torch.empty((ny,) + tuple(f_top.shape), dtype=a.dtype,
                          device=a.device)
    flux_dn[-1] = f_top
    # each plane in three operations written into its row of the result
    for j in range(ny - 2, -1, -1):
        torch.add(flux_dn[j + 1], em_hi[j], out=flux_dn[j])
        flux_dn[j].mul_(trans[j]).add_(em_lo[j])

    # bottom boundary: upward flux = eps b_sfc + (1-eps) reflected
    # upward: F(j+1) = tr(j) F(j) + 0.5 dy (tr(j) ab_j + ab_{j+1})
    flux_up = torch.empty_like(flux_dn)
    flux_up[0] = emissivity * b[:, 0, :] + (1.0 - emissivity) * flux_dn[0]
    for j in range(ny - 1):
        torch.add(flux_up[j], em_lo[j], out=flux_up[j + 1])
        flux_up[j + 1].mul_(trans[j]).add_(em_hi[j])
    flux_dn = flux_dn.transpose(0, 1)
    flux_up = flux_up.transpose(0, 1)

    src = a * (flux_up + flux_dn) - 2.0 * ab
    if return_fluxes:
        return src, flux_dn, flux_up
    return src


def infrared_band_source(props: RadiationProps, y, a_bands, T,
                         beta_bands, emissivity: float = 1.0,
                         bcs_top=None):
    """Multi-band RTE (reference TYPE_IR_BAND, radiation.f90:322-372): each
    band carries its own absorption field, its own downward top flux, and a
    quadratic-in-T emission fraction b_band = beta T^4 (b0 + T (b1 + T b2));
    band sources add."""
    src = None
    tops = bcs_top if bcs_top is not None else \
        (props.bcs_top or (props.flux_top,) * len(a_bands))
    for a_b, (b0, b1, b2), f_top in zip(a_bands, beta_bands, tops):
        # sigma T^4 (beta_band(T)) emission (radiation.f90:341)
        emis = props.beta * SIGMA * T ** 4 * (b0 + T * (b1 + T * b2))
        s = infrared_gray_source(props, y, a_b, emis,
                                 emissivity=emissivity, flux_top=f_top)
        src = s if src is None else src + s
    return src
