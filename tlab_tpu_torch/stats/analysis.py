"""Offline analysis modes of averages.x (reference
src/tools/statistics/averages.f90:150-204 ParamAverages options):

 3 momentum-equation budget        10 rate-of-strain eigenvalues
 4 main-variable extrema           12 longitudinal derivatives
 5 enstrophy equation              13 vertical fluxes
 6 strain equation                 15 dissipation
 7 scalar-gradient equation        16 third-order scalar covariances
 8 velocity-gradient invariants    17 potential vorticity
 9 scalar-gradient components

(1 conventional and 2 intermittency live in stats.averages; 18 phase
average in stats.phaseavg; 11 eigenframe alignment and 14 pressure
partition are not implemented yet.)

All profiles are (x,z)-plane averages vs y, computed from one snapshot
with the dense compact operators on the state's device (port of
tlab_tpu/stats/analysis.py).
"""
from __future__ import annotations

import numpy as np
import torch

from tlab_tpu_torch.dycore import incompressible as dyn
from tlab_tpu_torch import mappings
from tlab_tpu_torch.stats.averages import _pavg


def _fluct(a):
    return a - _pavg(a)[None, :, None]


def _grad9(P, u, v, w):
    g = {}
    for cname, comp in (("u", u), ("v", v), ("w", w)):
        for aname, ax in (("x", 0), ("y", 1), ("z", 2)):
            g[cname + aname] = dyn._d1(P, aname, ax, comp)
    return g


def momentum_budget(P, state, visc):
    """Mode 3: mean-momentum budgets: d<u_i>/dt = -d<u_i'v'>/dy
    + nu d2<u_i>/dy2 (temporal mode, homogeneous x,z)."""
    d1y = P["d1y"]
    out = {}
    vf = _fluct(state.v)
    for name, comp in (("U", state.u), ("W", state.w)):
        m = _pavg(comp)
        cf = _fluct(comp)
        turb = -(d1y @ _pavg(cf * vf))
        viscous = visc * (d1y @ (d1y @ m))
        out[f"r{name}"] = m
        out[f"Turb{name}"] = turb
        out[f"Visc{name}"] = viscous
        out[f"Res{name}"] = turb + viscous
    return out


def main_variables(P, state, p=None):
    """Mode 4: plane means / min / max of the main variables."""
    out = {}
    fields = {"U": state.u, "V": state.v, "W": state.w}
    if p is not None:
        fields["P"] = p
    for i in range(state.s.shape[0]):
        fields[f"S{i + 1}"] = state.s[i]
    for name, a in fields.items():
        out[f"r{name}"] = _pavg(a)
        out[f"min{name}"] = torch.amin(a, dim=(0, 2))
        out[f"max{name}"] = torch.amax(a, dim=(0, 2))
    return out


def enstrophy_equation(P, state, visc):
    """Mode 5: W_i W_i / 2 budget (reference FI_VORTICITY family):
    production omega_i s_ij omega_j, mean-flow stretching, dilatation,
    turbulent transport, viscous dissipation estimate."""
    u, v, w = state.u, state.v, state.w
    g = _grad9(P, u, v, w)
    wx = g["wy"] - g["vz"]
    wy = g["uz"] - g["wx"]
    wz = g["vx"] - g["uy"]
    ens = 0.5 * (wx * wx + wy * wy + wz * wz)
    # production omega_i S_ij omega_j
    prod = (wx * wx * g["ux"] + wy * wy * g["vy"] + wz * wz * g["wz"]
            + wx * wy * (g["uy"] + g["vx"])
            + wx * wz * (g["uz"] + g["wx"])
            + wy * wz * (g["vz"] + g["wy"]))
    # viscous destruction: nu grad omega : grad omega
    dest = 0.0
    for om in (wx, wy, wz):
        for aname, ax in (("x", 0), ("y", 1), ("z", 2)):
            d = dyn._d1(P, aname, ax, om)
            dest = dest + d * d
    d1y = P["d1y"]
    vf = _fluct(state.v)
    out = {
        "Ens": _pavg(ens),
        "Prod": _pavg(prod),
        "Diss": visc * _pavg(dest),
        "Trp": -(d1y @ _pavg(vf * ens)),
        "WX2": _pavg(_fluct(wx) ** 2),
        "WY2": _pavg(_fluct(wy) ** 2),
        "WZ2": _pavg(_fluct(wz) ** 2),
    }
    return out


def strain_equation(P, state, visc):
    """Mode 6: s_ij s_ij budget: production -s_ij s_jk s_ki, vortex
    interaction omega_i s_ij omega_j / 4, pressure-strain-gradient term,
    viscous destruction."""
    u, v, w = state.u, state.v, state.w
    g = _grad9(P, u, v, w)
    sxx, syy, szz = g["ux"], g["vy"], g["wz"]
    sxy = 0.5 * (g["uy"] + g["vx"])
    sxz = 0.5 * (g["uz"] + g["wx"])
    syz = 0.5 * (g["vz"] + g["wy"])
    s2 = (sxx ** 2 + syy ** 2 + szz ** 2
          + 2.0 * (sxy ** 2 + sxz ** 2 + syz ** 2))
    # -s_ij s_jk s_ki (strain self-amplification)
    sss = (sxx ** 3 + syy ** 3 + szz ** 3
           + 3.0 * sxx * (sxy ** 2 + sxz ** 2)
           + 3.0 * syy * (sxy ** 2 + syz ** 2)
           + 3.0 * szz * (sxz ** 2 + syz ** 2)
           + 6.0 * sxy * sxz * syz)
    wx = g["wy"] - g["vz"]
    wy = g["uz"] - g["wx"]
    wz = g["vx"] - g["uy"]
    womega = (wx * wx * sxx + wy * wy * syy + wz * wz * szz
              + 2.0 * (wx * wy * sxy + wx * wz * sxz + wy * wz * syz))
    return {
        "S2": _pavg(s2),
        "Prod": -_pavg(sss),
        "VortInt": 0.25 * _pavg(womega),
        "Diss2nuS2": 2.0 * visc * _pavg(s2),
    }


def scalar_gradient_equation(P, state, diff, i=0):
    """Mode 7: G_i G_i / 2 budget for scalar i: production -G_i s_ij G_j,
    molecular destruction."""
    s = state.s[i]
    gx = dyn._d1(P, "x", 0, s)
    gy = dyn._d1(P, "y", 1, s)
    gz = dyn._d1(P, "z", 2, s)
    g = _grad9(P, state.u, state.v, state.w)
    prod = -(gx * gx * g["ux"] + gy * gy * g["vy"] + gz * gz * g["wz"]
             + gx * gy * (g["uy"] + g["vx"])
             + gx * gz * (g["uz"] + g["wx"])
             + gy * gz * (g["vz"] + g["wy"]))
    dest = 0.0
    for gc in (gx, gy, gz):
        for aname, ax in (("x", 0), ("y", 1), ("z", 2)):
            d = dyn._d1(P, aname, ax, gc)
            dest = dest + d * d
    g2 = 0.5 * (gx * gx + gy * gy + gz * gz)
    return {"G2": _pavg(g2), "Prod": _pavg(prod),
            "Diss": diff * _pavg(dest)}


def gradient_invariants(P, state):
    """Mode 8: plane means and variances of the velocity-gradient
    invariants P, Q, R (reference FI_INVARIANT_*)."""
    pi, qi, ri = mappings.invariants(P, state.u, state.v, state.w)
    out = {}
    for name, a in (("P", pi), ("Q", qi), ("R", ri)):
        out[f"r{name}"] = _pavg(a)
        out[f"{name}2"] = _pavg(_fluct(a) ** 2)
    return out


def scalar_gradient_components(P, state, i=0):
    """Mode 9: variances of the scalar-gradient components + alignment
    of G with the vertical."""
    s = state.s[i]
    gx = dyn._d1(P, "x", 0, s)
    gy = dyn._d1(P, "y", 1, s)
    gz = dyn._d1(P, "z", 2, s)
    mag = torch.sqrt(gx * gx + gy * gy + gz * gz)
    eps = torch.finfo(mag.dtype).tiny
    return {"Gx2": _pavg(gx * gx), "Gy2": _pavg(gy * gy),
            "Gz2": _pavg(gz * gz),
            "cosGy": _pavg(gy / torch.clamp(mag, min=eps))}


def _sym_eigenvalues(axx, ayy, azz, axy, axz, ayz):
    """Closed-form eigenvalues of a symmetric 3x3 field (descending),
    Smith's trigonometric method, vectorized."""
    p1 = axy ** 2 + axz ** 2 + ayz ** 2
    q = (axx + ayy + azz) / 3.0
    p2 = (axx - q) ** 2 + (ayy - q) ** 2 + (azz - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-300))
    bxx, byy, bzz = (axx - q) / p, (ayy - q) / p, (azz - q) / p
    bxy, bxz, byz = axy / p, axz / p, ayz / p
    detb = (bxx * (byy * bzz - byz * byz)
            - bxy * (bxy * bzz - byz * bxz)
            + bxz * (bxy * byz - byy * bxz))
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    l1 = q + 2.0 * p * torch.cos(phi)
    l3 = q + 2.0 * p * torch.cos(phi + 2.0 * np.pi / 3.0)
    l2 = 3.0 * q - l1 - l3
    return l1, l2, l3


def strain_eigenvalues(P, state):
    """Mode 10: plane-averaged eigenvalues of the rate-of-strain tensor
    (lambda1 >= lambda2 >= lambda3; lambda2 sign is the classic
    topology marker)."""
    g = _grad9(P, state.u, state.v, state.w)
    l1, l2, l3 = _sym_eigenvalues(
        g["ux"], g["vy"], g["wz"],
        0.5 * (g["uy"] + g["vx"]), 0.5 * (g["uz"] + g["wx"]),
        0.5 * (g["vz"] + g["wy"]))
    return {"Lam1": _pavg(l1), "Lam2": _pavg(l2), "Lam3": _pavg(l3),
            "Lam2Pos": _pavg((l2 > 0).to(l1.dtype))}


def eigenframe_cosine_fields(P, state):
    """Pointwise direction cosines of the vorticity and of the
    scalar-gradient vector in the local strain eigenframe (3-D fields,
    shared by averages.x mode 11 and pdfs.x mode 12).

    Eigenvectors from a vectorized symmetric eigendecomposition with the
    reference's global orientation (TENSOR_EIGENFRAME, tensor.f90:79-80:
    e1 toward +Ox, e2 toward +Oy; e3 = e1 x e2), eigenvalues descending
    (lambda1 >= lambda2 >= lambda3)."""
    g = _grad9(P, state.u, state.v, state.w)
    sxx, syy, szz = g["ux"], g["vy"], g["wz"]
    sxy = 0.5 * (g["uy"] + g["vx"])
    sxz = 0.5 * (g["uz"] + g["wx"])
    syz = 0.5 * (g["vz"] + g["wy"])
    S = torch.stack([torch.stack([sxx, sxy, sxz], -1),
                     torch.stack([sxy, syy, syz], -1),
                     torch.stack([sxz, syz, szz], -1)], -2)   # (...,3,3)
    _, V = torch.linalg.eigh(S)               # ascending eigenvalues
    e1 = V[..., :, 2]                         # lambda1 (largest)
    e2 = V[..., :, 1]
    # reference orientation: e1 . ex > 0, e2 . ey > 0
    e1 = e1 * torch.sign(torch.where(e1[..., 0] == 0, 1.0,
                                     e1[..., 0]))[..., None]
    e2 = e2 * torch.sign(torch.where(e2[..., 1] == 0, 1.0,
                                     e2[..., 1]))[..., None]
    e3 = torch.linalg.cross(e1, e2)

    wx = g["wy"] - g["vz"]
    wy = g["uz"] - g["wx"]
    wz = g["vx"] - g["uy"]
    vort = torch.stack([wx, wy, wz], -1)
    tiny = torch.finfo(vort.dtype).tiny
    vn = vort / torch.clamp(
        torch.linalg.norm(vort, dim=-1, keepdim=True), min=tiny)
    out = {"cosWL1": torch.sum(vn * e1, -1),
           "cosWL2": torch.sum(vn * e2, -1),
           "cosWL3": torch.sum(vn * e3, -1)}
    if state.s.shape[0]:
        s0 = state.s[0]
        gr = torch.stack([dyn._d1(P, "x", 0, s0), dyn._d1(P, "y", 1, s0),
                          dyn._d1(P, "z", 2, s0)], -1)
        gn = gr / torch.clamp(
            torch.linalg.norm(gr, dim=-1, keepdim=True), min=tiny)
        out.update({"cosGL1": torch.sum(gn * e1, -1),
                    "cosGL2": torch.sum(gn * e2, -1),
                    "cosGL3": torch.sum(gn * e3, -1)})
    return out


def eigenframe_cosines(P, state):
    """Mode 11 (reference averages.f90:805-845, avgCos<it>): plane
    averages of the pointwise eigenframe cosines."""
    return {k: _pavg(v) for k, v in
            eigenframe_cosine_fields(P, state).items()}


def pressure_partition(P, state, p=None):
    """Mode 14 (reference averages.f90:907-922, avgP<it>): total
    Boussinesq diagnostic pressure, the static part (velocities zeroed --
    sources only), and their difference (dynamic pressure)."""
    from tlab_tpu_torch.dycore.pressure import pressure_boussinesq
    p_tot = p if p is not None else pressure_boussinesq(P, state)
    zero = torch.zeros_like(state.u)
    st0 = state._replace(u=zero, v=zero, w=zero)
    p_sta = pressure_boussinesq(P, st0)
    return {"P": _pavg(p_tot), "Psta": _pavg(p_sta),
            "Pdyn": _pavg(p_tot - p_sta),
            "P2": _pavg(_fluct(p_tot) ** 2),
            "Pdyn2": _pavg(_fluct(p_tot - p_sta) ** 2)}


def longitudinal_derivatives(P, state):
    """Mode 12: skewness/flatness of the longitudinal derivatives
    du/dx, dv/dy, dw/dz (isotropy diagnostics)."""
    out = {}
    eps = None
    for name, comp, aname, ax in (("Ux", state.u, "x", 0),
                                  ("Vy", state.v, "y", 1),
                                  ("Wz", state.w, "z", 2)):
        d = _fluct(dyn._d1(P, aname, ax, comp))
        var = _pavg(d * d)
        if eps is None:
            eps = torch.finfo(var.dtype).tiny
        out[f"S{name}"] = _pavg(d ** 3) / torch.clamp(var ** 1.5, min=eps)
        out[f"F{name}"] = _pavg(d ** 4) / torch.clamp(var ** 2, min=eps)
        out[f"{name}2"] = var
    return out


def vertical_fluxes(P, state, visc, diff=()):
    """Mode 13: vertical turbulent + molecular fluxes of momentum and
    scalars: total_u = nu dU/dy - <u'v'>."""
    d1y = P["d1y"]
    vf = _fluct(state.v)
    out = {}
    for name, comp in (("U", state.u), ("W", state.w)):
        m = _pavg(comp)
        turb = _pavg(_fluct(comp) * vf)
        mol = visc * (d1y @ m)
        out[f"Rv{name.lower()}"] = turb
        out[f"Mol{name}"] = mol
        out[f"Tot{name}"] = mol - turb
    for i in range(state.s.shape[0]):
        D = diff[i] if i < len(diff) else visc
        m = _pavg(state.s[i])
        turb = _pavg(_fluct(state.s[i]) * vf)
        mol = D * (d1y @ m)
        out[f"Rvs{i + 1}"] = turb
        out[f"MolS{i + 1}"] = mol
        out[f"TotS{i + 1}"] = mol - turb
    return out


def dissipation_profiles(P, state, visc):
    """Mode 15: dissipation profile and its components
    eps_ij = 2 nu <s_ij' s_ij'> variant."""
    g = _grad9(P, state.u, state.v, state.w)
    out = {}
    tot = 0.0
    for k, gv in g.items():
        f = _fluct(gv)
        c = _pavg(f * f)
        out[f"E{k}"] = visc * c
        tot = tot + c
    out["Eps"] = visc * tot
    return out


def third_order_scalar(P, state, i=0):
    """Mode 16: third-order scalar covariances <u_j' s'^2>, <u_j'^2 s'>."""
    sf = _fluct(state.s[i])
    out = {}
    for name, comp in (("u", state.u), ("v", state.v), ("w", state.w)):
        cf = _fluct(comp)
        out[f"R{name}ss"] = _pavg(cf * sf * sf)
        out[f"R{name}{name}s"] = _pavg(cf * cf * sf)
    out["Rsss"] = _pavg(sf ** 3)
    return out


def potential_vorticity(P, state, i=0):
    """Mode 17: PV = omega . grad(b) with scalar i as buoyancy proxy
    (reference FI_PV): plane mean and variance."""
    u, v, w = state.u, state.v, state.w
    g = _grad9(P, u, v, w)
    wx = g["wy"] - g["vz"]
    wy = g["uz"] - g["wx"]
    wz = g["vx"] - g["uy"]
    s = state.s[i]
    pv = (wx * dyn._d1(P, "x", 0, s) + wy * dyn._d1(P, "y", 1, s)
          + wz * dyn._d1(P, "z", 2, s))
    return {"rPV": _pavg(pv), "PV2": _pavg(_fluct(pv) ** 2)}


MODES = {
    3: ("momentum", lambda P, st, visc, diff, p:
        momentum_budget(P, st, visc)),
    4: ("mainvars", lambda P, st, visc, diff, p:
        main_variables(P, st, p=p)),
    5: ("enstrophy", lambda P, st, visc, diff, p:
        enstrophy_equation(P, st, visc)),
    6: ("strain", lambda P, st, visc, diff, p:
        strain_equation(P, st, visc)),
    7: ("scalgrad", lambda P, st, visc, diff, p:
        scalar_gradient_equation(P, st, diff[0] if diff else visc)),
    8: ("invariants", lambda P, st, visc, diff, p:
        gradient_invariants(P, st)),
    9: ("gradcomp", lambda P, st, visc, diff, p:
        scalar_gradient_components(P, st)),
    10: ("eigenvalues", lambda P, st, visc, diff, p:
         strain_eigenvalues(P, st)),
    11: ("eigenframe", lambda P, st, visc, diff, p:
         eigenframe_cosines(P, st)),
    12: ("longderiv", lambda P, st, visc, diff, p:
         longitudinal_derivatives(P, st)),
    13: ("fluxes", lambda P, st, visc, diff, p:
         vertical_fluxes(P, st, visc, diff)),
    14: ("pressurepart", lambda P, st, visc, diff, p:
         pressure_partition(P, st, p=p)),
    15: ("dissipation", lambda P, st, visc, diff, p:
         dissipation_profiles(P, st, visc)),
    16: ("scalcov3", lambda P, st, visc, diff, p:
         third_order_scalar(P, st)),
    17: ("pv", lambda P, st, visc, diff, p:
         potential_vorticity(P, st)),
}


def run_mode(P, state, visc, mode: int, diff=(), p=None) -> dict:
    """Dispatch a ParamAverages analysis mode; scalar-dependent modes
    require state.s non-empty."""
    if mode not in MODES:
        raise ValueError(
            f"ParamAverages mode {mode} not implemented "
            f"(available: {sorted(MODES)}; 1/2 via stats.averages, "
            "18 via stats.phaseavg)")
    if mode in (7, 9, 16, 17) and state.s.shape[0] == 0:
        raise ValueError(f"analysis mode {mode} needs a scalar field")
    name, fn = MODES[mode]
    return fn(P, state, visc, tuple(diff), p)
