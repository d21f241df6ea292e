"""Plane-averaged statistics (temporal mode): the AVG_FLOW_XZ / AVG_SCAL_XZ
tables (reference src/statistics/avg_flow_xz.f90, avg_scal_xz.f90).  Port
of the part of tlab_tpu/stats/averages.py that the DNS loop's in-run
statistics reach.

Profiles are horizontal (x,z)-plane averages as functions of y, reduced on
the state's device.  The table layout, group names and column names match
the reference's ASCII `avg<it>` / `avg<it>s<i>` files exactly
(io_averages.f90:95-130 non-NetCDF branch), so reference post-processing
scripts can consume the output.

Incompressible: rR = 1, Favre == Reynolds, and the thermodynamic,
Acoustics and RhoBudget columns are 0, as the reference leaves inactive
groups.  Compressible (the ideal gas; dns.write_statistics_compressible
passes the primitive state and the EOS pressure): the density field makes
the f* columns and the Reynolds stresses Favre (rho-weighted) averages and
fills the variable-density G and D terms, the temperature, energy,
enthalpy and entropy fields fill the thermodynamic columns, and the
Acoustics and RhoBudget groups are filled; a transport law's viscosity
field weights the scalar table's molecular terms.  Anelastic
(Equations=anelastic): the density and temperature of the equilibrium
thermodynamics fill rR, rT, fT, rR2, rT2, fT2 and the
RhoBudget group, the background fills rRref, rTref and rPref, and the
Stratification group is filled (Favre == Reynolds still).  The
equation-set context (`extras`, build_extras) carries the body forces: the
buoyancy field fills rB, the buoyancy production and flux terms (Bxx..,
Buo, Bsv) and Pot, the Coriolis vector the F terms.  As in tlab_tpu,
[Thermodynamics] Type=anelastic with Equations=incompressible fills no
background here, so its explicit buoyancy reads as zero in these tables.
Without a pressure the tables solve the diagnostic Boussinesq pressure
(dycore.pressure, as the reference's offline averages.x); the scalar
sources, a sound-speed profile (c2) and the compressible gravity (grav_y)
are optional extras; the legacy alias keys (SU, FU, .., Prod; Ss, Fs, Chi,
Rss) follow the written columns.  Also here: the NetCDF writer and reader
behind [Main] FileFormat=netcdf, and the conditional (gated) statistics.
"""
from __future__ import annotations

import numpy as np
import torch

from tlab_tpu_torch.dycore import incompressible as dyn
from tlab_tpu_torch.physics import gravity as grav
from tlab_tpu_torch.physics import thermo

# ---------------------------------------------------------------------------
# Table layout (reference avg_flow_xz.f90:102-391, avg_scal_xz.f90:92-236)
# ---------------------------------------------------------------------------

FLOW_GROUPS = [
    ("Mean", "rR rU rV rW rP rT re rh rs rB fU fV fW fT fe fh fs"),
    ("Fluctuations",
     "Tke Rxx Ryy Rzz Rxy Rxz Ryz rP2 rR2 rT2 fT2 re2 fe2 rh2 fh2 rs2 fs2"),
    ("Vorticity", "Wx Wy Wz Wx2 Wy2 Wz2"),
    ("RxxBudget", "Rxx_t Bxx Cxx Pxx Exx PIxx Fxx Txxy_y Txxy Gxx Dxx"),
    ("RyyBudget", "Ryy_t Byy Cyy Pyy Eyy PIyy Fyy Tyyy_y Tyyy Gyy Dyy"),
    ("RzzBudget", "Rzz_t Bzz Czz Pzz Ezz PIzz Fzz Tzzy_y Tzzy Gzz Dzz"),
    ("RxyBudget", "Rxy_t Bxy Cxy Pxy Exy PIxy Fxy Txyy_y Txyy Gxy Dxy"),
    ("RxzBudget", "Rxz_t Bxz Cxz Pxz Exz PIxz Fxz Txzy_y Txzy Gxz Dxz"),
    ("RyzBudget", "Ryz_t Byz Cyz Pyz Eyz PIyz Fyz Tyzy_y Tyzy Gyz Dyz"),
    ("TkeBudget", "Tke_t Buo Con Prd Eps Pi Trp Trp1 Trp2 Trp3 "
                  "Trp1_y Trp2_y Trp3_y G D Phi UgradP"),
    ("HigherOrder", "rU3 rU4 rV3 rV4 rW3 rW4"),
    ("DerivativeFluctuations",
     "U_y1 V_y1 W_y1 U_ii2 "
     "U_x2 U_y2 U_z2 V_x2 V_y2 V_z2 W_x2 W_y2 W_z2 "
     "U_x3 U_y3 U_z3 V_x3 V_y3 V_z3 W_x3 W_y3 W_z3 "
     "U_x4 U_y4 U_z4 V_x4 V_y4 V_z4 W_x4 W_y4 W_z4"),
    ("Acoustics", "gamma C2 Rho_ac Rho_en T_ac T_en M_t rRP rRT"),
    ("RhoBudget",
     "RhoFluxX RhoFluxY RhoFluxZ RhoDil1 RhoDil2 RhoTrp RhoProd RhoConv"),
    ("Stratification",
     "Pot rRref rTref BuoyFreq_fr BuoyFreq_eq LapseRate_fr LapseRate_eq "
     "PotTemp PotTemp_v SaturationPressure rPref RelativeHumidity "
     "Dewpoint LapseRate_dew"),
]

SCAL_GROUPS = [
    ("Mean", "rS fS rS_y fS_y rQ fQ"),
    ("Fluctuations", "Rsu Rsv Rsw fS2 fS3 fS4 rS2 rS3 rS4"),
    ("RssBudget", "Rss_t Css Pss Ess Tssy1 Tssy2 Tssy_y Dss Qss"),
    ("RsuBudget",
     "Rsu_t Csu Psu Esu PIsu Tsuy1 Tsuy2 Tsuy_y Dsu Gsu Bsu Fsu Qsu"),
    ("RsvBudget",
     "Rsv_t Csv Psv Esv PIsv Tsvy1 Tsvy2 Tsvy3 Tsvy_y Dsv Gsv Bsv Fsv Qsv"),
    ("RswBudget",
     "Rsw_t Csw Psw Esw PIsw Tswy1 Tswy2 Tswy_y Dsw Gsw Bsw Fsw Qsw"),
    ("DerivativeFluctuations",
     "S_x2 S_y2 S_z2 S_x3 S_y3 S_z3 S_x4 S_y4 S_z4"),
    # CrossScalars columns (Cs<j> Css<j>) are appended per case
]

# columns of the flow table that only another equation set fills
_FLOW_INACTIVE = (
    "rT re rh rs fT fe fh fs rR2 rT2 fT2 re2 fe2 rh2 fh2 rs2 fs2 "
    + FLOW_GROUPS[12][1] + " " + FLOW_GROUPS[13][1] + " "
    + FLOW_GROUPS[14][1].replace("Pot ", "")).split()
_COMPRESSIBLE = ("compressible", "total", "internal")
_EQNS_PORTED = ("incompressible", "anelastic") + _COMPRESSIBLE


def _pavg(a):
    """(x,z)-plane average -> (ny,)."""
    return torch.mean(a, dim=(0, 2))


def _pressure(P, state, p, extras):
    """The table's pressure: `p`, else the diagnostic Boussinesq pressure
    (as the reference's offline averages.x re-solves it)."""
    if (extras or {}).get("eqns") in _COMPRESSIBLE and "rho" not in extras:
        raise ValueError("compressible statistics need the density field "
                         "(extras['rho'])")
    if p is None:
        from tlab_tpu_torch.dycore.pressure import pressure_boussinesq
        p = pressure_boussinesq(P, state)
    return p


# ---------------------------------------------------------------------------
# Extras: equation-set-dependent context assembled from the Simulation
# ---------------------------------------------------------------------------

def build_extras_static(sim):
    """State-INDEPENDENT part of the statistics context: equation set,
    background profiles, Coriolis/buoyancy parameters."""
    eqns = sim.case.equations
    if eqns not in _EQNS_PORTED:
        raise ValueError(f"no statistics for Equations={eqns}")
    ex = {"eqns": eqns, "y": np.asarray(sim.grid.y.nodes),
          "froude": sim.nsp.froude or 1.0}
    buo = sim.case.buoyancy
    cor = sim.case.coriolis
    if cor is not None and cor.type != "none":
        ex["coriolis_y"] = float(cor.vector[1]) if len(cor.vector) > 1 \
            else 0.0
    if eqns == "anelastic":
        anel = sim.anelastic
        ex["tp"], ex["bg"] = anel["tp"], anel["bg"]
        ex["rref"] = anel["bg"]["rho"]
        ex["tref"] = anel["bg"]["T"]
        ex["pref"] = anel["bg"]["p"]
    if buo is not None and buo.type != "none":
        ex["bvec"] = tuple(buo.vector)
        prof = sim.case.scal_profiles[-1] if sim.case.scal_profiles else None
        ex["ymean"] = float(getattr(prof, "ymean", 0.0) or 0.0) \
            if prof is not None else 0.0
    return ex


def add_state_extras(sim, state, ex):
    """State-DEPENDENT part: the buoyancy field b(s) as the sources use
    it (unscaled; the table applies 1/froude and the gravity vector as
    the reference does)."""
    buo = sim.case.buoyancy
    if buo is None or buo.type == "none":
        return ex
    if buo.type == "explicit" and "bg" in ex:
        ex["b"] = thermo.buoyancy_explicit(ex["tp"], state.s, ex["bg"])
    elif state.s.shape[0] > 0:
        # an explicit buoyancy without the anelastic background (the
        # Boussinesq + moist-thermo combination) gives zeros here, as in
        # tlab_tpu (gravity.buoyancy_field knows no explicit type)
        # pad with zero profiles so the independent term keeps its
        # parameters(ns+1) slot (tlab_background.f90:194-221)
        profs = list(sim.case.scal_profiles)
        profs += [lambda yv: np.zeros_like(yv)] * \
            (state.s.shape[0] - len(profs))
        bback = grav.background_profile(buo, profs, sim.grid.y.nodes)
        ex["b"] = grav.buoyancy_field(
            buo, state.s, torch.as_tensor(bback).to(state.s.device,
                                                    state.s.dtype))
    return ex


def build_extras(sim, state):
    """Collect the equation-set context flow/scalar_statistics need for
    the buoyancy, Coriolis and potential-energy columns.

    Mirrors the globals AVG_FLOW_XZ pulls from its modules (buoyancy%,
    coriolis%)."""
    return add_state_extras(sim, state, build_extras_static(sim))


def stats_tables(sim, state, p):
    """The full avg tables of `state` (counterpart of tlab_tpu's
    make_stats_tables_fn): (flow dict, [scalar dicts]) of (ny,) NumPy
    columns, reduced on the state's device and brought to the host as one
    stacked (ncols, ny) array -- no full field is copied.  p: the
    projection pressure of the step that produced `state`."""
    ex = build_extras(sim, state)
    flow = flow_statistics(sim.P, state, sim.nsp.visc, p=p, extras=ex)
    scals = [scalar_statistics(sim.P, state, sim.nsp.diffusivity(i), i, p=p,
                               visc=sim.nsp.visc, extras=ex)
             for i in range(sim.nsp.n_scalars)]
    return to_host(flow, scals)


def to_host(flow: dict, scals: list):
    """The device tables (name -> (ny,) tensor) as NumPy columns, through
    one stacked (ncols, ny) copy: (flow dict, [scalar dicts])."""
    cols = [v for table in (flow, *scals) for v in table.values()]
    stacked = torch.stack(cols).cpu().numpy()        # one small copy
    k = len(flow)
    out = [dict(zip(flow, stacked[:k]))]
    for s in scals:
        out.append(dict(zip(s, stacked[k:k + len(s)])))
        k += len(s)
    return out[0], out[1:]


# ---------------------------------------------------------------------------
# AVG_FLOW_XZ
# ---------------------------------------------------------------------------

def flow_statistics(P, state, visc, p=None, extras=None):
    """Full reference flow table: dict name -> (ny,) profile
    (avg_flow_xz.f90), incompressible, anelastic and compressible sets.

    p: the projection pressure the dycore computed this step (the EOS
    pressure in the compressible set).  extras: build_extras' context
    (buoyancy field and vector, Froude number, Coriolis vector, nodes; the
    anelastic background), or the compressible writer's (the density,
    temperature, energy, enthalpy, entropy and gamma fields; a sound-speed
    profile "c2" replaces <gamma p / rho>).  Legacy alias keys (SU, FU,
    SV, FV, SW, FW, Prod) follow the written columns."""
    p = _pressure(P, state, p, extras)
    ex = extras or {}
    anelastic = ex.get("eqns") == "anelastic" and "tp" in ex
    compressible = ex.get("eqns") in _COMPRESSIBLE
    u, v, w = state.u, state.v, state.w
    d1y = P.get("d1y")
    ny = u.shape[1]
    zero = torch.zeros((ny,), dtype=u.dtype, device=u.device)

    def dy(prof):
        return (d1y @ prof) if d1y is not None else torch.zeros_like(prof)

    out = {}

    # --- Mean group (Favre == Reynolds but in the compressible set) -------
    rU, rV, rW = _pavg(u), _pavg(v), _pavg(w)
    rU_y, rV_y, rW_y = dy(rU), dy(rV), dy(rW)
    rP = _pavg(p)
    pf = p - rP[None, :, None]
    out["rR"] = torch.ones((ny,), dtype=u.dtype, device=u.device)
    out["rU"], out["rV"], out["rW"], out["rP"] = rU, rV, rW, rP
    out["fU"], out["fV"], out["fW"] = rU, rV, rW
    for n in _FLOW_INACTIVE:
        out[n] = zero
    rR = out["rR"]
    fU, fV, fW = rU, rV, rW
    rho3 = T3 = rf3 = None
    if anelastic:
        # density and temperature of the equilibrium thermodynamics
        # (Thermo_Anelastic_DENSITY); Favre == Reynolds for the velocity
        tp, bg = ex["tp"], ex["bg"]
        T3, ql3 = thermo.equilibrium_state(tp, state.s, bg)
        qt = state.s[1] if state.s.shape[0] > 1 else \
            torch.zeros_like(state.s[0])
        rho3 = bg["p"][None, :, None] / (thermo.mixture_R(tp, qt, ql3) * T3)
    elif compressible:
        rho3, T3 = ex["rho"], ex["T"]
    if rho3 is not None:
        rR = _pavg(rho3)
        rT = _pavg(T3)
        fT = _pavg(rho3 * T3) / rR
        rf3 = rho3 - rR[None, :, None]
        Tf3 = T3 - rT[None, :, None]
        fTf = T3 - fT[None, :, None]
        out["rR"], out["rT"], out["fT"] = rR, rT, fT
        out["rR2"] = _pavg(rf3 * rf3)
        out["rT2"] = _pavg(Tf3 * Tf3)
        out["fT2"] = _pavg(rho3 * fTf * fTf) / rR
    if compressible:
        # density-weighted (Favre) means and the caloric columns
        fU = _pavg(rho3 * u) / rR
        fV = _pavg(rho3 * v) / rR
        fW = _pavg(rho3 * w) / rR
        out["fU"], out["fV"], out["fW"] = fU, fV, fW
        for nm in ("e", "h", "s"):
            f3 = ex["entropy" if nm == "s" else nm]
            rm = _pavg(f3)
            fm = _pavg(rho3 * f3) / rR
            g = f3 - rm[None, :, None]
            gf = f3 - fm[None, :, None]
            out[f"r{nm}"], out[f"f{nm}"] = rm, fm
            out[f"r{nm}2"] = _pavg(g * g)
            out[f"f{nm}2"] = _pavg(rho3 * gf * gf) / rR
    fU_y, fV_y, fW_y = dy(fU), dy(fV), dy(fW)

    # buoyancy field (Gravity_Buoyancy)
    b3 = ex.get("b")
    bvec = ex.get("bvec", (0.0, -1.0, 0.0))
    rB_raw = _pavg(b3) if b3 is not None else zero
    rB = rB_raw / ex.get("froude", 1.0)
    out["rB"] = rB

    # --- Fluctuations (about the Favre means, rho-weighted: compressible) -
    uf = u - fU[None, :, None]
    vf = v - fV[None, :, None]
    wf = w - fW[None, :, None]
    if compressible:
        Rxx = _pavg(rho3 * uf * uf) / rR
        Ryy = _pavg(rho3 * vf * vf) / rR
        Rzz = _pavg(rho3 * wf * wf) / rR
        Rxy = _pavg(rho3 * uf * vf) / rR
        Rxz = _pavg(rho3 * uf * wf) / rR
        Ryz = _pavg(rho3 * vf * wf) / rR
    else:
        Rxx, Ryy, Rzz = _pavg(uf * uf), _pavg(vf * vf), _pavg(wf * wf)
        Rxy, Rxz, Ryz = _pavg(uf * vf), _pavg(uf * wf), _pavg(vf * wf)
    out["Tke"] = 0.5 * (Rxx + Ryy + Rzz)
    out["Rxx"], out["Ryy"], out["Rzz"] = Rxx, Ryy, Rzz
    out["Rxy"], out["Rxz"], out["Ryz"] = Rxy, Rxz, Ryz
    out["rP2"] = _pavg(pf * pf)

    # --- velocity gradient tensor ----------------------------------------
    g = {}
    for cname, comp in (("u", u), ("v", v), ("w", w)):
        for aname, axis in (("x", 0), ("y", 1), ("z", 2)):
            g[cname + aname] = dyn._d1(P, aname, axis, comp)
    div = g["ux"] + g["vy"] + g["wz"]

    # --- Vorticity --------------------------------------------------------
    for nm, om in (("Wx", g["wy"] - g["vz"]),
                   ("Wy", g["uz"] - g["wx"]),
                   ("Wz", g["vx"] - g["uy"])):
        m = _pavg(om)
        out[nm] = m
        out[nm + "2"] = _pavg((om - m[None, :, None]) ** 2)

    # --- budget building blocks ------------------------------------------
    c23 = 2.0 / 3.0
    tags = ("xx", "yy", "zz", "xy", "xz", "yz")
    Rm = {"xx": Rxx, "yy": Ryy, "zz": Rzz,
          "xy": Rxy, "xz": Rxz, "yz": Ryz}
    Ry = {k: dy(vv) for k, vv in Rm.items()}
    rmean_y = {"u": rU_y, "v": rV_y, "w": rW_y}

    # mean viscous stresses Tau_iy (avg_flow_xz.f90:1180-1215); the
    # fluctuating parts feed the transport/dissipation corrections
    tau_yy_f3 = (g["vy"] * 2.0 - g["ux"] - g["wz"])
    Tau_yy = _pavg(tau_yy_f3)
    tau_yy_f3 = (tau_yy_f3 - Tau_yy[None, :, None]) * c23
    Tau_yy = Tau_yy * visc * c23
    tau_xy_f3 = g["uy"] + g["vx"]
    Tau_xy = _pavg(tau_xy_f3)
    tau_xy_f3 = tau_xy_f3 - Tau_xy[None, :, None]
    Tau_xy = Tau_xy * visc
    tau_yz_f3 = g["vz"] + g["wy"]
    Tau_yz = _pavg(tau_yz_f3)
    tau_yz_f3 = tau_yz_f3 - Tau_yz[None, :, None]
    Tau_yz = Tau_yz * visc
    Tau_xy_y, Tau_yy_y, Tau_yz_y = dy(Tau_xy), dy(Tau_yy), dy(Tau_yz)

    # triple-velocity correlations + pressure + viscous contributions
    Txxy = _pavg(uf * uf * vf)
    Tyyy = _pavg(vf * vf * vf)
    Tzzy = _pavg(wf * wf * vf)
    Txyy = _pavg(uf * vf * vf)
    Txzy = _pavg(uf * wf * vf)
    Tyzy = _pavg(vf * wf * vf)
    Trp1 = 0.5 * (Txxy + Tyyy + Tzzy)              # Ty1, velocity triples
    pv_u = _pavg(uf * pf)
    pv_v = _pavg(vf * pf)
    pv_w = _pavg(wf * pf)
    Trp2 = pv_v                                    # Ty2, pressure transport
    Txyy = Txyy + pv_u
    Tyyy = Tyyy + 2.0 * pv_v
    Tyzy = Tyzy + pv_w
    visc_u = _pavg(tau_xy_f3 * uf)
    visc_v = _pavg(tau_yy_f3 * vf)
    visc_w = _pavg(tau_yz_f3 * wf)
    Trp3 = -visc * (visc_u + visc_v + visc_w)      # Ty3, viscous transport
    Txxy = Txxy - 2.0 * visc * visc_u
    Tyyy = Tyyy - 2.0 * visc * visc_v
    Tzzy = Tzzy - 2.0 * visc * visc_w
    Txyy = Txyy - visc * (_pavg(tau_yy_f3 * uf) + _pavg(tau_xy_f3 * vf))
    Txzy = Txzy - visc * (_pavg(tau_yz_f3 * uf) + _pavg(tau_xy_f3 * wf))
    Tyzy = Tyzy - visc * (_pavg(tau_yz_f3 * vf) + _pavg(tau_yy_f3 * wf))
    Tiy = {"xx": Txxy, "yy": Tyyy, "zz": Tzzy,
           "xy": Txyy, "xz": Txzy, "yz": Tyzy}
    Tiy_y = {k: dy(vv) for k, vv in Tiy.items()}

    # dissipation with deviatoric mean correction (avg_flow_xz.f90:1146+)
    dil23 = div * c23
    phi_xx = (g["ux"] * 2.0 - dil23) * g["ux"] \
        + (g["uy"] + g["vx"]) * g["uy"] + (g["uz"] + g["wx"]) * g["uz"]
    phi_yy = (g["vy"] * 2.0 - dil23) * g["vy"] \
        + (g["uy"] + g["vx"]) * g["vx"] + (g["vz"] + g["wy"]) * g["vz"]
    phi_zz = (g["wz"] * 2.0 - dil23) * g["wz"] \
        + (g["wy"] + g["vz"]) * g["wy"] + (g["wx"] + g["uz"]) * g["wx"]
    phi_xy = (g["ux"] * 2.0 - dil23) * g["vx"] \
        + (g["uy"] + g["vx"]) * g["vy"] + (g["uz"] + g["wx"]) * g["vz"] \
        + (g["vy"] * 2.0 - dil23) * g["uy"] \
        + (g["uy"] + g["vx"]) * g["ux"] + (g["vz"] + g["wy"]) * g["uz"]
    phi_xz = (g["ux"] * 2.0 - dil23) * g["wx"] \
        + (g["uy"] + g["vx"]) * g["wy"] + (g["uz"] + g["wx"]) * g["wz"] \
        + (g["wz"] * 2.0 - dil23) * g["uz"] \
        + (g["uz"] + g["wx"]) * g["ux"] + (g["vz"] + g["wy"]) * g["uy"]
    phi_yz = (g["vy"] * 2.0 - dil23) * g["wy"] \
        + (g["uy"] + g["vx"]) * g["wx"] + (g["vz"] + g["wy"]) * g["wz"] \
        + (g["wz"] * 2.0 - dil23) * g["vz"] \
        + (g["uz"] + g["wx"]) * g["vx"] + (g["vz"] + g["wy"]) * g["vy"]
    Eij = {"xx": (_pavg(phi_xx) * visc - Tau_xy * rU_y) * 2.0,
           "yy": (_pavg(phi_yy) * visc - Tau_yy * rV_y) * 2.0,
           "zz": (_pavg(phi_zz) * visc - Tau_yz * rW_y) * 2.0,
           "xy": _pavg(phi_xy) * visc - Tau_xy * rV_y - Tau_yy * rU_y,
           "xz": _pavg(phi_xz) * visc - Tau_xy * rW_y - Tau_yz * rU_y,
           "yz": _pavg(phi_yz) * visc - Tau_yy * rW_y - Tau_yz * rV_y}

    # pressure-strain (means need no subtraction: <p'> = 0)
    PIij = {"xx": 2.0 * _pavg(pf * g["ux"]),
            "yy": 2.0 * _pavg(pf * g["vy"]),
            "zz": 2.0 * _pavg(pf * g["wz"]),
            "xy": _pavg(pf * (g["uy"] + g["vx"])),
            "xz": _pavg(pf * (g["uz"] + g["wx"])),
            "yz": _pavg(pf * (g["vz"] + g["wy"]))}

    Cij = {t: -fV * Ry[t] for t in tags}
    Pij = {"xx": -2.0 * Rxy * fU_y, "yy": -2.0 * Ryy * fV_y,
           "zz": -2.0 * Ryz * fW_y,
           "xy": -(Rxy * fV_y + Ryy * fU_y),
           "xz": -(Rxy * fW_y + Ryz * fU_y),
           "yz": -(Ryy * fW_y + Ryz * fV_y)}

    # pressure / viscous variable-density terms (zero where Favre ==
    # Reynolds)
    if compressible:
        rUf, rVf, rWf = rU - fU, rV - fV, rW - fW
        rP_y = dy(rP)
        Gij = {"xx": zero, "yy": 2.0 * rVf * rP_y, "zz": zero,
               "xy": rUf * rP_y, "xz": zero, "yz": rWf * rP_y}
        Dij = {"xx": 2.0 * rUf * Tau_xy_y, "yy": 2.0 * rVf * Tau_yy_y,
               "zz": 2.0 * rWf * Tau_yz_y,
               "xy": rUf * Tau_yy_y + rVf * Tau_xy_y,
               "xz": rUf * Tau_yz_y + rWf * Tau_xy_y,
               "yz": rVf * Tau_yz_y + rWf * Tau_yy_y}
    else:
        Gij = Dij = {t: zero for t in tags}

    # buoyancy production (avg_flow_xz.f90 Potential-energy section)
    if b3 is not None:
        bf = b3 - rB_raw[None, :, None]
        Bx, By, Bz = _pavg(uf * bf), _pavg(vf * bf), _pavg(wf * bf)
        Bij = {"xx": 2.0 * Bx * bvec[0], "yy": 2.0 * By * bvec[1],
               "zz": 2.0 * Bz * bvec[2],
               "xy": Bx * bvec[1] + By * bvec[0],
               "xz": Bx * bvec[2] + Bz * bvec[0],
               "yz": By * bvec[2] + Bz * bvec[1]}
    else:
        Bij = {t: zero for t in tags}

    # Coriolis (angular velocity Oy; rotation.f90)
    om_y = ex.get("coriolis_y", 0.0)
    if om_y:
        Fij = {"xx": om_y * 2.0 * Rxz, "yy": zero,
               "zz": -om_y * 2.0 * Rxz, "xy": om_y * Ryz,
               "xz": om_y * (Rzz - Rxx), "yz": -om_y * Rxy}
    else:
        Fij = {t: zero for t in tags}

    for t in tags:
        out[f"R{t}_t"] = -Fij[t] + Bij[t] + Cij[t] + Pij[t] - Eij[t] \
            + (PIij[t] - Tiy_y[t] - Gij[t] + Dij[t]) / rR
        out[f"B{t}"] = Bij[t]
        out[f"C{t}"] = Cij[t]
        out[f"P{t}"] = Pij[t]
        out[f"E{t}"] = Eij[t]
        out[f"PI{t}"] = PIij[t]
        out[f"F{t}"] = Fij[t]
        out[f"T{t}y_y"] = Tiy_y[t]
        out[f"T{t}y"] = Tiy[t]
        out[f"G{t}"] = Gij[t]
        out[f"D{t}"] = Dij[t]

    # --- TKE budget -------------------------------------------------------
    Buo = 0.5 * (Bij["xx"] + Bij["yy"] + Bij["zz"])
    Con = 0.5 * (Cij["xx"] + Cij["yy"] + Cij["zz"])
    Prd = 0.5 * (Pij["xx"] + Pij["yy"] + Pij["zz"])
    Pi = 0.5 * (PIij["xx"] + PIij["yy"] + PIij["zz"])
    Eps = 0.5 * (Eij["xx"] + Eij["yy"] + Eij["zz"])
    Ty_y = 0.5 * (Tiy_y["xx"] + Tiy_y["yy"] + Tiy_y["zz"])
    Gkin = 0.5 * (Gij["xx"] + Gij["yy"] + Gij["zz"])
    Dkin = 0.5 * (Dij["xx"] + Dij["yy"] + Dij["zz"])
    Phi = 2.0 * visc * _pavg(
        g["ux"] ** 2 + g["vy"] ** 2 + g["wz"] ** 2
        + 0.5 * ((g["uy"] + g["vx"]) ** 2 + (g["uz"] + g["wx"]) ** 2
                 + (g["vz"] + g["wy"]) ** 2) - div ** 2 / 3.0)
    dpx = dyn._d1(P, "x", 0, p)
    dpy = dyn._d1(P, "y", 1, p)
    dpz = dyn._d1(P, "z", 2, p)
    out["Tke_t"] = Buo + Con + Prd - Eps + (-Ty_y + Pi - Gkin + Dkin) / rR
    out["Buo"], out["Con"], out["Prd"] = Buo, Con, Prd
    out["Eps"], out["Pi"], out["Trp"] = Eps, Pi, Ty_y
    out["Trp1"], out["Trp2"], out["Trp3"] = Trp1, Trp2, Trp3
    out["Trp1_y"], out["Trp2_y"], out["Trp3_y"] = dy(Trp1), dy(Trp2), \
        dy(Trp3)
    out["G"], out["D"], out["Phi"] = Gkin, Dkin, Phi
    out["UgradP"] = _pavg(u * dpx + v * dpy + w * dpz)

    # --- HigherOrder ------------------------------------------------------
    out["rU3"] = _pavg(uf ** 3)
    out["rU4"] = _pavg(uf ** 4)
    out["rV3"] = _pavg(vf ** 3)
    out["rV4"] = _pavg(vf ** 4)
    out["rW3"] = _pavg(wf ** 3)
    out["rW4"] = _pavg(wf ** 4)

    # --- DerivativeFluctuations ------------------------------------------
    out["U_y1"], out["V_y1"], out["W_y1"] = rU_y, rV_y, rW_y
    dil_f = div - rV_y[None, :, None]
    out["U_ii2"] = _pavg(dil_f * dil_f)
    for mom in (2, 3, 4):
        for cn in ("u", "v", "w"):
            for an in ("x", "y", "z"):
                gg = g[cn + an]
                if an == "y":
                    gg = gg - rmean_y[cn][None, :, None]
                out[f"{cn.upper()}_{an}{mom}"] = _pavg(gg ** mom)

    # --- Acoustics (a density field and a sound speed) --------------------
    gam3, c2 = ex.get("gamma_field"), ex.get("c2")
    if gam3 is not None:
        out["gamma"] = _pavg(gam3)
    if c2 is None and rho3 is not None and gam3 is not None:
        c2 = _pavg(gam3 * p / rho3)              # <gamma p / rho>
    if c2 is not None:
        out["C2"] = c2
    if rho3 is not None and c2 is not None:
        rho_ac3 = pf / c2[None, :, None]
        rho_en3 = rf3 - rho_ac3
        T_ac3 = (pf / rP[None, :, None]
                 - rho_ac3 / rR[None, :, None]) * fT[None, :, None]
        T_en3 = T3 - fT[None, :, None] - T_ac3
        out["Rho_ac"] = _pavg(rho_ac3 * rho_ac3)
        out["Rho_en"] = _pavg(rho_en3 * rho_en3)
        out["T_ac"] = _pavg(T_ac3 * T_ac3)
        out["T_en"] = _pavg(T_en3 * T_en3)
        out["M_t"] = torch.sqrt((Rxx + Ryy + Rzz) / torch.clamp(
            c2, min=torch.finfo(u.dtype).tiny))
        out["rRP"] = _pavg(rf3 * pf)
        out["rRT"] = _pavg(rf3 * (T3 - fT[None, :, None]))

    # --- RhoBudget (the density's fluctuations; Reynolds velocity ones) ---
    if rf3 is not None:
        urf = u - rU[None, :, None]
        vrf = v - rV[None, :, None]
        wrf = w - rW[None, :, None]
        fx, fy, fz = _pavg(urf * rf3), _pavg(vrf * rf3), _pavg(wrf * rf3)
        out["RhoFluxX"], out["RhoFluxY"], out["RhoFluxZ"] = fx, fy, fz
        out["RhoDil1"] = 2.0 * rR * _pavg(dil_f * rf3)
        out["RhoDil2"] = _pavg(dil_f * rf3 * rf3)
        out["RhoTrp"] = _pavg(vrf * rf3 * rf3)
        out["RhoProd"] = -2.0 * (fy * dy(rR) + out["rR2"] * rV_y)
        out["RhoConv"] = -rV * dy(out["rR2"])

    # --- Stratification ---------------------------------------------------
    if b3 is not None and "y" in ex:
        yt = torch.as_tensor(ex["y"]).to(u.device, u.dtype)
        out["Pot"] = -rB * (yt - ex.get("ymean", 0.0))
    else:
        out["Pot"] = zero
    if anelastic:
        out["rRref"], out["rTref"] = ex["rref"], ex["tref"]
        out.update(_stratification(P, ex, state, T3, ql3))

    # --- legacy aliases (not written by write_avg) ------------------------
    tiny = torch.finfo(u.dtype).tiny
    for c, R in (("U", Rxx), ("V", Ryy), ("W", Rzz)):
        out[f"S{c}"] = out[f"r{c}3"] / torch.clamp(R ** 1.5, min=tiny)
        out[f"F{c}"] = out[f"r{c}4"] / torch.clamp(R ** 2, min=tiny)
    out["Prod"] = Prd
    return out


def _stratification(P, ex, state, T3, ql3):
    """Anelastic Stratification group (avg_flow_xz.f90:703-766 anelastic
    branch; Thermo_Anelastic_{THETA,THETA_V,LAPSE_FR,LAPSE_EQU,
    VAPOR_PRESSURE,DEWPOINT,RELATIVEHUMIDITY} in tlab_tpu's
    nondimensionalization: lapse_fr = g_nd / cp_mix, theta via the Exner
    function with the surface pressure as reference)."""
    tp, bg = ex["tp"], ex["bg"]
    bvec = ex.get("bvec", (0.0, -1.0, 0.0))
    qt = state.s[1] if state.s.shape[0] > 1 else torch.zeros_like(state.s[0])
    qv = qt - ql3
    p3 = bg["p"][None, :, None]
    g_nd = tp.scale_height_inv
    out = {}
    cp_mix = tp.Cd + qt * tp.Cdv + ql3 * tp.Cvl
    lapse_fr3 = g_nd / cp_mix * torch.ones_like(T3)
    psat3 = tp.psat(T3)
    dTdy3 = dyn._d1(P, "y", 1, T3)
    out["LapseRate_fr"] = _pavg(lapse_fr3)
    out["BuoyFreq_fr"] = _pavg((lapse_fr3 + dTdy3) / T3) * bvec[1]
    # saturated (equilibrium) lapse rate, Thermo_Anelastic_LAPSE_EQU
    qv_ov_qd = (tp.Rd / tp.Rv) / torch.clamp(p3 / psat3 - 1.0, min=1e-30)
    Lv3 = tp.Lv0 - T3 * tp.Cvl
    lapse_eq3 = g_nd * (1.0 + qv_ov_qd * Lv3 / (tp.Rd * T3)) / (
        tp.Cd + qt * tp.Cdl - qv_ov_qd * (1.0 - qt) * tp.Cvl
        + qv_ov_qd * (1.0 - qt) * (1.0 + qv_ov_qd * tp.Rv / tp.Rd)
        * Lv3 ** 2 / (tp.Rv * T3 * T3))
    out["LapseRate_eq"] = _pavg(lapse_eq3)
    out["BuoyFreq_eq"] = _pavg((lapse_eq3 + dTdy3) / T3) * bvec[1]
    # potential temperatures via the Exner function (surface p as ref)
    p0 = float(bg["p"][0])
    exner_inv = (p0 / p3) ** (tp.Rd / tp.Cd)
    theta3 = T3 * exner_inv
    out["PotTemp"] = _pavg(theta3)
    out["PotTemp_v"] = _pavg(theta3 * (1.0 + qt * (tp.Rdv / tp.Rd)
                                       - ql3 * (tp.Rv / tp.Rd)))
    out["SaturationPressure"] = _pavg(psat3)
    out["rPref"] = ex["pref"]
    # vapor pressure pv = p qv Rv / R_mix; RH in % as the reference
    pv3 = p3 * qv * tp.Rv / thermo.mixture_R(tp, qt, ql3)
    out["RelativeHumidity"] = _pavg(pv3 / psat3 * 100.0)
    # dewpoint: Newton psat(Td) = pv from T as initial guess
    Td = T3
    for _ in range(5):
        Td = Td - (tp.psat(Td) - pv3) / tp.dpsat(Td)
    out["Dewpoint"] = _pavg(Td)
    dpvdy3 = dyn._d1(P, "y", 1, pv3 * torch.ones_like(T3))
    out["LapseRate_dew"] = _pavg(-dpvdy3 / tp.dpsat(Td))
    return out


# ---------------------------------------------------------------------------
# AVG_SCAL_XZ
# ---------------------------------------------------------------------------

def scalar_statistics(P, state, diff, i, p=None, visc=None, extras=None,
                      rho=None, vis=None):
    """Full reference scalar table (avg_scal_xz.f90) of scalar i: dict in
    reference column order.

    rho: the compressible density field -> Favre (density-weighted) means,
    second moments, transports and the variable-density D/G terms
    (avg_scal_xz.f90:313-400, :421-423, :580-597, :760-763).  vis: the
    normalized viscosity field of a transport law multiplying the
    visc/diff molecular terms (EQNS_TRANS_SUTHERLAND/POWERLAW branches,
    avg_scal_xz.f90:610+).  extras: as flow_statistics, and the scalar
    sources "scalar_sources" ((ns,) + shape or shape) for the Q columns.
    Legacy alias keys (Ss, Fs, Chi, Rss) follow the written columns."""
    p = _pressure(P, state, p, extras)
    ex = extras or {}
    s = state.s[i]
    u, v, w = state.u, state.v, state.w
    d1y = P.get("d1y")
    if visc is None:
        visc = float(P.get("visc", diff))
    ny = s.shape[1]
    zero = torch.zeros((ny,), dtype=s.dtype, device=s.device)
    c23 = 2.0 / 3.0
    comp = rho is not None

    def dy(prof):
        return (d1y @ prof) if d1y is not None else torch.zeros_like(prof)

    def vw(f3):
        # molecular-term viscosity multiplier (vis field) where active
        return f3 * vis if vis is not None else f3

    out = {}
    rU, rV, rW = _pavg(u), _pavg(v), _pavg(w)
    if comp:
        rR = _pavg(rho)
        fU = _pavg(rho * u) / rR
        fV = _pavg(rho * v) / rR
        fW = _pavg(rho * w) / rR
    else:
        rR = torch.ones((ny,), dtype=s.dtype, device=s.device)
        fU, fV, fW = rU, rV, rW
    rU_y, rV_y, rW_y = dy(rU), dy(rV), dy(rW)
    fU_y, fV_y, fW_y = dy(fU), dy(fV), dy(fW)

    uf = u - fU[None, :, None]
    vf = v - fV[None, :, None]
    wf = w - fW[None, :, None]
    if comp:
        Rvu = _pavg(rho * v * u) / rR - fV * fU
        Rvv = _pavg(rho * v * v) / rR - fV * fV
        Rvw = _pavg(rho * v * w) / rR - fV * fW
    else:
        Rvu = _pavg(vf * uf)
        Rvv = _pavg(vf * vf)
        Rvw = _pavg(vf * wf)

    rS = _pavg(s)
    fS = _pavg(rho * s) / rR if comp else rS
    rS_y, fS_y = dy(rS), dy(fS)
    sf = s - fS[None, :, None]
    srf = s - rS[None, :, None]
    out["rS"], out["fS"] = rS, fS
    out["rS_y"], out["fS_y"] = rS_y, fS_y

    # source terms (radiation/evaporation/sedimentation): optional extras
    q3 = ex.get("scalar_sources")
    q3 = q3[i] if (q3 is not None and q3.ndim == 4) else q3
    rQ = _pavg(q3) if q3 is not None else zero
    fQ = (_pavg(rho * q3) / rR) if (q3 is not None and comp) else rQ
    out["rQ"], out["fQ"] = rQ, fQ

    # density-weighted fluctuation field for cross terms
    sfw = sf * rho if comp else sf
    out["Rsu"] = _pavg(sfw * uf) / rR
    out["Rsv"] = _pavg(sfw * vf) / rR
    out["Rsw"] = _pavg(sfw * wf) / rR
    rS2 = _pavg(srf * srf)
    rS3 = _pavg(srf ** 3)
    rS4 = _pavg(srf ** 4)
    if comp:
        out["fS2"] = _pavg(rho * sf * sf) / rR
        out["fS3"] = _pavg(rho * sf ** 3) / rR
        out["fS4"] = _pavg(rho * sf ** 4) / rR
    else:
        out["fS2"], out["fS3"], out["fS4"] = rS2, rS3, rS4
    out["rS2"], out["rS3"], out["rS4"] = rS2, rS3, rS4
    Rss_y = dy(out["fS2"])
    Rsu_y, Rsv_y, Rsw_y = dy(out["Rsu"]), dy(out["Rsv"]), dy(out["Rsw"])

    # turbulent transport (velocity part; rho-weighted for compressible,
    # avg_scal_xz.f90:430-443)
    Tssy1 = _pavg(sfw * sf * vf)
    Tsuy1 = _pavg(sfw * uf * vf)
    Tsvy1 = _pavg(sfw * vf * vf)
    Tswy1 = _pavg(sfw * wf * vf)

    # pressure terms
    rP = _pavg(p)
    pf = p - rP[None, :, None]
    dsdx = dyn._d1(P, "x", 0, s)
    dsdy = dyn._d1(P, "y", 1, s)
    dsdz = dyn._d1(P, "z", 2, s)
    Tsvy3 = _pavg(pf * sf)
    PIsu = _pavg(pf * dsdx)
    PIsv = _pavg(pf * (dsdy - fS_y[None, :, None]))
    PIsw = _pavg(pf * dsdz)
    Gsv = (rS - fS) * dy(rP)         # zero where Favre == Reynolds

    # velocity gradients for dissipation/transport
    gux = dyn._d1(P, "x", 0, u)
    gvy = dyn._d1(P, "y", 1, v)
    gwz = dyn._d1(P, "z", 2, w)
    guy = dyn._d1(P, "y", 1, u)
    gvx = dyn._d1(P, "x", 0, v)
    gwy = dyn._d1(P, "y", 1, w)
    gvz = dyn._d1(P, "z", 2, v)
    gwx = dyn._d1(P, "x", 0, w)
    guz = dyn._d1(P, "z", 2, u)

    # dissipation accumulations (avg_scal_xz.f90:609-706; vis multiplies
    # every molecular term under Sutherland/powerlaw transport)
    Ess = 2.0 * diff * _pavg(vw(dsdx * dsdx + dsdy * dsdy + dsdz * dsdz))
    Esu = _pavg(vw(dsdx * ((gux * 2.0 - gvy - gwz) * c23 * visc + gux * diff)
                   + dsdy * ((guy + gvx) * visc + guy * diff)
                   + dsdz * ((guz + gwx) * visc + guz * diff)))
    Esv = _pavg(vw(dsdy * ((gvy * 2.0 - gux - gwz) * c23 * visc + gvy * diff)
                   + dsdx * ((guy + gvx) * visc + gvx * diff)
                   + dsdz * ((gwy + gvz) * visc + gvz * diff)))
    Esw = _pavg(vw(dsdz * ((gwz * 2.0 - gux - gvy) * c23 * visc + gwz * diff)
                   + dsdy * ((gwy + gvz) * visc + gwy * diff)
                   + dsdx * ((gwx + guz) * visc + gwx * diff)))

    # mean viscous stresses / molecular flux + transport contributions
    tau_yy3 = vw((gvy * 2.0 - gux - gwz) * c23 * visc)
    Tau_yy = _pavg(tau_yy3)
    Tsvy2 = -_pavg((tau_yy3 - Tau_yy[None, :, None]) * sf)
    tau_yx3 = vw((guy + gvx) * visc)
    Tau_yx = _pavg(tau_yx3)
    Tsuy2 = -_pavg((tau_yx3 - Tau_yx[None, :, None]) * sf)
    tau_yz3 = vw((gwy + gvz) * visc)
    Tau_yz = _pavg(tau_yz3)
    Tswy2 = -_pavg((tau_yz3 - Tau_yz[None, :, None]) * sf)

    flux3 = vw(dsdy)                 # molecular scalar flux field
    Fy = _pavg(flux3)
    dsdy_f = flux3 - Fy[None, :, None]
    Tssy2 = -2.0 * diff * _pavg(dsdy_f * sf)
    Tsuy2 = Tsuy2 - diff * _pavg(dsdy_f * uf)
    Tsvy2 = Tsvy2 - diff * _pavg(dsdy_f * vf)
    Tswy2 = Tswy2 - diff * _pavg(dsdy_f * wf)
    Fy = Fy * diff
    Fy_y = dy(Fy)

    # dissipation mean-flux corrections, /rR (avg_scal_xz.f90:760-763)
    Ess = (Ess - 2.0 * Fy * rS_y) / rR
    Esu = (Esu - Tau_yx * rS_y - Fy * rU_y) / rR
    Esv = (Esv - Tau_yy * rS_y - Fy * rV_y) / rR
    Esw = (Esw - Tau_yz * rS_y - Fy * rW_y) / rR

    # buoyancy cross term (compressible: rho*g_y, avg_scal_xz.f90:768-783)
    b3 = ex.get("b")
    if comp:
        Bsv = _pavg(sf * rho) * ex.get("grav_y", 0.0) / rR
    elif b3 is not None:
        Bsv = _pavg(sf * b3) / ex.get("froude", 1.0)
    else:
        Bsv = zero

    # source-correlation terms (rho-weighted total source, then /rR)
    if q3 is not None:
        q3w = q3 * rho if comp else q3
        Qss = 2.0 * _pavg(sf * q3w) / rR
        Qsu = _pavg(uf * q3w) / rR
        Qsv = _pavg(vf * q3w) / rR
        Qsw = _pavg(wf * q3w) / rR
    else:
        Qss = Qsu = Qsv = Qsw = zero

    # Coriolis
    om_y = ex.get("coriolis_y", 0.0)
    Fsu = om_y * out["Rsw"] if om_y else zero
    Fsw = -om_y * out["Rsu"] if om_y else zero

    # transport derivatives
    Tssy_y = dy(Tssy1 + Tssy2)
    Tsuy_y = dy(Tsuy1 + Tsuy2)
    Tsvy_y = dy(Tsvy1 + Tsvy2 + Tsvy3)
    Tswy_y = dy(Tswy1 + Tswy2)

    Css = -fV * Rss_y
    Csu = -fV * Rsu_y
    Csv = -fV * Rsv_y
    Csw = -fV * Rsw_y
    Pss = -2.0 * out["Rsv"] * fS_y
    Psu = -out["Rsv"] * fU_y - Rvu * fS_y
    Psv = -out["Rsv"] * fV_y - Rvv * fS_y
    Psw = -out["Rsv"] * fW_y - Rvw * fS_y
    Dss = (rS - fS) * Fy_y * 2.0
    Dsu = (rS - fS) * dy(Tau_yx) + (rU - fU) * Fy_y
    Dsv = (rS - fS) * dy(Tau_yy) + (rV - fV) * Fy_y
    Dsw = (rS - fS) * dy(Tau_yz) + (rW - fW) * Fy_y

    out["Rss_t"] = Css + Pss - Ess + Qss + (Dss - Tssy_y) / rR
    out["Css"], out["Pss"], out["Ess"] = Css, Pss, Ess
    out["Tssy1"], out["Tssy2"], out["Tssy_y"] = Tssy1, Tssy2, Tssy_y
    out["Dss"], out["Qss"] = Dss, Qss
    out["Rsu_t"] = Csu + Psu - Esu - Fsu + Qsu + (PIsu + Dsu - Tsuy_y) / rR
    out["Csu"], out["Psu"], out["Esu"], out["PIsu"] = Csu, Psu, Esu, PIsu
    out["Tsuy1"], out["Tsuy2"], out["Tsuy_y"] = Tsuy1, Tsuy2, Tsuy_y
    out["Rsv_t"] = Csv + Psv - Esv + Bsv + Qsv \
        + (PIsv + Dsv - Gsv - Tsvy_y) / rR
    out["Csv"], out["Psv"], out["Esv"], out["PIsv"] = Csv, Psv, Esv, PIsv
    out["Tsvy1"], out["Tsvy2"], out["Tsvy3"], out["Tsvy_y"] = \
        Tsvy1, Tsvy2, Tsvy3, Tsvy_y
    out["Rsw_t"] = Csw + Psw - Esw - Fsw + Qsw + (PIsw + Dsw - Tswy_y) / rR
    out["Csw"], out["Psw"], out["Esw"], out["PIsw"] = Csw, Psw, Esw, PIsw
    out["Tswy1"], out["Tswy2"], out["Tswy_y"] = Tswy1, Tswy2, Tswy_y
    for c in "uvw":
        for n in "GBFQ":
            out[f"{n}s{c}"] = zero
    out["Dsu"], out["Dsv"], out["Dsw"], out["Gsv"] = Dsu, Dsv, Dsw, Gsv
    out["Bsv"], out["Fsu"], out["Fsw"] = Bsv, Fsu, Fsw
    out["Qsu"], out["Qsv"], out["Qsw"] = Qsu, Qsv, Qsw

    # derivative moments
    dsdy_m = dsdy - rS_y[None, :, None]
    for mom in (2, 3, 4):
        out[f"S_x{mom}"] = _pavg(dsdx ** mom)
        out[f"S_y{mom}"] = _pavg(dsdy_m ** mom)
        out[f"S_z{mom}"] = _pavg(dsdz ** mom)

    # cross-scalar correlations
    for j in range(state.s.shape[0]):
        sj = state.s[j]
        sjf = sj - _pavg(sj)[None, :, None]
        out[f"Cs{j + 1}"] = _pavg(sjf * sf)
        out[f"Css{j + 1}"] = _pavg(sjf * sf * sf)

    # legacy aliases
    tiny = torch.finfo(s.dtype).tiny
    out["Ss"] = rS3 / torch.clamp(rS2 ** 1.5, min=tiny)
    out["Fs"] = rS4 / torch.clamp(rS2 ** 2, min=tiny)
    out["Chi"] = Ess
    out["Rss"] = rS2
    return out


def scal_groups(ns: int):
    """SCAL_GROUPS with the per-case CrossScalars columns appended."""
    cross = " ".join(f"Cs{j + 1} Css{j + 1}" for j in range(ns))
    return SCAL_GROUPS + [("CrossScalars", cross)] if ns else SCAL_GROUPS


# ---------------------------------------------------------------------------
# I/O -- reference ASCII format (io_averages.f90:95-130) and a simple
# one-header table kept for auxiliary outputs
# ---------------------------------------------------------------------------

def write_avg(path: str, y: np.ndarray, out: dict, groups, itime: int,
              rtime: float) -> None:
    """Reference `avg<it>` ASCII layout: RTIME line, one GROUP line per
    group, `I J Y <vars>` header, then rows `1 j y v1 v2 ...`."""
    names = []
    with open(path, "w") as fh:
        fh.write(f"RTIME = {rtime:14.7E}\n")
        for gname, vars_ in groups:
            fh.write(f"GROUP = {gname} {vars_}\n")
            names.extend(vars_.split())
        fh.write("I J Y " + " ".join(names) + "\n")
        cols = [np.asarray(out[n]) for n in names]
        data = np.column_stack([np.asarray(y)] + cols)
        for j, row in enumerate(data):
            vals = " ".join(f"{x: .8E}" for x in row)
            fh.write(f"{1:5d} {j + 1:5d} {vals}\n")


def avg_writer(case):
    """Select the averages writer: NetCDF when [Main] FileFormat=netcdf
    (the reference's USE_NETCDF build writes avg<it>.nc,
    io_averages.f90:64), ASCII otherwise."""
    ini = getattr(case, "ini", None)
    if ini is not None and ini.get("Main", "FileFormat",
                                   "mpiio").lower() == "netcdf":
        return write_avg_nc
    return write_avg


def write_avg_nc(path: str, y: np.ndarray, out: dict, groups, itime: int,
                 rtime: float) -> None:
    """NetCDF averages file with the reference's layout
    (io_averages.f90:64-89 USE_NETCDF branch): dims t (unlimited record)
    and y; variables t/y (float), it (int), one float profile per column
    with dims (y,t) and a 'group' attribute. Written as NetCDF3 classic
    (scipy) -- same variable/dimension layout as the reference's
    NetCDF4 files, readable by every nc tool."""
    from scipy.io import netcdf_file
    with netcdf_file(path if path.endswith(".nc") else path + ".nc",
                     "w") as f:
        f.createDimension("t", None)
        f.createDimension("y", len(y))
        vt = f.createVariable("t", "f4", ("t",))
        vy = f.createVariable("y", "f4", ("y",))
        vit = f.createVariable("it", "i4", ("t",))
        vy[:] = np.asarray(y, np.float32)
        vt[0] = np.float32(rtime)
        vit[0] = np.int32(itime)
        for gname, vars_ in groups:
            for n in vars_.split():
                v = f.createVariable(n, "f4", ("t", "y"))
                v.group = gname
                v[0, :] = np.asarray(out[n], np.float32)


def read_avg_nc(path: str):
    """Parse a .nc averages file -> (rtime, groups, dict) like read_avg."""
    from scipy.io import netcdf_file
    # mmap=False: the arrays are copied out, so the file closes cleanly
    with netcdf_file(path, "r", mmap=False) as f:
        rtime = float(f.variables["t"][0])
        out = {"Y": np.array(f.variables["y"][:], float)}
        gmap = {}
        for n, v in f.variables.items():
            if n in ("t", "y", "it"):
                continue
            out[n] = np.array(v[0, :], float)
            g = getattr(v, "group", b"")
            g = g.decode() if isinstance(g, bytes) else str(g)
            gmap.setdefault(g, []).append(n)
    groups = [(g, " ".join(ns)) for g, ns in gmap.items()]
    return rtime, groups, out


def read_avg(path: str):
    """Parse a reference-format avg file -> (rtime, groups, dict)."""
    groups = []
    with open(path) as fh:
        line = fh.readline()
        rtime = float(line.split("=")[1])
        names = None
        for line in fh:
            if line.startswith("GROUP = "):
                parts = line.split()
                groups.append((parts[2], " ".join(parts[3:])))
                continue
            if line.startswith("I J Y"):
                names = line.split()[3:]
                break
        data = np.loadtxt(fh)
    data = np.atleast_2d(data)
    out = {"Y": data[:, 2]}
    for k, n in enumerate(names):
        out[n] = data[:, 3 + k]
    return rtime, groups, out


def write_table(path: str, y: np.ndarray, groups: dict, itime: int,
                rtime: float) -> None:
    """ASCII table: header line of column names, then y + profiles."""
    names = list(groups.keys())
    cols = [np.asarray(groups[n]) for n in names]
    with open(path, "w") as fh:
        fh.write(f"# it={itime} rtime={rtime:.8e}\n")
        fh.write("# " + " ".join(["Y"] + names) + "\n")
        data = np.column_stack([y] + cols)
        for row in data:
            fh.write(" ".join(f"{x: .8e}" for x in row) + "\n")


def read_table(path: str):
    with open(path) as fh:
        fh.readline()
        names = fh.readline().split()[1:]
    data = np.loadtxt(path)
    return {n: data[:, i] for i, n in enumerate(names)}


# ---------------------------------------------------------------------------
# Conditional (gated) statistics -- intermittency analysis
# (reference src/statistics/cavg.f90, FI_GATE conditioning)
# ---------------------------------------------------------------------------

def intermittency(gate):
    """gamma(y): plane fraction of gated (gate > 0) points, in float64
    (tlab_tpu's is float32: ~1e-7 apart)."""
    return _pavg((gate > 0).to(torch.float64))


def conditional_average(a, gate):
    """Plane average of `a` over gated points; (cond_avg(ny,), gamma(ny,))."""
    g = (gate > 0).to(a.dtype)
    num = _pavg(a * g)
    den = _pavg(g)
    return num / torch.clamp(den, min=torch.finfo(a.dtype).tiny), den


def conditional_flow_statistics(P, state, gate):
    """Gated means and second moments of the velocity components."""
    out = {}
    for name, comp in (("U", state.u), ("V", state.v), ("W", state.w)):
        mean, gamma = conditional_average(comp, gate)
        out[f"c{name}"] = mean
        var, _ = conditional_average(comp * comp, gate)
        out[f"c{name}2"] = var - mean ** 2
    out["gamma"] = gamma
    return out
