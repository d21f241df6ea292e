"""Simulation context for the port: grid, plans and device operators from a
CaseSetup, for the incompressible (Boussinesq), anelastic and compressible
equation sets on one device (port of tlab_tpu/runtime.py: make_anelastic,
make_sources, the [IBMParameter] reader, the interactive surface BC,
attach_buffer, attach_buffer_compressible and Simulation without the
GSPMD shardings of its `mesh` argument, a JAX compiler path with no PyTorch
counterpart: on a rank mesh every rank builds the global plans and
parallel/pencil.pencil_plans makes them the rank's).  The compressible set
takes its characteristic (NSCBC) boundaries, the combustion mixtures,
CHEMKIN tables and the moist AirWater mixture.

A case option the port does not have raises NotImplementedError with the
reason; none is dropped silently.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tlab_tpu_torch.config import CaseSetup, consistency_check, load_case
from tlab_tpu_torch.constants import BC
from tlab_tpu_torch.fdm.plan import FdmPlan, build_deriv_plan, build_fdm_plan
from tlab_tpu_torch.grid import Grid, build_axis_from_segments, make_axis
from tlab_tpu_torch.physics.params import NSParams
from tlab_tpu_torch import device as _device
from tlab_tpu_torch import ibm as ibmmod
from tlab_tpu_torch.dycore import buffer as bufmod
from tlab_tpu_torch.dycore import incompressible as dyn
from tlab_tpu_torch.dycore.state import State
from tlab_tpu_torch.fdm import stagger as stg
from tlab_tpu_torch.ops import elliptic
from tlab_tpu_torch.ops import elliptic_factorize as fac
from tlab_tpu_torch.ops import filter as filt
from tlab_tpu_torch.physics import chemistry as chemmod
from tlab_tpu_torch.physics import forcing as forcmod
from tlab_tpu_torch.physics import gravity as grav
from tlab_tpu_torch.physics import microphysics as micmod
from tlab_tpu_torch.physics import mixtures as mixmod
from tlab_tpu_torch.physics import radiation as radmod
from tlab_tpu_torch.physics import rotation as rot
from tlab_tpu_torch.physics import thermo
from tlab_tpu_torch.physics.eos import GasParams
from tlab_tpu_torch.utils import trace as _trace

FACTORIZED_ORDERS = ("", "factorize", "compactjacobian6")


def make_anelastic(case: CaseSetup, grid: Grid, dtype=torch.float32,
                   device="cuda") -> dict:
    """Anelastic background state: hydrostatic profiles from the scalar mean
    profiles (reference TLab_Initialize_Background + Thermo_Anelastic).

    The background is host float64 work (thermo.hydrostatic_background),
    cast once to the run's dtype on the run's device: {"tp": ThermoParams,
    "bg": {p, T, rho, ql, ep, rho_inv} as (ny,) tensors, "rho", "rho_inv"}.
    """
    dev = _device.resolve(device)
    tcfg = case.thermo or {}
    mixture = tcfg.get("mixture", "airwater")
    if mixture in ("none", ""):
        mixture = "airwater" if len(case.scal_profiles) >= 2 else "air"
    sh = tcfg.get("scale_height", 0.0)
    tp = thermo.ThermoParams(mixture=mixture,
                             scale_height_inv=(1.0 / sh if sh > 0 else 0.0),
                             dsmooth=tcfg.get("smooth", 0.0),
                             thermo_param=tuple(tcfg.get("parameters", ())),
                             nondimensional=tcfg.get("nondimensional", True))
    y = grid.y.nodes
    h_prof = case.scal_profiles[0](y) if case.scal_profiles \
        else np.ones_like(y)
    qt_prof = case.scal_profiles[1](y) if len(case.scal_profiles) > 1 \
        else np.zeros_like(y)
    # pressure anchor [Flow] Pressure / YMean(Relative)Pressure (reference
    # pbg read in TLab_Initialize_Background, tlab_background.f90:86-92)
    ini = case.ini
    p_ref, y_ref = 1.0, None
    if ini is not None:
        p_ref = ini.get_float("Flow", "Pressure", 1.0)
        ymean_abs = ini.get("Flow", "YMeanPressure", "")
        rel = ini.get("Flow", "YMeanRelativePressure", "")
        if ymean_abs:
            y_ref = float(ymean_abs)
        elif rel:
            y_ref = float(y[0]) + (float(y[-1]) - float(y[0])) * float(rel)
    # compact cumulative integral for the hydrostatic solve (the
    # reference integrates with FDM_Int1)
    d1y = build_deriv_plan(grid.y, case.space_order1,
                           case.space_order2).d1[0]
    bg = thermo.hydrostatic_background(tp, y, h_prof, qt_prof,
                                       p_ref=p_ref, y_ref=y_ref, d1y=d1y)
    dev_bg = {k: torch.as_tensor(v).to(dev, dtype) for k, v in bg.items()}
    return {"tp": tp, "bg": dev_bg, "rho": dev_bg["rho"],
            "rho_inv": dev_bg["rho_inv"]}


def _radiation_props(ini) -> radmod.RadiationProps:
    """[Infrared] (or legacy [Radiation]) as RadiationProps.

    The reference layout (radiation.f90:117-163): BoundaryConditions = the
    per-band downward top fluxes, the LAST value the surface emissivity;
    AbsorptionComponent<c> = per-band kappas of the c-th radiatively
    active component (1 liquid, 2 vapor, 3 constant); BetaCoefficient<ic>
    = the ic-th polynomial coefficient across bands 1..nbands-1
    (coefficient-major; last band derived from sum beta = 1).  The legacy
    scalar keys hold where the reference keys are absent, and Bulk1dLocal
    converts to grayliquid."""
    rad_bcs = ini.get_floats("Infrared", "BoundaryConditions", ())
    rad_comps = []
    _c = 1
    while True:
        row = ini.get_floats("Infrared", f"AbsorptionComponent{_c}", ())
        if not row:
            break
        rad_comps.append(row)
        _c += 1
    rad_beta_rows = [ini.get_floats("Infrared", f"BetaCoefficient{i}", ())
                     for i in (1, 2, 3)]
    nbands, eps_sfc, bcs_top, kappa_table, beta_table = \
        radmod.derive_band_tables(rad_bcs or (1.0, 1.0), rad_comps,
                                  rad_beta_rows)
    ref_layout = bool(rad_bcs) or bool(rad_comps)
    # legacy scalar keys honoured when the reference keys are absent
    kap_l = kappa_table[0][0] if rad_comps else \
        ini.get_float("Infrared", "Kappa", 1.0)
    kap_v = kappa_table[1][0] if len(rad_comps) > 1 else \
        ini.get_float("Infrared", "KappaVapor", 0.0)
    kap_g = kappa_table[2][0] if len(rad_comps) > 2 else \
        ini.get_float("Infrared", "KappaGas", 0.0)
    rad = radmod.RadiationProps(
        type=ini.get("Infrared", "Type",
                     ini.get("Radiation", "Type", "none")).lower(),
        scalar=ini.get_int("Infrared", "Scalar", 1) - 1,
        kappa=kap_l, kappa_v=kap_v, kappa_g=kap_g,
        beta=ini.get_float("Infrared", "Beta", 1.0),
        emissivity=eps_sfc if ref_layout else
        ini.get_float("Infrared", "Emissivity", 1.0),
        flux_top=bcs_top[0] if rad_bcs else
        ini.get_float("Infrared", "FluxTop", 1.0),
        # grayliquid reads the SECOND BoundaryConditions value as the
        # upward bottom flux (radiation.f90:277-278, auxiliar(2))
        flux_bottom=rad_bcs[1] if len(rad_bcs) > 1 else
        ini.get_float("Infrared", "FluxBottom", 0.0),
        nbands=nbands, kappa_table=kappa_table, beta_table=beta_table,
        bcs_top=bcs_top)
    if rad.type == "bulk1dlocal":
        # backwards-compatible Bulk1dLocal -> grayliquid conversion
        # (radiation.f90:186-199): Parameters=(F0, delta[, Fb]) with
        # kappa = 1/delta, flux_top = F0*delta, flux_bottom = Fb*delta
        par = ini.get_floats("Infrared", "Parameters", (0.0, 1.0))
        par = tuple(par) + (0.0,) * (3 - len(par))
        rad = dataclasses.replace(rad, type="grayliquid",
                                  kappa=1.0 / par[1],
                                  flux_top=par[0] * par[1],
                                  flux_bottom=par[2] * par[1])
    return rad


def make_sources(case: CaseSetup, grid: Grid, dtype=torch.float32,
                 device="cuda", anelastic=None):
    """Momentum and scalar source-term hook, the equivalent of the
    reference's TLab_Sources_Flow dispatcher (src/physics/tlab_sources.f90):
    buoyancy (the anelastic explicit one with `anelastic`, make_anelastic's
    dict), Coriolis, homogeneous forcing, the wavemaker, infrared
    radiation, sedimentation, chemistry and subsidence.  Returns None when
    no source is active (keeps the RHS free of dead ops).

    The hook, sources(P, state, h1, h2, h3, hs, aux=None), ADDS the terms
    into h1, h2, h3 (nx, ny, nz) and hs (ns, nx, ny, nz) in place -- the
    step passes the rows of its stacked tendency -- and returns them.  The
    wavemaker reads the step's time aux["rtime"].  Attributes:
    ir_field(state, rad=None) and rad_props (the radiation, or None),
    time_dependent, and buoyancy_only / coriolis_only (the isolated terms
    of the pressure decomposition)."""
    dev = _device.resolve(device)
    buo = case.buoyancy
    cor = case.coriolis
    buo_on = buo is not None and buo.type != "none" and any(buo.active)
    cor_on = cor is not None and cor.type != "none"
    explicit = buo_on and buo.type == "explicit" and anelastic is not None
    ini = case.ini

    rad = _radiation_props(ini)
    settling = ini.get_float("Parameters", "Settling", 0.0)
    mic_pars = ini.get_floats("Sedimentation", "Parameters", (1.0,))
    mic = micmod.MicrophysicsProps(
        type=ini.get("Sedimentation", "Type",
                     ini.get("Microphysics", "Type", "none")).lower(),
        # settling folded into the per-scalar parameters at read time
        # (microphysics.f90:96-101)
        parameters=tuple(p * settling for p in mic_pars),
        exponent=ini.get_float("Sedimentation", "Exponent", 0.0))
    sub = forcmod.SubsidenceProps(
        type=ini.get("Subsidence", "Type",
                     ini.get("Main", "TermSubsidence", "none")).lower(),
        divergence=(ini.get_floats("Subsidence", "Parameters", (0.0,))
                    or (0.0,))[0])
    sub_on = sub.type not in ("none", "") and sub.divergence != 0.0

    da_list = ini.get_floats("Parameters", "Damkohler", (1.0,))
    da_list = tuple(da_list) + (da_list[-1],) * max(
        0, len(case.schmidt) - len(da_list))
    chem = chemmod.ChemistryProps(
        type=ini.get("Chemistry", "Type", "none").lower(),
        damkohler=da_list,
        parameters=ini.get_floats("Chemistry", "Parameters", (1.0, 1.0)),
        scalar=ini.get_int("Chemistry", "Scalar", 1) - 1,
        ymean=tuple(getattr(prof, "ymean", 0.0)
                    for prof in (case.scal_profiles or ())))
    rad_on = rad.type != "none"
    mic_on = mic.type != "none" and settling != 0.0
    chem_on = chem.type != "none"

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(dev, dtype)

    if rad_on or mic_on:
        # compact FDM_Int1 tau integrals with the case's y scheme (the
        # reference radiation integrates with fdm_Int0 = FDM_Int1 plans,
        # radiation.f90:414)
        Jt, Jb = radmod.int1_cumulative_matrices(build_deriv_plan(
            grid.y, case.space_order1, case.space_order2))
        Jt, Jb = t(Jt), t(Jb)
    y_dev = t(grid.y.nodes)

    wm = forcmod.wavemaker_from_ini(ini)
    wm_on = wm is not None and bool(wm.amp_x)
    if wm_on:
        wm_env, wm_phases = (t(a) for a in forcmod.wavemaker_fields(wm,
                                                                    grid))
    homog = forcmod.homogeneous_from_ini(ini)
    homog_on = homog is not None and any(abs(f) > 0 for f in homog)

    if not (buo_on or cor_on or rad_on or mic_on or chem_on or sub_on
            or wm_on or homog_on):
        return None

    # linearized stratocumulus mixture (MIXT_TYPE_AIRWATER_LINEAR): the
    # normalized liquid is a DIAGNOSTIC scalar appended to the stack for
    # buoyancy/radiation (reference thermo_airwater.f90:483-516; liquid is
    # scalar inb_scal_array)
    tcfg = case.thermo or {}
    awl_params = tuple(tcfg.get("parameters", ()))
    awl_on = tcfg.get("mixture", "") == "airwaterlinear" and bool(awl_params)

    def augment(s):
        if not awl_on or s.shape[0] == 0:
            return s
        liq = thermo.airwater_linear(awl_params, s)
        return torch.cat([s, liq[None]], dim=0)

    if buo_on and not explicit:
        # bbackground sees a ZERO liquid column for the linear mixture: the
        # reference fills sbackground only for the prognostic scalars before
        # computing bbackground (tlab_background.f90:194-221; the diagnostic
        # column is a fresh allocation, never written in the non-anelastic
        # path), so c3*ql_bg must NOT enter the reference profile.  The zero
        # column is kept in the stack so the independent term stays at
        # parameters(inb_scal_array+1) (gravity.f90:253).
        profs = case.scal_profiles
        if awl_on and profs:
            profs = list(profs) + [lambda yv: np.zeros_like(yv)]
        bback = t(grav.background_profile(buo, profs, grid.y.nodes))

    def buoyancy(s):
        if explicit:
            return thermo.buoyancy_explicit(anelastic["tp"], s,
                                            anelastic["bg"])
        return grav.buoyancy_field(buo, augment(s), bback)

    def liquid(state):
        """(T, liquid, rho_bar): the equilibrium of the anelastic mixture
        (T None otherwise), the linear mixture's liquid or the last
        scalar."""
        if anelastic is not None:
            T, ql = thermo.equilibrium_state(anelastic["tp"], state.s,
                                             anelastic["bg"])
            return T, ql, anelastic["rho"]
        ones = torch.ones_like(y_dev)
        if awl_on:
            return None, thermo.airwater_linear(awl_params, state.s), ones
        return None, state.s[-1], ones

    def compute_ir(state, rad=None, liq=None):
        """IR heating-rate field for the active scalar.  rad: optional
        props override (scaled fluxes for the iniscal NormalizeR
        accumulated-radiation IC, scal_main.f90:120-131); liq: liquid(state)
        where the caller has it."""
        if rad is None:
            rad = compute_ir.props
        T, ql, rho_b = liq if liq is not None else liquid(state)
        if rad.type == "gray" and anelastic is not None:
            qv = state.s[-1] - ql
            a_f = (rad.kappa * ql + rad.kappa_v * qv
                   + rad.kappa_g) * rho_b[None, :, None]
            # emission by the Stefan-Boltzmann law (radiation.f90:292);
            # beta is a unit-override knob (1 for reference cases)
            b_f = rad.beta * radmod.SIGMA * T ** 4
            return radmod.infrared_gray_source(
                rad, y_dev, a_f, b_f, emissivity=rad.emissivity)
        if rad.type == "band" and anelastic is not None:
            qv = state.s[-1] - ql
            nb = rad.nbands
            kt = rad.kappa_table or ((rad.kappa,) * nb,)
            k_l = kt[0]
            k_v = kt[1] if len(kt) > 1 else (0.0,) * nb
            k_c = kt[2] if len(kt) > 2 else (0.0,) * nb
            a_bands = [(k_l[b] * ql + k_v[b] * qv + k_c[b])
                       * rho_b[None, :, None] for b in range(nb)]
            return radmod.infrared_band_source(
                rad, y_dev, a_bands, T, rad.beta_table,
                emissivity=rad.emissivity, bcs_top=rad.bcs_top)
        return radmod.infrared_source(rad, Jt, Jb, ql, rho_b)

    def sources(P, state, h1, h2, h3, hs, aux=None):
        if homog_on:
            # constant body force (channel driving pressure gradient)
            for h, f in zip((h1, h2, h3), homog):
                if abs(f) > 0:
                    h += f
        if wm_on:
            # wavemaker relaxation toward the plane-wave field, phase at
            # the START-of-step rtime exactly as the reference (the
            # dispatcher passes TLab_Time rtime, tlab_sources.f90:115)
            rtime = (aux or {}).get("rtime", 0.0)
            env_l, ph_l = forcmod.localize_wavemaker(wm_env, wm_phases,
                                                     P.get("comm"))
            h1 += forcmod.wavemaker_source(wm, env_l, ph_l, 0, state.u,
                                           rtime)
            h2 += forcmod.wavemaker_source(wm, env_l, ph_l, 1, state.v,
                                           rtime)
        if cor_on:
            r1, r2, r3 = rot.coriolis_tendency(cor, state.u, state.v,
                                               state.w)
            h1 += r1
            h2 += r2
            h3 += r3
        if buo_on:
            b = buoyancy(state.s)
            for h, g in zip((h1, h2, h3), buo.vector):
                if abs(g) > 0:
                    h.add_(b, alpha=g)
        if rad_on or mic_on:
            # liquid water: diagnostic (anelastic airwater) or a scalar
            liq = liquid(state)
            T, ql, rho_b = liq
            if rad_on:
                hs[rad.scalar] += compute_ir(state, liq=liq)
            if mic_on:
                # driving field = diagnostic liquid (last array scalar),
                # rho-weighted in anelastic mode (microphysics.f90:133)
                if anelastic is not None:
                    s_active = ql * rho_b[None, :, None]
                else:
                    s_active = ql
                stat_l = None
                if mic.type == "airwater":
                    stat_l = micmod.liquid_static_energy(
                        anelastic["tp"], state.s[0], T,
                        anelastic["bg"]["ep"][None, :, None])
                for isc in range(state.s.shape[0]):
                    if mic.type == "airwatersimplified":
                        sed = micmod.sedimentation_simplified(
                            mic, P, isc, s_active)
                    else:
                        sed = micmod.sedimentation_airwater(
                            mic, P, isc, state.s, s_active, stat_l)
                    if anelastic is not None:
                        # ribackground weighting of the tendency
                        # (tlab_sources.f90:176-177)
                        sed = sed / rho_b[None, :, None]
                    hs[isc] += sed
        if chem_on:
            # every scalar with nonzero Damkohler receives its reaction
            # source (chemistry.f90:78-81,102-155)
            for isc in chemmod.active_scalars(chem, state.s.shape[0]):
                hs[isc] += chemmod.source(chem, state.s, isc, y_dev)
        if sub_on:
            # ConstantDivergenceLocal is folded into OPR_Burgers_Y in the
            # reference (opr_burgers.f90:336-340), so it acts on EVERY
            # field advected in y: u, v, w and all scalars
            for isc in range(state.s.shape[0]):
                hs[isc].add_(forcmod.subsidence_source(sub, P, y_dev,
                                                       state.s[isc]))
            h1 += forcmod.subsidence_source(sub, P, y_dev, state.u)
            h2 += forcmod.subsidence_source(sub, P, y_dev, state.v)
            h3 += forcmod.subsidence_source(sub, P, y_dev, state.w)
        return h1, h2, h3, hs

    compute_ir.props = rad
    sources.ir_field = compute_ir if rad_on else None
    sources.rad_props = rad if rad_on else None
    sources.time_dependent = wm_on

    # isolated-term closures for the pressure-decomposition menu
    # (FI_PRESSURE_BOUSSINESQ DCMP_CORIOLIS/DCMP_BUOYANCY,
    # fi_pressure_boussinesq.f90:158-190)
    if cor_on:
        def coriolis_only(state):
            return rot.coriolis_tendency(cor, state.u, state.v, state.w)
        sources.coriolis_only = coriolis_only
    if buo_on:
        def buoyancy_only(state):
            b = buoyancy(state.s)
            z = torch.zeros_like(state.u)
            return tuple(g * b if abs(g) > 0 else z for g in buo.vector)
        sources.buoyancy_only = buoyancy_only
    return sources


def grid_from_case(case: CaseSetup) -> Grid:
    axes = []
    for i, d in enumerate("xyz"):
        spec = case.grid_segments[d]
        segs = spec["segments"] if isinstance(spec, dict) else spec
        mirrored = spec.get("mirrored", False) if isinstance(spec, dict) \
            else False
        fixed = spec.get("fixed_scale", -1.0) if isinstance(spec, dict) \
            else -1.0
        if segs and segs[0]["n"] > 1:
            axes.append(build_axis_from_segments(segs, case.periodic[i],
                                                 mirrored=mirrored,
                                                 fixed_scale=fixed))
        else:
            axes.append(make_axis(np.zeros(1), False))
    return Grid(*axes)


COMPRESSIBLE = ("compressible", "total", "internal")


def _nscbc_spec(case: CaseSetup, grid: Grid, aw):
    """The characteristic-boundary spec of a compressible case, or None:
    a Velocity<side>=outflow|inflow side is open (the other a wall); the
    AirWater mixture opens any non-periodic y as outflow, with SigmaOut,
    SigmaInf and BetaTransverse of [BoundaryConditions] (the reference
    applies characteristic BCs there, time.f90:792-796)."""
    from tlab_tpu_torch.dycore.nscbc import NSCBCSpec
    vb = case.velocity_bc
    if any(k in ("outflow", "inflow") for k in vb):
        return NSCBCSpec(
            ymin=vb[0] if vb[0] in ("outflow", "inflow") else "wall",
            ymax=vb[1] if vb[1] in ("outflow", "inflow") else "wall",
            p_inf=1.0 / (case.gamma * case.mach ** 2))
    if aw is None or grid.y.periodic:
        return None
    ini = case.ini

    def key(name):
        return max(ini.get_float("BoundaryConditions", name, -1.0), 0.0) \
            if ini is not None else 0.0
    return NSCBCSpec(ymin="outflow", ymax="outflow", sigma=key("SigmaOut"),
                     cinf=key("SigmaInf"), ctan=key("BetaTransverse"))


def _compressible(case: CaseSetup, grid: Grid, nsp: NSParams, P: dict,
                  dtype, dev) -> dict:
    """The compressible set's context (tlab_tpu's Simulation.comp): the gas,
    the mixture (a combustion table, or the AirWater ThermoParams "aw" in
    compressible units, whose gamma0 replaces the case's), the NSCBC spec,
    the [Control] FlowLimit bounds, the gravity vector, the
    diffusion-number factor, the Euler form and the energy variable; sets
    P["y_periodic"] and the scalar clip P["scal_bounds"]."""
    tcfg = case.thermo or {}
    gas = GasParams(gamma=case.gamma, mach=case.mach,
                    transport=tcfg.get("transport", "none"))
    P["y_periodic"] = grid.y.periodic
    # [BoundaryConditions] ViscousI/J/K are accepted but inert, exactly
    # like the current reference (opr_partial.f90:91 reads column 1 of
    # bcs_inf/bcs_out only): P["visc_bc"] stays unset
    # multi-species mixtures ([Main] Mixture=BS/PETERS1991/...): caloric
    # tables for the combustion families (thermodynamics.f90:217-430)
    mixname = tcfg.get("mixture", "none")
    mixture = None
    if mixname in mixmod.MIXTURES:
        mixture = mixmod.build_mixture(mixname)
    elif mixname == "chemkin" and tcfg.get("chemkin_file"):
        mixture = mixmod.read_chemkin(tcfg["chemkin_file"])
    # moist air with the compressible solver (MIXT_TYPE_AIRWATER +
    # Equations=internal, the Case14 family): ThermoParams in compressible
    # units (RRATIO-scaled R and psat)
    aw = None
    gama = case.gamma
    if mixname == "airwater":
        aw = thermo.compressible_airwater_params(
            mach=case.mach, dsmooth=tcfg.get("smooth", 0.0))
        gama = aw.Cpd_dim / (aw.Cpd_dim - aw.Rd_dim)
        if case.equations != "internal":
            raise NotImplementedError(
                "Mixture=AirWater compressible: internal-energy "
                "formulation only (reference RHS_FLOW_GLOBAL_2)")
    gvec = tuple(case.buoyancy.vector) if case.buoyancy is not None \
        else (0.0, 0.0, 0.0)
    sfactor = (1.0 / case.reynolds) * max(
        1.0, 1.0 / case.prandtl,
        1.0 / min(case.schmidt) if case.schmidt else 1.0)
    # compressible bounds control ([Control] FlowLimit; defaults
    # pbg/rbg mean * 1e-/+6, dns_main.f90:211-214)
    bounds = None
    ctrl = case.control or {}
    if ctrl.get("flow_limit", True):
        ini = case.ini
        p_mean = ini.get_float("Flow", "Pressure",
                               1.0 / (gama * case.mach ** 2)) \
            if ini is not None else 1.0 / (gama * case.mach ** 2)
        r_mean = ini.get_float("Flow", "Density", 1.0) \
            if ini is not None else 1.0
        pmin = ctrl.get("min_pressure", -1.0)
        pmax = ctrl.get("max_pressure", -1.0)
        rmin = ctrl.get("min_density", -1.0)
        rmax = ctrl.get("max_density", -1.0)
        bounds = {"p": (pmin if pmin >= 0 else p_mean * 1e-6,
                        pmax if pmax >= 0 else p_mean * 1e6),
                  "r": (rmin if rmin >= 0 else r_mean * 1e-6,
                        rmax if rmax >= 0 else r_mean * 1e6)}
    if ctrl.get("scal_limit") and nsp.n_scalars:
        # per-substep clipping of the transported scalars (DNS_BOUNDS_LIMIT)
        P["scal_bounds"] = dyn.scalar_bounds(
            ctrl["min_scalar"], ctrl["max_scalar"], dtype, dev)
    return {"gamma": gama, "mach": case.mach, "bounds": bounds,
            "mixture": mixture, "aw": aw, "gvec": gvec,
            "schmidt": case.schmidt[0] if case.schmidt else 1.0,
            "sfactor": sfactor, "prandtl": case.prandtl, "gas": gas,
            "form": ("skewsymmetric" if case.term_advection == "skewsymmetric"
                     else "divergence"),
            "energy": "internal" if case.equations == "internal"
            else "total",
            "nscbc": _nscbc_spec(case, grid, aw),
            "ly": float(grid.y.nodes[-1] - grid.y.nodes[0]),
            "lx": float(grid.x.scale)}


def _staggered_plans(grid: Grid, fdm: FdmPlan, factorized: bool, dtype,
                     dev) -> dict:
    """Plan entries of the horizontally staggered pressure ([Staggering]
    StaggerHorizontalPressure=yes; reference
    tlab_initialize_parameters.f90:112-117): "stag", the dense staggered
    operators along x and z, and the Poisson plan rebuilt on the staggered
    derivative's wavenumbers -- "ell_fac" or, for the direct solver,
    "ell_stag"."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(dev, dtype)

    sd = {}
    nx = grid.x.size
    for k, M in stg.build_stagger_ops(nx, grid.x.scale / nx).items():
        sd[f"{k}x"] = t(M)
    wx = stg.modified_wavenumber(nx, grid.x.scale)
    wz = None
    if grid.z.size > 1:
        nz = grid.z.size
        for k, M in stg.build_stagger_ops(nz, grid.z.scale / nz).items():
            sd[f"{k}z"] = t(M)
        wz_half = stg.modified_wavenumber(nz, grid.z.scale)
        k = np.arange(nz)
        wz = wz_half[np.minimum(k, nz - k)]          # full-fft ordering
    out = {"stag": sd}
    if factorized:
        # the staggered divergence/gradient operators define the modal
        # eigenvalues, and only the (0,0) mode is singular (reference
        # opr_elliptic.f90:144-147)
        out["ell_fac"] = fac.device_factorize_plan(
            fac.build_factorize_plan(fdm, mwn_x=wx, mwn_z=wz), dtype, dev)
    else:
        # eigen pencil (EllipticOrder=compactdirect*); accurate only on y
        # grids with a well-conditioned pencil
        out["ell_stag"] = elliptic.device_elliptic_plan(
            elliptic.build_elliptic_plan(
                fdm, ibc=BC.NN, lam_x=wx ** 2,
                lam_z=None if wz is None else wz ** 2), dtype, dev)
    return out


def _immersed_boundary(case: CaseSetup, grid: Grid, dtype, dev):
    """[IBMParameter]/[IBMGeometry]: the plan's "ibm" entry (solid mask and
    spline fills), or None with Status=off (reference IBM_READ_INI +
    IBM_INITIALIZE_GEOMETRY, ibm_read.f90:47-127; tlab_tpu/runtime.py:
    614-649)."""
    ini = case.ini
    if ini is None or ini.get("IBMParameter", "Status",
                              "off").lower() != "on":
        return None
    gtype = ini.get("IBMGeometry", "Type", "xbars").lower()
    if gtype in ("xbars", "bars"):
        eps = ibmmod.geometry_xbars(
            grid, ini.get_int("IBMGeometry", "Number", 1),
            ini.get_int("IBMGeometry", "Height", 4),
            ini.get_int("IBMGeometry", "Width", 4),
            mirrored=ini.get_bool("IBMGeometry", "Mirrored", False))
    elif gtype == "hill":
        eps = ibmmod.geometry_hill(
            grid, ini.get_float("IBMGeometry", "Height", 0.1),
            ini.get_float("IBMGeometry", "Width", 0.2),
            ini.get_float("IBMGeometry", "Center", 0.5 * grid.x.scale))
    elif gtype == "valley":
        eps = ibmmod.geometry_valley(
            grid, ini.get_int("IBMGeometry", "Height", 4),
            ini.get_int("IBMGeometry", "Alpha", 1))
    else:
        raise ValueError(f"[IBMGeometry] Type={gtype!r} unknown")
    eps = np.asarray(eps, float)
    with _trace.trace("immersed boundary fills"):
        ib = ibmmod.build_ibm(eps, dtype=dtype, device=dev)
        ib["fills"] = ibmmod.build_ibm_spline(eps, grid, dtype=dtype,
                                              device=dev)
    return ib


@dataclasses.dataclass
class Simulation:
    case: CaseSetup
    grid: Grid
    fdm: FdmPlan
    nsp: NSParams
    P: dict                      # dycore device plans
    ell_plans: dict              # BC -> direct eigen Poisson plan on device
    dtype: torch.dtype
    device: torch.device
    # make_anelastic's background where the thermodynamics are anelastic
    # ([Thermodynamics] Type=anelastic or Equations=anelastic), else None
    anelastic: Optional[dict] = None
    # (amp, filter) of [BufferZone] Type=filter|both, set by attach_buffer
    filter_sponge: object = None
    # the compressible set's context (_compressible), else None
    comp: Optional[dict] = None

    @classmethod
    @_trace.trace("runtime.from_case")
    def from_case(cls, case_or_path, dtype=torch.float32, device="cuda",
                  grid: Optional[Grid] = None,
                  banded_min_n: Optional[int] = None) -> "Simulation":
        """The simulation of a case file (or CaseSetup).  A long line takes
        the substructured operators (dycore.incompressible.
        build_device_plans): from TLAB_TPU_THOMAS_MIN_N points between
        walls and TLAB_TPU_PARTITION_MIN_N periodic (2304 when unset), or
        from `banded_min_n` points for both where it is given."""
        case = case_or_path if isinstance(case_or_path, CaseSetup) \
            else load_case(case_or_path)
        consistency_check(case)
        dev = _device.resolve(device)
        if grid is None:
            grid = grid_from_case(case)
        with _trace.trace("runtime.fdm_plan"):
            fdm = build_fdm_plan(grid, case.space_order1, case.space_order2)
        nsp = NSParams(reynolds=case.reynolds, schmidt=tuple(case.schmidt),
                       prandtl=case.prandtl, froude=case.froude,
                       rossby=case.rossby)
        scal_bcs = tuple(
            (b if b in ("dirichlet", "neumann") else "dirichlet",
             t if t in ("dirichlet", "neumann") else "dirichlet")
            for b, t in case.scalar_bc)
        bcs = dyn.WallBCs.from_velocity_kind(case.velocity_bc[0],
                                             case.velocity_bc[1],
                                             scalar_bcs=scal_bcs)
        # Dirichlet wall reference values = mean velocity profile at the
        # walls (reference BcsFlowJmin/Jmax%ref)
        yw = np.asarray([grid.y.nodes[0], grid.y.nodes[-1]])
        wall_refs = {
            "u": tuple(float(v) for v in case.vel_profiles[0](yw)),
            "v": (0.0, 0.0),
            "w": tuple(float(v) for v in case.vel_profiles[2](yw)),
        }
        if case.equations in COMPRESSIBLE:
            # no pressure Poisson, acoustic integration (reference
            # DNS_EQNS_TOTAL/INTERNAL); the Poisson solves of the initial
            # conditions build their plans at first use
            with _trace.trace("runtime.device_plans"):
                P = dyn.build_device_plans(
                    fdm, nsp, bcs, rk_name=case.time_order, dtype=dtype,
                    device=dev, wall_refs=wall_refs, with_elliptic=False,
                    **dyn.banded_crossovers(banded_min_n))
            with _trace.trace("runtime.tables"):
                comp = _compressible(case, grid, nsp, P, dtype, dev)
            return cls(case=case, grid=grid, fdm=fdm, nsp=nsp, P=P,
                       ell_plans={}, dtype=dtype, device=dev, comp=comp)
        # EllipticOrder: the factorized formulation is the default (as the
        # reference): its D1-consistent integrals make the projection
        # remove the D1-measured divergence to round-off. The direct eigen
        # pencil (EllipticOrder=compactdirect4/6) leaves the D1^2-vs-D2
        # truncation mismatch as residual divergence at grid scales --
        # O(1) on noisy fields.
        factorized = case.elliptic_order in FACTORIZED_ORDERS \
            and grid.y.size > 4
        # anelastic THERMODYNAMICS are independent of the momentum set:
        # [Thermodynamics] Type=anelastic with Equations=incompressible is
        # the reference's Boussinesq + moist-thermo combination; only
        # Equations=anelastic also weights the dycore by rho_bar
        # (P["anelastic"] below)
        with _trace.trace("runtime.tables"):
            anelastic = make_anelastic(case, grid, dtype, dev) \
                if (case.equations == "anelastic"
                    or (case.thermo or {}).get("type", "").lower()
                    == "anelastic") else None
            bodyforce = make_sources(case, grid, dtype, dev,
                                     anelastic=anelastic)
        with _trace.trace("runtime.device_plans"):
            P = dyn.build_device_plans(
                fdm, nsp, bcs, rk_name=case.time_order, dtype=dtype,
                device=dev, wall_refs=wall_refs, bodyforce=bodyforce,
                factorize=factorized and not case.stagger,
                **dyn.banded_crossovers(banded_min_n))
        # [Main] TermAdvection selects the nonlinear formulation
        # (reference rhs_flow_global_incompressible_1/2/3.f90); the
        # anelastic set is combined-convective only, as the reference
        if case.term_advection in ("divergence", "skewsymmetric") \
                and case.equations != "anelastic":
            P["adv_form"] = case.term_advection
        if case.equations == "anelastic":
            P["anelastic"] = {"rho": anelastic["rho"],
                              "rho_inv": anelastic["rho_inv"]}
        # [Main] TermDivergence=none drops the q/dte residual-divergence
        # term from the projection forcing (dns_read_local.f90:79-83)
        if case.ini is not None and case.ini.get(
                "Main", "TermDivergence", "remove").lower() == "none":
            P["remove_divergence"] = False
        pf = case.pressure_filter
        if pf is not None and pf.type != "none":
            if pf.type == "helmholtz":
                # marker dict: the projection routes it through the eigen
                # Helmholtz solve
                width = pf.parameters[0] if pf.parameters else 2.0
                P["pfilter"] = {
                    "helmholtz_alpha": -24.0 / max(width, 1e-30) ** 2}
            else:
                P["pfilter"] = filt.build_filter_matrices(fdm, pf, dtype,
                                                          dev)
        if case.stagger:
            P.update(_staggered_plans(grid, fdm, factorized, dtype, dev))
        if case.dealias is not None and case.dealias.type != "none":
            P["dealias"] = filt.build_filter_matrices(fdm, case.dealias,
                                                      dtype, dev)
        ctrl = case.control or {}
        if ctrl.get("scal_limit") and nsp.n_scalars:
            P["scal_bounds"] = dyn.scalar_bounds(
                ctrl["min_scalar"], ctrl["max_scalar"], dtype, dev)
        ibm = _immersed_boundary(case, grid, dtype, dev)
        if ibm is not None:
            P["ibm"] = ibm
        sfc = case.surface_bc or ()
        if any(d["jmin"] == "linear" or d["jmax"] == "linear" for d in sfc):
            # interactive surface BC (reference BOUNDARY_BCS_SURFACE_Y)
            P["surface_bc"] = {
                "cpl_jmin": tuple(
                    d["cpl_jmin"] if d["jmin"] == "linear" else 0.0
                    for d in sfc),
                "cpl_jmax": tuple(
                    d["cpl_jmax"] if d["jmax"] == "linear" else 0.0
                    for d in sfc)}
        sim = cls(case=case, grid=grid, fdm=fdm, nsp=nsp, P=P,
                  ell_plans={BC.NN: P["ell"]}, dtype=dtype, device=dev,
                  anelastic=anelastic)
        if "diffusion" in case.time_order.lower():
            # the Dirichlet pencil of the semi-implicit step's Helmholtz
            # solves (a no-slip wall, v, a Dirichlet scalar); tlab_tpu builds
            # it for every case, the explicit steps never read it (and
            # implicit._plan_for raises where a plan lacks it)
            P["ell_dd"] = sim.ell(BC.DD)
        return sim

    # -- optional subsystems ------------------------------------------------
    def attach_buffer(self, state: State) -> None:
        """Build sponge-zone relaxation data with reference profiles taken
        from the given (initial) state, reference
        BOUNDARY_BUFFER_INITIALIZE: P["buffer"] for Type=relaxation|both,
        self.filter_sponge for Type=filter|both."""
        spec = self.case.buffer
        if spec is None or spec.type == "none":
            return

        def profile(a):                       # the plane mean, (ny,)
            return torch.mean(a, dim=(0, 2))

        refs = {"u": profile(state.u), "v": profile(state.v),
                "w": profile(state.w)}
        for i in range(state.s.shape[0]):
            refs[f"s{i}"] = profile(state.s[i])
        # spatial mode: Imin/Imax strips relax toward the inflow-plane state
        x = self.grid.x.nodes if self.case.flow_type == "spatial" else None
        ref_inflow = None
        if x is not None:
            ref_inflow = {"u": torch.mean(state.u[0], dim=1),
                          "v": torch.mean(state.v[0], dim=1),
                          "w": torch.mean(state.w[0], dim=1)}
            for i in range(state.s.shape[0]):
                ref_inflow[f"s{i}"] = torch.mean(state.s[i][0], dim=1)
        if spec.type in ("relaxation", "both"):
            self.P["buffer"] = bufmod.build_buffer(
                self.grid.y.nodes, spec, refs, self.dtype, x=x,
                ref_inflow=ref_inflow, device=self.device)
        if spec.type in ("filter", "both"):
            # filter-type sponge (reference BOUNDARY_BUFFER_FILTER, stubbed
            # there; tlab_tpu's working blend): post-step blend toward the
            # filtered state
            mats = self.filter_matrices() or filt.build_filter_matrices(
                self.fdm, filt.FilterSpec(type="explicit6"), self.dtype,
                self.device)
            amp = bufmod.filter_sponge_amp(
                self.grid.x.nodes, spec.points_imin, spec.points_imax,
                self.dtype, self.device)
            self.filter_sponge = (amp, mats)

    def attach_buffer_compressible(self, U) -> None:
        """Compressible buffer zones and the characteristic-BC reference
        states (BOUNDARY_BUFFER_INITIALIZE with RELAX_BLOCK_CF semantics +
        boundary_bcs.f90:224-287): self.comp["buffer"] relaxes the
        CONSERVATIVE fields toward their plane-mean initial profiles, and
        with AirWater the y NSCBC reference state of each side is the
        buffer mean at its wall row (T, ql from airwater_re in float64,
        p from thermal_pressure)."""
        spec = self.case.buffer
        if spec is None or spec.type not in ("relaxation", "both"):
            return
        if not (spec.points_jmin > 1 or spec.points_jmax > 1):
            return
        tau = bufmod.tau_profile(self.grid.y.nodes, spec)

        def profile(a):                       # the plane mean, (ny,)
            return torch.mean(a, dim=(0, 2))

        refs = {"rho": profile(U.rho), "rhou": profile(U.rhou),
                "rhov": profile(U.rhov), "rhow": profile(U.rhow),
                "rhoE": profile(U.rhoE)}
        if U.rhos is not None:
            for i in range(U.rhos.shape[0]):
                refs[f"rs{i}"] = profile(U.rhos[i])
        self.comp["buffer"] = {
            "tau": torch.as_tensor(np.asarray(tau, np.float64)).to(
                self.device, self.dtype)[None, :, None],
            "refs": {k: v[None, :, None] for k, v in refs.items()}}
        nscbc, aw = self.comp.get("nscbc"), self.comp.get("aw")
        if nscbc is None or aw is None:
            return
        # one host read of the wall rows of the plane means
        names = ["rho", "rhov", "rhou", "rhow", "rhoE"] \
            + (["rs0"] if "rs0" in refs else [])
        walls = torch.stack([refs[n][[0, -1]] for n in names]).to(
            "cpu", torch.float64)
        sides = {}
        for k, side in enumerate(("refs_ymin", "refs_ymax")):
            r0 = float(walls[0, k])
            un0, v10, v20, e0, *qt = (float(walls[i, k]) / r0
                                      for i in range(1, len(names)))
            qt0 = qt[0] if qt else 0.0
            T0, ql0, _ = thermo.airwater_re(
                aw, torch.tensor(qt0, dtype=torch.float64),
                torch.tensor(e0, dtype=torch.float64),
                torch.tensor(r0, dtype=torch.float64))
            p0 = float(thermo.thermal_pressure(aw, qt0, float(ql0), r0,
                                               float(T0)))
            sides[side] = (r0, un0, v10, v20, p0, qt0)
        self.comp["nscbc"] = dataclasses.replace(nscbc, **sides)

    def filter_matrices(self):
        """The [Filter] of the case as apply_filter takes it (matrices, or
        the Helmholtz filter's function), or None."""
        spec = self.case.filter
        if spec is None or spec.type == "none":
            return None
        if spec.type == "helmholtz":
            width = spec.parameters[0] if spec.parameters else 2.0
            # zero-gradient walls preserve the field at the boundary
            return filt.build_helmholtz_filter(self.P["ell"], width)
        return filt.build_filter_matrices(self.fdm, spec, self.dtype,
                                          self.device)

    # -- convenience ops (the initial conditions' vector calculus) ----------
    def zero_state(self) -> State:
        nx, ny, nz = self.grid.shape
        kw = {"dtype": self.dtype, "device": self.device}
        return State(u=torch.zeros((nx, ny, nz), **kw),
                     v=torch.zeros((nx, ny, nz), **kw),
                     w=torch.zeros((nx, ny, nz), **kw),
                     s=torch.zeros((self.nsp.n_scalars, nx, ny, nz), **kw))

    def ell(self, bc):
        """Direct eigen Poisson plan for the given wall BC, built at first
        use (the Neumann one is the step's P["ell"])."""
        if bc not in self.ell_plans:
            plan = elliptic.build_elliptic_plan(self.fdm, ibc=bc)
            self.ell_plans[bc] = elliptic.device_elliptic_plan(
                plan, self.dtype, self.device)
        return self.ell_plans[bc]

    def curl(self, u, v, w):
        dy_w = dyn._d1(self.P, "y", 1, w)
        dz_v = dyn._d1(self.P, "z", 2, v)
        dz_u = dyn._d1(self.P, "z", 2, u)
        dx_w = dyn._d1(self.P, "x", 0, w)
        dx_v = dyn._d1(self.P, "x", 0, v)
        dy_u = dyn._d1(self.P, "y", 1, u)
        return dy_w - dz_v, dz_u - dx_w, dx_v - dy_u

    def poisson_ref(self, bc, f):
        """The Poisson solve the reference's OPR_Poisson pointer resolves
        to, with homogeneous walls of kind `bc` (BC.NN or BC.DD): the
        factorized formulation when active (the default), else the direct
        eigen pencil.  The initial conditions share it with the dycore
        (flow_local.f90:315-337, fi_vectorcalculus.f90:94)."""
        dev = self.P.get("ell_fac") or self.P.get("ell_fac_ic")
        if dev is None and self.case.elliptic_order in FACTORIZED_ORDERS \
                and self.grid.y.size > 4 and self.grid.x.periodic:
            # the compressible set has no Poisson plan: the initial
            # conditions' factorized one is built at first use
            dev = fac.device_factorize_plan(
                fac.build_factorize_plan(self.fdm), self.dtype, self.device)
            self.P["ell_fac_ic"] = dev
        if dev is not None:
            p, _ = fac.poisson_factorize(dev, f,
                                         ibc="nn" if bc == BC.NN else "dd")
            return p
        return elliptic.poisson(self.ell(bc), f)

    def solenoidal(self, u, v, w):
        """Remove dilatation: u += grad(phi), lap(phi) = -div(u)
        (cf. reference FI_SOLENOIDAL, fi_vectorcalculus.f90:72-106);
        the y-correction uses OPR_Partial_Y (D1), not the stage dpdy."""
        div = dyn.divergence(self.P, u, v, w)
        phi = self.poisson_ref(BC.NN, -div)
        u = u + dyn._d1(self.P, "x", 0, phi)
        v = v + dyn._d1(self.P, "y", 1, phi)
        w = w + dyn._d1(self.P, "z", 2, phi)
        return u, v, w
