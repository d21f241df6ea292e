"""Offline post-processing over saved snapshots: averages.x / pdfs.x /
spectra.x / superlayer equivalents (reference src/tools/statistics; port of
tlab_tpu/tools/postprocess.py).

Each function loops over a snapshot iteration list, reads the restart
fields onto the simulation's device, computes there, and writes analysis
files: averages.x, spectra.x, pdfs.x, visuals.x (run_visuals), apriori.x
(run_apriori) and the superlayer tools.

Each run_* takes debug_nans=False: the NaN trap (utils/nantrap.py) over
its work, each snapshot's computation one region.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from tlab_tpu_torch import mappings
from tlab_tpu_torch.convert import state_from_numpy
from tlab_tpu_torch.dycore import incompressible as dyn
from tlab_tpu_torch.dycore.pressure import pressure_boussinesq
from tlab_tpu_torch.io import fields_io
from tlab_tpu_torch.io import reference_formats as rf
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.stats import averages, pdfs, spectra
from tlab_tpu_torch.utils import nantrap


def _debug_nans(fn):
    """fn with the keyword debug_nans=False: the NaN trap over its work."""
    @functools.wraps(fn)
    def run(*args, debug_nans: bool = False, **kwargs):
        with nantrap.trap(debug_nans):
            return fn(*args, **kwargs)
    return run


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _host_table(table: dict) -> dict:
    """A dict of (ny,) device columns as NumPy, through one copy."""
    return averages.to_host(table, [])[0]


def load_snapshot(sim: Simulation, outdir: str, itime: int):
    """(State, rtime): PRIMITIVE fields for either solver family.

    Compressible restarts (flow.<it>.1-5 conservative fields, reference
    inb_flow=5) are converted to primitive velocities/scalars so every
    postprocessor below works on both; the thermodynamic fields are
    available via comp_fields()."""
    if sim.comp is not None:
        from tlab_tpu_torch.dycore.compressible import primitive_view
        U, rtime = _load_comp(sim, outdir, itime)
        return primitive_view(U), rtime
    u, v, w, s, rtime, _ = fields_io.read_state(
        os.path.join(outdir, "flow"), os.path.join(outdir, "scal"),
        itime, sim.nsp.n_scalars)
    # C order, as the run's own state: the reductions then sum in its
    # order, and a snapshot's tables equal the run's in-run ones
    return state_from_numpy(*(np.ascontiguousarray(a) for a in (u, v, w, s)),
                            sim.device, sim.dtype), rtime


def _load_comp(sim: Simulation, outdir: str, itime: int):
    from tlab_tpu_torch.dycore.compressible import CompState
    U, rtime, _ = fields_io.read_comp_state(os.path.join(outdir, "flow"),
                                            itime)
    return CompState(*(None if a is None else torch.as_tensor(a).to(
        sim.device, sim.dtype) for a in U)), rtime


def comp_fields(sim: Simulation, U):
    """(rho, T, p [, ql]) primitive thermodynamics of a compressible
    restart (FI_DIAGNOSTIC: THERMO_CALORIC_TEMPERATURE +
    THERMO_THERMAL_PRESSURE)."""
    from tlab_tpu_torch.dycore import compressible as comp_mod
    c = sim.comp
    if c.get("aw") is not None:
        u, v, w, T, p, ql, _ = comp_mod.primitive_airwater(U, c["aw"])
        return U.rho, T, p, ql
    fn = comp_mod.primitive if c["energy"] == "total" \
        else comp_mod.primitive_internal
    prim = fn(sim.P, U, c["gamma"], c["mach"], mix=c.get("mixture"))
    return U.rho, prim[3], prim[4], None


# reference file names of the ParamAverages analysis modes
# (averages.f90:561-959)
_MODE_FILES = {3: "avgMom", 4: "avgMain", 5: "avgW2", 6: "avgS2",
               7: "avgG2", 8: "avgInv", 9: "avgGi", 10: "avgEig",
               11: "avgCos", 12: "avgDer", 13: "avgFluxY", 14: "avgP",
               15: "avgEps", 16: "avgSiCov", 17: "avgPV"}


@_debug_nans
def run_averages(sim: Simulation, outdir: str, iterations,
                 gate_scalar: int = 0, gate_level: float = 0.0) -> None:
    """Plane-averaged statistics tables; gate_scalar>0 additionally writes
    gate-conditioned statistics and the intermittency profile, gated on
    scalar #gate_scalar exceeding gate_level (reference averages.f90
    conditional analysis, igate/gate_level).

    The diagnostic pressure is solved once a snapshot and serves the flow
    table and every scalar table (tlab_tpu solves it again for each
    scalar table; the numbers are the same)."""
    if sim.comp is not None:
        # compressible branch: the dns-side Favre table writer consumes
        # the conservative state directly (avg_flow_xz.f90 compressible)
        from tlab_tpu_torch.tools.dns import write_statistics_compressible
        for it in iterations:
            U, rtime = _load_comp(sim, outdir, it)
            write_statistics_compressible(sim, U, outdir, it, rtime)
        return
    y = sim.grid.y.nodes
    wr = averages.avg_writer(sim.case)
    pvec = sim.case.ini.get_floats("PostProcessing", "ParamAverages", ())
    mode = int(pvec[0]) if pvec else 0

    def tables(it):
        """(rtime, flow, [scalar tables], {file prefix: extra table}) of
        snapshot `it`, as NumPy columns."""
        st, rtime = load_snapshot(sim, outdir, it)
        p = pressure_boussinesq(sim.P, st)
        extras = averages.build_extras(sim, st)
        flow = averages.flow_statistics(sim.P, st, sim.nsp.visc, p=p,
                                        extras=extras)
        scals = [averages.scalar_statistics(
            sim.P, st, sim.nsp.diffusivity(i), i, p=p, visc=sim.nsp.visc,
            extras=extras) for i in range(sim.nsp.n_scalars)]
        more = {}
        if gate_scalar > 0:
            gate = st.s[gate_scalar - 1] > gate_level
            more["cavg"] = _host_table(
                averages.conditional_flow_statistics(sim.P, st, gate))
            more["int"] = _host_table(
                {"gamma": averages.intermittency(gate)})
        # [PostProcessing] ParamAverages analysis modes (reference
        # averages.f90:150-204: mode 1/2 are the tables above; 3-17 are
        # the specialised budgets/diagnostics in stats.analysis)
        if mode >= 3:
            from tlab_tpu_torch.stats import analysis
            more[_MODE_FILES[mode]] = _host_table(analysis.run_mode(
                sim.P, st, sim.nsp.visc, mode,
                diff=[sim.nsp.diffusivity(i)
                      for i in range(sim.nsp.n_scalars)]))
        return (rtime, *averages.to_host(flow, scals), more)

    for it in iterations:
        rtime, flow, scals, more = nantrap.region("averages", tables)(it)
        wr(os.path.join(outdir, f"avg{it}"), y, flow, averages.FLOW_GROUPS,
           it, rtime)
        sgroups = averages.scal_groups(len(scals))
        for i, sc in enumerate(scals):
            wr(os.path.join(outdir, f"avg{it}s{i + 1}"), y, sc, sgroups, it,
               rtime)
        for prefix, tab in more.items():
            averages.write_table(os.path.join(outdir, f"{prefix}{it}"), y,
                                 tab, it, rtime)


def _snapshot_fields(sim, st):
    comps = {"u": st.u, "v": st.v, "w": st.w}
    for i in range(sim.nsp.n_scalars):
        comps[f"s{i + 1}"] = st.s[i]
    return comps


@_debug_nans
def run_spectra(sim: Simulation, outdir: str, iterations,
                cross: bool = False, correlations: bool = False,
                y_blocks: int = 0) -> None:
    """xsp/zsp/rsp auto-spectra of u,v,w,s in the REFERENCE binary format
    (spectra.f90:730-787 + IO_Write_Subarray: float32 (nk, ny) files named
    xsp<it>.E<ab>, holding HALF the folded spectrum, as
    scripts/python/PlotSpectra.py consumes); cross=True adds pair
    cross-spectra with pow/pha decomposition; correlations=True writes
    xcr/zcr two-point correlations (xcr<it>.C<ab>); y_blocks>0 writes the
    2-D (kx,kz) spectral density averaged in y blocks (opt_block)."""
    def tag(name):
        # reference tag_var: scalars are numbered (spectra.f90:473)
        return name[1:] if name.startswith("s") else name

    nx = sim.grid.x.size
    nz = sim.grid.z.size

    def files(it):
        """[(kind, tag, NumPy table)] of snapshot `it`, and the 2-D
        spectra {field name: table}."""
        st, _ = load_snapshot(sim, outdir, it)
        comps = _snapshot_fields(sim, st)
        out, sp2d = [], {}
        for name, a in comps.items():
            t2 = tag(name) + tag(name)
            ex = _np(spectra.spectrum_x(a))
            out.append(("xsp", "E" + t2, 0.5 * ex[: nx // 2]))
            if nz > 1:
                ez = _np(spectra.spectrum_z(a))
                out.append(("zsp", "E" + t2, 0.5 * ez[: nz // 2]))
                er = spectra.radial_spectrum(a, sim.grid.x.scale,
                                             sim.grid.z.scale)
                nk = min(nx // 2, nz // 2)
                rsp = np.zeros((nk, er.shape[1]), er.dtype)
                rsp[: min(nk, er.shape[0])] = er[: nk]
                out.append(("rsp", "E" + t2, 0.5 * rsp))
            if correlations:
                cx = _np(spectra.correlation_x(a))
                out.append(("xcr", "C" + t2, cx[: nx // 2]))
                if nz > 1:
                    cz = _np(spectra.correlation_z(a))
                    out.append(("zcr", "C" + t2, cz[: nz // 2]))
            if y_blocks > 0:
                sp2d[name] = _np(spectra.spectrum_2d(a, y_blocks=y_blocks))
        if cross:
            names = list(comps)
            pairs = [("u", "v"), ("u", "w"), ("v", "w")] + \
                [("v", n) for n in names if n.startswith("s")]
            for na, nb in pairs:
                tp = tag(na) + tag(nb)
                ex = _np(spectra.spectrum_x(comps[na], comps[nb]))
                out.append(("xsp", "E" + tp, 0.5 * ex[: nx // 2]))
                power, phase = spectra.cross_phase_x(comps[na], comps[nb])
                out.append(("pow", "E" + tp, _np(power)[: nx // 2]))
                out.append(("pha", "E" + tp, _np(phase)[: nx // 2]))
                if correlations:
                    cx = _np(spectra.correlation_x(comps[na], comps[nb]))
                    out.append(("xcr", "C" + tp, cx[: nx // 2]))
        return out, sp2d

    for it in iterations:
        out, sp2d = nantrap.region("spectra", files)(it)
        for kind, t, a in out:
            rf.write_spectrum_file(outdir, kind, it, t, a)
        for name, e2 in sp2d.items():
            np.savez(os.path.join(outdir, f"sp2d{it}.{name}.npz"), e=e2,
                     itime=it)


@_debug_nans
def run_pdfs(sim: Simulation, outdir: str, iterations, nbins=32) -> None:
    """pdfs.x equivalent: [PostProcessing] ParamPdfs = mode, block,
    gate_level, nbins1[, nbins2] (pdfs.f90:130-173); default mode 1
    (main variables).  Outputs in the reference pdf binary layout.  An
    incompressible snapshot gets one diagnostic pressure solve."""
    pvec = sim.case.ini.get_floats("PostProcessing", "ParamPdfs", ())
    opt_main = int(pvec[0]) if pvec else 1
    gate_level = float(pvec[2]) if len(pvec) > 2 else 0.0
    nb = (int(pvec[3]) if len(pvec) > 3 else nbins,
          int(pvec[4]) if len(pvec) > 4 else
          (int(pvec[3]) if len(pvec) > 3 else nbins))

    def fields(it):
        st, rtime = load_snapshot(sim, outdir, it)
        pres = pressure_boussinesq(sim.P, st) if sim.comp is None else None
        return st, rtime, pres, pdfs.mode_fields(sim, st, pres, opt_main)

    for it in iterations:
        st, rtime, pres, mode = nantrap.region("pdfs", fields)(it)
        pdfs.run_pdf_mode(sim, st, pres, outdir, it, float(rtime),
                          opt_main=opt_main, nbins=nb,
                          gate_level=gate_level, fields=mode)


@_debug_nans
def run_apriori(sim: Simulation, outdir: str, iterations) -> None:
    """apriori.x equivalent: [PostProcessing] ParamStructure = 1 (the
    subgrid-stress profiles tau<it> and the Smagorinsky study sgs<it>) or
    2 (filtered velocity derivatives, gradU<it>) using the [Filter] domain
    filter as the test filter (apriori.f90:156-340); without an active
    [Filter], the compact 0.49 filter in every direction (the reference's
    apriori.x requires one)."""
    from tlab_tpu_torch.ops.filter import FilterSpec, build_filter_matrices
    from tlab_tpu_torch.tools import apriori as ap
    pvec = sim.case.ini.get_floats("PostProcessing", "ParamStructure", (1,))
    mode = int(pvec[0]) if pvec else 1
    mats = sim.filter_matrices()
    if mats is None:
        spec = sim.case.filter
        if spec is None or spec.type == "none":
            spec = FilterSpec(type="compact", parameters=(0.49,),
                              active=(True, True, True), step=0)
        mats = build_filter_matrices(sim.fdm, spec, sim.dtype, sim.device)
    dx = sim.grid.x.scale / max(sim.grid.x.size, 1)
    y = sim.grid.y.nodes

    def tables(it):
        """(rtime, {file prefix: NumPy table}) of snapshot `it`."""
        st, rtime = load_snapshot(sim, outdir, it)
        if mode == 2:
            return rtime, {"gradU": _host_table(
                ap.filtered_gradients(sim.P, mats, st))}
        # reference tau<it> table: plane profiles of the six subgrid
        # stresses tagged Tauxx..Tauyz (apriori.f90:248-295 AVG_N_XZ)
        tau, _ = ap.subgrid_stress(mats, st.u, st.v, st.w)
        tab = {"Tau" + b: averages._pavg(tau[a]) for a, b in
               (("uu", "xx"), ("vv", "yy"), ("ww", "zz"),
                ("uv", "xy"), ("uw", "xz"), ("vw", "yz"))}
        del tau
        # the Smagorinsky-coefficient study in a side table
        return rtime, {"tau": _host_table(tab), "sgs": _host_table(
            ap.apriori_statistics(sim.P, mats, st, delta=2.0 * dx))}

    for it in iterations:
        rtime, tabs = nantrap.region("apriori", tables)(it)
        for prefix, tab in tabs.items():
            averages.write_table(os.path.join(outdir, f"{prefix}{it}"), y,
                                 tab, it, float(rtime))


def subdomain_slices(sim):
    """[PostProcessing] Subdomain=i0,i1,j0,j1,k0,k1 (1-based inclusive,
    reference REDUCE_BLOCK_INPLACE consumption, visuals.f90:274-292);
    None when absent/incomplete."""
    vec = sim.case.ini.get_floats("PostProcessing", "Subdomain", ())
    if len(vec) < 6:
        return None
    i = [int(v) for v in vec[:6]]
    return (slice(i[0] - 1, i[1]), slice(i[2] - 1, i[3]),
            slice(i[4] - 1, i[5]))


def _get_ane(sim, box: dict):
    """Anelastic background, built once per tool invocation (the
    hydrostatic integration is iteration-independent)."""
    if "ane" not in box:
        from tlab_tpu_torch import runtime as rt
        box["ane"] = rt.make_anelastic(sim.case, sim.grid, sim.dtype,
                                       sim.device)
    return box["ane"]


def _visual_buoyancy(sim, st, box: dict):
    """b(s)/Froude as visuals.f90 evaluates it (741-747): the anelastic
    Thermo_Anelastic_BUOYANCY for Type=explicit, Gravity_Buoyancy with a
    zero reference otherwise, zeros when no [BodyForce] is active."""
    from tlab_tpu_torch.physics import thermo as th
    from tlab_tpu_torch.physics.gravity import buoyancy_field
    props = sim.case.buoyancy
    froude = getattr(sim.nsp, "froude", 1.0) or 1.0
    if props is None or props.type == "none":
        return torch.zeros_like(st.u)
    if props.type == "explicit":
        ane = _get_ane(sim, box)
        return th.buoyancy_explicit(ane["tp"], st.s, ane["bg"]) / froude
    ref = st.u.new_zeros(sim.grid.y.size)
    return buoyancy_field(props, st.s, ref) / froude


def _anelastic_liquid(sim, st, box: dict):
    """The diagnostic liquid slot s(:, inb_scal+1) for the anelastic
    mixtures: prognostic when Damkohler>0 (3-scalar non-equilibrium),
    else airwater equilibrium / the airwaterlinear closure."""
    from tlab_tpu_torch.physics import thermo as th
    tcfg = sim.case.thermo or {}
    if tcfg.get("mixture", "") == "airwaterlinear" \
            and tcfg.get("parameters"):
        return th.airwater_linear(tuple(tcfg["parameters"]), st.s)
    if st.s.shape[0] > 2:
        return st.s[2]
    ane = _get_ane(sim, box)
    return th.diagnostic_fields(ane["tp"], st.s[:2], ane["bg"])["ql"]


def _plane_fluct(a):
    """a minus its (x,z)-plane mean."""
    return a - a.mean(dim=(0, 2))[None, :, None]


def _file_set(name: str, st, P, visc, pressure):
    """(file name suffix, field) of a vector or tensor name's file set,
    or None for a scalar name; `pressure()` solves the diagnostic
    pressure."""
    if name == "ScalarGradientVector":
        return [("G" + t, dyn._d1(P, t, ax, st.s[0]))
                for ax, t in enumerate("xyz")]
    if name == "Vorticity":
        return list(zip(("Wx", "Wy", "Wz"), mappings.curl(P, st.u, st.v,
                                                          st.w)))
    if name == "VelocityVector":
        # three-component file set (visuals.f90:495-498, IO_WRITE_VISUALS
        # nfield=3 -> per-component subarrays)
        return [(f"VelocityVector{i}", c)
                for i, c in enumerate((st.u, st.v, st.w), 1)]
    if name == "VorticityVector":
        # FI_CURL components (visuals.f90:725-727)
        return [(f"VorticityVector{i}", c) for i, c in
                enumerate(mappings.curl(P, st.u, st.v, st.w), 1)]
    if name == "StrainTensor":
        # FI_STRAIN_TENSOR order Sxx,Syy,Szz,Sxy,Sxz,Syz
        # (fi_strain.f90:29-63; visuals.f90:776-779)
        g = mappings.velocity_gradient(P, st.u, st.v, st.w)
        comps = (g["ux"], g["vy"], g["wz"], 0.5 * (g["uy"] + g["vx"]),
                 0.5 * (g["uz"] + g["wx"]), 0.5 * (g["vz"] + g["wy"]))
        return [(f"StrainTensor{i}", c) for i, c in enumerate(comps, 1)]
    if name == "StressTensor":
        # 2 visc S_ij - p delta_ij, six components (visuals.f90 Total
        # stress tensor)
        g = mappings.velocity_gradient(P, st.u, st.v, st.w)
        p = pressure()
        return [("StressTensorxx", 2 * visc * g["ux"] - p),
                ("StressTensoryy", 2 * visc * g["vy"] - p),
                ("StressTensorzz", 2 * visc * g["wz"] - p),
                ("StressTensorxy", visc * (g["uy"] + g["vx"])),
                ("StressTensorxz", visc * (g["uz"] + g["wx"])),
                ("StressTensoryz", visc * (g["vz"] + g["wy"]))]
    if name == "ReynoldsTensor":
        # u_i' u_j' about the plane means
        f = {t: _plane_fluct(c) for t, c in (("u", st.u), ("v", st.v),
                                              ("w", st.w))}
        return [(f"ReynoldsTensor{a}{b}", f[a] * f[b])
                for a, b in (("u", "u"), ("v", "v"), ("w", "w"),
                             ("u", "v"), ("u", "w"), ("v", "w"))]
    return None


def _visual_field(sim, name: str, st, comp_f, box: dict, dcmp: str, outdir,
                  it):
    """The field of one scalar visual name (visuals.f90's menu)."""
    from tlab_tpu_torch.physics import thermo as th
    P, visc = sim.P, sim.nsp.visc
    if name == "Enstrophy":
        return mappings.vorticity_magnitude2(P, st.u, st.v, st.w)
    if name == "Strain":
        # the reference's Strain file is 2 s_ij s_ij (visuals.f90:786)
        return 2.0 * mappings.strain2(P, st.u, st.v, st.w)
    if name == "LogStrain":
        # iscal_offset+8: log10(2 s_ij s_ij + small)
        return torch.log10(2.0 * mappings.strain2(P, st.u, st.v, st.w)
                           + 1e-30)
    if name in ("InvariantP", "InvariantQ", "InvariantR"):
        inv = mappings.invariants(P, st.u, st.v, st.w)
        return inv["PQR".index(name[-1])]
    if name == "Dilatation":
        return dyn.divergence(P, st.u, st.v, st.w)
    if name == "Dissipation":
        return mappings.dissipation(P, st.u, st.v, st.w, visc)
    if name == "ScalarGradient":
        return mappings.gradient_magnitude2(P, st.s[0])
    if name == "VelocityMagnitude":
        return st.u ** 2 + st.v ** 2 + st.w ** 2
    if name == "Pressure":
        # [PostProcessing] PressureDecomposition selects which tendency
        # pieces feed the diagnostic Poisson (visuals.f90:136-149 DCMP_*)
        return pressure_boussinesq(P, st, decomposition=dcmp)
    if name == "HorizontalDivergence":
        return dyn._d1(P, "x", 0, st.u) + dyn._d1(P, "z", 2, st.w)
    if name in ("Buoyancy", "Fvb", "bPrime", "Cvb", "LogBuoyancySource"):
        # buoyancy-analysis family (visuals.f90 iscal_offset+12): b/Froude,
        # its vertical flux, fluctuation, b'v' covariance, and the
        # evaporative source magnitude
        from tlab_tpu_torch.physics.gravity import buoyancy_source
        props = sim.case.buoyancy
        if props is None or props.type == "none":
            raise ValueError(f"{name} visual needs [BodyForce]")
        froude = getattr(sim.nsp, "froude", 1.0) or 1.0
        b = _visual_buoyancy(sim, st, box)
        if name == "Buoyancy":
            return b
        if name == "Fvb":
            return b * st.v
        if name == "bPrime":
            return _plane_fluct(b)
        if name == "Cvb":
            return _plane_fluct(b) * _plane_fluct(st.v)
        tcfg = sim.case.thermo or {}
        if tcfg.get("mixture", "") == "airwaterlinear" \
                and tcfg.get("parameters"):
            xi, _d1f, d2f = th.airwater_linear_source(
                tuple(tcfg["parameters"]), st.s)
            g2 = mappings.gradient_magnitude2(P, xi)
            ns = st.s.shape[0]
            cl = props.parameters[ns] if len(props.parameters) > ns else 0.0
            src = g2 * d2f * cl
        else:
            src = buoyancy_source(props, mappings.gradient_magnitude2(
                P, st.s[0]))
        src = src * visc / sim.case.schmidt[0] / froude
        return torch.log10(src.abs() + 1e-30)
    if name == "LogEnstrophy":
        return torch.log10(torch.clamp(
            mappings.vorticity_magnitude2(P, st.u, st.v, st.w), min=1e-30))
    if name == "LogPotentialEnstrophy":
        # log10((omega . grad b)^2) with b the buoyancy/Froude; the
        # reference computes it for whatever buoyancy is active, zeros
        # included (visuals.f90:739-755)
        b = _visual_buoyancy(sim, st, box)
        om = mappings.curl(P, st.u, st.v, st.w)
        pe = sum(dyn._d1(P, t, ax, b) * om[ax]
                 for ax, t in enumerate("xyz"))
        return torch.log10(pe * pe + 1e-30)
    if name == "Supsat":
        # supersaturated liquid (s_ql - ql_eq)/s_ql(1) (visuals.f90:527-533;
        # needs the non-equilibrium airwater 3-scalar state,
        # damkohler(1) > 0)
        if st.s.shape[0] < 3:
            raise ValueError("Supsat needs the non-equilibrium airwater "
                             "state (3 scalars)")
        ane = _get_ane(sim, box)
        ql_eq = th.diagnostic_fields(ane["tp"], st.s[:2], ane["bg"])["ql"]
        return (st.s[2] - ql_eq) / st.s[2].reshape(-1)[0].item()
    if name == "EpsSolid":
        # IBM solid mask (visuals.f90:1035-1039)
        if not P.get("ibm"):
            raise ValueError("EpsSolid visual needs [IBMParameter]")
        return P["ibm"]["eps"]
    if name == "EnstrophyProduction":
        return mappings.vorticity_production(P, st.u, st.v, st.w)
    if name == "EnstrophyDiffusion":
        return visc * mappings.vorticity_diffusion(P, st.u, st.v, st.w)
    if name == "StrainProduction":
        return 2.0 * mappings.strain_production(P, st.u, st.v, st.w)
    if name == "StrainDiffusion":
        return 2.0 * visc * mappings.strain_diffusion(P, st.u, st.v, st.w)
    if name == "StrainPressure":
        return 2.0 * mappings.strain_pressure(P, st.u, st.v, st.w,
                                              pressure_boussinesq(P, st))
    if name == "ScalarGradientProduction":
        return mappings.gradient_production(P, st.s[0], st.u, st.v, st.w)
    if name == "Tke":
        # fluctuation TKE about the (x,z)-plane means
        return 0.5 * (_plane_fluct(st.u) ** 2 + _plane_fluct(st.v) ** 2
                      + _plane_fluct(st.w) ** 2)
    if name == "LogDissipation":
        return torch.log10(torch.clamp(
            mappings.dissipation(P, st.u, st.v, st.w, visc), min=1e-30))
    if name == "Radiation":
        ir = getattr(P.get("bodyforce"), "ir_field", None)
        if ir is None:
            raise ValueError("Radiation visual needs an active [Infrared] "
                             "term")
        return ir(st)
    if name == "RelativeHumidity":
        # RH% = pv/psat with pv = p qv Rv/Rmix, the same formula as the
        # avg Stratification group (averages.py)
        ane = _get_ane(sim, box)
        tp = ane["tp"]
        diag = th.diagnostic_fields(tp, st.s, ane["bg"])
        qt = st.s[1] if st.s.shape[0] > 1 else st.s[0]
        pv = ane["bg"]["p"][None, :, None] * (qt - diag["ql"]) * tp.Rv \
            / th.mixture_R(tp, qt, diag["ql"])
        return pv / tp.psat(diag["T"]) * 100.0
    if name == "PressureGradientPower":
        pf = pressure_boussinesq(P, st)
        return -(dyn._d1(P, "x", 0, pf) * st.u + dyn._d1(P, "y", 1, pf)
                 * st.v + dyn._d1(P, "z", 2, pf) * st.w)
    if name in ("PressureStrainX", "PressureStrainY", "PressureStrainZ"):
        pp = _plane_fluct(pressure_boussinesq(P, st))
        ax = "XYZ".index(name[-1])
        comp = (st.u, st.v, st.w)[ax]
        return pp * dyn._d1(P, "xyz"[ax], ax, _plane_fluct(comp))
    if name in ("PressureHydrostatic", "PressureHydrodynamic"):
        zero = torch.zeros_like(st.u)
        p_sta = pressure_boussinesq(P, st._replace(u=zero, v=zero, w=zero))
        if name == "PressureHydrostatic":
            return p_sta
        return pressure_boussinesq(P, st) - p_sta
    if name.startswith("Pressure") and name[8:] in (
            "Total", "Advection", "AdvDiff", "Diffusion", "Coriolis",
            "Buoyancy"):
        return pressure_boussinesq(P, st, decomposition=name[8:].lower())
    if name == "LaplacianV":
        return mappings.laplacian(P, st.v)
    if name in ("LaplacianB", "GradientRi"):
        props = sim.case.buoyancy
        if props is None or props.type == "none":
            raise ValueError(f"{name} visual needs [BodyForce]")
        b = _visual_buoyancy(sim, st, box)
        if name == "LaplacianB":
            return mappings.laplacian(P, b)
        # gradient Richardson proxy |db/dy| / (du/dy)^2 (visuals.f90
        # iscal_offset+19)
        return dyn._d1(P, "y", 1, b).abs() \
            / (dyn._d1(P, "y", 1, st.u) ** 2 + 1e-30)
    if name == "PressureGradientY":
        return dyn._d1(P, "y", 1, pressure_boussinesq(P, st))
    if name == "ParticleDensity":
        # scatter unit weights from the part.<it> restart (visuals.f90
        # iscal_offset+18, PARTICLE_TO_FIELD)
        from tlab_tpu_torch.particles.core import (make_locator,
                                                   particles_to_field)
        from tlab_tpu_torch.particles.io import read_particles
        ps, _ = read_particles(os.path.join(outdir, f"part.{it}"),
                               dtype=sim.dtype, device=sim.device)
        loc = make_locator(sim.grid)(ps.x)
        return particles_to_field(ps.x.new_ones(ps.x.shape[0]), loc,
                                  sim.grid.shape)
    if name in ("H2Ov", "Air", "H2Ol", "Liquid", "Chi", "Psi"):
        # mixture species mass fractions (visuals.f90:649-668): airwater
        # H2Ov = qt - ql, Air = 1 - qt, H2Ol = the liquid slot;
        # airwaterlinear Chi/Psi are the mixing scalars and Liquid the
        # diagnostic closure
        if name in ("Chi", "Psi"):
            return st.s[("Chi", "Psi").index(name)]
        if comp_f is not None:
            qt = st.s[0] if st.s.shape[0] else torch.zeros_like(st.u)
            ql = comp_f.get("Liquid", torch.zeros_like(qt))
        else:
            qt = st.s[1] if st.s.shape[0] > 1 else st.s[0]
            ql = torch.zeros_like(qt) \
                if (sim.case.thermo or {}).get("mixture", "") == "airvapor" \
                else _anelastic_liquid(sim, st, box)
        return {"H2Ov": qt - ql, "Air": 1.0 - qt}.get(name, ql)
    if name in ("VelocityX", "VelocityY", "VelocityZ"):
        return (st.u, st.v, st.w)["XYZ".index(name[-1])]
    if name.startswith("Scalar"):
        return st.s[int(name[6:]) - 1]
    raise ValueError(name)


@_debug_nans
def run_visuals(sim: Simulation, outdir: str, iterations,
                which=("Enstrophy",)) -> None:
    """visuals.x equivalent: the derived fields `which` of each snapshot as
    vis<it>.<name> files (a file set vis<it>.<name><i> for the vector and
    tensor names), single precision, optionally restricted to
    [PostProcessing] Subdomain; [PostProcessing] Format=general writes the
    restart format instead of raw f4.  Each name that needs the diagnostic
    pressure solves it (PressureHydrodynamic and PressureAdvection twice),
    as tlab_tpu.  Each field goes to the host once and is freed before the
    next."""
    sub = subdomain_slices(sim)
    box = {}
    ini = sim.case.ini
    # [PostProcessing] Format: 'single' (default) = raw f32 no header, as
    # the reference's IO_WRITE_VISUALS FORMAT_SINGLE (what the xdmf/python
    # readers mmap); 'general' = restart stream format
    fv = ini.get("PostProcessing", "Format", "single").lower()
    vfmt = "general" if fv in ("general", "0") else "single"
    dcmp = ini.get("PostProcessing", "PressureDecomposition",
                   "total").lower()
    for it in iterations:
        comp_f = None
        if sim.comp is not None:
            from tlab_tpu_torch.dycore.compressible import primitive_view
            U, rtime = _load_comp(sim, outdir, it)
            rho, T, p, ql = comp_fields(sim, U)
            comp_f = {"Density": rho, "Temperature": T, "Pressure": p}
            if ql is not None:
                comp_f["Liquid"] = ql
            st = primitive_view(U)
        else:
            st, rtime = load_snapshot(sim, outdir, it)

        def write(suffix, fld):
            fields_io.write_visual(
                os.path.join(outdir, f"vis{it}.{suffix}"),
                fld if sub is None else fld[sub], it, (rtime,), fmt=vfmt)

        def files(name):
            """[(file suffix, field)] of the visual `name`."""
            if comp_f is not None and name in comp_f:
                return [(name, comp_f[name])]
            out = _file_set(name, st, sim.P, sim.nsp.visc,
                            lambda: pressure_boussinesq(sim.P, st))
            if out is None:
                out = [(name, _visual_field(sim, name, st, comp_f, box,
                                            dcmp, outdir, it))]
            return out

        for name in which:
            fs = nantrap.region(f"visuals {name}", files)(name)
            for suffix, fld in fs:
                write(suffix, fld)
            del fs


@_debug_nans
def run_superlayer(sim: Simulation, outdir: str, iterations,
                   indicator: str = "vorticity", threshold: float = 0.01,
                   samples=("Enstrophy",), nbins: int = 64) -> None:
    """Superlayer extraction (reference sl_boundary.f90 + sl_normal/pdf
    tools): upper/lower interface heights of `indicator` (vorticity |
    scalargradient) at threshold*global-max, surface statistics, height
    PDFs, and fields sampled on both surfaces; written to sl{it}.npz."""
    from tlab_tpu_torch.stats import superlayer as sl
    y = sim.grid.y.nodes

    def surfaces(it):
        """The arrays of sl<it>.npz."""
        st, _ = load_snapshot(sim, outdir, it)
        if indicator == "vorticity":
            a = mappings.vorticity_magnitude2(sim.P, st.u, st.v, st.w)
        elif indicator == "scalargradient":
            a = mappings.gradient_magnitude2(sim.P, st.s[0])
        else:
            raise ValueError(indicator)
        amin = threshold * float(torch.amax(a))
        y_up = sl.upper_boundary(y, a, amin)
        y_lo = sl.lower_boundary(y, a, amin)
        out = {"y_upper": _np(y_up), "y_lower": _np(y_lo),
               "threshold": amin, "itime": it}
        for tag, ysl in (("up", y_up), ("lo", y_lo)):
            for k, v in sl.surface_statistics(ysl).items():
                out[f"{tag}_{k}"] = float(v)
            counts, edges = sl.height_pdf(ysl, nbins=nbins)
            out[f"{tag}_pdf"] = counts
            out[f"{tag}_pdf_edges"] = edges
            for name in samples:
                if name == "Enstrophy":
                    fld = a if indicator == "vorticity" else \
                        mappings.vorticity_magnitude2(sim.P, st.u, st.v,
                                                      st.w)
                elif name.startswith("Scalar"):
                    fld = st.s[int(name[6:]) - 1]
                else:
                    fld = {"VelocityX": st.u, "VelocityY": st.v,
                           "VelocityZ": st.w}[name]
                out[f"{tag}_{name}"] = _np(sl.sample_at_surface(fld, y,
                                                                ysl))[0]
                # samples along the LOCAL interface normal (reference
                # sl_normal_sample.f90): 3 distances into the outer side
                dists = (0.0, 0.05 * sim.grid.y.scale,
                         0.10 * sim.grid.y.scale)
                side = "upper" if tag == "up" else "lower"
                out[f"{tag}_{name}_normal"] = _np(
                    sl.sample_along_normals(sim.grid, fld, ysl, dists,
                                            side=side))
                out[f"{tag}_normal_dists"] = np.asarray(dists)
        return out

    for it in iterations:
        np.savez(os.path.join(outdir, f"sl{it}.npz"),
                 **nantrap.region("superlayer", surfaces)(it))
