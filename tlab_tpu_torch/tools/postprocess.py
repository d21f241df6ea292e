"""Offline post-processing over saved snapshots: averages.x / pdfs.x /
spectra.x / superlayer equivalents (reference src/tools/statistics; port of
tlab_tpu/tools/postprocess.py).

Each function loops over a snapshot iteration list, reads the restart
fields onto the simulation's device, computes there, and writes analysis
files.  visuals.x (run_visuals) and apriori.x (run_apriori) are ROADMAP
A16.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from tlab_tpu_torch import mappings
from tlab_tpu_torch.convert import state_from_numpy
from tlab_tpu_torch.dycore.pressure import pressure_boussinesq
from tlab_tpu_torch.io import fields_io
from tlab_tpu_torch.io import reference_formats as rf
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.stats import averages, pdfs, spectra


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
    for it in iterations:
        st, rtime = load_snapshot(sim, outdir, it)
        p = pressure_boussinesq(sim.P, st)
        extras = averages.build_extras(sim, st)
        flow = averages.flow_statistics(sim.P, st, sim.nsp.visc, p=p,
                                        extras=extras)
        scals = [averages.scalar_statistics(
            sim.P, st, sim.nsp.diffusivity(i), i, p=p, visc=sim.nsp.visc,
            extras=extras) for i in range(sim.nsp.n_scalars)]
        flow, scals = averages.to_host(flow, scals)
        wr(os.path.join(outdir, f"avg{it}"), y, flow, averages.FLOW_GROUPS,
           it, rtime)
        sgroups = averages.scal_groups(st.s.shape[0])
        for i, sc in enumerate(scals):
            wr(os.path.join(outdir, f"avg{it}s{i + 1}"), y, sc, sgroups, it,
               rtime)
        if gate_scalar > 0:
            gate = st.s[gate_scalar - 1] > gate_level
            cond = averages.conditional_flow_statistics(sim.P, st, gate)
            averages.write_table(os.path.join(outdir, f"cavg{it}"), y,
                                 _host_table(cond), it, rtime)
            averages.write_table(
                os.path.join(outdir, f"int{it}"), y,
                _host_table({"gamma": averages.intermittency(gate)}), it,
                rtime)
        # [PostProcessing] ParamAverages analysis modes (reference
        # averages.f90:150-204: mode 1/2 are the tables above; 3-17 are
        # the specialised budgets/diagnostics in stats.analysis)
        if mode >= 3:
            from tlab_tpu_torch.stats import analysis
            tab = analysis.run_mode(sim.P, st, sim.nsp.visc, mode,
                                    diff=[sim.nsp.diffusivity(i) for i in
                                          range(sim.nsp.n_scalars)])
            averages.write_table(
                os.path.join(outdir, f"{_MODE_FILES[mode]}{it}"), y,
                _host_table(tab), it, rtime)


def _snapshot_fields(sim, st):
    comps = {"u": st.u, "v": st.v, "w": st.w}
    for i in range(sim.nsp.n_scalars):
        comps[f"s{i + 1}"] = st.s[i]
    return comps


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
    for it in iterations:
        st, _ = load_snapshot(sim, outdir, it)
        comps = _snapshot_fields(sim, st)
        for name, a in comps.items():
            t2 = tag(name) + tag(name)
            ex = _np(spectra.spectrum_x(a))
            rf.write_spectrum_file(outdir, "xsp", it, "E" + t2,
                                   0.5 * ex[: nx // 2])
            if nz > 1:
                ez = _np(spectra.spectrum_z(a))
                rf.write_spectrum_file(outdir, "zsp", it, "E" + t2,
                                       0.5 * ez[: nz // 2])
                er = spectra.radial_spectrum(a, sim.grid.x.scale,
                                             sim.grid.z.scale)
                nk = min(nx // 2, nz // 2)
                out = np.zeros((nk, er.shape[1]), er.dtype)
                out[: min(nk, er.shape[0])] = er[: nk]
                rf.write_spectrum_file(outdir, "rsp", it, "E" + t2,
                                       0.5 * out)
            if correlations:
                cx = _np(spectra.correlation_x(a))
                rf.write_spectrum_file(outdir, "xcr", it, "C" + t2,
                                       cx[: nx // 2])
                if nz > 1:
                    cz = _np(spectra.correlation_z(a))
                    rf.write_spectrum_file(outdir, "zcr", it, "C" + t2,
                                           cz[: nz // 2])
            if y_blocks > 0:
                e2 = spectra.spectrum_2d(a, y_blocks=y_blocks)
                np.savez(os.path.join(outdir, f"sp2d{it}.{name}.npz"),
                         e=_np(e2), itime=it)
        if cross:
            names = list(comps)
            pairs = [("u", "v"), ("u", "w"), ("v", "w")] + \
                [("v", n) for n in names if n.startswith("s")]
            for na, nb in pairs:
                tp = tag(na) + tag(nb)
                ex = _np(spectra.spectrum_x(comps[na], comps[nb]))
                rf.write_spectrum_file(outdir, "xsp", it, "E" + tp,
                                       0.5 * ex[: nx // 2])
                power, phase = spectra.cross_phase_x(comps[na], comps[nb])
                rf.write_spectrum_file(outdir, "pow", it, "E" + tp,
                                       _np(power)[: nx // 2])
                rf.write_spectrum_file(outdir, "pha", it, "E" + tp,
                                       _np(phase)[: nx // 2])
                if correlations:
                    cx = _np(spectra.correlation_x(comps[na], comps[nb]))
                    rf.write_spectrum_file(outdir, "xcr", it, "C" + tp,
                                           cx[: nx // 2])


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
    for it in iterations:
        st, rtime = load_snapshot(sim, outdir, it)
        pres = pressure_boussinesq(sim.P, st) if sim.comp is None else None
        pdfs.run_pdf_mode(sim, st, pres, outdir, it, float(rtime),
                          opt_main=opt_main, nbins=nb,
                          gate_level=gate_level)


def run_visuals(sim: Simulation, outdir: str, iterations,
                which=("Enstrophy",)) -> None:
    raise NotImplementedError("visuals (derived-field extraction): "
                              "ROADMAP A16")


def run_apriori(sim: Simulation, outdir: str, iterations) -> None:
    raise NotImplementedError("apriori (subgrid-stress analysis): "
                              "ROADMAP A16")


def run_superlayer(sim: Simulation, outdir: str, iterations,
                   indicator: str = "vorticity", threshold: float = 0.01,
                   samples=("Enstrophy",), nbins: int = 64) -> None:
    """Superlayer extraction (reference sl_boundary.f90 + sl_normal/pdf
    tools): upper/lower interface heights of `indicator` (vorticity |
    scalargradient) at threshold*global-max, surface statistics, height
    PDFs, and fields sampled on both surfaces; written to sl{it}.npz."""
    from tlab_tpu_torch.stats import superlayer as sl
    y = sim.grid.y.nodes
    for it in iterations:
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
        np.savez(os.path.join(outdir, f"sl{it}.npz"), **out)
