"""The dns.x equivalent time loop (port of tlab_tpu/tools/dns.py,
the single-device incompressible and ideal-gas compressible threads
through it).

Outer loop on the host (adaptive dt, logging, checkpoints, statistics);
each RK step, or window of `inner_steps` steps, is a sequence of device
calls that the host waits for once, when it reads the window's CFL and
dilatation extrema.  Structure mirrors reference dns_main.f90:246-361; the
dns.out step log reproduces the reference's columns (Itn. time dt CFL# D#
visc DilMin DilMax, and NewtonRs for the anelastic AirWater mixture,
dns_main.f90:394-495).  TimeOrder=RungeKuttaDiffusion3 steps with the
semi-implicit diffusion of dycore/implicit.py, one step at a time within a
window.

The compressible set (sim.comp) steps its conservative state with
dycore/compressible.py in a loop of its own (_run_compressible), one step
a window: the acoustic CFL and the diffusion-number density set dt, the
log prints the pressure and density extrema (PMin PMax RMin RMax,
dns_main.f90:434-439) and, for the AirWater mixture, the saturation
Newton's NewtonRs, all read in one copy a step; the buffer and the NSCBC
reference states attach at the start (Simulation.attach_buffer_compressible);
the restarts hold the conservative fields (fields_io.write_comp_state), the
statistics are the Favre tables of write_statistics_compressible, and a
spatial run accumulates the density-weighted (z, t) sums and the MA_*
registers on the device (stats/spatial.make_comp_spatial_reducer; avg_zt
and avgMA_zt at the statistics cadence).

The boundary machinery rides in the loop as in tlab_tpu's: the interactive
surface state starts at zero, the buffer takes its references from the
state the run starts from (Simulation.attach_buffer), the filter sponge
blends the state after each step, an unsteady inflow (`inflow`, an
dycore/inflow.InflowBox) feeds the Imin/Imax strips each step, and a
spatial run accumulates its (z, t) station statistics every step
(st<it>.npz at the restart cadence, avg_zt<it> at the statistics cadence).

At the statistics cadence the [Statistics] Pdfs/Intermittency/Spectrums/
Correlations are computed on the device in one call and copied to the host
as one flat tensor (_inrun_pdfs_spectra); an incompressible run with
[Iteration] PhaseAvg accumulates the phase-locked z-means of u, v, w, the
diagnostic pressure and the scalars every PhaseAvg steps (phavg<it>.npz at
the restart cadence).

Lagrangian particles (`pstate`, `particle_props`) ride the step
(particles/stepping.rk_step_with_particles, one RK step a window), with the
part.<it> restarts, the tagged trajectories (trajectories.<a>-<b>.npz at
the restart cadence) and the particle PDFs (particle_pdf.<it> at the
statistics cadence).  [SavePlanes] writes planesI/J/K.<it> every
[Iteration] SavePlanes steps (u, v, w, the scalars and the pressure: the
step's own, else the diagnostic one), [SaveTowers] accumulates its strided
columns and plane means every step and flushes them at the restart cadence;
both in the compressible set too (the primitive view, the EOS pressure).

On the (x, z) rank mesh (`mesh`, a parallel.mesh.Mesh; one process a rank,
every rank calling run with the same arguments and the global state) each
rank steps its block through the pencil engine (parallel/pencil.py) and the
log's diagnostics are the mesh's (one all-reduce a step: the CFL, the
dilatation or pressure and density extrema, NewtonRs).  Rank 0 writes every
file: the restarts, statistics, towers, planes, dns.out, tlab.log and the
particle files come from the fields gathered to it at their cadence and are
written as the single-device run writes them; the other ranks write nothing.
The [Filter] cadence and the filter sponge go through the same engine
(pencil.make_pencil_filter), the particles are owner-sharded slots
(particles/parallel.py).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Optional

import numpy as np
import torch

from tlab_tpu_torch.dycore import buffer as bufmod
from tlab_tpu_torch.dycore import compressible as comp_mod
from tlab_tpu_torch.dycore import implicit
from tlab_tpu_torch.dycore import incompressible as dyn
from tlab_tpu_torch.dycore.pressure import pressure_boussinesq
from tlab_tpu_torch.dycore.state import State
from tlab_tpu_torch.io import fields_io
from tlab_tpu_torch.io import reference_formats as rf
from tlab_tpu_torch.io.planes import PlaneSpec, TowerAccumulator, write_planes
from tlab_tpu_torch.ops import burgers
from tlab_tpu_torch.ops.filter import filter_state
from tlab_tpu_torch.parallel import pencil
from tlab_tpu_torch.particles import io as pio
from tlab_tpu_torch.particles import parallel as ppar
from tlab_tpu_torch.particles.core import make_locator, n_props
from tlab_tpu_torch.particles.stepping import rk_step_with_particles
from tlab_tpu_torch.physics import eos, mixtures, thermo
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.stats import averages as avg
from tlab_tpu_torch.stats import spectra
from tlab_tpu_torch.stats.pdfs import pdf1v_plane_table_device
from tlab_tpu_torch.stats.phaseavg import PhaseAverage
from tlab_tpu_torch.stats.spatial import (SpatialStats,
                                          make_comp_spatial_reducer,
                                          register_station_table,
                                          state_fields,
                                          write_station_budgets)
from tlab_tpu_torch.utils import trace as _trace
from tlab_tpu_torch.utils.fortran_fmt import fort_e


@dataclasses.dataclass
class RunLog:
    path: Optional[str] = None
    lines: list = dataclasses.field(default_factory=list)
    newton: bool = False        # AirWater NewtonRs column (dns_main.f90:406)
    comp: bool = False          # the compressible PMin..RMax columns

    def header(self):
        if self.comp and self.newton:
            h = ("#" * 122 + "\n"
                 "#  Itn.    time          dt         CFL#       D#      "
                 "   visc       PMin       PMax       RMin       RMax     "
                 "  NewtonRs#\n" + "#" * 122)
        elif self.comp:
            # compressible columns (reference DNS_LOGS_INITIALIZE,
            # dns_main.f90:434-439): p and rho extrema
            h = ("#" * 93 + "\n"
                 "#  Itn.    time          dt         CFL#       D#      "
                 "   visc       PMin       PMax       RMin       RMax #\n"
                 + "#" * 93)
        elif self.newton:
            # anelastic equilibrium AirWater adds the saturation Newton
            # residual (dns_main.f90:443, imixture==AIRWATER & Da3<=0)
            h = ("#" * 106 + "\n"
                 "#  Itn.    time          dt         CFL#       D#         "
                 "visc       DilMin        DilMax        NewtonRs#\n"
                 + "#" * 106)
        else:
            h = ("#" * 93 + "\n"
                 "#  Itn.    time          dt         CFL#       D#      "
                 "   visc       DilMin        DilMax     #\n" + "#" * 93)
        self._write(h)

    def step(self, status, itime, rtime, dt, cfl, dnum, visc, *extra):
        line = (f"{status} {itime:7d}  {fort_e(rtime, 6)}  {fort_e(dt, 3)}  "
                f"{fort_e(cfl, 3)}  {fort_e(dnum, 3)}  {fort_e(visc, 3)}")
        if self.comp:
            line += "".join(f" {fort_e(v, 3)}" for v in extra)
        elif self.newton and len(extra) >= 3:
            # DilMin DilMax at E13.6, NewtonRs at E10.3 (dns_main 200/400)
            line += " " + "  ".join(fort_e(v, 6) for v in extra[:2])
            line += "  " + fort_e(extra[2], 3)
        else:
            line += " " + "  ".join(fort_e(v, 6) for v in extra)
        self._write(line)

    def _write(self, text):
        self.lines.append(text)
        if self.path:
            with open(self.path, "a") as fh:
                fh.write(text + "\n")


@dataclasses.dataclass
class DnsRun:
    sim: Simulation
    state: State
    itime: int
    rtime: float
    log: RunLog
    pstate: object = None


def newton_error_fn(sim: Simulation):
    """The NewtonRs column's function of the state (a 0-d tensor), or None:
    anelastic thermodynamics with the equilibrium AirWater mixture and
    [Parameters] Damkohler(3) <= 0 (dns_main.f90:443-493)."""
    ane = sim.anelastic
    if ane is None:
        return None
    ini = sim.case.ini
    da = tuple(ini.get_floats("Parameters", "Damkohler", ())) \
        if ini is not None else ()
    if ane["tp"].mixture != "airwater" or (da[2] if len(da) > 2
                                           else 0.0) > 0.0:
        return None
    return lambda state: thermo.equilibrium_newton_error(
        ane["tp"], state.s, ane["bg"])


def _reduced(mesh, vals, mins=()):
    """torch.stack(vals); on a mesh each entry the world's max of the ranks'
    values (the min for the entries at `mins`), in one all-reduce."""
    t = torch.stack(vals)
    if mesh is None:
        return t
    sign = torch.ones_like(t)
    sign[list(mins)] = -1.0
    return mesh.all_reduce(t * sign, "max") * sign


def make_step_functions(sim: Simulation, inner_steps: int = 1,
                        particles=None, mesh=None):
    """(step, diagnostics) for the single-device run.

    step(state, dtime, extra=None) takes `inner_steps` RK steps at a fixed
    dt (inner_steps > 1: one State<->stack conversion for the window; the
    CFL-based dt then updates every window instead of every step, where the
    reference syncs each step, TIME_COURANT) and returns (state, last
    pressure, diagnostics(new state)).  diagnostics(state) is the device
    tensor [CFL max, dilatation min, dilatation max(, NewtonRs)], which the
    host reads in one copy.  extra: the step's aux dict ({"visc_scale":
    factor, "rtime": t} or None).  NewtonRs: where newton_error_fn(sim)
    gives the column.

    particles (a ParticleProps): step(state, pstate, dtime) takes one RK
    step of the flow and the particles (rk_step_with_particles, whatever the
    case's TimeOrder, as tlab_tpu) and returns (state, pstate,
    diagnostics(new state)).

    mesh (a parallel.mesh.Mesh): the functions take and return this rank's
    blocks (the particles: its slots (X, V, T, M)); the step is
    pencil.make_pencil_step's (make_pencil_step_particles'), the
    diagnostics are reduced over the mesh."""
    P = sim.P
    if sim.comp is not None:
        if particles is not None:
            raise NotImplementedError(
                "particles in the compressible set: tlab_tpu has no "
                "particle step for it")
        return _compressible_step_functions(sim, mesh)
    newton = newton_error_fn(sim)
    # TimeOrder=RungeKuttaDiffusion3: the SMR91 semi-implicit diffusion step
    # (reference RKM_IMP3_DIFFUSION, time.f90:114-134), which is what drops
    # the diffusion-number limit on dt; it does not take the stacked loop
    implicit_diff = "diffusion" in sim.case.time_order.lower()

    pstep = None
    if mesh is not None and particles is None:
        def rk(Pp, state, dtime, aux):
            if implicit_diff:
                return implicit.rk_step_implicit(Pp, state, dtime, aux=aux)
            return dyn.rk_step(Pp, state, dtime, aux=aux)

        pstep = pencil.make_pencil_step(mesh, P, rk, inner_steps=inner_steps)
        P = pstep.plan
    elif mesh is not None:
        pstep = pencil.make_pencil_step_particles(mesh, P, sim.grid,
                                                  particles)
        P = pstep.plan

    def diagnostics(state):
        vals = [dyn.cfl_advective_max(P, state),
                *dyn.dilatation_minmax(P, state)]
        if newton is not None:
            vals.append(newton(state))
        return _reduced(mesh, vals, mins=(1,))

    if pstep is not None and particles is None:
        def step(state, dtime, extra=None):
            new_state, p = pstep(state, dtime, extra)
            return new_state, p, diagnostics(new_state)

        return step, diagnostics
    if pstep is not None:
        def step(state, parts, dtime):
            new_state, new_parts, _ = pstep(state, parts, dtime)
            return new_state, new_parts, diagnostics(new_state)

        return step, diagnostics

    def step(state, dtime, extra=None):
        if implicit_diff:
            new_state = state
            for _ in range(inner_steps):
                new_state, p = implicit.rk_step_implicit(P, new_state, dtime,
                                                         aux=extra)
        elif inner_steps > 1:
            new_state, p = dyn.rk_loop_stacked(P, state, dtime, inner_steps,
                                               aux=extra)
        else:
            new_state, p = dyn.rk_step(P, state, dtime, aux=extra)
        return new_state, p, diagnostics(new_state)

    if particles is not None:
        locate = make_locator(sim.grid)

        def step(state, pstate, dtime):
            new_state, new_ps = rk_step_with_particles(
                P, sim.grid, locate, particles, state, pstate, dtime)
            return new_state, new_ps, diagnostics(new_state)

    return step, diagnostics


def _primitive(sim: Simulation, U, P=None):
    """(u, v, w, T, p) of the conservative state in the set's energy
    formulation and mixture (P: the plan, sim.P by default)."""
    c = sim.comp
    if c.get("aw") is not None:
        return comp_mod.primitive_airwater(U, c["aw"])[:5]
    fn = comp_mod.primitive if c["energy"] == "total" \
        else comp_mod.primitive_internal
    return fn(sim.P if P is None else P, U, c["gamma"], c["mach"],
              mix=c.get("mixture"))


def _compressible_step_functions(sim: Simulation, mesh=None):
    """(step, diagnostics) of the compressible set, one RK step a call.
    diagnostics(U) is the device tensor [acoustic CFL max, PMin, PMax, RMin,
    RMax, (NewtonRs,) diffusion-number density] (the density, max(sfactor
    (sum 1/ds^2)/rho), is TIME_COURANT's compressible branch; NewtonRs, the
    AirWater mixture's, is the step's max over its substeps and 0 before
    the first step), read in one copy; step(U, dtime, extra=None) returns
    (U, p, diagnostics(U)) with p the EOS pressure of the new state.

    mesh: the functions take and return this rank's blocks, the step is
    pencil.make_pencil_step_compressible's (the buffer cut to the block,
    NewtonRs the mesh's max) and the diagnostics are the mesh's."""
    P, c = sim.P, sim.comp
    aw, mix = c.get("aw"), c.get("mixture")

    def rk(Pp, U, dtime):
        buf = bufmod.localize(c.get("buffer"), Pp.get("comm"))
        if aw is not None:
            return comp_mod.rk_step_airwater(
                Pp, U, dtime, aw, sim.nsp.visc, c["prandtl"], c["schmidt"],
                nscbc=c["nscbc"], ly=c["ly"], gvec=c["gvec"], buffer=buf)
        return comp_mod.rk_step_compressible(
            Pp, U, dtime, c["gamma"], c["mach"], sim.nsp.visc, c["prandtl"],
            nscbc=c["nscbc"], ly=c["ly"], gas=c["gas"], lx=c["lx"],
            form=c["form"], energy=c["energy"], mix=mix, gvec=c["gvec"],
            buffer=buf)

    if mesh is not None:
        advance = pencil.make_pencil_step_compressible(
            mesh, P, rk, return_scalar=aw is not None)
        P = advance.plan
    else:
        def advance(U, dtime):
            return rk(P, U, dtime)

    def stack(U, cfl, p, newton=None):
        vals = [cfl, p.min(), p.max(), U.rho.min(), U.rho.max()]
        if aw is not None:
            vals.append(newton if newton is not None
                        else U.rho.new_zeros(()))
        vals.append(comp_mod.diffusion_number_max(P, U, c["sfactor"]))
        return _reduced(mesh, vals, mins=(1, 3))

    if aw is not None:
        def diagnostics(U, newton=None):
            prim = comp_mod.primitive_airwater(U, aw)
            cfl = comp_mod.acoustic_cfl_max_airwater(P, U, aw, prim=prim)
            return stack(U, cfl, prim[4], newton), prim[4]

        def step(U, dtime, extra=None):
            new_U, newton = advance(U, dtime)
            diag, p = diagnostics(new_U, newton)
            return new_U, p, diag

        return step, lambda U: diagnostics(U)[0]

    def diagnostics(U, p=None):
        if p is None:
            p = _primitive(sim, U, P)[4]
        cfl = comp_mod.acoustic_cfl_max(P, U, c["gamma"], c["mach"],
                                        mix=mix, energy=c["energy"])
        return stack(U, cfl, p)

    def step(U, dtime, extra=None):
        new_U = advance(U, dtime)
        p = _primitive(sim, new_U, P)[4]
        return new_U, p, diagnostics(new_U, p)

    return step, diagnostics


def write_statistics(sim: Simulation, state: State, outdir: str,
                     itime: int, rtime: float, p=None) -> None:
    """avg<itime> / avg<itime>s<i> plane-statistics tables
    (reference DNS_STATISTICS_TEMPORAL, dns_statistics.f90:56). p: the
    projection pressure the step already computed.

    The tables are reduced on the device and come to the host as one
    (ncols, ny) stack -- no full field is copied (the reference reduces in
    place via AVG_IK_V, averages.f90:36-333)."""
    _write_tables(sim, outdir, itime, rtime,
                  *avg.stats_tables(sim, state, p))
    _inrun_pdfs_spectra(sim, state, outdir, itime, rtime)


def _write_tables(sim: Simulation, outdir: str, itime: int, rtime: float,
                  flow: dict, scals: list) -> None:
    """avg<itime> and avg<itime>s<i> from the host tables."""
    y = sim.grid.y.nodes
    _wr = avg.avg_writer(sim.case)
    _wr(os.path.join(outdir, f"avg{itime}"), y, flow, avg.FLOW_GROUPS,
        itime, rtime)
    sgroups = avg.scal_groups(len(scals))
    for i, sc in enumerate(scals):
        _wr(os.path.join(outdir, f"avg{itime}s{i + 1}"), y, sc, sgroups,
            itime, rtime)


def write_statistics_compressible(sim: Simulation, U, outdir: str,
                                  itime: int, rtime: float) -> None:
    """Compressible avg<itime> / avg<itime>s<i> tables: the primitive
    decomposition feeds the density-weighted (Favre) columns, the
    thermodynamic ones, Acoustics and RhoBudget of the reference
    AVG_FLOW_XZ (compressible branch, avg_flow_xz.f90:768-940), with the
    AirWater or combustion mixture's energy, enthalpy, entropy and gamma;
    reduced on the device, one (ncols, ny) copy to the host."""
    c = sim.comp
    gamma, mach = c["gamma"], c["mach"]
    rho = U.rho
    aw, mix = c.get("aw"), c.get("mixture")
    if aw is not None:
        u, v, w, T, p, ql, _ = comp_mod.primitive_airwater(U, aw)
        qt = U.rhos[0] / rho
        e = U.rhoE / rho
        h = thermo.caloric_enthalpy(aw, qt, ql, T)
        s_ent = torch.log(T) / (gamma - 1.0) - torch.log(rho)
        gamma_field = comp_mod.gamma_airwater(aw, qt, ql, T)
    else:
        u, v, w, T, p = _primitive(sim, U)
        if mix is not None and U.rhos is not None:
            Y = comp_mod.mass_fractions(U)
            cp = mixtures.cp_mixture(mix, T, Y)
            R = mixtures.gas_constant(mix, Y)
            rfac = (mix.gama0 - 1.0) / mix.gama0
            h_nd = mixtures.h_mixture(mix, T, Y)
            e = (h_nd - rfac * R * T) / ((mix.gama0 - 1.0) * mach ** 2)
            h = h_nd / ((mix.gama0 - 1.0) * mach ** 2)
            s_ent = (torch.log(torch.clamp(T, min=1e-30)) * cp
                     - rfac * R * torch.log(torch.clamp(p, min=1e-30)))
            gamma_field = cp / (cp - rfac * R)
        else:
            e = T / (gamma * (gamma - 1.0) * mach ** 2)
            h = e + p / rho
            # ideal-gas entropy s = ln(T)/(gamma-1) - ln(rho)
            # (THERMO_ENTROPY analog in this nondimensionalization)
            s_ent = torch.log(T) / (gamma - 1.0) - torch.log(rho)
            gamma_field = torch.full_like(T, gamma)
    ns = U.rhos.shape[0] if U.rhos is not None else 0
    s_scal = (U.rhos / rho[None]) if ns else rho.new_zeros((0,) + rho.shape)
    state = State(u=u, v=v, w=w, s=s_scal)
    extras = {"eqns": "compressible", "rho": rho, "T": T, "e": e, "h": h,
              "entropy": s_ent, "gamma_field": gamma_field,
              "y": np.asarray(sim.grid.y.nodes)}
    gas = c.get("gas")
    vis = None
    if gas is not None and gas.transport in ("powerlaw", "sutherland"):
        vis = eos.viscosity(gas, T)
    flow = avg.flow_statistics(sim.P, state, sim.nsp.visc, p=p,
                               extras=extras)
    scals = [avg.scalar_statistics(sim.P, state, sim.nsp.diffusivity(i), i,
                                   p=p, visc=sim.nsp.visc, extras=extras,
                                   rho=rho, vis=vis) for i in range(ns)]
    _write_tables(sim, outdir, itime, rtime, *avg.to_host(flow, scals))
    _inrun_pdfs_spectra(sim, state, outdir, itime, rtime)


def _inrun_pdfs_spectra(sim: Simulation, state: State, outdir: str,
                        itime: int, rtime: float) -> None:
    """[Statistics] Pdfs / Intermittency / Spectrums / Correlations at
    the statistics cadence (DNS_STATISTICS_TEMPORAL branches) -- shared
    by the incompressible and compressible (primitive-view) writers.

    Every table of every field is computed on the device and packed into
    one flat float64 tensor, copied to the host once; the host slices the
    pack and writes the files (the reference reduces everything in one
    pass, averages.f90:36-333).  float64 keeps the pdf counts exact above
    2^24 (the files hold float32, as the reference's)."""
    ini = sim.case.ini
    want_pdf = ini.get_bool("Statistics", "Pdfs", False)
    want_int = bool(state.s.shape[0]) and \
        ini.get_bool("Statistics", "Intermittency", False)
    want_spec = ini.get_bool("Statistics", "Spectrums", False)
    if not (want_pdf or want_int or want_spec):
        return
    nx, ny, nz = state.u.shape
    nb = 32
    want_corr = ini.get_bool("Statistics", "Correlations", False)
    fields = dict(u=state.u, v=state.v, w=state.w)
    for i in range(state.s.shape[0]):
        fields[f"s{i + 1}"] = state.s[i]
    plan = []                       # (kind, tag, table) per piece
    if want_pdf:
        plan += [("pdf", n, pdf1v_plane_table_device(f, nb))
                 for n, f in fields.items()]
    if want_int:
        gate_level = ini.get_float("Statistics", "GateLevel", 0.5)
        plan.append(("int", "gamma",
                     avg.intermittency(state.s[0] > gate_level)))
    if want_spec:
        for n, f in fields.items():
            t2 = "E" + 2 * (n[1:] if n.startswith("s") else n)
            plan.append(("xsp", t2, 0.5 * spectra.spectrum_x(f)[: nx // 2]))
            if nz > 1:
                plan.append(("zsp", t2,
                             0.5 * spectra.spectrum_z(f)[: nz // 2]))
            if want_corr:
                c2 = "C" + t2[1:]
                plan.append(("xcr", c2, spectra.correlation_x(f)[: nx // 2]))
                if nz > 1:
                    plan.append(("zcr", c2,
                                 spectra.correlation_z(f)[: nz // 2]))
    flat = torch.cat([a.to(torch.float64).reshape(-1)
                      for _, _, a in plan]).cpu().numpy()   # the one copy
    y = sim.grid.y.nodes
    off = 0
    for kind, tag, a in plan:
        a = flat[off:off + a.numel()].reshape(a.shape)
        off += a.size
        if kind == "pdf":
            rf.write_pdf_file(outdir, f"pdf{itime}.{tag}", rtime, y, a, nb)
        elif kind == "int":
            avg.write_table(os.path.join(outdir, f"int{itime}"), y,
                            {"gamma": a}, itime, rtime)
        else:
            rf.write_spectrum_file(outdir, kind, itime, tag, a)


def write_obs(sim: Simulation, state: State, outdir: str, itime: int,
              rtime: float) -> None:
    """Ekman-case observables to dns.obs (reference dns_main.f90:500-566):
    bulk velocities, friction velocity and stress angle at the lower wall."""
    y = sim.grid.y.nodes
    yt = torch.as_tensor(y).to(state.u.device, state.u.dtype)
    U = torch.mean(state.u, dim=(0, 2))
    W = torch.mean(state.w, dim=(0, 2))
    d1y = sim.P.get("d1y")
    zero = torch.zeros((), dtype=U.dtype, device=U.device)
    ub, wb, dUdy, dWdy = torch.stack([
        torch.trapezoid(U, yt) / (y[-1] - y[0]),
        torch.trapezoid(W, yt) / (y[-1] - y[0]),
        (d1y @ U)[0] if d1y is not None else zero,
        (d1y @ W)[0] if d1y is not None else zero]).tolist()
    visc = sim.nsp.visc
    utau = (visc * np.hypot(dUdy, dWdy)) ** 0.5
    alpha = np.degrees(np.arctan2(dWdy, dUdy))
    with open(os.path.join(outdir, "dns.obs"), "a") as fh:
        fh.write(f"{itime:7d} {rtime:.8e} {ub:.8e} {wb:.8e} "
                 f"{utau:.8e} {alpha:.6f}\n")


def _stations(case, nx: int) -> list:
    """x-station indices for the spatial-mode tables: [Statistics]
    Stations list (1-based, reference statavg) or every nx/8 column."""
    ini = getattr(case, "ini", None)
    stations = [int(s) - 1 for s in ini.get_floats(
        "Statistics", "Stations", ())] if ini is not None else []
    if not stations:
        stations = list(range(nx // 8, nx, max(nx // 8, 1)))
    return stations


def _host(t):
    """A plan's operator as a float64 host array (None stays None)."""
    return None if t is None else t.detach().to("cpu", torch.float64).numpy()


def velocity_gradients(P, state) -> dict:
    """The nine velocity-gradient fields of the spatial statistics (the
    reference's MA_Ux..MA_Wz correlation families, avgij_map.h:14-37)."""
    g = {}
    for cname, comp in (("u", state.u), ("v", state.v), ("w", state.w)):
        for aname, ax in (("x", 0), ("y", 1), ("z", 2)):
            g[cname + aname] = dyn._d1(P, aname, ax, comp)
    return g


class _Ranks:
    """The run's view of its ranks: one device (mesh None), or this rank of
    the mesh.  whole_* gather a rank's blocks into the global fields on
    rank 0 (None on the others; the objects themselves on one device):
    collectives, so every rank calls them at the same points."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.root = mesh is None or mesh.root

    def whole(self, a):
        return a if self.mesh is None or a is None else self.mesh.gather(a)

    def whole_state(self, state):
        if self.mesh is None:
            return state
        Q = self.mesh.gather(torch.cat([state.u[None], state.v[None],
                                        state.w[None], state.s]))
        return None if Q is None else State(u=Q[0], v=Q[1], w=Q[2],
                                            s=Q[3:])

    def whole_comp(self, U):
        if self.mesh is None:
            return U
        parts = [a[None] for a in U[:5]] + ([U.rhos] if U.rhos is not None
                                            else [])
        G = self.mesh.gather(torch.cat(parts))
        if G is None:
            return None
        return type(U)(*G[:5], G[5:] if U.rhos is not None else None)

    def whole_particles(self, pstate):
        if self.mesh is None or pstate is None:
            return pstate
        return ppar.from_mesh(self.mesh, pstate)

    def local_state(self, state):
        """This rank's blocks of a global state (sfc (2, ns, nx, nz) too)."""
        if self.mesh is None:
            return state
        m = self.mesh
        return State(u=m.block(state.u), v=m.block(state.v),
                     w=m.block(state.w), s=m.block(state.s),
                     sfc=None if state.sfc is None
                     else m.block(state.sfc, x_axis=-2, z_axis=-1))

    def local_comp(self, U):
        if self.mesh is None:
            return U
        return type(U)(*(None if a is None else self.mesh.block(a)
                         for a in U))

    def log_launches(self, outdir: str, counts) -> None:
        """On a mesh, the Burgers kernels' launches (K1, K2, K3) of each
        rank's run, one line in tlab.log: the kernels run in the ranks'
        processes, where no caller can count them."""
        if self.mesh is None:
            return
        got = self.mesh.gather_list(torch.tensor(counts, dtype=torch.int64,
                                                 device=self.mesh.device))
        if got is not None:
            with open(os.path.join(outdir, "tlab.log"), "a") as fh:
                fh.write("Burgers kernel launches (K1, K2, K3) by rank: "
                         + ", ".join(f"{r} {g.tolist()}"
                                     for r, g in enumerate(got)) + "\n")

    def elapsed(self, t_start: float) -> float:
        """Seconds since t_start: the ranks' max on a mesh (the walltime
        watchdog then stops every rank at the same step)."""
        dt = time.monotonic() - t_start
        if self.mesh is None:
            return dt
        return float(self.mesh.all_reduce(
            torch.tensor(dt, dtype=torch.float64,
                         device=self.mesh.device), "max"))

    def filters(self, sim: Simulation):
        """(the [Filter] function of a state, the filter sponge's blend) of
        this run, each None where the case has none: on a mesh through
        pencil.make_pencil_filter (a Helmholtz filter through
        pencil_helmholtz) and the sponge's amplitude cut to the block."""
        def on_mesh(mats):
            if not callable(mats):
                return pencil.make_pencil_filter(self.mesh, sim.P, mats=mats)
            spec = sim.case.filter          # [Filter] Type=helmholtz
            wd = spec.parameters[0] if spec.parameters else 2.0
            return pencil.make_pencil_filter(
                self.mesh, sim.P, helmholtz_alpha=-24.0 / max(wd, 1e-30) ** 2)

        def one_device(mats):
            return lambda st: filter_state(mats, st)

        make = one_device if self.mesh is None else on_mesh
        filt = sim.filter_matrices()
        filt_fn = make(filt) if filt is not None else None
        sponge_fn = None
        if sim.filter_sponge is not None:
            amp, mats = sim.filter_sponge
            sfilt = make(mats)
            if self.mesh is not None:
                nxl = amp.shape[0] // self.mesh.px
                amp = amp[self.mesh.ix * nxl:(self.mesh.ix + 1) * nxl]

            def sponge_fn(st):
                return bufmod.blend_sponge(amp, st, sfilt(st))
        return filt_fn, sponge_fn


def _plane_specs(case, n_steps: int):
    """([PlaneSpec], the planes' cadence) of [SavePlanes]; [Iteration]
    SavePlanes <= 0 is clamped to the run length (dns_read_local.f90:538),
    i.e. no in-run planes without the key."""
    cfg = getattr(case, "planes", None) or {}
    specs = [PlaneSpec(axis=ax, indices=cfg[ax]) for ax in ("i", "j", "k")
             if cfg.get(ax)]
    step = cfg.get("step", -1)
    return specs, (step if step > 0 else n_steps + 1)


def _towers(case):
    """The TowerAccumulator of [SaveTowers], or None.  Stride is (si, sj,
    sk) -- ALL three, including the y subsampling (dns_tower.f90:4-8);
    a short list is padded with its last value, like LIST_INT."""
    st = tuple(int(v) for v in
               (getattr(case, "towers", None) or {}).get("stride", ()))
    if not st:
        return None
    return TowerAccumulator(stride=(st + st[-1:] * 3)[:3])


def _restart_dtype(ini) -> str:
    """[Main] FileType=single writes f32 restarts (io_fields.f90:37-40);
    read_field autodetects on reload."""
    return "<f4" if (ini is not None and ini.get(
        "Main", "FileType", "double").lower() == "single") else "<f8"


def _visc_ramp(ini, visc_ini: float, restart_visc, ramp: bool = True):
    """(visc, ramp rate) of the [ViscChange] viscosity ramp: a restart
    whose stored viscosity differs from the INI's relaxes linearly over
    Time toward it (dns_main.f90:176-184, 261)."""
    if ramp and restart_visc is not None and restart_visc > 0.0 \
            and abs(restart_visc - visc_ini) > 1e-14 * visc_ini:
        vtime = ini.get_float("ViscChange", "Time", 0.0) if ini else 0.0
        if vtime > 0.0:
            return restart_visc, (visc_ini - restart_visc) / vtime
    return visc_ini, 0.0


def _ramped(visc: float, visc_ini: float, rate: float, dt: float) -> float:
    """The viscosity `dt` later along the ramp, held at visc_ini once it
    gets there."""
    if rate == 0.0 or visc == visc_ini:
        return visc
    visc = visc + rate * dt
    return visc_ini if (rate > 0) == (visc >= visc_ini) else visc


def _loop_keys(ini, fixed_dt):
    """(dt_lag, runtime_sec, profile) of the loop's [Iteration] and [Main]
    keys.  Lagged dt (DtLag=yes): the next dt comes from the PREVIOUS
    window's CFL, the one-step-stale value compensated by a 0.97 safety
    factor; disabled when dt is fixed.  Kept so that a case with the key
    gives tlab_tpu's numbers.  It hides no latency here: the read is a copy
    on the stream the window was enqueued on, so it still waits for that
    window.  Runtime: the walltime watchdog (dns_main.f90:355-360: write
    tlab.err so job chains stop).  Profiling: per-window wall times
    (reference USE_PROFILE per-RK-substep timing, time.f90:228-329)."""
    dt_lag = bool(ini and ini.get_bool("Iteration", "DtLag", False)
                  and fixed_dt is None)
    runtime_sec = ini.get_float("Iteration", "Runtime", 1.0e7) \
        if ini else 1.0e7
    profile = bool(ini and ini.get_bool("Main", "Profiling", False))
    return dt_lag, runtime_sec, profile


def _stop(outdir: str, text: str) -> None:
    """The line of tlab.err that says why the run stopped."""
    with open(os.path.join(outdir, "tlab.err"), "a") as fh:
        fh.write(text + "\n")


def _write_profile(sim: Simulation, outdir: str, log: RunLog, samples,
                   n_sub: int, inner_steps: int) -> None:
    """dns.prof: the per-window wall times, and their mean per substep at
    the end of the step log."""
    samples = np.asarray(samples)
    per_sub = samples / (inner_steps * n_sub)
    with open(os.path.join(outdir, "dns.prof"), "w") as fh:
        fh.write("# per-window wall time [s] on "
                 f"{_device_name(sim.device)}; per-RK-substep [s] "
                 f"(n_sub={n_sub}, inner_steps={inner_steps})\n")
        fh.write(f"# windows={len(samples)} "
                 f"total={samples.sum():.6f}\n")
        fh.write(f"# substep mean={per_sub.mean():.6e} "
                 f"min={per_sub.min():.6e} max={per_sub.max():.6e}\n")
        for s in samples:
            fh.write(f"{s:.6e}\n")
    log._write(f"# profiling: {per_sub.mean()*1e3:.3f} ms/RK-substep "
               f"(min {per_sub.min()*1e3:.3f})")


def run(sim: Simulation, state: State, outdir: str = ".",
        itime: int = 0, rtime: float = 0.0,
        n_steps: Optional[int] = None, log_path: Optional[str] = None,
        checkpoint: bool = True, nan_abort: bool = True,
        opr_check: bool = False, pstate=None, particle_props=None,
        inner_steps: int = 1, inflow=None,
        restart_visc: Optional[float] = None, mesh=None) -> DnsRun:
    """The time loop from `state` (and `pstate`), n_steps steps (the case's
    end by default).  mesh: this rank of the (x, z) rank mesh; every rank
    calls run with the same arguments and the global state, steps its
    blocks and writes nothing but on rank 0; the DnsRun's state (and
    pstate) is then the global one on rank 0 and None on the others."""
    case = sim.case
    if mesh is not None:
        nx, _, nz = sim.grid.shape
        pencil.check_decomposition(mesh.px, mesh.pz, nx, nz)
    ranks = _Ranks(mesh)
    ini = getattr(case, "ini", None)
    n_steps = n_steps if n_steps is not None else (case.it_end - itime)
    if pstate is not None and inflow is not None:
        raise NotImplementedError("unsteady inflow with particles")
    if sim.comp is not None:
        if pstate is not None:
            raise NotImplementedError(
                "particles in the compressible set: tlab_tpu has no "
                "particle step for it")
        if opr_check:
            raise ValueError(
                "opr_check in the compressible set: its step has no "
                "Poisson plan to check (tlab_tpu's opr_check raises too)")
        return _run_compressible(sim, state, outdir, itime, rtime, n_steps,
                                 log_path, checkpoint, nan_abort,
                                 restart_visc, ranks)
    # the [Filter] cadence and a time-dependent forcing (the wavemaker reads
    # the start-of-step time) are per-step host work: no window across them
    filt = sim.filter_matrices()
    filt_step = case.filter.step if case.filter is not None else 0
    timed = bool(getattr(sim.P.get("bodyforce"), "time_dependent", False))
    spatial = case.flow_type == "spatial"
    if filt is not None or timed or spatial or inflow is not None \
            or pstate is not None:
        inner_steps = 1     # per-step host work (the sums, the particles)
    restart_dtype = _restart_dtype(ini)
    if ranks.root:
        _trace.maybe_init(case, outdir)
    if sim.P.get("surface_bc") is not None and state.sfc is None \
            and state.s.shape[0]:
        # interactive-surface reference state (BcsScal%ref) starts at 0
        # each run, as the reference (allocated fresh per execution)
        ns, nx, _, nz = state.s.shape
        state = state._replace(sfc=state.s.new_zeros((2, ns, nx, nz)))
    with _trace.trace("attach_buffer"):
        sim.attach_buffer(state)
    filt_fn, sponge_fn = ranks.filters(sim)

    def checkpoint_now():
        whole = ranks.whole_state(state)
        if ranks.root:
            fields_io.write_state(os.path.join(outdir, "flow"),
                                  os.path.join(outdir, "scal"), itime, whole,
                                  rtime, visc, dtype=restart_dtype)

    # the [ViscChange] ramp rides into the step as the visc_scale factor on
    # every diffusivity (as tlab_tpu: no ramp with an unsteady inflow or
    # with particles)
    cfla = case.time_cfl
    cfld = case.time_cfl_diffusive
    fixed_dt = case.time_step if case.time_step > 0 else None
    visc_ini = sim.nsp.visc
    visc, ramp_rate = _visc_ramp(ini, visc_ini, restart_visc,
                                 ramp=inflow is None and pstate is None)
    if pstate is not None and particle_props is not None:
        # the droplet types need their property columns (a file from
        # inipart carries none): padded with zeros, else the droplet
        # integration would not run
        need = n_props(particle_props) - pstate.props.shape[1]
        if need > 0:
            pstate = pstate._replace(props=torch.cat(
                [pstate.props, pstate.x.new_zeros((pstate.x.shape[0],
                                                   need))], dim=1))
    n_part = pstate.x.shape[0] if pstate is not None else 0
    if mesh is not None:
        # from here on this rank's blocks, and its particle slots
        state = ranks.local_state(state)
        if pstate is not None:
            cap = ini.get_int("Particles", "MeshCapacity", 0) if ini else 0
            pstate = ppar.to_mesh(mesh, sim.grid, pstate,
                                  capacity=cap or None, dtype=state.u.dtype)

    def _aux():
        aux = {}
        if ramp_rate != 0.0:
            aux["visc_scale"] = visc / visc_ini
        if timed:
            aux["rtime"] = rtime        # the start of the step
        if inflow is not None:
            # the inflow planes at the start of the step (host NumPy, one
            # copy a step)
            aux["refs_x"] = inflow.refs_at(rtime, dtype=state.u.dtype,
                                           ny=state.u.shape[1],
                                           device=state.u.device)
        return aux or None

    with _trace.trace("building step functions"):
        step, diagnostics = make_step_functions(
            sim, inner_steps=inner_steps,
            particles=particle_props if pstate is not None else None,
            mesh=mesh)
    newton = newton_error_fn(sim) is not None

    if ranks.root:
        write_tlab_log(sim, outdir, mesh=mesh)
        if mesh is not None:
            print(mesh.describe(), flush=True)
    log = RunLog(path=log_path if ranks.root else None, newton=newton)
    if opr_check and ranks.root:
        # startup operator self-test + micro-benchmark (reference OPR_CHECK)
        # on rank 0's device
        from tlab_tpu_torch.ops.check import format_report, \
            opr_check as run_check
        log._write(format_report(run_check(sim)))
    log.header()

    obs_log = ini.get("Iteration", "ObsLog", "none").lower() != "none" \
        if ini else False
    plane_specs, plane_step = _plane_specs(case, n_steps)
    towers = _towers(case)
    tower_pressure = bool((case.towers or {}).get("pressure"))
    # in-run particle trajectories and PDFs ([Particles] TrajNumber /
    # CalculatePDF, reference particle_trajectories.f90, particle_pdf.f90)
    traj = part_pdf = None
    if pstate is not None and ini is not None:
        tn = ini.get_int("Particles", "TrajNumber", 0)
        if tn > 0:
            traj = pio.TrajectoryAccumulator(
                tag_ids=np.arange(min(tn, n_part)))
        if ini.get_bool("Particles", "CalculatePDF", False):
            part_pdf = {
                "subdomain": ini.get_floats("Particles", "PdfSubdomain", ()),
                "max": ini.get_float("Particles", "PdfMax", 10.0),
                "interval": ini.get_float("Particles", "PdfInterval", 0.5),
                "locate": make_locator(sim.grid)}
    # spatial mode: (z, t) running sums every [Iteration] SaveStats steps
    # (tlab_tpu's default 1; the reference accumulates once at the end)
    spatial_stats = None
    stats_spa = 1
    it_first = itime
    if spatial:
        stats_spa = max(ini.get_int("Iteration", "SaveStats", 1), 1) \
            if ini is not None else 1
        nx, ny, _ = sim.grid.shape
        spatial_stats = SpatialStats.create(
            nx, ny, ["u", "v", "w"]
            + [f"s{i + 1}" for i in range(sim.nsp.n_scalars)])
    dconst = sim.P["diffusion_constant"]
    max_dil = (getattr(case, "control", None)
               or {}).get("max_dilatation", -1.0)
    # [Iteration] PhaseAvg: phase-locked z-means every `stride` steps
    ph_stride = ini.get_int("Iteration", "PhaseAvg", 0) if ini else 0
    phavg = None
    if ph_stride > 0:
        nx, ny, _ = sim.grid.shape
        phavg = PhaseAverage.create(ph_stride,
                                    max(case.it_restart, ph_stride), nx, ny,
                                    n_scalars=sim.nsp.n_scalars)

    dt_lag, runtime_sec, profile = _loop_keys(ini, fixed_dt)
    prev_diag = None
    n_sub = len(sim.P["rk"]["kdt"])
    prof_samples = []
    launches0 = list(burgers.launches)
    t_start = time.monotonic()

    # initial dt + step-0 log line: one read of [CFL, DilMin, DilMax(,
    # NewtonRs)]
    cmax, *extras0 = diagnostics(state).tolist()
    dtime = fixed_dt or dyn.next_dt(sim.P, cmax, cfla, cfld)
    log.step(0, itime, rtime, dtime, dtime * cmax, dtime * dconst, visc,
             *extras0)

    status = 0
    _trace.point("time loop starts")
    for _ in range(0, n_steps, inner_steps):
        t_it = time.monotonic()
        if pstate is not None:
            state, pstate, diag = step(state, pstate, dtime)
            p_cur = None
        else:
            state, p_cur, diag = step(state, dtime, extra=_aux())
        itime += inner_steps
        rtime += dtime * inner_steps      # Python float64, never a tensor
        visc = _ramped(visc, visc_ini, ramp_rate, dtime * inner_steps)
        if sponge_fn is not None:
            state = sponge_fn(state)
        if filt_fn is not None and filt_step > 0 and itime % filt_step == 0:
            state = filt_fn(state)      # reference DNS_FILTER cadence
        if dt_lag and prev_diag is not None:
            # the window's one host sync: the previous window's diagnostics
            # and this one's, whose NewtonRs (of the stepped state) is what
            # tlab_tpu logs
            (cmax, *extras), now = torch.stack((prev_diag, diag)).tolist()
            cmax *= 1.0 / 0.97
            if newton:
                extras[2] = now[3]
            prev_diag = diag
        else:
            if dt_lag:
                prev_diag = diag
            # the window's one host sync: a 3-element copy
            cmax, *extras = diag.tolist()
        if profile:
            prof_samples.append(time.monotonic() - t_it)
        if nan_abort and not np.isfinite(cmax):
            status = 1                   # reference logs_data(1) != 0 path
            log.step(status, itime, rtime, dtime, np.nan, np.nan, visc,
                     *extras)
            break
        new_dt = fixed_dt or dyn.next_dt(sim.P, cmax, cfla, cfld)
        dnum = new_dt * dconst
        # dilatation bound (DNS_BOUNDS_CONTROL bound_d branch): abort when
        # max |nabla.u| exceeds [Control] MaxDilatation
        if max_dil > 0 and max(abs(extras[0]), abs(extras[1])) > max_dil:
            status = 3
            log.step(status, itime, rtime, new_dt, new_dt * cmax, dnum,
                     visc, *extras)
            if ranks.root:
                _stop(outdir, f"DNS_CONTROL. Dilatation out of bounds "
                      f"at It{itime}.")
            if checkpoint and case.it_restart > 0:
                checkpoint_now()
            break
        if itime % case.it_log == 0:
            log.step(status, itime, rtime, new_dt, new_dt * cmax, dnum,
                     visc, *extras)
            _trace.point(f"iteration {itime} logged (dt={new_dt:.3e})")
        if ranks.elapsed(t_start) > runtime_sec:
            if ranks.root:
                _stop(outdir, f"Maximum walltime of {runtime_sec:g} seconds "
                      f"is reached at It{itime}.")
            if checkpoint and case.it_restart > 0:
                checkpoint_now()
            break
        restart_now = checkpoint and case.it_restart > 0 \
            and itime % case.it_restart == 0
        stats_now = case.it_stats > 0 and itime % case.it_stats == 0
        obs_now = obs_log and itime % case.it_log == 0
        planes_now = bool(plane_specs) and (itime - it_first) % plane_step == 0
        ph_now = phavg is not None and phavg.wants(itime)
        spa_now = spatial_stats is not None \
            and (itime - it_first) % stats_spa == 0
        pdf_now = part_pdf is not None and stats_now
        # the global fields on rank 0 where this step writes or accumulates
        # (the objects themselves on one device)
        g_state = ranks.whole_state(state) if (
            restart_now or stats_now or obs_now or planes_now or ph_now
            or spa_now or pdf_now or towers is not None) else None
        g_p = ranks.whole(p_cur) if (stats_now or planes_now
                                     or spa_now) else None
        g_ps = ranks.whole_particles(pstate) if (
            restart_now or pdf_now or traj is not None) else None
        if restart_now:
            with _trace.trace(f"checkpoint {itime}"):
                if ranks.root:
                    fields_io.write_state(
                        os.path.join(outdir, "flow"),
                        os.path.join(outdir, "scal"), itime, g_state, rtime,
                        visc, dtype=restart_dtype)
                    if pstate is not None:
                        pio.write_particles(
                            os.path.join(outdir, f"part.{itime}"), g_ps,
                            itime)
        if not ranks.root:
            dtime = new_dt
            continue
        if stats_now:
            with _trace.trace(f"statistics {itime}"):
                write_statistics(sim, g_state, outdir, itime, rtime, p=g_p)
            if spatial_stats is not None and spatial_stats.n_samples:
                # per-station Rij budget tables from the running (z,t) sums
                # (reference AVG_FLOW_ZT_REDUCE at the statistics cadence,
                # dns_statistics.f90:233), before this step's sample
                tabs = spatial_stats.station_budgets(
                    _stations(case, sim.grid.shape[0]), sim.nsp.visc,
                    d1x=_host(sim.P.get("d1x")), d1y=_host(sim.P.get("d1y")))
                write_station_budgets(
                    os.path.join(outdir, f"avg_zt{itime}"),
                    sim.grid.x.nodes, sim.grid.y.nodes, tabs, itime, rtime)
        if traj is not None:
            traj.accumulate(itime, rtime, g_ps)
            if restart_now:
                traj.flush(outdir)
        if pdf_now:
            _particle_pdf(sim, g_state, g_ps, part_pdf, outdir, itime)
        if obs_now:
            write_obs(sim, g_state, outdir, itime, rtime)
        if planes_now:
            # every plane set carries the pressure too (planes.f90
            # PLANES_INITIALIZE sizes flow + scalars + 1)
            write_planes(outdir, itime, g_state, plane_specs,
                         pressure=g_p if g_p is not None
                         else pressure_boussinesq(sim.P, g_state))
        if towers is not None:
            towers.accumulate(itime, rtime, g_state, pressure=(
                pressure_boussinesq(sim.P, g_state) if tower_pressure
                else None))
            if restart_now:
                towers.flush(outdir)
        if ph_now:
            pfields = {"u": g_state.u, "v": g_state.v, "w": g_state.w,
                       "p": pressure_boussinesq(sim.P, g_state)}
            for i in range(sim.nsp.n_scalars):
                pfields[f"s{i + 1}"] = g_state.s[i]
            phavg.accumulate(itime, pfields)
            if restart_now:
                phavg.save(os.path.join(outdir, f"phavg{itime}.npz"), itime)
        if spa_now:
            # one device reduction; only (K, nx, ny) comes to the host
            spatial_stats.accumulate_device(
                state_fields(g_state),
                grads=velocity_gradients(sim.P, g_state), p=g_p)
            if restart_now:
                spatial_stats.save(os.path.join(outdir, f"st{itime}.npz"),
                                   itime)
        dtime = new_dt

    if profile and prof_samples and ranks.root:
        _write_profile(sim, outdir, log, prof_samples, n_sub, inner_steps)
    if checkpoint and status != 0 and case.it_restart > 0 \
            and itime % case.it_restart != 0:
        checkpoint_now()
    ranks.log_launches(outdir, [b - a for a, b in zip(launches0,
                                                      burgers.launches)])
    state = ranks.whole_state(state)
    pstate = ranks.whole_particles(pstate)
    if traj is not None and ranks.root:
        traj.flush(outdir)
    return DnsRun(sim=sim, state=state, itime=itime, rtime=rtime, log=log,
                  pstate=pstate)


def _particle_pdf(sim: Simulation, state: State, pstate, cfg: dict,
                  outdir: str, itime: int) -> None:
    """particle_pdf.<it>: the reference PARTICLE_PDF on the LAST scalar
    (the diagnostic AirWaterLinear liquid where the mixture is that,
    s(:,inb_scal_array))."""
    tcfg = sim.case.thermo or {}
    sf = state.s[-1] if state.s.shape[0] else torch.zeros_like(state.u)
    if tcfg.get("mixture", "") == "airwaterlinear" \
            and tcfg.get("parameters"):
        sf = thermo.airwater_linear(tuple(tcfg["parameters"]), state.s)
    pio.particle_pdf_reference(
        sim.grid, pstate, sf, cfg["locate"], cfg["subdomain"], cfg["max"],
        cfg["interval"], os.path.join(outdir, f"particle_pdf.{itime}"))


def _run_compressible(sim: Simulation, U, outdir: str, itime: int,
                      rtime: float, n_steps: int, log_path, checkpoint: bool,
                      nan_abort: bool, restart_visc,
                      ranks: _Ranks = None) -> DnsRun:
    """run() of the compressible set (sim.comp): one RK step a window; dt
    from the acoustic CFL and the diffusion-number density (TIME_COURANT's
    compressible branch); the log's PMin PMax RMin RMax (and NewtonRs for
    AirWater), read with the CFL in one copy a step; the [Control]
    pressure and density bounds (DNS_BOUNDS_CONTROL, dns_local.f90:136-158);
    the buffer attached at the start (Simulation.attach_buffer_compressible);
    write_comp_state restarts, the Favre statistics and, in a spatial run,
    the density-weighted station sums; the planes and towers of the
    primitive view (comp_mod.primitive_view) with the EOS pressure of the
    step.  As tlab_tpu's compressible thread: no [Filter], ObsLog or
    dilatation bound, and the [ViscChange] ramp moves only the log's visc
    column.  ranks: the mesh's view (run's), the blocks stepped and
    gathered to rank 0 for every file."""
    ranks = ranks or _Ranks(None)
    mesh = ranks.mesh
    case = sim.case
    ini = case.ini
    restart_dtype = _restart_dtype(ini)
    if ranks.root:
        _trace.maybe_init(case, outdir)
    cfla = case.time_cfl
    cfld = case.time_cfl_diffusive
    fixed_dt = case.time_step if case.time_step > 0 else None
    visc_ini = sim.nsp.visc
    visc, ramp_rate = _visc_ramp(ini, visc_ini, restart_visc)
    dt_lag, runtime_sec, profile = _loop_keys(ini, fixed_dt)
    bnd = sim.comp.get("bounds")
    with _trace.trace("attach_buffer"):
        sim.attach_buffer_compressible(U)
    U = ranks.local_comp(U)
    with _trace.trace("building step functions"):
        step, diagnostics = _compressible_step_functions(sim, mesh)
    if ranks.root:
        write_tlab_log(sim, outdir, mesh=mesh)
        if mesh is not None:
            print(mesh.describe(), flush=True)
    log = RunLog(path=log_path if ranks.root else None, comp=True,
                 newton=sim.comp.get("aw") is not None)
    log.header()
    # spatial mode: the density-weighted (z, t) sums every [Iteration]
    # SaveStats steps, reduced on the device (one (K, nx, ny) copy)
    spatial_stats = reducer = None
    stats_spa = 1
    it_first = itime
    if case.flow_type == "spatial":
        stats_spa = max(ini.get_int("Iteration", "SaveStats", 1), 1) \
            if ini is not None else 1
        nx, ny, _ = sim.grid.shape
        spatial_stats = SpatialStats.create(
            nx, ny, ["u", "v", "w"]
            + [f"s{i + 1}" for i in range(sim.nsp.n_scalars)])
        reducer = make_comp_spatial_reducer(sim, spatial_stats)
    plane_specs, plane_step = _plane_specs(case, n_steps)
    towers = _towers(case)
    tower_pressure = bool((case.towers or {}).get("pressure"))

    def checkpoint_now():
        whole = ranks.whole_comp(U)
        if ranks.root:
            fields_io.write_comp_state(os.path.join(outdir, "flow"), itime,
                                       whole, rtime, visc,
                                       dtype=restart_dtype)

    def next_dt(cmax, dden):
        dt = fixed_dt or min(cfla / cmax if cmax > 0 else np.inf,
                             cfld / dden if dden > 0 else np.inf)
        return dt, dt * dden

    # initial dt + step-0 log line: one read of [CFL, PMin, PMax, RMin,
    # RMax, (NewtonRs,) diffusion-number density]
    cmax, *extras, dden = diagnostics(U).tolist()
    dtime, dnum = next_dt(cmax, dden)
    log.step(0, itime, rtime, dtime, dtime * cmax, dnum, visc, *extras)

    status = 0
    prev_diag = None
    prof_samples = []
    t_start = time.monotonic()
    _trace.point("time loop starts")
    for _ in range(n_steps):
        t_it = time.monotonic()
        U, p_cur, diag = step(U, dtime)
        itime += 1
        rtime += dtime
        visc = _ramped(visc, visc_ini, ramp_rate, dtime)
        # the window's one host sync: a 6- or 7-element copy (the previous
        # window's with DtLag)
        cmax, *extras, dden = (prev_diag if dt_lag and prev_diag is not None
                               else diag).tolist()
        if dt_lag and prev_diag is not None:
            cmax *= 1.0 / 0.97
        if dt_lag:
            prev_diag = diag
        if profile:
            prof_samples.append(time.monotonic() - t_it)
        if nan_abort and not np.isfinite(cmax):
            status = 1
            log.step(status, itime, rtime, dtime, np.nan, np.nan, visc,
                     *extras)
            break
        new_dt, dnum = next_dt(cmax, dden)
        if bnd is not None and (
                extras[0] < bnd["p"][0] or extras[1] > bnd["p"][1]
                or extras[2] < bnd["r"][0] or extras[3] > bnd["r"][1]):
            status = 2              # DNS_ERROR_NEGDENS/NEGPRESS analog
            log.step(status, itime, rtime, new_dt, new_dt * cmax, dnum,
                     visc, *extras)
            if ranks.root:
                _stop(outdir, f"DNS_CONTROL. Pressure/density out of bounds "
                      f"at It{itime}.")
            if checkpoint and case.it_restart > 0:
                checkpoint_now()
            break
        if itime % case.it_log == 0:
            log.step(status, itime, rtime, new_dt, new_dt * cmax, dnum,
                     visc, *extras)
            _trace.point(f"iteration {itime} logged (dt={new_dt:.3e})")
        if ranks.elapsed(t_start) > runtime_sec:
            if ranks.root:
                _stop(outdir, f"Maximum walltime of {runtime_sec:g} seconds "
                      f"is reached at It{itime}.")
            if checkpoint and case.it_restart > 0:
                checkpoint_now()
            break
        restart_now = checkpoint and case.it_restart > 0 \
            and itime % case.it_restart == 0
        stats_now = case.it_stats > 0 and itime % case.it_stats == 0
        planes_now = bool(plane_specs) and (itime - it_first) % plane_step == 0
        spa_now = spatial_stats is not None \
            and (itime - it_first) % stats_spa == 0
        # the global fields on rank 0 where this step writes or accumulates
        g_U = ranks.whole_comp(U) if (
            restart_now or stats_now or planes_now or spa_now
            or towers is not None) else None
        g_p = ranks.whole(p_cur) if (
            planes_now or (towers is not None and tower_pressure)) else None
        if not ranks.root:
            dtime = new_dt
            continue
        if restart_now:
            with _trace.trace(f"checkpoint {itime}"):
                fields_io.write_comp_state(os.path.join(outdir, "flow"),
                                           itime, g_U, rtime, visc,
                                           dtype=restart_dtype)
        if stats_now:
            with _trace.trace(f"statistics {itime}"):
                write_statistics_compressible(sim, g_U, outdir, itime, rtime)
            if spatial_stats is not None and spatial_stats.n_samples:
                # Favre station tables from the density-weighted (z, t)
                # sums (avg_flow_zt_reduce.f90), before this step's sample,
                # and the full MA_* register table (avgij_map.h families)
                sta = _stations(case, sim.grid.shape[0])
                for name, tabs in (
                        (f"avg_zt{itime}",
                         spatial_stats.favre_station_table(sta)),
                        (f"avgMA_zt{itime}",
                         register_station_table(spatial_stats, sta))):
                    if tabs:
                        write_station_budgets(
                            os.path.join(outdir, name), sim.grid.x.nodes,
                            sim.grid.y.nodes, tabs, itime, rtime)
        if planes_now:
            write_planes(outdir, itime, comp_mod.primitive_view(g_U),
                         plane_specs, pressure=g_p)
        if towers is not None:
            towers.accumulate(itime, rtime, comp_mod.primitive_view(g_U),
                              pressure=g_p if tower_pressure else None)
            if restart_now:
                towers.flush(outdir)
        if spa_now:
            with _trace.trace(f"spatial sums {itime}"):
                spatial_stats.accumulate_comp_stack(reducer(g_U))
            if restart_now:
                spatial_stats.save(os.path.join(outdir, f"st{itime}.npz"),
                                   itime)
        dtime = new_dt

    if profile and prof_samples and ranks.root:
        _write_profile(sim, outdir, log, prof_samples,
                       len(sim.P["rk"]["kdt"]), 1)
    if checkpoint and status != 0 and case.it_restart > 0 \
            and itime % case.it_restart != 0:
        checkpoint_now()
    return DnsRun(sim=sim, state=ranks.whole_comp(U), itime=itime,
                  rtime=rtime, log=log)


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


def write_tlab_log(sim: Simulation, outdir: str, extra: str = "",
                   mesh=None) -> None:
    """Run-provenance narrative log (reference tlab.log written by
    TLab_Write_ASCII during initialization: banner, option echo, sizes);
    on a rank mesh its shape, ranks and backend after the device line."""
    case = sim.case
    nx, ny, nz = sim.grid.shape
    lines = [
        "########################################",
        "# tlab_tpu_torch DNS",
        f"# started {datetime.datetime.now().isoformat(timespec='seconds')}",
        "########################################",
        f"Devices          : {_device_name(sim.device)}",
        *([f"Mesh             : {mesh.describe()}"] if mesh is not None
          else []),
        f"Precision        : {str(sim.dtype).replace('torch.', '')}",
        f"Grid             : {nx} x {ny} x {nz}",
        f"Scales           : {sim.grid.x.scale:g} x {sim.grid.y.nodes[-1] - sim.grid.y.nodes[0]:g} x {sim.grid.z.scale:g}",
        f"Periodicity      : x={sim.grid.x.periodic} y={sim.grid.y.periodic} z={sim.grid.z.periodic}",
        f"Type             : {case.flow_type}",
        f"Equations        : {case.equations}",
        f"SpaceOrder       : {case.space_order1} / {case.space_order2}",
        f"TimeOrder        : {case.time_order}",
        f"Reynolds         : {case.reynolds:g}  (visc={sim.nsp.visc:g})",
        f"Schmidt          : {tuple(case.schmidt)}",
        f"VelocityBCs      : jmin={case.velocity_bc[0]} jmax={case.velocity_bc[1]}",
        f"Buffer           : {getattr(getattr(case, 'buffer', None), 'type', 'none')}",
        f"Stagger          : {getattr(case, 'stagger', False)}",
        f"EllipticOrder    : {case.elliptic_order or 'factorize (default)'}",
    ]
    if extra:
        lines.append(extra)
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "tlab.log"), "a") as fh:
        fh.write("\n".join(lines) + "\n")
