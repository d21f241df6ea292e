"""Command-line entry points sharing one tlab.ini-compatible config (port of
tlab_tpu/tools/cli.py: pre-processing, the DNS loop and the statistics
post-processing).

Usage:  python -m tlab_tpu_torch.tools.cli <command> [--ini tlab.ini] [options]
Commands: inigrid, ini (aliases inirand, iniflow, iniscal), inipart, dns,
averages, spectra, pdfs, superlayer, visuals, apriori, transfields,
transgrid, stats2nc, planes2nc, tower2nc, and the cloud-state tools state,
smooth, saturation, reversal.
Equivalent surface to the reference executables inigrid.x/inirand.x/
iniflow.x/iniscal.x/inipart.x/dns.x/averages.x/spectra.x/pdfs.x/visuals.x/
apriori.x/transfields.x/transgrid.x/state.x/smooth.x/saturation.x/
reversal.x, the superlayer tools and stats2nc.py/Planes2nc.py/tower2nc.py.
The run is on the CUDA card unless --device names another device; --x64
computes in float64 (validation mode).  --debug-nans, or [Main]
DebugNans=yes in the case file, stops any command at the first NaN a
computation makes with FloatingPointError naming the op
(utils/nantrap.py; tlab_tpu's jax_debug_nans).

dns on a rank mesh: --mesh PX,PZ or [Parallel] Mesh=PX,PZ.  Launched as one
process, dns spawns PX PZ ranks itself (parallel.mesh.spawn, a FileStore in
--outdir) and exits non-zero if any rank fails; under
`python -m torch.distributed.run --nproc-per-node PX*PZ` each process joins
the world of the environment (a world of another size is refused).  The
backend: NCCL where every rank has a card of its own, gloo where ranks share
a card or run on the CPU (tlab.log's "Mesh" line).

Files: inigrid writes `grid` and `<ini>.bak`; ini writes
flow.<Start>.{1,2,3} and scal.<Start>.<i> (the compressible set: the
conservative flow.<Start>.{1..5} and flow.<Start>.s<i>); inipart writes
part.<Start> ([Particles] Number, the IniP keys); dns reads them (the
particles where [Particles] Type is set and part.<Start> exists) and writes
dns.out, tlab.log, restarts (and part.<it>, trajectories) at the
[Iteration] Restart cadence, avg<it> / avg<it>s<i> at the Statistics
cadence, planesI/J/K.<it> and tower.* where [SavePlanes]/[SaveTowers]
ask.  The post-processing commands read the restarts of --files (else
[PostProcessing] Files): averages writes avg<it>, avg<it>s<i> (and
cavg<it>, int<it> with --gate-scalar; the ParamAverages analysis table),
spectra xsp/zsp/rsp (and xcr/zcr, pow/pha), pdfs pdf<it>.<tag>
(ParamPdfs), superlayer sl<it>.npz, visuals vis<it>.<name> (--fields,
else the [PostProcessing] ParamVisuals menu numbers), apriori tau<it> and
sgs<it> (gradU<it> with ParamStructure=2), transfields flow_rm.<it>.* and
scal_rm.<it>.* on the grid of --ini2, stats2nc avg<it>.nc, planes2nc
planesI/J/K.<it>.nc, tower2nc towers.nc.  transgrid reads --grid-in and
writes --grid-out in --outdir (no case file); the cloud tools write
state.dat, vapor.dat, sat.dat or reversal.dat, with [Thermodynamics] of
--ini where that file exists.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

from tlab_tpu_torch.utils import nantrap

INI_COMMANDS = ("ini", "inirand", "iniflow", "iniscal")
POST_COMMANDS = ("averages", "spectra", "pdfs", "superlayer", "visuals",
                 "apriori")
CONVERTERS = ("stats2nc", "planes2nc", "tower2nc")
CLOUD_TOOLS = ("state", "smooth", "saturation", "reversal")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tlab-tpu-torch")
    ap.add_argument("command",
                    choices=["inigrid", *INI_COMMANDS, "inipart", "dns",
                             *POST_COMMANDS, "transfields", "transgrid",
                             *CONVERTERS, *CLOUD_TOOLS])
    ap.add_argument("--ini2", default="",
                    help="target-case ini for transfields remeshing")
    ap.add_argument("--nparticles", type=int, default=10000,
                    help="inipart: particles where [Particles] Number "
                         "is not set")
    ap.add_argument("--inner-steps", type=int, default=1,
                    help="RK steps per host sync (fixed dt within)")
    ap.add_argument("--mesh", default="",
                    help="PX,PZ rank mesh for a multi-rank dns run "
                         "(overrides [Parallel] Mesh)")
    ap.add_argument("--ini", default="tlab.ini")
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--seed", type=int, default=None,
                    help="override [Broadband] Seed (default: ini value)")
    ap.add_argument("--x64", action="store_true",
                    help="run in float64 (validation mode)")
    ap.add_argument("--debug-nans", action="store_true",
                    help="trap the first NaN (not Inf) that a computation "
                         "makes: FloatingPointError naming the op or the "
                         "Burgers kernel's entry point (the reference's "
                         "debug-build FPE trap, config/*.cmake "
                         "-ffpe-trap); also [Main] DebugNans=yes")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' for a run without one)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--files", default="",
                    help="comma-separated snapshot iterations for "
                         "postprocessing")
    ap.add_argument("--fields", default="",
                    help="comma-separated derived fields for visuals "
                         "(default: [PostProcessing] ParamVisuals, else "
                         "Enstrophy)")
    ap.add_argument("--cross", action="store_true",
                    help="spectra: add pair cross-spectra (pow/pha)")
    ap.add_argument("--correlations", action="store_true",
                    help="spectra: add two-point correlations (xcr/zcr)")
    ap.add_argument("--y-blocks", type=int, default=0,
                    help="spectra: write 2-D (kx,kz) spectra in y blocks")
    ap.add_argument("--gate-scalar", type=int, default=0,
                    help="averages: condition on scalar # > gate level")
    ap.add_argument("--gate-level", type=float, default=0.0)
    ap.add_argument("--refine", type=int, default=2,
                    help="transgrid: points multiplier per direction "
                         "(-k divides by k)")
    # cloud-state tools (reference state.x/smooth.x/saturation.x/
    # reversal.x, src/tools/cloud): flags replace the interactive prompts
    ap.add_argument("--p", type=float, default=1.0,
                    help="cloud tools: pressure (nondimensional)")
    ap.add_argument("--h", type=float, default=None,
                    help="cloud tools: static enthalpy")
    ap.add_argument("--qt", type=float, default=None,
                    help="cloud tools: total-water specific humidity")
    ap.add_argument("--h2", type=float, default=None,
                    help="reversal: enthalpy of the second parcel")
    ap.add_argument("--qt2", type=float, default=None,
                    help="reversal: qt of the second parcel")
    ap.add_argument("--range", dest="sweep", default="",
                    help="smooth/saturation: sweep 'start,stop,n'")
    ap.add_argument("--npts", type=int, default=201,
                    help="cloud tools: points along the mixing line")
    ap.add_argument("--grid-in", default="grid",
                    help="transgrid: grid file read in --outdir")
    ap.add_argument("--grid-out", default="grid.ref",
                    help="transgrid: grid file written in --outdir")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    try:
        # before the command branches, as tlab_tpu sets jax_debug_nans
        with nantrap.trap(args.debug_nans):
            return _run(args)
    except NotImplementedError as e:        # an option that is not ported
        raise SystemExit(f"tlab_tpu_torch: {e}")


def _mesh_shape(spec: str) -> tuple:
    px, pz = (int(v) for v in spec.split(","))
    return px, pz


def _dns_rank(mesh, args) -> int:
    """One rank of a spawned mesh run: the dns command on this rank."""
    with nantrap.trap(args.debug_nans):
        return _run(args, mesh)


def _dns_on_mesh(args, spec: str) -> int:
    """dns on a (px, pz) rank mesh: join the world of torch.distributed.run
    where this process is one of its ranks, else spawn the px pz ranks."""
    import torch.distributed as dist
    from tlab_tpu_torch.config import load_case
    from tlab_tpu_torch.parallel import mesh as pmesh
    from tlab_tpu_torch.parallel.pencil import check_decomposition
    from tlab_tpu_torch.runtime import grid_from_case
    px, pz = _mesh_shape(spec)
    nx, _, nz = grid_from_case(load_case(args.ini)).shape
    check_decomposition(px, pz, nx, nz)
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        if world != px * pz:
            raise SystemExit(f"tlab_tpu_torch: mesh {px}x{pz} needs "
                             f"{px * pz} ranks, torch.distributed.run "
                             f"started {world}")
        import datetime
        rank = int(os.environ["RANK"])
        dev = pmesh.rank_device(args.device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            pmesh.backend_rule(world, args.device),
            timeout=datetime.timedelta(seconds=pmesh.TIMEOUT_S))
        try:
            return _run(args, pmesh.make_mesh(px, pz, args.device))
        finally:
            dist.destroy_process_group()
    try:
        pmesh.spawn(_dns_rank, px, pz, args.device, args,
                    store_dir=args.outdir, results=False)
    except Exception as e:                  # a rank failed or timed out
        raise SystemExit(f"tlab_tpu_torch: dns on mesh {px}x{pz} failed: "
                         f"{e}")
    return 0


def _run(args, mesh=None) -> int:
    from tlab_tpu_torch.config import load_case

    # the commands that need no case file go before it is read
    if args.command == "transgrid":
        return _transgrid(args)
    if args.command in CLOUD_TOOLS:
        return _cloud_tool(args)

    case = load_case(args.ini)
    # [Main] DebugNans=yes|true turns the trap on as --debug-nans does (and
    # so for the ranks of a mesh run too)
    if case.ini.get("Main", "DebugNans", "no").lower() in ("yes", "true"):
        args.debug_nans = True
    with nantrap.trap(args.debug_nans):
        return _case_command(args, case, mesh)


def _case_command(args, case, mesh=None) -> int:
    """The commands that read the case file `case`; tlab.trace, where the
    case asks for it, is the root's and ends with the registry's table."""
    from tlab_tpu_torch.utils import trace

    os.makedirs(args.outdir, exist_ok=True)
    if args.command == "dns" and mesh is None:
        spec = args.mesh or case.ini.get("Parallel", "Mesh", "")
        if spec:
            return _dns_on_mesh(args, spec)
    if mesh is not None and not mesh.root:
        return _command(args, case, mesh)
    trace.maybe_init(case, args.outdir)
    try:
        return _command(args, case, mesh)
    finally:
        trace.close()


def _command(args, case, mesh=None) -> int:
    """_case_command's command, on this rank."""
    from tlab_tpu_torch.convert import state_from_numpy
    from tlab_tpu_torch.grid import write_reference_grid
    from tlab_tpu_torch.io import fields_io
    from tlab_tpu_torch.particles.core import props_from_ini
    from tlab_tpu_torch.particles.io import read_particles
    from tlab_tpu_torch.runtime import Simulation, grid_from_case
    from tlab_tpu_torch.utils import trace

    trace.point(f"tool {args.command} starting ({args.ini})")

    if args.command == "inigrid":
        grid = grid_from_case(case)
        write_reference_grid(os.path.join(args.outdir, "grid"), grid)
        case.ini.write_bak(os.path.join(args.outdir,
                                        os.path.basename(args.ini) + ".bak"))
        print(f"grid written: {grid.shape}")
        return 0

    # [PostProcessing] Files = iteration list (the reference tools' batch
    # input, dns_read_times.h), unless --files names them
    its = [int(t) for t in args.files.split(",") if t] or [
        int(v) for v in case.ini.get_floats("PostProcessing", "Files", ())]
    if args.command in CONVERTERS:
        return _convert(args, case, its)

    dtype = torch.float64 if args.x64 else torch.float32
    sim = Simulation.from_case(case, dtype=dtype, device=args.device
                               if mesh is None else mesh.device)
    flow = os.path.join(args.outdir, "flow")
    scal = os.path.join(args.outdir, "scal")

    if args.command in INI_COMMANDS:
        from tlab_tpu_torch.tools import initialize
        if sim.comp is not None:
            # compressible restart: the conservative fields (reference
            # inb_flow=5, io_fields flow.<it>.1-5)
            with trace.trace("initial_state"):
                U = initialize.compressible_initial_state(sim,
                                                          seed=args.seed)
            fields_io.write_comp_state(flow, case.it_start, U, 0.0,
                                       sim.nsp.visc)
        else:
            with trace.trace("initial_state"):
                state = initialize.initial_state(sim, seed=args.seed)
            fields_io.write_state(flow, scal, case.it_start, state, 0.0,
                                  sim.nsp.visc)
        print(f"initial fields written at it={case.it_start}")
        return 0

    if args.command == "inipart":
        return _inipart(args, case, sim)

    if args.command == "transfields":
        return _transfields(args, sim, its)

    if args.command in POST_COMMANDS:
        from tlab_tpu_torch.tools import postprocess as pp
        debug = args.debug_nans
        if args.command == "visuals":
            fields = tuple(f for f in args.fields.split(",") if f) \
                or visual_menu(case, sim)
            pp.run_visuals(sim, args.outdir, its, which=fields,
                           debug_nans=debug)
        elif args.command == "apriori":
            pp.run_apriori(sim, args.outdir, its, debug_nans=debug)
        elif args.command == "averages":
            pp.run_averages(sim, args.outdir, its,
                            gate_scalar=args.gate_scalar,
                            gate_level=args.gate_level, debug_nans=debug)
        elif args.command == "spectra":
            cross, corr = args.cross, args.correlations
            psp = case.ini.get_floats("PostProcessing", "ParamSpectra", ())
            if psp and not (cross or corr or args.y_blocks):
                # ParamSpectra: 1 spectra, 2 cross-spectra,
                # 3 correlations, 4 cross-correlations (spectra.f90 menu)
                cross = int(psp[0]) in (2, 4)
                corr = int(psp[0]) in (3, 4)
            pp.run_spectra(sim, args.outdir, its, cross=cross,
                           correlations=corr, y_blocks=args.y_blocks,
                           debug_nans=debug)
        elif args.command == "pdfs":
            pp.run_pdfs(sim, args.outdir, its, debug_nans=debug)
        else:
            pp.run_superlayer(sim, args.outdir, its, debug_nans=debug)
        print(f"{args.command} done for {its}")
        return 0

    # dns (on a rank mesh: this rank's part of the run)
    from tlab_tpu_torch.tools import dns as dns_tool
    it0 = case.it_start
    if sim.comp is not None:
        from tlab_tpu_torch.dycore.compressible import CompState
        # as tlab_tpu's: no [ViscChange] ramp in the compressible set
        with trace.trace("io.read_state"):
            U0, rtime, _ = fields_io.read_comp_state(flow, it0)
            state = CompState(*(None if a is None else torch.as_tensor(
                a).to(sim.device, sim.dtype) for a in U0))
        visc0 = None
    else:
        with trace.trace("io.read_state"):
            u, v, w, s, rtime, visc0 = fields_io.read_state(
                flow, scal, it0, sim.nsp.n_scalars)
            state = state_from_numpy(u, v, w, s, sim.device, sim.dtype)
    # Lagrangian particles (reference dns.x particle path): engaged when
    # [Particles] Type is set and a part.<it> restart exists
    pstate = None
    pprops = props_from_ini(case.ini) if sim.comp is None else None
    ppath = os.path.join(args.outdir, f"part.{it0}")
    if pprops is not None and os.path.exists(ppath):
        pstate, _ = read_particles(ppath, dtype=sim.dtype,
                                   device=sim.device)
    else:
        pprops = None           # no particle restart -> flow only
    run = dns_tool.run(sim, state, outdir=args.outdir, itime=it0,
                       rtime=float(rtime), n_steps=args.steps,
                       log_path=os.path.join(args.outdir, "dns.out"),
                       inner_steps=args.inner_steps, pstate=pstate,
                       particle_props=pprops,
                       restart_visc=float(visc0) if visc0 else None,
                       mesh=mesh, debug_nans=args.debug_nans)
    if mesh is None or mesh.root:
        print("\n".join(run.log.lines[-3:]))
    return 0


def _convert(args, case, its) -> int:
    """stats2nc, planes2nc, tower2nc: the scripts/python converters
    (stats2nc.py, Planes2nc.py, tower2nc.py), host work from the case
    file's grid, plane indices and tower strides."""
    import types

    from tlab_tpu_torch.physics.params import NSParams
    from tlab_tpu_torch.runtime import grid_from_case
    from tlab_tpu_torch.tools import convert
    if args.command == "stats2nc":
        out = convert.stats_to_nc(args.outdir, its)
    else:
        sim = types.SimpleNamespace(
            case=case, grid=grid_from_case(case),
            nsp=NSParams(reynolds=case.reynolds,
                         schmidt=tuple(case.schmidt)))
        if args.command == "planes2nc":
            out = convert.planes_to_nc(sim, args.outdir, its)
        else:
            out = convert.towers_to_nc(sim, args.outdir)
            out = [out] if out else []
    print(f"{args.command}: wrote {out}")
    return 0


def visual_menu(case, sim) -> tuple:
    """The names of the [PostProcessing] ParamVisuals menu numbers (the
    visuals.f90 menu, visuals.f90:179-213): iscal_offset = 9, or 9 + the
    species of a mixture (visuals.f90:166-167,189-192,649-668); Supsat
    joins 7 for the non-equilibrium airwater (Damkohler(1) > 0,
    visuals.f90:527), EpsSolid the Strain and Stress entries of an IBM
    case, and PressureDecomposition=resolved adds the pressure's parts to
    8.  ("Enstrophy",) without the key or where its numbers name nothing."""
    from tlab_tpu_torch.physics.mixtures import MIXTURES
    ini = case.ini
    pvis = ini.get_floats("PostProcessing", "ParamVisuals", ())
    ns = sim.nsp.n_scalars
    lpe = ("LogPotentialEnstrophy",)
    eps_s = ("EpsSolid",) if sim.P.get("ibm") else ()
    mix = ((case.thermo or {}).get("mixture", "") or "").lower()
    damk = ini.get_floats("Parameters", "Damkohler", ())
    sups = ("Supsat",) if (mix == "airwater" and ns >= 3 and damk
                           and damk[0] > 0.0) else ()
    if mix in ("", "none"):
        spn = ()
    elif mix == "airwater":
        spn = ("H2Ov", "Air", "H2Ol")
    elif mix == "airvapor":
        spn = ("H2Ov", "Air")
    elif mix == "airwaterlinear":
        spn = ("Chi", "Psi") + tuple(
            f"Scalar{i}" for i in range(3, ns + 1)) + ("Liquid",)
    elif mix in MIXTURES:
        spn = MIXTURES[mix]
    else:
        spn = tuple(f"Scalar{i + 1}" for i in range(ns))
    off = 9 + len(spn)
    scal9 = tuple(f"Scalar{i + 1}" for i in range(max(ns, 1)))
    if mix in ("airwater", "airwaterlinear"):
        scal9 = scal9 + ("Liquid",)       # the inb_scal_array slot
    menu = {1: ("VelocityX",), 2: ("VelocityY",), 3: ("VelocityZ",),
            4: ("VelocityVector",), 5: ("VelocityMagnitude",),
            6: ("Density",), 7: ("Temperature",) + sups,
            8: ("Pressure", "PressureGradientPower", "PressureStrainX",
                "PressureStrainY", "PressureStrainZ",
                "PressureHydrostatic", "PressureHydrodynamic"),
            9: scal9}
    for i, nm in enumerate(spn):
        menu[10 + i] = (nm,)
    menu.update({
        off + 1: ("ScalarGradientVector",),
        off + 2: ("ScalarGradient",),
        off + 3: ("ScalarGradientProduction",),
        off + 4: ("VorticityVector",),
        off + 5: ("LogEnstrophy",) + lpe,
        off + 6: ("Enstrophy", "EnstrophyProduction",
                  "EnstrophyDiffusion") + lpe,
        off + 7: ("StrainTensor",),
        # +8/+9 share the Strain block which also accumulates the stress
        # tensor + IBM mask (visuals.f90:786-830)
        off + 8: ("LogStrain", "StressTensor") + eps_s,
        off + 9: ("Strain", "StressTensor", "StrainProduction",
                  "StrainDiffusion", "StrainPressure") + eps_s,
        off + 10: ("InvariantP", "InvariantQ", "InvariantR"),
        off + 12: ("Buoyancy", "Fvb", "bPrime", "Cvb",
                   "LogBuoyancySource"),
        off + 14: ("HorizontalDivergence",),
        off + 15: ("Tke", "ReynoldsTensor"),
        off + 16: ("Radiation",),
        off + 17: ("RelativeHumidity",),
        off + 18: ("ParticleDensity",),
        off + 19: ("LaplacianV", "Buoyancy", "LaplacianB", "GradientRi",
                   "Pressure", "PressureGradientY"),
        off + 20: ("StressTensor",) + eps_s})
    if ini.get("PostProcessing", "PressureDecomposition",
               "total").lower() == "resolved":
        menu[8] = menu[8] + ("PressureCoriolis", "PressureBuoyancy",
                             "PressureDiffusion", "PressureAdvection",
                             "PressureAdvDiff", "PressureTotal")
    return tuple(n for v in pvis for n in menu.get(int(v), ())) \
        or ("Enstrophy",)


def _transgrid(args) -> int:
    """Grid refinement/coarsening (reference transgrid.f90): each axis's
    nodes resampled linearly in the arc parameter, --refine times as many
    points (1/k of them for -k); host work, no case file."""
    import numpy as np

    from tlab_tpu_torch.grid import (Grid, make_axis, read_reference_grid,
                                     write_reference_grid)
    g = read_reference_grid(os.path.join(args.outdir, args.grid_in))
    axes = []
    for ax in (g.x, g.y, g.z):
        if ax.size <= 1:
            axes.append(ax)
            continue
        n_new = ax.size * args.refine if args.refine > 0 \
            else ax.size // (-args.refine)
        nodes = np.interp(np.linspace(0.0, 1.0, n_new),
                          np.linspace(0.0, 1.0, ax.size), ax.nodes)
        axes.append(make_axis(nodes, ax.periodic))
    write_reference_grid(os.path.join(args.outdir, args.grid_out),
                         Grid(*axes))
    print(f"transgrid done -> {args.grid_out}")
    return 0


def _transfields(args, sim, its) -> int:
    """The restarts of `its` remeshed onto the grid of --ini2 (reference
    transfields.x): flow_rm.<it>.* and scal_rm.<it>.*, cubic Lagrange along
    each axis whose nodes change, on the run's device and in its dtype."""
    from tlab_tpu_torch.config import load_case
    from tlab_tpu_torch.dycore.state import State
    from tlab_tpu_torch.io import fields_io
    from tlab_tpu_torch.ops.interpolate import remesh_field
    from tlab_tpu_torch.runtime import grid_from_case
    grid2 = grid_from_case(load_case(args.ini2))

    def remesh(a):
        return remesh_field(torch.as_tensor(a).to(sim.device, sim.dtype),
                            sim.grid, grid2)

    for it in its:
        u, v, w, s, rtime, visc = fields_io.read_state(
            os.path.join(args.outdir, "flow"),
            os.path.join(args.outdir, "scal"), it, sim.nsp.n_scalars)
        s2 = torch.stack([remesh(a) for a in s]) if s.shape[0] else \
            torch.zeros((0,) + grid2.shape, dtype=sim.dtype,
                        device=sim.device)
        new = State(u=remesh(u), v=remesh(v), w=remesh(w), s=s2)
        fields_io.write_state(os.path.join(args.outdir, "flow_rm"),
                              os.path.join(args.outdir, "scal_rm"), it, new,
                              float(rtime), float(visc))
    print(f"remeshed {its} onto {grid2.shape}")
    return 0


def _cloud_tool(args) -> int:
    """state/smooth/saturation/reversal: the reference cloud-state
    executables (src/tools/cloud/{state,smooth,saturation,reversal}.f90)
    with flags in place of the interactive prompts, the airwater
    equilibrium in float64 on --device.  [Thermodynamics] of --ini is
    honored when the file exists; outputs go to --outdir."""
    import numpy as np

    from tlab_tpu_torch.physics import thermo
    from tlab_tpu_torch.tools import cloudstate as cs
    kw = {"mixture": "airwater"}
    if os.path.exists(args.ini):
        from tlab_tpu_torch.config import load_case
        tcfg = load_case(args.ini).thermo or {}
        sh = tcfg.get("scale_height", 0.0)
        kw.update(scale_height_inv=(1.0 / sh if sh > 0 else 0.0),
                  dsmooth=tcfg.get("smooth", 0.0),
                  thermo_param=tuple(tcfg.get("parameters", ())),
                  nondimensional=tcfg.get("nondimensional", True))
    tp = thermo.ThermoParams(**kw)
    dev = args.device
    os.makedirs(args.outdir, exist_ok=True)

    def sweep(lo, hi):
        if args.sweep:
            lo, hi, npts = args.sweep.split(",")
            return np.linspace(float(lo), float(hi), int(npts))
        return np.linspace(lo, hi, args.npts)

    if args.command == "state":
        if args.h is None or args.qt is None:
            raise SystemExit("state: --h and --qt required (p-h case)")
        rows = cs.equilibrium_state(tp, args.p, args.h, args.qt, device=dev)
        with open(os.path.join(args.outdir, "state.dat"), "w") as fh:
            fh.write("# " + " ".join(rows) + "\n")
            fh.write(" ".join(f"{v:.10e}" for v in rows.values()) + "\n")
        for k, v in rows.items():
            print(f"{k:5s} = {v:.10e}")
        return 0

    if args.command == "smooth":
        if args.h is None:
            raise SystemExit("smooth: --h required (p-h sweep over qt)")
        qt = sweep(0.0, 0.05)
        cs.vapor_table(tp, args.p, args.h, qt, device=dev,
                       path=os.path.join(args.outdir, "vapor.dat"))
        print(f"vapor.dat written ({qt.size} rows, p={args.p}, h={args.h})")
        return 0

    if args.command == "saturation":
        T = sweep(0.85, 1.05)
        qs = cs.saturation_curve(tp, T, args.p, device=dev)
        np.savetxt(os.path.join(args.outdir, "sat.dat"),
                   np.column_stack([T, qs]), header=f"T qsat(p={args.p})")
        print(f"sat.dat written ({T.size} rows)")
        return 0

    # reversal
    if None in (args.h, args.qt, args.h2, args.qt2):
        raise SystemExit("reversal: --h --qt --h2 --qt2 required")
    d = cs.buoyancy_reversal(tp, args.h, args.qt, args.h2, args.qt2,
                             args.p, n=args.npts, device=dev)
    cols = ("chi", "h", "qt", "T", "ql", "b")
    tail = (f"chi_star={d['chi_star']:.6e} b_star={d['b_star']:.6e} "
            f"chi_s={d['chi_s']:.6e}")
    np.savetxt(os.path.join(args.outdir, "reversal.dat"),
               np.column_stack([d[k] for k in cols]),
               header=" ".join(cols) + "  " + tail)
    print(f"reversal.dat written; {tail}")
    return 0


def _inipart(args, case, sim) -> int:
    """part.<Start>: [Particles] Number particles (--nparticles without the
    key) from the [Particles] IniP block (particle_main.f90:65-84,198-254):
    ymean from YMeanIniP or YMeanRelativeIniP times the y scale, slab width
    DiamIniP, ProfileIniP=hardcoded|scalar (any other profile draws the
    default uniform slab, as tlab_tpu: ROADMAP C); the bil_cloud droplets
    start at the local airwaterlinear liquid.  Positions in the run's
    dtype (float32 without --x64, as tlab_tpu's without x64), seed 7 unless
    --seed."""
    import numpy as np
    import torch

    from tlab_tpu_torch.io import fields_io
    from tlab_tpu_torch.particles.core import (init_particles, make_locator,
                                               interpolate_to_particles,
                                               n_props, props_from_ini)
    from tlab_tpu_torch.particles.io import write_particles
    from tlab_tpu_torch.physics import thermo
    ini = case.ini
    it0 = case.it_start
    n_part = ini.get_int("Particles", "Number", args.nparticles)
    g = sim.grid
    kw = {}
    rel = ini.get("Particles", "YMeanRelativeIniP", "")
    absm = ini.get("Particles", "YMeanIniP", "")
    if absm:
        kw["ymean"] = float(absm)
    elif rel:
        kw["ymean"] = float(g.y.nodes[0]) + float(g.y.scale) * float(rel)
    diam = ini.get("Particles", "DiamIniP", "")
    if diam:
        kw["diam"] = float(diam)
    prof = ini.get("Particles", "ProfileIniP", "none").lower()
    scal1 = os.path.join(args.outdir, f"scal.{it0}.1")
    if prof == "hardcoded":
        kw["mode"] = "hardcoded"
    elif prof == "scalar":
        kw.update(mode="scalar", scal=fields_io.read_field(scal1)[0],
                  scal_mean=ini.get_float("Scalar", "MeanScalar1", 0.0),
                  scal_delta=ini.get_float("Scalar", "DeltaScalar1", 1.0))
    ps = init_particles(g, n_part, seed=7 if args.seed is None else args.seed,
                        dtype=sim.dtype, device=sim.device, **kw)
    pprops = props_from_ini(ini)
    if pprops is not None and pprops.type.startswith("bil_cloud"):
        # droplet scalars start at the LOCAL airwaterlinear liquid at the
        # particle (particle_main.f90:266-281); bil_cloud_4 residence
        # clocks start at zero
        pr = np.zeros((n_part, n_props(pprops)))
        tcfg = case.thermo or {}
        if tcfg.get("mixture") == "airwaterlinear" \
                and tcfg.get("parameters") and os.path.exists(scal1):
            names = [scal1, os.path.join(args.outdir, f"scal.{it0}.2")]
            fields = [torch.as_tensor(fields_io.read_field(n)[0]).to(
                sim.device, sim.dtype) for n in names if os.path.exists(n)]
            loc = make_locator(g)(ps.x)
            sp = torch.stack([interpolate_to_particles(f, loc)
                              for f in fields])
            liq = thermo.airwater_linear(tuple(tcfg["parameters"]),
                                         sp).cpu().numpy()
            pr[:, 0] = liq
            pr[:, 1] = liq
        ps = ps._replace(props=torch.as_tensor(pr, dtype=sim.dtype,
                                               device=sim.device))
    write_particles(os.path.join(args.outdir, f"part.{it0}"), ps, it0)
    print(f"{n_part} particles written")
    return 0


if __name__ == "__main__":
    sys.exit(main())
