"""Command-line entry points sharing one tlab.ini-compatible config (port of
tlab_tpu/tools/cli.py: pre-processing, the DNS loop and the statistics
post-processing).

Usage:  python -m tlab_tpu_torch.tools.cli <command> [--ini tlab.ini] [options]
Commands: inigrid, ini (aliases inirand, iniflow, iniscal), inipart, dns,
averages, spectra, pdfs, superlayer, stats2nc, planes2nc, tower2nc.
Equivalent surface to the reference executables inigrid.x/inirand.x/
iniflow.x/iniscal.x/inipart.x/dns.x/averages.x/spectra.x/pdfs.x, the
superlayer tools and stats2nc.py/Planes2nc.py/tower2nc.py.  The run is on
the CUDA card unless --device names another device; --x64 computes in
float64 (validation mode).

Files: inigrid writes `grid` and `<ini>.bak`; ini writes
flow.<Start>.{1,2,3} and scal.<Start>.<i> (the compressible set: the
conservative flow.<Start>.{1..5} and flow.<Start>.s<i>); inipart writes
part.<Start> ([Particles] Number, the IniP keys); dns reads them (the
particles where [Particles] Type is set and part.<Start> exists) and writes
dns.out, tlab.log, restarts (and part.<it>, trajectories) at the
[Iteration] Restart cadence, avg<it> / avg<it>s<i> at the Statistics
cadence, planesI/J/K.<it> and tower.* where [SavePlanes]/[SaveTowers]
ask.  The post-processing commands read the restarts of --files (else [PostProcessing] Files):
averages writes avg<it>, avg<it>s<i> (and cavg<it>, int<it> with
--gate-scalar; the ParamAverages analysis table), spectra xsp/zsp/rsp (and
xcr/zcr, pow/pha), pdfs pdf<it>.<tag> (ParamPdfs), superlayer sl<it>.npz,
stats2nc avg<it>.nc, planes2nc planesI/J/K.<it>.nc, tower2nc towers.nc.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

# tlab_tpu's other commands and the ROADMAP item that ports each
UNPORTED = {
    "visuals": "A16", "transfields": "A16", "transgrid": "A16",
    "apriori": "A16", "state": "A16", "smooth": "A16", "saturation": "A16",
    "reversal": "A16"}
INI_COMMANDS = ("ini", "inirand", "iniflow", "iniscal")
POST_COMMANDS = ("averages", "spectra", "pdfs", "superlayer")
CONVERTERS = ("stats2nc", "planes2nc", "tower2nc")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tlab-tpu-torch")
    ap.add_argument("command",
                    choices=["inigrid", *INI_COMMANDS, "inipart", "dns",
                             *POST_COMMANDS, *CONVERTERS, *UNPORTED])
    ap.add_argument("--nparticles", type=int, default=10000,
                    help="inipart: particles where [Particles] Number "
                         "is not set")
    ap.add_argument("--inner-steps", type=int, default=1,
                    help="RK steps per host sync (fixed dt within)")
    ap.add_argument("--ini", default="tlab.ini")
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--seed", type=int, default=None,
                    help="override [Broadband] Seed (default: ini value)")
    ap.add_argument("--x64", action="store_true",
                    help="run in float64 (validation mode)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' for a run without one)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--files", default="",
                    help="comma-separated snapshot iterations for "
                         "postprocessing")
    ap.add_argument("--cross", action="store_true",
                    help="spectra: add pair cross-spectra (pow/pha)")
    ap.add_argument("--correlations", action="store_true",
                    help="spectra: add two-point correlations (xcr/zcr)")
    ap.add_argument("--y-blocks", type=int, default=0,
                    help="spectra: write 2-D (kx,kz) spectra in y blocks")
    ap.add_argument("--gate-scalar", type=int, default=0,
                    help="averages: condition on scalar # > gate level")
    ap.add_argument("--gate-level", type=float, default=0.0)
    args = ap.parse_args(argv)

    if args.command in UNPORTED:
        raise SystemExit(f"tlab_tpu_torch: command {args.command!r} is not "
                         f"ported yet (ROADMAP {UNPORTED[args.command]})")
    try:
        return _run(args)
    except NotImplementedError as e:        # an option that is not ported
        raise SystemExit(f"tlab_tpu_torch: {e}")


def _run(args) -> int:
    from tlab_tpu_torch.config import load_case
    from tlab_tpu_torch.convert import state_from_numpy
    from tlab_tpu_torch.grid import write_reference_grid
    from tlab_tpu_torch.io import fields_io
    from tlab_tpu_torch.particles.core import props_from_ini
    from tlab_tpu_torch.particles.io import read_particles
    from tlab_tpu_torch.runtime import Simulation, grid_from_case
    from tlab_tpu_torch.utils import trace

    case = load_case(args.ini)
    os.makedirs(args.outdir, exist_ok=True)
    trace.maybe_init(case, args.outdir)
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
    sim = Simulation.from_case(case, dtype=dtype, device=args.device)
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

    if args.command in POST_COMMANDS:
        from tlab_tpu_torch.tools import postprocess as pp
        if args.command == "averages":
            pp.run_averages(sim, args.outdir, its,
                            gate_scalar=args.gate_scalar,
                            gate_level=args.gate_level)
        elif args.command == "spectra":
            cross, corr = args.cross, args.correlations
            psp = case.ini.get_floats("PostProcessing", "ParamSpectra", ())
            if psp and not (cross or corr or args.y_blocks):
                # ParamSpectra: 1 spectra, 2 cross-spectra,
                # 3 correlations, 4 cross-correlations (spectra.f90 menu)
                cross = int(psp[0]) in (2, 4)
                corr = int(psp[0]) in (3, 4)
            pp.run_spectra(sim, args.outdir, its, cross=cross,
                           correlations=corr, y_blocks=args.y_blocks)
        elif args.command == "pdfs":
            pp.run_pdfs(sim, args.outdir, its)
        else:
            pp.run_superlayer(sim, args.outdir, its)
        print(f"{args.command} done for {its}")
        return 0

    # dns
    from tlab_tpu_torch.tools import dns as dns_tool
    if case.ini.get("Parallel", "Mesh", ""):
        # tlab_tpu's dns runs a [Parallel] Mesh=PX,PZ case on a device mesh
        raise NotImplementedError("not ported yet: [Parallel] Mesh "
                                  "(multi-GPU pencils) (ROADMAP A17)")
    it0 = case.it_start
    if sim.comp is not None:
        from tlab_tpu_torch.dycore.compressible import CompState
        # as tlab_tpu's: no [ViscChange] ramp in the compressible set
        U0, rtime, _ = fields_io.read_comp_state(flow, it0)
        visc0 = None
        state = CompState(*(None if a is None else torch.as_tensor(a).to(
            sim.device, sim.dtype) for a in U0))
    else:
        u, v, w, s, rtime, visc0 = fields_io.read_state(flow, scal, it0,
                                                        sim.nsp.n_scalars)
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
                       restart_visc=float(visc0) if visc0 else None)
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
