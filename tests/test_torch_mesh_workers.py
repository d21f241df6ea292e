"""Rank functions of the rank-mesh tests (tests/test_torch_pencil.py,
test_torch_mesh_features.py, test_torch_particles_parallel.py,
test_torch_sharded.py), spawned through tlab_tpu_torch.parallel.mesh.spawn.

A spawned rank unpickles its function from this module, so the module
imports neither JAX nor tlab_tpu (the test modules do, and a rank importing
them would load JAX); it holds no tests.  Every function takes the rank's
Mesh first and returns what the parent compares, on the CPU in float64.
"""
import os

import numpy as np
import torch

from tlab_tpu_torch import entry
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.convert import state_from_numpy
from tlab_tpu_torch.dycore import compressible as comp
from tlab_tpu_torch.dycore import incompressible as dyn
from tlab_tpu_torch.dycore.nscbc import NSCBCSpec
from tlab_tpu_torch.dycore.state import State
from tlab_tpu_torch.fdm.plan import build_fdm_plan
from tlab_tpu_torch.grid import uniform_grid
from tlab_tpu_torch.ops import check
from tlab_tpu_torch.parallel import mesh as pmesh
from tlab_tpu_torch.parallel import pencil
from tlab_tpu_torch.physics.params import NSParams

F64 = torch.float64
# the solves' grid: nkx = 13 is odd and pads to 16 on 4 ranks (8 for
# tlab_tpu's 4x2 mesh); 24 x 16 splits on 2x2, 4x1, 1x4 and 4x2
SOLVE_SHAPE = (24, 10, 16)
STEP_SHAPE = (16, 12, 8)
COMP_SHAPE = (16, 12, 8)
GAMMA, MACH = 1.4, 0.5


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def solve_plans():
    """(grid, P) of the solves: the shear layer's plans at SOLVE_SHAPE."""
    grid, P, _ = entry.build(*SOLVE_SHAPE, F64, "cpu")
    return grid, P


def solve_inputs(shape=SOLVE_SHAPE, seed: int = 11):
    """(f, bcs_b, bcs_t) of the solves, NumPy float64."""
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((nx, ny, nz)),
            rng.standard_normal((nx, nz)), rng.standard_normal((nx, nz)))


def step_setup(shape=STEP_SHAPE):
    """(P, state) of the one-step comparisons: the shear layer at `shape`
    with a random state, one scalar."""
    nx, ny, nz = shape
    _, P, _ = entry.build(nx, ny, nz, F64, "cpu")
    rng = np.random.default_rng(0)
    f = [rng.standard_normal((nx, ny, nz)) for _ in range(3)]
    s = rng.standard_normal((1, nx, ny, nz))
    return P, state_from_numpy(*f, s, "cpu", F64)


def comp_setup(shape=COMP_SHAPE):
    """(P, U, spec, step_fn) of the compressible one-step comparison:
    outflow NSCBC on both y sides with the transverse terms (tlab_tpu's
    test_pencil_step_compressible_matches)."""
    nx, ny, nz = shape
    grid = uniform_grid(nx, ny, nz, 2 * np.pi, 1.0, np.pi)
    fdm = build_fdm_plan(grid)
    nsp = NSParams(reynolds=500.0, schmidt=(1.0,))
    bcs = dyn.WallBCs.from_velocity_kind(
        "freeslip", "freeslip", scalar_bcs=(("neumann", "neumann"),))
    P = dyn.build_device_plans(fdm, nsp, bcs, dtype=F64, device="cpu",
                               with_elliptic=False)
    P["y_periodic"] = False
    rng = np.random.default_rng(3)

    def f():
        return torch.as_tensor(1.0 + 0.05 * rng.standard_normal(shape))

    U = comp.from_primitive(f(), 0.1 * (f() - 1.0), 0.1 * (f() - 1.0),
                            0.1 * (f() - 1.0), f(), GAMMA, MACH,
                            s=0.5 * f()[None])
    spec = NSCBCSpec(ymin="outflow", ymax="outflow", sigma=0.25, ctan=0.25,
                     p_inf=1.0 / (GAMMA * MACH ** 2))

    def step_fn(Pl, Ul, dtime):
        return comp.rk_step_compressible(Pl, Ul, dtime, GAMMA, MACH,
                                         nsp.visc, 0.7, nscbc=spec, ly=1.0)
    return P, U, step_fn


def pencil_job(mesh, arr, wire_arr, parts):
    """The transposes of the global `arr` (x-gathered, z-gathered, each
    scattered back, the round trip) and of `wire_arr` with float32 on the
    wire; with "solves" in parts the three pencil solves of solve_inputs,
    with "steps" one RK step of the incompressible and of the compressible
    core through make_pencil_step(_compressible) (and of the former with
    float32 on the wire), with "check" transpose_check."""
    blk = mesh.block(torch.as_tensor(arr))
    gx = pencil.gather_x(mesh, blk)
    gz = pencil.gather_z(mesh, blk)
    out = {"block": _np(blk), "gather_x": _np(gx), "gather_z": _np(gz),
           "scatter_x": _np(pencil.scatter_x(mesh, gx)),
           "scatter_z": _np(pencil.scatter_z(mesh, gz)),
           "roundtrip": _np(pencil.scatter_z(mesh, pencil.gather_z(
               mesh, pencil.scatter_x(mesh, gx))))}
    wb = mesh.block(torch.as_tensor(wire_arr))
    out["wire_gather_x"] = _np(pencil.cast_on_wire(
        pencil.gather_x, mesh, wb, 0, torch.float32))
    sf = pmesh.scatter_field(mesh, arr if mesh.root else None)
    out["scatter_field"] = _np(sf)
    out["gather_field"] = pmesh.gather_field(mesh, sf)
    if "solves" in parts:
        _, P = solve_plans()
        Pp = pencil.pencil_plans(mesh, P)
        f, bb, bt = (torch.as_tensor(a) for a in solve_inputs())
        fb = mesh.block(f)
        bbl = mesh.block(bb[:, None, :])[:, 0, :]
        btl = mesh.block(bt[:, None, :])[:, 0, :]
        p, dpdy = pencil.pencil_poisson(Pp["ell"], fb, Pp["comm"], bbl, btl,
                                        d1y=P["d1y"])
        out["poisson"] = (_np(p), _np(dpdy))
        out["helmholtz"] = _np(pencil.pencil_helmholtz(
            Pp["ell"], fb, Pp["comm"], -3.0, bbl, btl))
        out["factorize"] = tuple(_np(a) for a in pencil.pencil_poisson_factorize(
            Pp["ell_fac"], fb, Pp["comm"], bbl, btl))
    if "steps" in parts:
        P, state = step_setup()

        def rk(Pl, st, dt, aux):
            return dyn.rk_step(Pl, st, dt, aux=aux)

        local = State(*(mesh.block(a) for a in state[:4]))
        for key, wire in (("step", None), ("step_wire", torch.float32)):
            step = pencil.make_pencil_step(mesh, P, rk, wire_dtype=wire)
            new, p = step(local, 1e-3)
            out[key] = [_np(a) for a in new[:4]] + [_np(p)]
        Pc, U, step_fn = comp_setup()
        cstep = pencil.make_pencil_step_compressible(mesh, Pc, step_fn)
        Ul = comp.CompState(*(mesh.block(a) for a in U))
        out["comp_step"] = [_np(a) for a in cstep(Ul, 1e-4)]
    if "check" in parts:
        out["check"] = check.transpose_check(mesh, SOLVE_SHAPE, F64)
    return out


# ---------------------------------------------------------------------------
# dns.run features on the mesh (tlab_tpu's tests/test_mesh_features.py)
# ---------------------------------------------------------------------------

def _sim(text):
    from tlab_tpu_torch.runtime import Simulation
    return Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                                device="cpu")


def feature_run(name: str, text: str, outdir: str, mesh=None):
    """dns.run of one feature case (FEATURES of test_torch_mesh_features)
    on one device (mesh None) or on this rank; returns (log lines, state
    as NumPy, particles as NumPy or None) on rank 0, None elsewhere."""
    import dataclasses
    from tlab_tpu_torch.particles.core import init_particles, props_from_ini
    from tlab_tpu_torch.tools import dns
    from tlab_tpu_torch.tools.initialize import (compressible_initial_state,
                                                 initial_state)
    sim = _sim(text)
    nx, ny, nz = sim.grid.shape
    y = sim.grid.y.nodes
    kw = dict(outdir=outdir, mesh=mesh)
    if name == "inflow":
        kw.update(inflow=_inflow_box(sim), checkpoint=False, n_steps=12)
        state = _profile_state(sim)
    elif name == "sponge":
        kw.update(checkpoint=False, n_steps=6)
        state = _profile_state(sim)
    elif name == "wavemaker":
        state = state_from_numpy(
            np.zeros((nx, ny, nz)), np.zeros((nx, ny, nz)),
            np.zeros((nx, ny, nz)),
            np.broadcast_to(sim.case.scal_profiles[0](y)[None, :, None],
                            (1, nx, ny, nz)), "cpu", F64)
        kw.update(checkpoint=False, n_steps=10)
    elif name in ("particles", "bil_cloud"):
        state = _shear_state(sim)
        props = props_from_ini(sim.case.ini)
        n = 240 if name == "particles" else 160
        ps = init_particles(sim.grid, n, seed=9 if name == "particles"
                            else 5, dtype=F64, device="cpu")
        if name == "bil_cloud":
            from tlab_tpu_torch.particles.bil_cloud import BilCloudParams
            state = state._replace(s=torch.cat([state.s,
                                                0.3 + 0.4 * state.s]))
            ps = ps._replace(props=torch.zeros((n, 2), dtype=F64))
            props = dataclasses.replace(
                props, bil_cloud=BilCloudParams(thermo=(1.0, 0.5, 0.2)))
        kw.update(checkpoint=False, n_steps=10 if name == "particles" else 6,
                  pstate=ps, particle_props=props)
    elif name == "comp_spatial":
        state = compressible_initial_state(sim, seed=1)
        kw.update(n_steps=6)
    elif name == "anelastic":
        rng = np.random.default_rng(4)
        s1 = sim.case.scal_profiles[0](y)
        s2 = sim.case.scal_profiles[1](y)
        pert = 1e-3 * rng.standard_normal((nx, ny, nz)) \
            * np.sin(np.pi * (y - y[0]) / (y[-1] - y[0]))[None, :, None]
        state = state_from_numpy(
            pert, np.zeros((nx, ny, nz)), np.zeros((nx, ny, nz)),
            np.stack([np.broadcast_to(s[None, :, None], (nx, ny, nz))
                      for s in (s1, s2)]), "cpu", F64)
        kw.update(checkpoint=False, n_steps=8)
    elif name == "inner_steps":
        state = initial_state(sim, seed=7)
        kw.update(checkpoint=False, n_steps=8, inner_steps=2)
    else:                   # the surface BC and sponge, the SMR91 step
        state = initial_state(sim, seed=7)
        kw.update(checkpoint=False, n_steps=4)
    run = dns.run(sim, state, **kw)
    if run.state is None:
        return None
    ps = run.pstate
    return (run.log.lines, [_np(a) for a in run.state[:6] if a is not None],
            None if ps is None else [_np(a) for a in ps])


def features_job(mesh, cases: dict, top: str):
    """feature_run of every case on this rank, each in top/<name>."""
    return {name: feature_run(name, text, os.path.join(top, name), mesh)
            for name, text in cases.items()}


def _profile_state(sim):
    nx, ny, nz = sim.grid.shape
    y = sim.grid.y.nodes
    prof = sim.case.vel_profiles[0](y)
    sprof = sim.case.scal_profiles[0](y)
    z = np.zeros((nx, ny, nz))
    return state_from_numpy(
        np.broadcast_to(prof[None, :, None], (nx, ny, nz)), z, z,
        np.broadcast_to(sprof[None, :, None], (1, nx, ny, nz)), "cpu", F64)


def _inflow_box(sim):
    from tlab_tpu_torch.dycore.inflow import InflowBox
    nx, ny, nz = sim.grid.shape
    y = sim.grid.y.nodes
    z = sim.grid.z.nodes
    prof = sim.case.vel_profiles[0](y)
    nbox = 16
    g = np.exp(-((y - y[ny // 2]) / 0.2) ** 2)
    phases = np.sin(2 * np.pi * np.arange(nbox) / nbox)
    zmod = 1.0 + 0.3 * np.cos(2 * np.pi * z / sim.grid.z.scale)
    box = {"u": np.broadcast_to(prof[None, :, None], (nbox, ny, nz)).copy(),
           "v": 0.03 * phases[:, None, None] * g[None, :, None]
           * zmod[None, None, :],
           "w": np.zeros((nbox, ny, nz)),
           "s0": np.broadcast_to(sim.case.scal_profiles[0](y)[None, :, None],
                                 (nbox, ny, nz)).copy()}
    return InflowBox(fields=box, u_convect=1.0, lx=2.0)


def _shear_state(sim, amp=0.05):
    nx, ny, nz = sim.grid.shape
    y = sim.grid.y.nodes
    rng = np.random.default_rng(3)
    env = np.sin(np.pi * y)[None, :, None]
    prof = np.tanh((y[None, :, None] - 0.5) / 0.08) * np.ones((nx, ny, nz))

    def f():
        return amp * env * rng.standard_normal((nx, ny, nz))

    return state_from_numpy(prof + f(), f(), f(), (0.5 - 0.5 * prof)[None],
                            "cpu", F64)


# ---------------------------------------------------------------------------
# particles/parallel.py and io/sharded.py
# ---------------------------------------------------------------------------

def particles_job(mesh, shape, scales, n_part, cap, seed, drift, dt,
                  n_steps, fields):
    """This rank's slots after n_steps of a uniform drift with migration
    (fields None), or of forward Euler through the halo-extended block
    interpolation of `fields` (u, w global NumPy arrays)."""
    from tlab_tpu_torch.particles import core as pc
    from tlab_tpu_torch.particles import parallel as pp
    grid = uniform_grid(*shape, *scales)
    ps = pc.init_particles(grid, n_part, seed=seed, dtype=F64, device="cpu")
    X, V, T, M = pp.to_mesh(mesh, grid, ps, capacity=cap)
    p = pp.ShardedParticles(X, V, T, M)
    locate = pp.make_block_locator(mesh, grid)
    if fields is not None:
        halo = pp.halo_exchange(mesh, torch.stack(
            [mesh.block(torch.as_tensor(a)) for a in fields]))
    for _ in range(n_steps):
        x = p.x.clone()
        if fields is None:
            x[:, 0] += drift[0] * dt
            x[:, 2] += drift[1] * dt
        else:
            loc = locate(p.x)
            x[:, 0] += dt * pp.interpolate_block(halo[0], loc)
            x[:, 2] += dt * pp.interpolate_block(halo[1], loc)
        x = pc.wrap_positions(grid, x)
        p = pp.ShardedParticles(x, p.v, p.tags, p.mask)
        p = pp.migrate(mesh, p, grid, "x")
        p = pp.migrate(mesh, p, grid, "z")
    whole = pp.from_mesh(mesh, tuple(p))
    return ([_np(a) for a in p],
            None if whole is None else [_np(a) for a in whole])


def sharded_job(mesh, arr, prefix: str, read_from: str):
    """write_sharded of this rank's block of `arr` at `prefix`, and the
    restart of write_state_sharded with u, v = arr[0], arr[1], w = -arr[0],
    s = arr[1:] at `prefix` + "." (iteration 5); then this rank's block
    read back through read_sharded_to from `read_from` (a file of either
    package)."""
    from tlab_tpu_torch.io import sharded
    blk = mesh.block(torch.as_tensor(arr))
    sharded.write_sharded(prefix, mesh, blk, {"itime": 3, "rtime": 0.5})
    sharded.write_state_sharded(prefix + ".", 5, State(
        u=blk[0], v=blk[1], w=-blk[0], s=blk[1:]), 0.25, 1e-3, mesh)
    return _np(sharded.read_sharded_to(read_from, mesh))


def nan_trap_ranks(mesh):
    """The NaN trap on a mesh: rank 1 alone divides 0 by 0 inside a region
    that also all-reduces, so the NaN reaches the other ranks through the
    collective.  (nantrap.nan_flag of the outputs, the message the region
    raised or None) on this rank."""
    from tlab_tpu_torch.utils import nantrap
    a = torch.full((4,), 0.0 if mesh.rank == 1 else 1.0, dtype=F64)

    def body(x):
        q = x / x
        return q, mesh.all_reduce(q.sum(), "sum") * x

    flag = nantrap.nan_flag(body(a), mesh)
    try:
        with nantrap.trap():
            nantrap.region("body", body, mesh)(a)
    except FloatingPointError as e:
        return flag, str(e)
    return flag, None
