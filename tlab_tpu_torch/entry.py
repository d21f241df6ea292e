"""The benchmark-shaped shear layer, built for the port (counterpart of
__graft_entry__._build and bench.py:33-56).

A 3-D temporal shear layer: uniform grid (2 pi, 1, pi), periodic x and z,
free-slip walls in y, one scalar with Neumann walls, Re = 5000, low-storage
RK4.  The initial condition is a tanh velocity and scalar profile plus
wall-clean noise (envelope sin(pi y)) of amplitude 0.01, made with numpy
from `seed`.  dryrun_multichip steps every path of the rank mesh once at
tiny shapes.
"""
from __future__ import annotations

import numpy as np
import torch

from tlab_tpu_torch.fdm.plan import build_fdm_plan
from tlab_tpu_torch.grid import uniform_grid
from tlab_tpu_torch.physics.params import NSParams
from tlab_tpu_torch.convert import state_from_numpy
from tlab_tpu_torch.dycore import incompressible as dyn

REYNOLDS = 5000.0
DT = 5e-4                 # bench.py's step at 512x256x256 (CFL ~ 0.03)


def initial_fields(grid, seed: int, n_scalars: int = 1):
    """(u, v, w, s) float64 numpy arrays of the shear-layer initial state."""
    nx, ny, nz = grid.shape
    rng = np.random.default_rng(seed)
    y = grid.y.nodes[None, :, None]
    prof = 0.5 * np.tanh(-0.5 * (y - 0.5) / 0.05)
    env = np.sin(np.pi * y)

    def noise():
        return 0.01 * env * rng.standard_normal((nx, ny, nz))

    u = prof + noise()
    v = noise()
    w = noise()
    s = np.broadcast_to(0.5 - prof, (n_scalars, nx, ny, nz))
    return u, v, w, s


def build(nx: int, ny: int, nz: int, dtype=torch.float32, device="cuda",
          seed: int = 0, n_scalars: int = 1):
    """(grid, P, state) of the shear layer on `device` in `dtype`; a long
    line's crossovers from tlab_tpu's environment variables, as
    Simulation.from_case reads them."""
    grid = uniform_grid(nx, ny, nz, 2.0 * np.pi, 1.0, np.pi)
    fdm = build_fdm_plan(grid)
    nsp = NSParams(reynolds=REYNOLDS, schmidt=(1.0,) * n_scalars)
    bcs = dyn.WallBCs.from_velocity_kind(
        "freeslip", "freeslip",
        scalar_bcs=(("neumann", "neumann"),) * n_scalars)
    P = dyn.build_device_plans(fdm, nsp, bcs, dtype=dtype, device=device,
                               **dyn.banded_crossovers())
    state = state_from_numpy(*initial_fields(grid, seed, n_scalars),
                             device=device, dtype=dtype)
    return grid, P, state


def _dryrun_rank(mesh, nx: int, ny: int, nz: int) -> dict:
    """One rank of dryrun_multichip: the shear layer's pencil step, the
    compressible core's, dns.run of case01 resized, a step with an
    immersed boundary, and the particle step, on this rank's blocks."""
    import os
    import tempfile
    from tlab_tpu_torch import ibm as ibmmod
    from tlab_tpu_torch.config import Ini, load_case
    from tlab_tpu_torch.dycore import compressible as comp
    from tlab_tpu_torch.dycore.state import State
    from tlab_tpu_torch.parallel import pencil
    from tlab_tpu_torch.particles import parallel as pp
    from tlab_tpu_torch.particles.core import ParticleProps, init_particles
    from tlab_tpu_torch.runtime import Simulation
    from tlab_tpu_torch.tools import dns as dns_tool
    from tlab_tpu_torch.tools.initialize import initial_state
    dt, dev = torch.float32, mesh.device
    grid, P, state = build(nx, ny, nz, dt, dev)
    local = State(*(mesh.block(a) for a in state[:4]))

    def rk(Pl, st, dtime, aux):
        return dyn.rk_step(Pl, st, dtime, aux=aux)

    out = {"rank": mesh.rank, "describe": mesh.describe()}
    new, _ = pencil.make_pencil_step(mesh, P, rk)(local, 1e-4)
    out["step"] = bool(torch.isfinite(new.u).all())
    Pc = dyn.build_device_plans(
        build_fdm_plan(grid), NSParams(reynolds=1e4, schmidt=(1.0,)),
        dyn.WallBCs.from_velocity_kind(
            "freeslip", "freeslip", scalar_bcs=(("neumann", "neumann"),)),
        dtype=dt, device=dev, with_elliptic=False)
    Pc["y_periodic"] = False
    one = torch.ones_like(local.u)
    U = comp.from_primitive(one, local.u, local.v, local.w, one, 1.4, 0.3,
                            s=local.s)
    Uc = pencil.make_pencil_step_compressible(
        mesh, Pc, lambda Pl, Ul, dtime: comp.rk_step_compressible(
            Pl, Ul, dtime, 1.4, 0.3, 1e-4, 0.7))(U, 1e-5)
    out["compressible"] = bool(torch.isfinite(Uc.rho).all())
    # the production driver: dns.run of case01 resized, through the mesh
    tpl = open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "data",
        "case01_small3d.ini")).read()
    for old, new_ in (("Imax=128", f"Imax={nx}"), ("Jmax=64", f"Jmax={ny}"),
                      ("Kmax=16", f"Kmax={nz}"),
                      ("points_1=129", f"points_1={nx + 1}"),
                      ("points_1=64", f"points_1={ny}"),
                      ("points_1=17", f"points_1={nz + 1}")):
        tpl = tpl.replace(old, new_)
    sim = Simulation.from_case(load_case(Ini(text=tpl)), dtype=dt,
                               device=dev)
    with tempfile.TemporaryDirectory() as td:
        run = dns_tool.run(sim, initial_state(sim), outdir=td, n_steps=1,
                           checkpoint=False, mesh=mesh)
    out["dns_log"] = list(run.log.lines)
    # the immersed boundary: mask and fills cut to the rank's views
    eps = ibmmod.geometry_xbars(grid, 1, max(ny // 8, 2), max(nz // 4, 2))
    P_ibm = dict(P, ibm=dict(
        ibmmod.build_ibm(np.asarray(eps, float), dtype=dt, device=dev),
        fills=ibmmod.build_ibm_spline(np.asarray(eps, float), grid,
                                      dtype=dt, device=dev)))
    new, _ = pencil.make_pencil_step(mesh, P_ibm, rk)(local, 1e-4)
    out["ibm"] = bool(torch.isfinite(new.u).all())
    # particles: owner-sharded slots, migration, coupled to the step
    ps = init_particles(grid, 64, seed=3, dtype=dt, device=dev)
    parts = pp.to_mesh(mesh, grid, ps, dtype=dt)
    _, parts, _ = pencil.make_pencil_step_particles(
        mesh, P, grid, ParticleProps(type="tracer"))(local, parts, 1e-4)
    whole = pp.from_mesh(mesh, parts)
    out["particles"] = None if whole is None else int(whole.x.shape[0])
    return out


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """One step of every mesh path on n_devices ranks at tiny shapes (the
    explicit-engine half of tlab_tpu's __graft_entry__.dryrun_multichip;
    its GSPMD half has no PyTorch counterpart): the shear layer's pencil
    step, the compressible core's, dns.run through the mesh, a step with an
    immersed boundary and the coupled particle step, on a (px, pz) grid of
    ranks spawned by parallel.mesh.spawn (px the largest divisor of
    n_devices up to its square root).  Returns the ranks' summaries; raises
    if a rank fails or a path gives a non-finite field or loses a
    particle."""
    import tempfile
    from tlab_tpu_torch.parallel import mesh as pmesh
    px = int(np.sqrt(n_devices))
    while n_devices % px:
        px -= 1
    pz = n_devices // px
    with tempfile.TemporaryDirectory(prefix="tlab_dryrun_") as td:
        out = pmesh.spawn(_dryrun_rank, px, pz, device, 16 * px, 8 * px * pz,
                          8 * pz, store_dir=td)
    for r in out:
        if not all(r[k] for k in ("step", "compressible", "ibm")):
            raise RuntimeError(f"dryrun: a non-finite field on rank {r}")
    if out[0]["particles"] != 64 or not out[0]["dns_log"]:
        raise RuntimeError(f"dryrun: rank 0 {out[0]}")
    return out
