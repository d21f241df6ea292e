"""The benchmark-shaped shear layer, built for the port (counterpart of
__graft_entry__._build and bench.py:33-56).

A 3-D temporal shear layer: uniform grid (2 pi, 1, pi), periodic x and z,
free-slip walls in y, one scalar with Neumann walls, Re = 5000, low-storage
RK4.  The initial condition is a tanh velocity and scalar profile plus
wall-clean noise (envelope sin(pi y)) of amplitude 0.01, made with numpy
from `seed`.
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
    """(grid, P, state) of the shear layer on `device` in `dtype`."""
    grid = uniform_grid(nx, ny, nz, 2.0 * np.pi, 1.0, np.pi)
    fdm = build_fdm_plan(grid)
    nsp = NSParams(reynolds=REYNOLDS, schmidt=(1.0,) * n_scalars)
    bcs = dyn.WallBCs.from_velocity_kind(
        "freeslip", "freeslip",
        scalar_bcs=(("neumann", "neumann"),) * n_scalars)
    P = dyn.build_device_plans(fdm, nsp, bcs, dtype=dtype, device=device)
    state = state_from_numpy(*initial_fields(grid, seed, n_scalars),
                             device=device, dtype=dtype)
    return grid, P, state
