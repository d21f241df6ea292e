"""The port's direct eigen Poisson / Helmholtz solvers
(tlab_tpu_torch/ops/elliptic.py) against tlab_tpu's, float64 on the CPU, on
the same inputs made from a seed with NumPy: 1e-11 of the result's max.
Then the manufactured solutions of tests/test_poisson.py on the port, with
that file's limits."""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tlab_tpu import grid as jgrid
from tlab_tpu.constants import BC as JBC
from tlab_tpu.fdm.plan import build_fdm_plan as jbuild_fdm_plan
from tlab_tpu.ops import elliptic as jell
from tlab_tpu_torch import grid as tgrid
from tlab_tpu_torch.constants import BC
from tlab_tpu_torch.fdm.plan import build_fdm_plan
from tlab_tpu_torch.ops import elliptic as tell

F64 = torch.float64
TOL = 1e-11

torch.set_num_threads(2)


def _grid(mod, nx, ny, nz, stretched=False):
    if not stretched:
        return mod.uniform_grid(nx, ny, nz, 2.0, 1.0, 1.5)
    s = np.linspace(0.0, 1.0, ny)
    return mod.Grid(
        mod.make_axis(np.arange(nx) * (2.0 / nx), True),
        mod.make_axis(s + 0.15 * np.sin(np.pi * s), False),
        mod.make_axis(np.arange(nz) * (1.5 / nz), True) if nz > 1
        else mod.make_axis(np.zeros(1), False))


def _both(nx, ny, nz, ibc="NN", stretched=False):
    """(fdm, plan, device plan) of the port and of tlab_tpu."""
    ft = build_fdm_plan(_grid(tgrid, nx, ny, nz, stretched))
    fj = jbuild_fdm_plan(_grid(jgrid, nx, ny, nz, stretched))
    pt = tell.build_elliptic_plan(ft, ibc=BC[ibc])
    pj = jell.build_elliptic_plan(fj, ibc=JBC[ibc])
    return (ft, pt, tell.device_elliptic_plan(pt, F64, "cpu")), \
        (fj, pj, jell.device_elliptic_plan(pj, jnp.float64))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("stretched", [False, True])
@pytest.mark.parametrize("ibc", ["NN", "DD"])
@pytest.mark.parametrize("walls", [False, True])
def test_poisson_matches_jax(ibc, walls, stretched):
    (ft, _, dt), (fj, _, dj) = _both(24, 33, 12, ibc, stretched)
    rng = np.random.default_rng(0)
    f = rng.standard_normal((24, 33, 12))
    kw_t, kw_j = {}, {}
    if walls:
        bb, bt = rng.standard_normal((2, 24, 12))
        kw_t = {"bcs_b": torch.from_numpy(bb), "bcs_t": torch.from_numpy(bt)}
        kw_j = {"bcs_b": jnp.asarray(bb), "bcs_t": jnp.asarray(bt)}
    fin = torch.from_numpy(f.copy())
    pt, dpt = tell.poisson(dt, fin, d1y=torch.from_numpy(ft.y.d1[BC.DD]),
                           **kw_t)
    pj, dpj = jell.poisson(dj, jnp.asarray(f),
                           d1y=jnp.asarray(fj.y.d1[JBC.DD]), **kw_j)
    assert torch.equal(fin, torch.from_numpy(f))     # input left as it was
    assert _rel(pt, pj) <= TOL and _rel(dpt, dpj) <= TOL
    assert _rel(tell.poisson(dt, fin, **kw_t), pj) <= TOL      # no d1y: p


@pytest.mark.parametrize("nz", [12, 1])
@pytest.mark.parametrize("alpha", [-37.0, -6.0])
def test_helmholtz_matches_jax(alpha, nz):
    (_, _, dt), (_, _, dj) = _both(24, 33, nz)
    f = np.random.default_rng(1).standard_normal((24, 33, nz))
    at = tell.helmholtz(dt, torch.from_numpy(f), alpha)
    aj = jell.helmholtz(dj, jnp.asarray(f), alpha)
    assert _rel(at, aj) <= TOL


@pytest.mark.parametrize("ibc", ["NN", "DD"])
@pytest.mark.parametrize("alpha", [0.0, -11.0])
def test_solve_modal_matches_dense_and_jax(ibc, alpha):
    """The eigen path against the per-mode dense solve (the limit of
    tests/test_poisson.py: 1e-9) and against tlab_tpu's eigen path."""
    (_, pt, dt), (_, _, dj) = _both(16, 24, 8, ibc)
    rng = np.random.default_rng(2)
    f = rng.standard_normal((16, 24, 8))
    f[:, (0, -1), :] = 0.0
    f_hat = np.fft.fft(np.fft.rfft(f, axis=0), axis=2)
    fix = alpha == 0.0
    got = tell.solve_modal(dt, torch.from_numpy(f_hat), alpha=alpha,
                           singular_fix=fix).numpy()
    want = np.asarray(jell.solve_modal(dj, jnp.asarray(f_hat), alpha=alpha,
                                       singular_fix=fix))
    assert _rel(got, want) <= TOL
    plan = pt if fix else dataclasses.replace(pt, S_sing=None)
    dense = tell.solve_modal_dense(plan, f_hat, alpha=alpha)
    assert np.max(np.abs(got - dense)) < 1e-9 * max(1.0,
                                                    np.max(np.abs(dense)))


def test_staggered_eigenvalues_pass_through():
    """lam_x/lam_z overrides (the staggered pressure grid) reach the device
    plan's modal table."""
    ft = build_fdm_plan(_grid(tgrid, 16, 12, 8))
    lam_x, lam_z = np.linspace(0, -3, 9), np.linspace(0, -2, 8)
    plan = tell.build_elliptic_plan(ft, lam_x=lam_x, lam_z=lam_z)
    dev = tell.device_elliptic_plan(plan, F64, "cpu")
    assert np.array_equal(dev["lam_xz"].numpy(),
                          lam_x[:, None] + lam_z[None, :])
    assert "S_sing" in dev and "dft" not in dev


# ---------------------------------------------------------------------------
# the manufactured solutions of tests/test_poisson.py on the port
# ---------------------------------------------------------------------------

def _port(nx, ny, nz, ibc="NN", stretched=False):
    grid = _grid(tgrid, nx, ny, nz, stretched)
    fdm = build_fdm_plan(grid)
    plan = tell.build_elliptic_plan(fdm, ibc=BC[ibc])
    return grid, fdm, plan, tell.device_elliptic_plan(plan, F64, "cpu")


@pytest.mark.parametrize("ibc", ["NN", "DD"])
def test_poisson_manufactured(ibc):
    grid, _, _, dev = _port(48, 64, 12, ibc)
    X = grid.x.nodes[:, None, None]
    Y = grid.y.nodes[None, :, None]
    Z = grid.z.nodes[None, None, :]
    kx = 2 * np.pi / grid.x.scale
    kz = 2 * np.pi / grid.z.scale
    if ibc == "NN":
        fy, fyy = np.cos(np.pi * Y), -np.pi ** 2 * np.cos(np.pi * Y)
    else:
        fy, fyy = np.sin(np.pi * Y), -np.pi ** 2 * np.sin(np.pi * Y)
    p_exact = np.cos(kx * X) * fy * np.cos(kz * Z)
    f = (-(kx ** 2) - kz ** 2) * p_exact \
        + np.cos(kx * X) * fyy * np.cos(kz * Z)
    p = tell.poisson(dev, torch.from_numpy(f)).numpy()
    if ibc == "NN":
        p = p - p.mean()
        p_exact = p_exact - p_exact.mean()
    assert np.max(np.abs(p - p_exact)) < 5e-5


def test_poisson_discrete_residual():
    grid, _, plan, dev = _port(32, 40, 8)
    f = np.random.default_rng(1).standard_normal(grid.shape)
    f[:, (0, -1), :] = 0.0
    p = tell.poisson(dev, torch.from_numpy(f)).numpy()
    p_hat = np.fft.fft(np.fft.rfft(p, axis=0), axis=2)
    f_hat = np.fft.fft(np.fft.rfft(f, axis=0), axis=2)
    lam = plan.lam_x[:, None] + plan.lam_z[None, :]
    res = np.einsum("ab,kbz->kaz", plan.M0, p_hat) \
        - lam[:, None, :] * np.einsum("ab,kbz->kaz", plan.M1, p_hat) \
        - np.einsum("ab,kbz->kaz", plan.R, f_hat)
    res[0, :, 0] = 0.0                   # singular mode solved separately
    assert np.max(np.abs(res[:, 1:-1, :])) < 1e-8


def test_poisson_neumann_bc_values():
    grid, fdm, _, dev = _port(32, 64, 1)
    nx, ny, nz = grid.shape
    X = grid.x.nodes[:, None]
    kx = 2 * np.pi / grid.x.scale
    bcs_b = 0.3 * np.cos(kx * X) * np.ones((1, nz))
    bcs_t = -0.2 * np.sin(kx * X) * np.ones((1, nz))
    _, dpdy = tell.poisson(dev, torch.zeros((nx, ny, nz), dtype=F64),
                           bcs_b=torch.from_numpy(bcs_b),
                           bcs_t=torch.from_numpy(bcs_t),
                           d1y=torch.from_numpy(fdm.y.d1[BC.DD]))
    dpdy = dpdy.numpy()
    assert np.max(np.abs(dpdy[:, 0, :] - bcs_b)) < 2e-4
    assert np.max(np.abs(dpdy[:, -1, :] - bcs_t)) < 2e-4


def test_helmholtz_manufactured():
    grid, _, _, dev = _port(48, 64, 1, "DD")
    alpha = -37.0
    X = grid.x.nodes[:, None, None]
    Y = grid.y.nodes[None, :, None]
    kx = 2 * np.pi / grid.x.scale
    a_exact = np.sin(kx * X) * np.sin(2 * np.pi * Y) * np.ones((1, 1, 1))
    f = (-(kx ** 2) - (2 * np.pi) ** 2 + alpha) * a_exact
    a = tell.helmholtz(dev, torch.from_numpy(f), alpha).numpy()
    assert np.max(np.abs(a - a_exact)) < 5e-5


def test_poisson_nonuniform_y():
    grid, fdm, _, dev = _port(48, 80, 1, stretched=True)
    assert not fdm.y.uniform
    X = grid.x.nodes[:, None, None]
    Y = grid.y.nodes[None, :, None]
    kx = 2 * np.pi / grid.x.scale
    p_exact = np.cos(kx * X) * np.cos(np.pi * Y) * np.ones(grid.shape)
    f = (-(kx ** 2) - np.pi ** 2) * p_exact
    p = tell.poisson(dev, torch.from_numpy(f)).numpy()
    assert np.max(np.abs(p - p.mean() - (p_exact - p_exact.mean()))) < 2e-4


def test_float32_plan_and_solve():
    """The float32 plan holds float32 tensors, and a float32 solve follows
    the float64 one (1e-3 of max: cond(V) times float32 round-off)."""
    grid, _, plan, dev64 = _port(32, 33, 8)
    dev32 = tell.device_elliptic_plan(plan, torch.float32, "cpu")
    assert all(t.dtype == torch.float32 for t in dev32.values()
               if isinstance(t, torch.Tensor))
    f = np.random.default_rng(3).standard_normal(grid.shape)
    p64 = tell.poisson(dev64, torch.from_numpy(f))
    p32 = tell.poisson(dev32, torch.from_numpy(f).float())
    assert p32.dtype == torch.float32
    assert _rel(p32.double(), p64) <= 1e-3
