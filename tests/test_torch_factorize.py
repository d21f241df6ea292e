"""The port's factorized Poisson solver against tlab_tpu's, float64 on the
CPU, plus the divergence-removal property of tests/test_factorize.py."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tlab_tpu.fdm.plan import build_fdm_plan
from tlab_tpu.grid import uniform_grid
from tlab_tpu.ops import elliptic_factorize as jfac
from tlab_tpu_torch import grid as tgrid
from tlab_tpu_torch.dycore import incompressible as tdyn
from tlab_tpu_torch.fdm.plan import build_fdm_plan as tbuild_fdm_plan
from tlab_tpu_torch.ops import elliptic_factorize as tfac
from tlab_tpu_torch.physics.params import NSParams as TNSParams


def _plans(nx, ny, nz):
    grid = uniform_grid(nx, ny, nz, 2.0, 1.0, 1.5)
    fdm = build_fdm_plan(grid)
    plan = jfac.build_factorize_plan(fdm)
    tfdm = tbuild_fdm_plan(tgrid.uniform_grid(nx, ny, nz, 2.0, 1.0, 1.5))
    return grid, tfdm, jfac.device_factorize_plan(plan, jnp.float64), \
        tfac.device_factorize_plan(tfac.build_factorize_plan(tfdm),
                                   torch.float64, "cpu")


def _rel(a, b):
    return np.max(np.abs(np.asarray(a) - np.asarray(b))) / \
        np.max(np.abs(np.asarray(b)))


@pytest.mark.parametrize("nx, ny, nz", [(32, 33, 16), (16, 24, 1)])
def test_poisson_factorize_matches_jax(nx, ny, nz):
    grid, fdm, dev_j, dev_t = _plans(nx, ny, nz)
    rng = np.random.default_rng(11)
    f = rng.standard_normal((nx, ny, nz))
    bb = rng.standard_normal((nx, nz))
    bt = rng.standard_normal((nx, nz))
    p_j, dpdy_j = jfac.poisson_factorize(dev_j, jnp.asarray(f),
                                         bcs_b=jnp.asarray(bb),
                                         bcs_t=jnp.asarray(bt))
    p_t, dpdy_t = tfac.poisson_factorize(dev_t, torch.from_numpy(f),
                                         bcs_b=torch.from_numpy(bb),
                                         bcs_t=torch.from_numpy(bt))
    assert _rel(p_t, p_j) <= 1e-11
    assert _rel(dpdy_t, dpdy_j) <= 1e-11


def test_tables_match_jax():
    """The per-mode tables, built once per plan, equal tlab_tpu's."""
    _, _, dev_j, dev_t = _plans(32, 33, 16)
    tb_j = jfac.build_tables(dev_j)
    tb_t = dev_t["tables"]
    for name in ("em", "v1", "u1", "sp", "ep"):
        assert _rel(tb_t[name].real.movedim(1, 0), tb_j[name]) <= 1e-12
    for name in ("du1_n", "dsp_n", "dep_n"):
        assert _rel(tb_t[name].real, tb_j[name]) <= 1e-12
    for name in ("dmin", "dmax"):
        got = tb_t[name].movedim(1, 0)
        assert _rel(got.real, tb_j[name + "_re"]) <= 1e-14
        assert _rel(got.imag, tb_j[name + "_im"]) <= 1e-14


def test_factorize_roundoff_divergence_removal():
    """Projecting with the port's solver and its stage-consistent dpdy
    removes divergence to round-off in the interior (as
    tests/test_factorize.py:43 for tlab_tpu)."""
    grid, fdm, _, dev = _plans(32, 48, 8)
    nx, ny, nz = grid.shape
    P = tdyn.build_device_plans(
        fdm, TNSParams(reynolds=100.0, schmidt=()),
        tdyn.WallBCs.from_velocity_kind("freeslip", "freeslip",
                                        scalar_bcs=()),
        dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(0)
    u, v, w = (torch.from_numpy(rng.standard_normal((nx, ny, nz)))
               for _ in range(3))
    v[:, 0, :] = 0.0
    v[:, -1, :] = 0.0
    div = tdyn.divergence(P, u, v, w)
    p, dpdy = tfac.poisson_factorize(dev, div)
    div2 = tdyn.divergence(P, u - tdyn._d1(P, "x", 0, p), v - dpdy,
                           w - tdyn._d1(P, "z", 2, p))
    red = div2[:, 2:-2, :].abs().max() / div.abs().max()
    assert red < 1e-9, red


@pytest.mark.parametrize("nx, ny, nz", [(32, 33, 16), (16, 24, 1)])
def test_poisson_factorize_dd_matches_jax(nx, ny, nz):
    """Dirichlet walls (ibc="dd", the initial conditions' solve) with
    non-zero wall values, against tlab_tpu to 1e-11."""
    grid, fdm, dev_j, dev_t = _plans(nx, ny, nz)
    rng = np.random.default_rng(12)
    f = rng.standard_normal((nx, ny, nz))
    bb = rng.standard_normal((nx, nz))
    bt = rng.standard_normal((nx, nz))
    p_j, dpdy_j = jfac.poisson_factorize(dev_j, jnp.asarray(f),
                                         bcs_b=jnp.asarray(bb),
                                         bcs_t=jnp.asarray(bt), ibc="dd")
    p_t, dpdy_t = tfac.poisson_factorize(dev_t, torch.from_numpy(f),
                                         bcs_b=torch.from_numpy(bb),
                                         bcs_t=torch.from_numpy(bt),
                                         ibc="dd")
    assert _rel(p_t, p_j) <= 1e-11
    assert _rel(dpdy_t, dpdy_j) <= 1e-11
    # the wall rows hold the Dirichlet data
    assert _rel(p_t[:, 0, :], bb) <= 1e-11 and _rel(p_t[:, -1, :], bt) <= 1e-11


def test_poisson_factorize_dd_manufactured_solution():
    """lap(p) = f with p = sin(pi y) cos(2 pi x / Lx) cos(2 pi z / Lz) + y,
    p given at both walls: two first-order compact integrals recover p to
    1.1e-4 at 48 points (tests/test_factorize.py holds tlab_tpu's Neumann
    solve to 5e-5 on its grid); the singular (mean) column carries the
    linear part."""
    nx, ny, nz = 16, 48, 8
    grid, fdm, _, dev = _plans(nx, ny, nz)
    x, y, z = (a.nodes for a in (grid.x, grid.y, grid.z))
    kx, kz = 2.0 * np.pi / 2.0, 2.0 * np.pi / 1.5
    X, Y, Z = np.meshgrid(x, y, z, indexing="ij")
    wave = np.cos(kx * X) * np.cos(kz * Z)
    p = np.sin(np.pi * Y) * wave + Y
    f = -(np.pi ** 2 + kx ** 2 + kz ** 2) * np.sin(np.pi * Y) * wave
    got, _ = tfac.poisson_factorize(
        dev, torch.from_numpy(f), bcs_b=torch.from_numpy(p[:, 0, :].copy()),
        bcs_t=torch.from_numpy(p[:, -1, :].copy()), ibc="dd")
    assert np.max(np.abs(got.numpy() - p)) < 5e-4


def test_sing_column_dd_matches_jax():
    _, _, dev_j, dev_t = _plans(32, 33, 16)
    rng = np.random.default_rng(13)
    fcol = rng.standard_normal(33) + 1j * rng.standard_normal(33)
    gbs, gts = 0.3 - 0.2j, -0.7 + 0.1j
    uj, vj = jfac.sing_column(dev_j, jnp.asarray(fcol), gbs, gts, "dd")
    ut, vt = tfac.sing_column(dev_t, torch.from_numpy(fcol),
                              torch.tensor(gbs, dtype=torch.complex128),
                              torch.tensor(gts, dtype=torch.complex128), "dd")
    assert _rel(ut, uj) <= 1e-11 and _rel(vt, vj) <= 1e-11
    with pytest.raises(ValueError, match="ibc"):
        tfac.solve_modal_factorize(dev_t, None, None, None, ibc="dn")
