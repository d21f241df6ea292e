"""The port's factorized Poisson solver against tlab_tpu's, float64 on the
CPU, plus the divergence-removal property of tests/test_factorize.py and
the refusal of a float32 plan past its conditioning."""
import os
import re

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
    """The batched singular solve with one mode against tlab_tpu's
    per-mode DD_Sing column."""
    _, _, dev_j, dev_t = _plans(32, 33, 16)
    rng = np.random.default_rng(13)
    fcol = rng.standard_normal(33) + 1j * rng.standard_normal(33)
    gbs, gts = 0.3 - 0.2j, -0.7 + 0.1j
    uj, vj = jfac.sing_column(dev_j, jnp.asarray(fcol), gbs, gts, "dd")
    ut, vt = tfac.sing_column(dev_t, torch.from_numpy(fcol)[:, None],
                              torch.tensor([gbs], dtype=torch.complex128),
                              torch.tensor([gts], dtype=torch.complex128),
                              "dd")
    assert ut.shape == vt.shape == (33, 1)
    assert _rel(ut[:, 0], uj) <= 1e-11 and _rel(vt[:, 0], vj) <= 1e-11
    with pytest.raises(ValueError, match="ibc"):
        tfac.solve_modal_factorize(dev_t, None, None, None, ibc="dn")


# the singular index sets: the reference's four {0, Nyquist}^2 (the plan's
# own), the staggered grid's one, and a pencil rank's empty set
SING_SETS = {"four": None, "one": ((0, 0),), "none": ()}


@pytest.mark.parametrize("modes", list(SING_SETS))
@pytest.mark.parametrize("ibc, mode", [("nn", None), ("nn", "legacy"),
                                       ("dd", None)])
def test_batched_singular_solve_matches_jax_per_mode(monkeypatch, ibc, mode,
                                                     modes):
    """solve_modal_factorize solves the plan's singular modes as one batch:
    each mode's columns equal tlab_tpu's sing_column of that mode alone to
    1e-12 (float64), every mode with a forcing column and wall values of
    its own, and the whole solve equals tlab_tpu's over the same index set
    to 1e-11 (but for the kappa ~ 0 modes outside it); an empty set makes
    no product of its own."""
    from tlab_tpu_torch.utils import trace
    if mode is None:
        monkeypatch.delenv("TLAB_TPU_SING_MODE", raising=False)
    else:
        monkeypatch.setenv("TLAB_TPU_SING_MODE", mode)
    nx, ny, nz = 32, 33, 16
    sing_idx = SING_SETS[modes]
    fdm = build_fdm_plan(uniform_grid(nx, ny, nz, 2.0, 1.0, 1.5))
    tfdm = tbuild_fdm_plan(tgrid.uniform_grid(nx, ny, nz, 2.0, 1.0, 1.5))
    dev_j = jfac.device_factorize_plan(
        jfac.build_factorize_plan(fdm, sing_idx=sing_idx), jnp.float64)
    dev_t = tfac.device_factorize_plan(
        tfac.build_factorize_plan(tfdm, sing_idx=sing_idx), torch.float64,
        "cpu")
    m = len(dev_t["sing_idx"])
    assert m == {"four": 4, "one": 1, "none": 0}[modes]
    nkx = nx // 2 + 1
    rng = np.random.default_rng(14)

    def cplx(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    f_hat, gb, gt = cplx(nkx, ny, nz), cplx(nkx, nz), cplx(nkx, nz)
    trace.stop()
    trace.reset()
    trace.start(host_only=True)
    try:
        with trace.span("t.solve"):
            u, v = tfac.solve_modal_factorize(
                dev_t, torch.from_numpy(f_hat), torch.from_numpy(gb),
                torch.from_numpy(gt), ibc)
        counts = trace.totals()["spans"]["t.solve"]["counts"]
    finally:
        trace.stop()
        trace.reset()
    assert counts["library.cublas"] == 7 + (4 if m else 0)
    assert counts["ops.poisson.sing_columns"] == m
    for (i, k) in dev_t["sing_idx"]:
        gbs = 0.0 if ibc == "nn" else gb[i, k]
        uj, vj = jfac.sing_column(dev_j, jnp.asarray(f_hat[i, :, k]), gbs,
                                  gt[i, k], ibc)
        assert _rel(u[i, :, k], uj) <= 1e-12
        assert _rel(v[i, :, k], vj) <= 1e-12
    # kappa ~ 0 modes outside the set keep the regular solve's ill-posed
    # 'nn' columns (kappa 1e-14 at Nyquist: ~1e27), which neither package
    # defines: left out
    kappa = dev_t["kappa"].numpy()
    keep = kappa > 1e-8 * kappa.max()
    for (i, k) in dev_t["sing_idx"]:
        keep[i, k] = True
    uj, vj = jfac.solve_modal_factorize(
        dev_j, jnp.asarray(f_hat), jnp.asarray(gb), jnp.asarray(gt),
        ibc=ibc, sing_idx=dev_j["sing_idx"])
    for a, b in ((u, uj), (v, vj)):
        a, b = a.numpy().transpose(0, 2, 1), np.asarray(b).transpose(0, 2, 1)
        assert _rel(a[keep], b[keep]) <= 1e-11


def _shear_text(ny, changes=(), n=8):
    """examples/shear3d/tlab.ini (its stretched y) at n x ny x n, with
    `changes` {(section, key): value} (a key it lacks is added)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "examples", "shear3d", "tlab.ini")) as fh:
        text = fh.read()
    keys = {("Grid", "Imax"): n, ("Grid", "Jmax"): ny, ("Grid", "Kmax"): n,
            ("IniGridOx", "points_1"): n + 1, ("IniGridOy", "points_1"): ny,
            ("IniGridOz", "points_1"): n + 1, **dict(changes)}
    for (sec, key), v in keys.items():
        pat = re.compile(rf"(\[{sec}\][^\[]*?^{key}=)[^\n]*", re.M | re.S)
        text, found = pat.subn(rf"\g<1>{v}", text)
        if not found:
            text = text.replace(f"[{sec}]\n", f"[{sec}]\n{key}={v}\n", 1)
    return text


def _fp32_noise_error(ny):
    """max|p32 - p64| / max|p64| of the factorized solve of a white-noise
    forcing on the shear layer's y at 16 x ny x 16."""
    from tlab_tpu_torch.config import Ini, load_case
    from tlab_tpu_torch.runtime import grid_from_case
    grid = grid_from_case(load_case(Ini(text=_shear_text(ny, n=16))))
    plan = tfac.build_factorize_plan(tbuild_fdm_plan(grid))
    f = np.random.default_rng(0).standard_normal((16, ny, 16))
    p = [tfac.poisson_factorize(tfac.device_factorize_plan(plan, dt, "cpu"),
                                torch.tensor(f, dtype=dt))[0].double()
         for dt in (torch.float32, torch.float64)]
    return _rel(p[0], p[1]), max(plan.emin["cond"], plan.emax["cond"])


def test_float32_factorized_plan_past_its_conditioning_is_refused(
        monkeypatch):
    """The shear layer's y at 512 points gives the factorized plan
    eigenbases of cond(V) ~2e7, past FP32_COND_MAX: Simulation.from_case
    refuses it in float32 and names the way out (float64, or the direct
    eigen solve), builds it in float64, and builds the direct eigen solve in
    float32.  The refusal's premise: a white-noise forcing's float32 solve
    is off by a tenth of its max and more there, by a few hundredths at 256
    points (the main case's y, cond(V) ~2e6)."""
    from tlab_tpu_torch.config import Ini, load_case
    from tlab_tpu_torch.runtime import Simulation
    text = _shear_text(512)
    with pytest.raises(ValueError, match="compactdirect6") as err:
        Simulation.from_case(load_case(Ini(text=text)), dtype=torch.float32,
                             device="cpu")
    assert "--x64" in str(err.value) and "ny = 512" in str(err.value)
    assert "ell_fac" in Simulation.from_case(
        load_case(Ini(text=text)), dtype=torch.float64, device="cpu").P
    direct = Simulation.from_case(load_case(Ini(text=_shear_text(
        512, {("Main", "EllipticOrder"): "compactdirect6"}))),
        dtype=torch.float32, device="cpu")
    assert "ell_fac" not in direct.P
    assert "ell_fac" in Simulation.from_case(
        load_case(Ini(text=_shear_text(256))), dtype=torch.float32,
        device="cpu").P
    monkeypatch.setattr(tfac, "FP32_COND_MAX", np.inf)
    err256, cond256 = _fp32_noise_error(256)
    err512, cond512 = _fp32_noise_error(512)
    assert cond256 < 2.0 ** 24 < cond512
    assert err256 < 0.05 and err512 > 0.1
