"""The port's immersed boundaries (tlab_tpu_torch/ibm.py and their hooks in
the step) against tlab_tpu, float64 on the CPU.

The geometries and build_spline_fill are NumPy copies and equal their
originals exactly; the port's fill tables (one interpolation per distinct
solid mask of a line, the solid points only) equal tlab_tpu's dense tables
at the solid points exactly, on 3-D grids (where tlab_tpu's y tables stay
zero: its moveaxis-then-reshape copies) and 2-D ones, with the
periodic-wrap and wall-anchor cases of tests/test_ibm.py.  The fill itself
agrees to 1e-14; the channel over mirrored bars (tests/data/case93_small3d.ini,
and its staggered copy) steps as tlab_tpu's to 1e-10 of max|field| over one
RK4 step and five, and runs through both command lines with dns.out equal
in every printed digit and the avg columns within 1e-9."""
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tlab_tpu import ibm as jibm
from tlab_tpu.config import load_case as jload_case
from tlab_tpu.dycore import incompressible as jdyn
from tlab_tpu.grid import uniform_grid as juniform_grid
from tlab_tpu.runtime import Simulation as JSimulation
from tlab_tpu.stats import averages as javg
from tlab_tpu.tools import cli as jcli
from tlab_tpu.tools.initialize import initial_state as jinitial_state
from tlab_tpu_torch import ibm as tibm
from tlab_tpu_torch.config import load_case
from tlab_tpu_torch.convert import (plans_from_jax, state_from_numpy,
                                    state_to_numpy)
from tlab_tpu_torch.dycore import incompressible as tdyn
from tlab_tpu_torch.grid import uniform_grid
from tlab_tpu_torch.io import fields_io as tio
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.stats import averages as tavg
from tlab_tpu_torch.tools import cli

DATA = os.path.join(os.path.dirname(__file__), "data")
CASE93 = os.path.join(DATA, "case93_small3d.ini")
CASE93STAG = os.path.join(DATA, "case93stag_small3d.ini")
F64 = torch.float64
TOL = 1e-10

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


GRIDS = {   # (nx, ny, nz), (lx, ly, lz)
    "3d": ((16, 24, 16), (3.0, 1.0, 1.5)),
    "2d": ((20, 18, 1), (3.0, 1.0, 1.0)),
    "odd": ((12, 10, 14), (2.0, 1.0, 1.5)),
}


def _grids(name):
    (nx, ny, nz), (lx, ly, lz) = GRIDS[name]
    return juniform_grid(nx, ny, nz, lx, ly, lz), \
        uniform_grid(nx, ny, nz, lx, ly, lz)


@pytest.mark.parametrize("kind", ["xbars", "xbars_mirrored", "box", "hill",
                                  "valley"])
def test_geometries_equal_the_copy(kind):
    jg, tg = _grids("3d")
    call = {
        "xbars": lambda m, g: m.geometry_xbars(g, 2, 5, 4),
        "xbars_mirrored": lambda m, g: m.geometry_xbars(g, 3, 4, 2,
                                                        mirrored=True),
        "box": lambda m, g: m.geometry_box(g, 3, 9, 0, 7, 2, 12),
        "hill": lambda m, g: m.geometry_hill(g, 0.3, 0.5, 1.2),
        "valley": lambda m, g: m.geometry_valley(g, 6, 2),
    }[kind]
    want, got = call(jibm, jg), call(tibm, tg)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.any()


def _eps(name, g):
    """A solid mask with bars (or a hill in 2-D) and an interior box."""
    eps = jibm.geometry_xbars(g, 2, 5, 4, mirrored=True) \
        if g.shape[2] > 1 else jibm.geometry_hill(g, 0.3, 0.5, 1.0)
    eps[3:6, 6:9, :] = 1.0
    return eps


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("wall", [(0.0, 0.0), (0.7, -0.2)])
def test_fill_tables_equal_the_copy(grid, wall):
    """build_spline_fill is a copy; the port's sparse tables (memoised per
    line mask) hold tlab_tpu's numbers at the solid points, bit for bit."""
    jg, tg = _grids(grid)
    eps = _eps(grid, jg)
    for axis, ax in enumerate((jg.x, jg.y, jg.z)):
        if ax.size == 1:
            continue
        args = (eps, axis, ax.nodes)
        kw = dict(periodic=ax.periodic, scale=ax.scale, wall_values=wall)
        want = jibm.build_spline_fill(*args, **kw)
        for a, b in zip(tibm.build_spline_fill(*args, **kw), want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        dense = dict(zip(("idx", "w", "const"), want), solid=eps > 0.5)
        got = tibm._sparse_fill(eps, axis, ax.nodes, ax.periodic, ax.scale,
                                wall)
        for a, b in zip(got, tibm.sparse_from_dense(dense, axis)):
            assert np.array_equal(a, b), (axis, grid)
        # tlab_tpu's y tables of a 3-D grid never receive their numbers
        lost = axis == 1 and jg.shape[2] > 1
        assert (not want[1].any()) == lost


@pytest.mark.parametrize("case", ["wall_anchor", "periodic_wrap", "cubic"])
def test_fill_cases_of_test_ibm(case):
    """The wall-anchor, periodic-wrap and cubic-exact cases of
    tests/test_ibm.py: the port's tables equal tlab_tpu's and its fill
    reproduces tlab_tpu's to 1e-14."""
    n = 32
    if case == "wall_anchor":
        nodes = np.linspace(0.0, 1.0, n)
        eps = np.zeros((4, n, 1))
        eps[:, :5, :] = 1.0
        axis, periodic, scale, wall = 1, False, None, (0.7, 0.0)
        u = np.broadcast_to(nodes[None, :, None], eps.shape).copy()
    elif case == "periodic_wrap":
        nodes = np.arange(n) * (2.0 / n)
        eps = np.zeros((1, 1, n))
        eps[..., :3] = 1.0
        axis, periodic, scale, wall = 2, True, 2.0, (0.0, 0.0)
        u = np.cos(np.pi * nodes)[None, None, :]
    else:
        nodes = np.linspace(0.0, 1.0, n, endpoint=False)
        eps = np.zeros((n, 8, 1))
        eps[10:15] = 1.0
        axis, periodic, scale, wall = 0, True, 1.0, (0.0, 0.0)
        x = nodes[:, None, None]
        u = (0.3 + 2 * x - x ** 2 + 0.5 * x ** 3) * np.ones(eps.shape)
    u = np.where(eps > 0.5, 99.0, u)            # garbage in the solid
    idx, w, const = jibm.build_spline_fill(eps, axis, nodes, periodic,
                                           scale, wall)
    dense = {"idx": idx, "w": w, "const": const, "solid": eps > 0.5}
    want = np.asarray(jibm.apply_spline_fill(jnp.asarray(u), dense, axis))
    fill = tibm.fill_from_dense(dense, axis, F64, "cpu")
    got = tibm.apply_spline_fill(torch.from_numpy(u), fill).numpy()
    assert np.max(np.abs(got - want)) <= 1e-14 * np.max(np.abs(want))
    assert np.abs(got - u).max() > 0.0


@pytest.mark.parametrize("grid", list(GRIDS))
def test_apply_spline_fill_matches(grid):
    """The fill of a 4-D stack and of one field, every direction, against
    tlab_tpu's dense fill; u itself is not written."""
    jg, tg = _grids(grid)
    eps = _eps(grid, jg)
    jf = jibm.build_ibm_spline(eps, jg, dtype=jnp.float64)
    tf = tibm.build_ibm_spline(eps, tg, dtype=F64, device="cpu")
    assert sorted(jf) == sorted(tf)
    rng = np.random.default_rng(0)
    stack = rng.standard_normal((4,) + jg.shape)
    for name, fill in jf.items():
        axis = "xyz".index(name)
        four = {k: v[None] for k, v in fill.items()}
        want = np.asarray(jibm.apply_spline_fill(jnp.asarray(stack), four,
                                                 axis + 1))
        q = torch.from_numpy(stack.copy())
        got = tibm.apply_spline_fill(q, tf[name]).numpy()
        assert np.array_equal(q.numpy(), stack)
        assert np.max(np.abs(got - want)) <= 1e-14 * np.max(np.abs(want))
        one = tibm.apply_spline_fill(q[1], tf[name]).numpy()
        assert np.array_equal(one, got[1])
    assert tibm.fill_bytes(tf) > 0


@pytest.mark.parametrize("values", [None, (0.3, -0.2)])
def test_direct_forcing_matches(values):
    """apply_ibm_state (zero velocity, scalars pinned to their values or 0
    in the solids) against tlab_tpu's, exactly."""
    jg, tg = _grids("3d")
    eps = _eps("3d", jg)
    rng = np.random.default_rng(4)
    u, v, w = (rng.standard_normal(jg.shape) for _ in range(3))
    s = rng.standard_normal((2,) + jg.shape)
    want = jibm.apply_ibm_state(
        jibm.build_ibm(eps, dtype=jnp.float64, scalar_values=values),
        jdyn.State(*(jnp.asarray(a) for a in (u, v, w, s))))
    got = tibm.apply_ibm_state(
        tibm.build_ibm(eps, dtype=F64, device="cpu", scalar_values=values),
        state_from_numpy(u, v, w, s, "cpu", F64))
    for a, b in zip(state_to_numpy(got), state_to_numpy(want)):
        assert np.array_equal(a, b)
    assert not state_to_numpy(got)[0][eps > 0.5].any()


def _noisy_start(jsim, seed=3):
    st = jinitial_state(jsim, seed=seed)
    rng = np.random.default_rng(seed)
    ny = jsim.grid.shape[1]
    env = np.sin(np.pi * np.linspace(0.0, 1.0, ny))[None, :, None]
    u, v, w = (np.asarray(a) + 0.05 * env * rng.standard_normal(a.shape)
               for a in (st.u, st.v, st.w))
    s = np.asarray(st.s) + 0.05 * env * rng.standard_normal(st.s.shape)
    return u, v, w, s


@pytest.mark.parametrize("path", [CASE93, CASE93STAG])
def test_channel_over_bars_steps_as_jax(path):
    """One RK4 step and five of the case files, from the same noisy state,
    through both packages' from_case plans; the port's plan carried from
    tlab_tpu's steps the same."""
    jsim = JSimulation.from_case(jload_case(path))
    tsim = Simulation.from_case(load_case(path), dtype=F64, device="cpu")
    assert "ibm" in tsim.P and sorted(tsim.P["ibm"]["fills"]) == ["x", "y",
                                                                  "z"]
    assert "src" not in tsim.P["ibm"]["fills"]["y"]     # tables of zeros
    start = _noisy_start(jsim)
    sj = jdyn.State(*(jnp.asarray(a) for a in start))
    st = state_from_numpy(*start, "cpu", F64)
    carried = plans_from_jax(jsim.P, "cpu", F64,
                             bodyforce=tsim.P["bodyforce"])
    sc = st
    solid = np.asarray(jsim.P["ibm"]["eps"]) > 0.5
    for i in range(5):
        sj, pj = jdyn.rk_step(jsim.P, sj, 4e-3, unroll=True)
        st, pt = tdyn.rk_step(tsim.P, st, 4e-3)
        sc, _ = tdyn.rk_step(carried, sc, 4e-3)
        if i in (0, 4):
            for a, b, c in zip(state_to_numpy(st), state_to_numpy(sj),
                               state_to_numpy(sc)):
                assert _rel(a, b) <= TOL and _rel(c, b) <= TOL, i
            assert _rel(pt, pj) <= TOL
    for a in state_to_numpy(st)[:3]:
        assert np.max(np.abs(a[solid])) == 0.0


def test_ibm_step_leaves_its_input():
    """The fill writes new tensors: a step leaves the state it was given."""
    tsim = Simulation.from_case(load_case(CASE93), dtype=F64, device="cpu")
    start = _noisy_start(JSimulation.from_case(jload_case(CASE93)))
    st = state_from_numpy(*start, "cpu", F64)
    before = [a.clone() for a in st[:4]]
    tdyn.rk_step(tsim.P, st, 4e-3)
    for a, b in zip(st[:4], before):
        assert torch.equal(a, b)


def test_channel_over_bars_through_both_clis(tmp_path):
    """inigrid, ini and dns of case93_small3d.ini (10 steps, statistics at
    5 and 10) through both command lines: dns.out in every printed digit,
    the restart fields to 1e-10, the avg files to their printed digits
    (1e-8) and the tables in memory to 1e-9 of each column's max."""
    with open(CASE93) as fh:
        text = fh.read()
    dirs = {}
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        ini = str(d / "tlab.ini")
        (d / "tlab.ini").write_text(text)
        for command in ("inigrid", "ini", "dns"):
            if pkg == "jax":
                rc = jcli.main([command, "--ini", ini, "--outdir", str(d),
                                "--cpu", "--x64"])
            else:
                rc = cli.main([command, "--ini", ini, "--outdir", str(d),
                               "--device", "cpu", "--x64"])
            assert rc == 0, (pkg, command)
        dirs[pkg] = d
    dj, dt = dirs["jax"], dirs["port"]
    lj = (dj / "dns.out").read_text().splitlines()
    lt = (dt / "dns.out").read_text().splitlines()
    assert len(lt) == 3 + 11 and lt == lj
    got = tio.read_state(str(dt / "flow"), str(dt / "scal"), 10, 1)
    want = tio.read_state(str(dj / "flow"), str(dj / "scal"), 10, 1)
    for a, b in zip(got[:4], want[:4]):
        assert _rel(a, b) <= TOL
    for name in ("avg5", "avg10", "avg10s1"):   # 9 printed digits
        _, gj, cj = tavg.read_avg(str(dj / name))
        _, gt, ct = tavg.read_avg(str(dt / name))
        assert gj == gt and list(cj) == list(ct)
        for k in cj:
            assert np.max(np.abs(ct[k] - cj[k])) <= max(
                1e-8 * np.max(np.abs(cj[k])), 1e-13), (name, k)
    # the tables in memory, of the final state and one more step's pressure
    jsim = JSimulation.from_case(jload_case(CASE93))
    tsim = Simulation.from_case(load_case(CASE93), dtype=F64, device="cpu")
    sj = jdyn.State(*(jnp.asarray(a) for a in want[:4]))
    pj = jdyn.rk_step(jsim.P, sj, 1e-3)[1]
    flow_j, scal_j = javg.make_stats_tables_fn(jsim)(sj, pj)
    flow_t, scal_t = tavg.stats_tables(
        tsim, state_from_numpy(*want[:4], "cpu", F64),
        torch.from_numpy(np.array(pj)))
    for ref, tab, groups in ((flow_j, flow_t, tavg.FLOW_GROUPS),
                             (scal_j[0], scal_t[0], tavg.scal_groups(1))):
        # the written columns (the tables also carry the legacy aliases)
        for k in (k for _, names in groups for k in names.split()):
            a, b = np.asarray(ref[k], np.float64), np.asarray(tab[k])
            assert np.max(np.abs(a - b)) <= max(1e-9 * np.max(np.abs(a)),
                                                1e-13), k
