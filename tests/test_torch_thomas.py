"""The port's long-line operators (tlab_tpu_torch/ops/thomas.py and their
selection in dycore/incompressible.py) against tlab_tpu's
ops/pallas_thomas.py, float64 on the CPU: the host plans exactly, the
substructured first derivative and solve against tlab_tpu's and against
the dense product, the plan keys that the port's threshold keyword and
tlab_tpu's environment variables select, and RK steps on such plans."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from threadpoolctl import threadpool_limits

from tlab_tpu import grid as jgrid
from tlab_tpu.dycore import incompressible as jdyn
from tlab_tpu.fdm.plan import build_deriv_plan, build_fdm_plan
from tlab_tpu.grid import make_axis
from tlab_tpu.ops import pallas_thomas as jthomas
from tlab_tpu.physics.params import NSParams
from tlab_tpu_torch import grid as tgrid
from tlab_tpu_torch.constants import BC
from tlab_tpu_torch.convert import plans_from_jax, state_from_numpy
from tlab_tpu_torch.dycore import incompressible as tdyn
from tlab_tpu_torch.fdm.plan import build_fdm_plan as tbuild_fdm_plan
from tlab_tpu_torch.ops import thomas
from tlab_tpu_torch.physics.params import NSParams as TNSParams

F64 = torch.float64
# the algebra is an exact block LU of the dense operator: both sides are
# round-off apart
TOL = 1e-10

# the test workers share the machine's cores: with every worker's products
# on all of them, the threads spin on each other and a step takes 20x longer
torch.set_num_threads(2)
# the same holds for NumPy's BLAS, which the host plans call many times
# (small inverses and solves, each waking every BLAS thread)
threadpool_limits(1, user_api="blas")

# (n, periodic): 256 (two 128-point segments), 320 (128 does not divide
# it: the plan takes 64-point segments), periodic and not
LINES = [(256, False), (256, True), (320, False), (320, True)]


def _axis(n, periodic):
    nodes = np.arange(n) * (2 * np.pi / n) if periodic \
        else np.linspace(0.0, 1.0, n) ** 1.2      # stretched
    return make_axis(nodes, periodic)


def _exact(a, b, where="plan"):
    """Port plan `a` and tlab_tpu plan `b` hold the same data, exactly."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _exact(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@pytest.mark.parametrize("n, periodic", LINES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plans_equal_jax(n, periodic, dtype):
    plan = build_deriv_plan(_axis(n, periodic))
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    _exact(thomas.banded_plan(plan.A1, plan.B1, dtype, periodic=periodic),
           jthomas.banded_plan(plan.A1, plan.B1, jdt, periodic=periodic))
    _exact(thomas.partitioned_plan(plan.A2, 128, dtype, periodic),
           jthomas.partitioned_plan(plan.A2, 128, jdt, periodic))
    if n == 320:
        assert thomas.partitioned_plan(plan.A1, 128, dtype)["L"] == 64


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("n, periodic", LINES)
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_banded_der1_matches_jax_and_dense(n, periodic, axis):
    plan = build_deriv_plan(_axis(n, periodic))
    bj = jthomas.banded_plan(plan.A1, plan.B1, jnp.float64,
                             periodic=periodic)
    bt = thomas.device_plan(thomas.banded_plan(plan.A1, plan.B1, np.float64,
                                               periodic=periodic),
                            F64, "cpu")
    shape = [3, 5, 4]
    shape[axis] = n
    u = np.random.default_rng(3).standard_normal(shape)
    got = thomas.banded_der1(bt, torch.from_numpy(u), axis)
    dense = np.moveaxis(np.tensordot(plan.d1[BC.DD], u, (1, axis)), 0, axis)
    assert got.shape == u.shape
    assert _rel(got, jthomas.banded_der1(bj, jnp.asarray(u), axis)) <= TOL
    assert _rel(got, dense) <= TOL


@pytest.mark.parametrize("n, periodic", LINES)
def test_partitioned_solve_matches_jax_and_dense(n, periodic):
    A = build_deriv_plan(_axis(n, periodic)).A1
    pj = jthomas.partitioned_plan(A, 128, jnp.float64, periodic)
    pt = thomas.device_plan(thomas.partitioned_plan(A, 128, np.float64,
                                                    periodic), F64, "cpu")
    rhs = np.random.default_rng(4).standard_normal((6, n))
    got = thomas.partitioned_solve(pt, torch.from_numpy(rhs))
    assert _rel(got, jthomas.partitioned_solve(pj, jnp.asarray(rhs))) <= TOL
    assert _rel(got, np.linalg.solve(A, rhs.T).T) <= TOL


def _plans(monkeypatch, shape, threshold, periodic_y=False, **kw):
    """Both packages' plans of a (nx, ny, nz) box: tlab_tpu's with its two
    environment variables at `threshold` (None: its defaults), the port's
    with the keyword."""
    if threshold is not None:
        monkeypatch.setenv("TLAB_TPU_THOMAS_MIN_N", str(threshold))
        monkeypatch.setenv("TLAB_TPU_PARTITION_MIN_N", str(threshold))
    nsp = dict(reynolds=400.0, schmidt=(1.0,))
    sbc = (("neumann", "neumann"),)
    args = [2 * np.pi, 1.0, np.pi]

    def grid(mod):
        g = mod.uniform_grid(*shape, *args)
        if periodic_y:
            y = mod.make_axis(np.arange(shape[1]) / shape[1], True)
            g = mod.Grid(g.x, y, g.z)
        return g

    PJ = jdyn.build_device_plans(
        build_fdm_plan(grid(jgrid)),
        NSParams(**nsp),
        jdyn.WallBCs.from_velocity_kind("freeslip", "freeslip",
                                        scalar_bcs=sbc),
        dtype=jnp.float64, **kw)
    tkw = dict(kw)
    if threshold is not None:
        tkw["banded_min_n"] = threshold
    PT = tdyn.build_device_plans(
        tbuild_fdm_plan(grid(tgrid)), TNSParams(**nsp),
        tdyn.WallBCs.from_velocity_kind("freeslip", "freeslip",
                                        scalar_bcs=sbc),
        dtype=F64, device="cpu", factorize=False, **tkw)
    return PJ, PT


@pytest.mark.parametrize("shape, periodic_y, keys", [
    ((256, 33, 8), False, {"d1x_banded", "d2x_banded"}),
    ((16, 256, 8), False, {"d1y_banded"}),
    ((16, 320, 8), True, {"d1y_banded", "d2y_banded"}),
    ((16, 17, 256), False, {"d1z_banded", "d2z_banded"}),
])
def test_threshold_keyword_selects_jax_keys(monkeypatch, shape, periodic_y,
                                            keys):
    kw = {"with_elliptic": False} if periodic_y else {}
    PJ, PT = _plans(monkeypatch, shape, 256, periodic_y, **kw)
    banded = {k for k in PT if k.endswith("_banded")}
    assert banded == keys == {k for k in PJ if k.endswith("_banded")}
    conv = plans_from_jax({k: PJ[k] for k in banded}, "cpu", F64)
    for k in banded:
        assert conv[k]["pad"] == PT[k]["pad"] == 8
        assert torch.equal(conv[k]["F"], PT[k]["F"])
        assert torch.equal(conv[k]["part"]["Minv"], PT[k]["part"]["Minv"])
    # the default threshold selects nothing below 2304
    assert not [k for k in tdyn.build_device_plans(
        tbuild_fdm_plan(tgrid.uniform_grid(*shape, 1.0, 1.0, 1.0)),
        TNSParams(), tdyn.WallBCs(s=()), dtype=F64, device="cpu",
        factorize=False, with_elliptic=not periodic_y)
        if k.endswith("_banded")]


@pytest.mark.parametrize("shape", [(256, 33, 8), (16, 256, 8)],
                         ids=["x", "y"])
def test_rk_steps_on_banded_plans_match_jax(monkeypatch, shape):
    """One RK4 step and five on a plan with a banded x line (periodic: d1
    and d2, the Burgers term's substructured pair) or y line (walls: d1,
    the projection's divergence and gradient), against tlab_tpu's."""
    PJ, PT = _plans(monkeypatch, shape, 256)
    rng = np.random.default_rng(5)
    y = np.linspace(0.0, 1.0, shape[1])[None, :, None]
    u = np.tanh((y - 0.5) / 0.1) + 0.1 * rng.standard_normal(shape)
    v = 0.1 * rng.standard_normal(shape) * np.sin(np.pi * y)
    w = 0.1 * rng.standard_normal(shape)
    s = (0.5 + 0.5 * np.tanh((y - 0.5) / 0.1) + 0.0 * u)[None]
    sj = jdyn.State(u=jnp.asarray(u), v=jnp.asarray(v), w=jnp.asarray(w),
                    s=jnp.asarray(s))
    st = state_from_numpy(u, v, w, s, "cpu", F64)
    for n in range(1, 6):
        sj, _ = jdyn.rk_step(PJ, sj, 2e-3)
        st, _ = tdyn.rk_step(PT, st, 2e-3)
        if n in (1, 5):
            for a, b in zip(st[:4], sj[:4]):
                assert _rel(a, b) <= TOL
    # the banded derivative stood in for the dense one
    a = torch.from_numpy(u)
    name, axis = ("x", 0) if shape[0] == 256 else ("y", 1)
    assert _rel(tdyn._d1(PT, name, axis, a),
                tdyn.der1(PT[f"d1{name}"], a, axis)) <= TOL


def _golden_sims(text, steps, **kw):
    """Both Simulations of `text` (the port's with `kw`), their banded plan
    keys, and tlab_tpu's initial state stepped by both, one RK step and
    `steps`: each field to 1e-10 of its max."""
    from tlab_tpu.config import Ini as JIni, load_case as jload_case
    from tlab_tpu.runtime import Simulation as JSimulation
    from tlab_tpu.tools.initialize import initial_state as jinitial_state
    from tlab_tpu_torch.config import Ini, load_case
    from tlab_tpu_torch.convert import state_to_numpy
    from tlab_tpu_torch.runtime import Simulation
    jsim = JSimulation.from_case(jload_case(JIni(text=text)))
    tsim = Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                                device="cpu", **kw)
    keys = {k for k in tsim.P if k.endswith("_banded")}
    assert keys == {k for k in jsim.P if k.endswith("_banded")}
    sj = jinitial_state(jsim, seed=2)
    st = state_from_numpy(*state_to_numpy(sj), "cpu", F64)
    for n in range(1, steps + 1):
        sj, _ = jdyn.rk_step(jsim.P, sj, 1e-3)
        st, _ = tdyn.rk_step(tsim.P, st, 1e-3)
        if n in (1, steps):
            for a, b in zip(st[:4], sj[:4]):
                # w of a 2-D case stays 0 in both
                assert _rel(a, b) <= TOL if float(abs(b).max()) > 0 \
                    else float(abs(a).max()) == 0.0
    return tsim, keys, st


def test_default_threshold_takes_a_2304_point_line(monkeypatch):
    """The golden slice's case in 2-D with a 2304-point periodic x: both
    Simulations select the substructured x pair by their defaults (the
    port's keyword, tlab_tpu's unset environment variables), and one RK
    step agrees to 1e-10 of max|field|."""
    from test_golden import INI
    monkeypatch.delenv("TLAB_TPU_THOMAS_MIN_N", raising=False)
    monkeypatch.delenv("TLAB_TPU_PARTITION_MIN_N", raising=False)
    text = INI.replace("points_1=33\nscales_1=4.0",
                       "points_1=2305\nscales_1=4.0").replace(
        "points_1=16\nscales_1=2.0", "points_1=1\nscales_1=2.0")
    tsim, keys, st = _golden_sims(text, 1)
    assert tsim.grid.shape == (2304, 33, 1)
    assert keys == {"d1x_banded", "d2x_banded"}
    assert float(abs(st.w).max()) == 0.0                 # 2-D


@pytest.mark.parametrize("line, old, new, shape, keys", [
    ("x", "points_1=33\nscales_1=4.0", "points_1=257\nscales_1=4.0",
     (256, 33, 1), {"d1x_banded", "d2x_banded"}),
    ("y", "points_1=33\nscales_1=2.0", "points_1=256\nscales_1=2.0",
     (32, 256, 1), {"d1y_banded"}),
])
def test_from_case_takes_the_threshold_keyword(monkeypatch, line, old, new,
                                               shape, keys):
    """Simulation.from_case(banded_min_n=256) on the golden case in 2-D
    with a 256-point x line (periodic: d1 and d2) or y line (walls: d1)
    builds the keys tlab_tpu builds with its environment variables at 256,
    and one RK step and five agree to 1e-10 of max|field|."""
    from test_golden import INI
    monkeypatch.setenv("TLAB_TPU_THOMAS_MIN_N", "256")
    monkeypatch.setenv("TLAB_TPU_PARTITION_MIN_N", "256")
    assert old in INI
    text = INI.replace(old, new).replace("points_1=16\nscales_1=2.0",
                                         "points_1=1\nscales_1=2.0")
    tsim, got, _ = _golden_sims(text, 5, banded_min_n=256)
    assert tsim.grid.shape == shape and got == keys
