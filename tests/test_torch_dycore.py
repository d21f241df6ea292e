"""The port's incompressible main path against tlab_tpu, float64 on the
CPU: plans, one stacked substep, one RK4 step, the diagnostics, the
golden 20-step RK3 slice, the options that were once refused and now run
(each against tlab_tpu), and the options the port still rejects."""
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from test_golden import GOLDEN, INI
from tlab_tpu.config import Ini, load_case
from tlab_tpu.dycore import incompressible as jdyn
from tlab_tpu.fdm.plan import build_fdm_plan
from tlab_tpu.grid import uniform_grid
from tlab_tpu.ops import elliptic_factorize as jfac
from tlab_tpu.physics.params import NSParams
from tlab_tpu.runtime import Simulation as JSimulation
from tlab_tpu.tools.initialize import initial_state as jinitial_state
from tlab_tpu_torch import entry
from tlab_tpu_torch import config as tconfig
from tlab_tpu_torch import grid as tgrid
from tlab_tpu_torch.fdm.plan import build_fdm_plan as tbuild_fdm_plan
from tlab_tpu_torch.physics.params import NSParams as TNSParams
from tlab_tpu_torch.convert import plans_from_jax, state_from_numpy
from tlab_tpu_torch.dycore import incompressible as tdyn
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.tools.initialize import initial_state

F64 = torch.float64

# the test workers share the machine's cores: with every worker's products
# on all of them, the threads spin on each other and a step takes 20x longer
torch.set_num_threads(2)


def _setup(rk_name="RungeKuttaExplicit4"):
    """Both packages' plans for a 32x33x16 shear layer and its state with
    extra noise (so every term of the RHS is exercised)."""
    grid = uniform_grid(32, 33, 16, 2.0 * np.pi, 1.0, np.pi)
    fdm = build_fdm_plan(grid)
    nsp = NSParams(reynolds=500.0, schmidt=(1.0,))
    sbc = (("neumann", "neumann"),)
    PJ = jdyn.build_device_plans(
        fdm, nsp, jdyn.WallBCs.from_velocity_kind("freeslip", "freeslip",
                                                  scalar_bcs=sbc),
        rk_name=rk_name, dtype=jnp.float64)
    PJ["ell_fac"] = jfac.device_factorize_plan(jfac.build_factorize_plan(fdm),
                                               jnp.float64)
    PT = tdyn.build_device_plans(
        tbuild_fdm_plan(tgrid.uniform_grid(32, 33, 16, 2.0 * np.pi, 1.0,
                                           np.pi)),
        TNSParams(reynolds=500.0, schmidt=(1.0,)),
        tdyn.WallBCs.from_velocity_kind("freeslip", "freeslip",
                                        scalar_bcs=sbc),
        rk_name=rk_name, dtype=F64, device="cpu")
    u, v, w, s = entry.initial_fields(grid, seed=3)
    rng = np.random.default_rng(4)
    u, v, w = (a + 0.1 * rng.standard_normal(a.shape) for a in (u, v, w))
    return PJ, PT, (u, v, w, np.array(s))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        return all(_same(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype \
            and torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def test_plans_from_jax_equal_port_plans():
    PJ, PT, _ = _setup()
    assert _same(plans_from_jax(PJ, "cpu", F64), PT)


def test_substep_rhs_stacked_matches_jax():
    PJ, PT, (u, v, w, s) = _setup()
    Q = np.concatenate([u[None], v[None], w[None], s])
    H = np.random.default_rng(5).standard_normal(Q.shape)
    HJ, pJ = jdyn.substep_rhs_stacked(PJ, jnp.asarray(Q), jnp.asarray(H),
                                      1e-3)
    Hin = torch.from_numpy(H)
    HT, pT = tdyn.substep_rhs_stacked(PT, torch.from_numpy(Q), Hin, 1e-3)
    assert torch.equal(Hin, torch.from_numpy(H))     # input left as it was
    assert _rel(HT, HJ) <= 1e-12
    assert _rel(pT, pJ) <= 1e-12


@pytest.mark.parametrize("rk_name", ["RungeKuttaExplicit4",
                                     "RungeKuttaExplicit3"])
def test_rk_step_matches_jax(rk_name):
    PJ, PT, (u, v, w, s) = _setup(rk_name)
    sj, _ = jdyn.rk_step(PJ, jdyn.State(u=jnp.asarray(u), v=jnp.asarray(v),
                                        w=jnp.asarray(w), s=jnp.asarray(s)),
                         1e-3)
    st = state_from_numpy(u, v, w, s, "cpu", F64)
    st2, _ = tdyn.rk_step(PT, st, 1e-3)
    assert _rel(st.u, u) == 0.0                      # input left as it was
    for a, b in zip(st2[:4], sj[:4]):
        assert _rel(a, b) <= 1e-12


def test_rk_loop_stacked_matches_jax():
    PJ, PT, (u, v, w, s) = _setup()
    sj, pj = jdyn.rk_loop_stacked(PJ, jdyn.State(
        u=jnp.asarray(u), v=jnp.asarray(v), w=jnp.asarray(w),
        s=jnp.asarray(s)), 1e-3, 2)
    st, pt = tdyn.rk_loop_stacked(PT, state_from_numpy(u, v, w, s, "cpu",
                                                       F64), 1e-3, 2)
    for a, b in zip(st[:4], sj[:4]):
        assert _rel(a, b) <= 1e-12
    assert _rel(pt, pj) <= 1e-11


def test_diagnostics_match_jax():
    PJ, PT, (u, v, w, s) = _setup()
    sj = jdyn.State(u=jnp.asarray(u), v=jnp.asarray(v), w=jnp.asarray(w),
                    s=jnp.asarray(s))
    st = state_from_numpy(u, v, w, s, "cpu", F64)
    cj = float(jdyn.cfl_advective_max(PJ, sj))
    ct = float(tdyn.cfl_advective_max(PT, st))
    assert abs(ct - cj) <= 1e-13 * cj
    for a, b in zip(tdyn.dilatation_minmax(PT, st),
                    jdyn.dilatation_minmax(PJ, sj)):
        assert abs(float(a) - float(b)) <= 1e-12 * abs(float(b))
    assert tdyn.next_dt(PT, ct, 0.8, 0.2) == pytest.approx(
        jdyn.next_dt(PJ, cj, 0.8, 0.2), rel=1e-13)


def test_golden_slice():
    """tests/test_golden.py's 20 RK3 steps through the port alone: the
    case loads through the port's own load_case and runtime, and the initial
    state comes from the port's initializer, which tlab_tpu's is held
    against here (1e-11 of max|field|)."""
    case = tconfig.load_case(tconfig.Ini(text=INI))
    sim = Simulation.from_case(case, dtype=F64, device="cpu")
    state = initial_state(sim, seed=12345)
    st = jinitial_state(JSimulation.from_case(load_case(Ini(text=INI))),
                        seed=12345)
    for a, b in zip(state[:4], (st.u, st.v, st.w, st.s)):
        assert _rel(a, b) <= 1e-11
    for _ in range(20):
        state, _ = tdyn.rk_step(sim.P, state, 2e-3)
    u = state.u.numpy()
    v = state.v.numpy()
    s = state.s[0].numpy()
    got = {
        'u_mean': float(u.mean()), 'u_var': float(u.var()),
        'v_var': float(v.var()), 's_mean': float(s.mean()),
        'u_probe': float(u[7, 16, 3]), 'v_probe': float(v[20, 8, 11]),
        's_probe': float(s[3, 25, 7]),
    }
    for k, ref in GOLDEN.items():
        scale = max(abs(ref), 1e-8)
        assert abs(got[k] - ref) / scale < 1e-9, (k, got[k], ref)


def _with_key(section, key, value, text=INI):
    """The golden case's text (or `text`) with [section] key=value set."""
    if f"[{section}]\n" not in text:
        return text + f"[{section}]\n{key}={value}\n"
    head, body = text.split(f"[{section}]\n", 1)
    body, sep, rest = body.partition("[")
    body = re.sub(rf"^{key}=[^\n]*\n", "", body, flags=re.M)
    return f"{head}[{section}]\n{key}={value}\n{body}{sep}{rest}"


@pytest.mark.parametrize("edits", [
    (("Main", "Equations", "internal"),
     ("BoundaryConditions", "VelocityJmin", "outflow")),
    (("Main", "Equations", "internal"),
     ("Thermodynamics", "Mixture", "AirWater")),
], ids=["nscbc", "airwater"])
def test_from_case_builds_the_compressible_options_once_refused(edits):
    """The compressible set's characteristic boundaries and its moist
    mixture, refused until they were ported: from_case builds tlab_tpu's
    context (the NSCBC spec, open at Jmin and a wall at Jmax, or the
    AirWater units with outflow at any non-periodic y), and the NSCBC case
    steps as tlab_tpu's from the same state (1e-10 of max|field|; the
    AirWater physics of a shear layer without an enthalpy profile is no
    state: tests/test_torch_airwater.py steps Case14)."""
    import dataclasses
    from tlab_tpu.dycore import compressible as jcomp
    from tlab_tpu.tools.initialize import compressible_initial_state
    from tlab_tpu_torch.dycore import compressible as tcomp
    text = INI
    for section, key, value in edits:
        text = _with_key(section, key, value, text)
    tsim = Simulation.from_case(tconfig.load_case(tconfig.Ini(text=text)),
                                dtype=F64, device="cpu")
    jsim = JSimulation.from_case(load_case(Ini(text=text)))
    tc, jc = tsim.comp, jsim.comp
    assert dataclasses.asdict(tc["nscbc"]) == dataclasses.asdict(jc["nscbc"])
    assert (tc["aw"] is None) == (jc["aw"] is None)
    assert tc["gamma"] == jc["gamma"]
    if tc["aw"] is not None:
        assert dataclasses.asdict(tc["aw"]) == dataclasses.asdict(jc["aw"])
        return
    assert (tc["nscbc"].ymin, tc["nscbc"].ymax) == ("outflow", "wall")
    Uj = compressible_initial_state(jsim, seed=3)
    Ut = tcomp.CompState(*(torch.from_numpy(np.array(a)) for a in Uj))
    kw = dict(nscbc=None, energy="internal")
    Uj = jcomp.rk_step_compressible(
        jsim.P, Uj, 1e-4, jc["gamma"], jc["mach"], jsim.nsp.visc,
        jc["prandtl"], **dict(kw, nscbc=jc["nscbc"]))
    Ut = tcomp.rk_step_compressible(
        tsim.P, Ut, 1e-4, tc["gamma"], tc["mach"], tsim.nsp.visc,
        tc["prandtl"], **dict(kw, nscbc=tc["nscbc"]))
    for a, b in zip(Ut, Uj):
        assert _rel(a, b) <= 1e-10


@pytest.mark.parametrize("section, key, value, plan_key", [
    ("Main", "TermAdvection", "skewsymmetric", "adv_form"),
    ("Main", "EllipticOrder", "compactdirect6", "ell"),
    ("Main", "TermDivergence", "none", "remove_divergence"),
    ("Filter", "Type", "compact", None),
    ("Infrared", "Type", "grayliquid", "bodyforce"),
    ("Chemistry", "Type", "quadratic", "bodyforce"),
    # the boundary machinery; a value's further lines are keys of its
    # section (the coupling, the strips)
    ("BoundaryConditions", "Scalar1SfcTypeJmin",
     "linear\nScalar1CouplingJmin=0.5", "surface_bc"),
    ("BufferZone", "Type", "relaxation\nPointsJmax=8\nPointsJmin=6",
     "buffer"),
    ("IBMParameter", "Status", "on", "ibm"),
    # spatial mode keeps x periodic (its x operators), its strips are
    # tests/test_torch_spatial.py's
    ("Main", "Type", "spatial", "d12x"),
])
def test_from_case_runs_options_once_refused(section, key, value, plan_key):
    """The case options this file pinned as refused until they were ported:
    each loads, sets its plan key (the buffer's when the run attaches it to
    its start) and steps as tlab_tpu does (1e-10 of max|field|)."""
    text = _with_key(section, key, value)
    tsim = Simulation.from_case(tconfig.load_case(tconfig.Ini(text=text)),
                                dtype=F64, device="cpu")
    jsim = JSimulation.from_case(load_case(Ini(text=text)))
    sj = jinitial_state(jsim, seed=3)
    st = state_from_numpy(sj.u, sj.v, sj.w, sj.s, "cpu", F64)
    if plan_key == "buffer":
        jsim.attach_buffer(sj)
        tsim.attach_buffer(st)
    if plan_key is None:
        assert set(tsim.filter_matrices()) == set(jsim.filter_matrices())
    else:
        assert plan_key in tsim.P and plan_key in jsim.P
        assert ("ell_fac" in tsim.P) == ("ell_fac" in jsim.P)
    sj, _ = jdyn.rk_step(jsim.P, sj, 2e-3, unroll=True)
    st, _ = tdyn.rk_step(tsim.P, st, 2e-3)
    for a, b in zip(st[:4], sj[:4]):
        assert _rel(a, b) <= 1e-10


@pytest.mark.parametrize("key, value", [
    ("comm", {}),
])
def test_step_rejects_plans_off_the_path(key, value):
    """A mesh descriptor is on the path now (parallel/pencil.py), but only
    a rank's: a "comm" without its mesh is refused."""
    _, PT, (u, v, w, s) = _setup()
    PT[key] = value
    with pytest.raises(ValueError, match="pencil_plans"):
        tdyn.rk_step(PT, state_from_numpy(u, v, w, s, "cpu", F64), 1e-3)


def test_step_with_banded_x_plans_matches_jax():
    """The plan key this file once pinned as refused ("d1x_banded"): _setup's
    periodic uniform x with the substructured d1 and d2 of both packages
    (ops/thomas.py, tlab_tpu's ops/pallas_thomas.py) steps as tlab_tpu's,
    and the banded pair stands in for the dense [D1;D2] of the x Burgers
    term."""
    from tlab_tpu.ops import pallas_thomas as jthomas
    from tlab_tpu_torch.ops import thomas
    PJ, PT, (u, v, w, s) = _setup()
    plan = build_fdm_plan(uniform_grid(32, 33, 16, 2.0 * np.pi, 1.0,
                                       np.pi)).x
    for key, (A, B) in (("d1x_banded", (plan.A1, plan.B1)),
                        ("d2x_banded", (plan.A2, plan.B2))):
        PJ[key] = jthomas.banded_plan(A, B, jnp.float64, periodic=True)
        PT[key] = thomas.device_plan(thomas.banded_plan(
            A, B, np.float64, periodic=True), F64, "cpu")
    sj, _ = jdyn.rk_step(PJ, jdyn.State(u=jnp.asarray(u), v=jnp.asarray(v),
                                        w=jnp.asarray(w), s=jnp.asarray(s)),
                         1e-3)
    st, _ = tdyn.rk_step(PT, state_from_numpy(u, v, w, s, "cpu", F64), 1e-3)
    for a, b in zip(st[:4], sj[:4]):
        assert _rel(a, b) <= 1e-10
    Q = torch.from_numpy(np.stack([u, v, w]))
    d1, d2 = tdyn._d12_apply(PT, "x", 0, Q)
    dense1, dense2 = tdyn.der12(PT["d12x"], Q, 1)
    assert _rel(d1, dense1) <= 1e-10 and _rel(d2, dense2) <= 1e-10


def _boundary_entries(key, PJ):
    """Both packages' plan entry `key` of the boundary machinery on
    _setup's 32x33x16 grid: an immersed box on the bottom wall with its
    fills, Jmin/Jmax relaxation strips toward profiles, an interactive
    surface on both walls."""
    from tlab_tpu import ibm as jibm
    from tlab_tpu.dycore import buffer as jbuf
    from tlab_tpu_torch import ibm as tibm
    from tlab_tpu_torch.dycore import buffer as tbuf
    jg = uniform_grid(32, 33, 16, 2.0 * np.pi, 1.0, np.pi)
    tg = tgrid.uniform_grid(32, 33, 16, 2.0 * np.pi, 1.0, np.pi)
    if key == "ibm":
        eps = jibm.geometry_box(jg, 8, 16, 0, 6, 2, 10)
        ej = jibm.build_ibm(eps, dtype=jnp.float64)
        ej["fills"] = jibm.build_ibm_spline(eps, jg, dtype=jnp.float64)
        et = tibm.build_ibm(eps, dtype=F64, device="cpu")
        et["fills"] = tibm.build_ibm_spline(eps, tg, dtype=F64,
                                            device="cpu")
        return ej, et
    if key == "buffer":
        y = jg.y.nodes
        refs = {"u": np.tanh(y - 0.5), "w": 0.1 * y, "s0": np.cos(y)}
        spec = dict(type="relaxation", points_jmin=6, points_jmax=8,
                    strength=3.0, sigma=2.0)
        return (jbuf.build_buffer(y, jbuf.BufferSpec(**spec), refs),
                tbuf.build_buffer(y, tbuf.BufferSpec(**spec), refs, F64,
                                  device="cpu"))
    entry_ = {"cpl_jmin": (0.5,), "cpl_jmax": (0.25,)}
    return entry_, dict(entry_)


@pytest.mark.parametrize("key", ["bodyforce", "ibm", "buffer",
                                 "surface_bc"])
def test_step_runs_plan_keys_once_refused(key):
    """The plan keys the step refused until they were ported, against
    tlab_tpu's step with the same plan entries: `bodyforce` and `adv_form`
    (a constant force on v through the hook, and the divergence form), and
    the boundary machinery's `ibm`, `buffer` and `surface_bc` (one RK4
    step from the same state, the surface state created by the step)."""
    PJ, PT, (u, v, w, s) = _setup()
    if key != "bodyforce":
        PJ[key], PT[key] = _boundary_entries(key, PJ)
        sj, _ = jdyn.rk_step(PJ, jdyn.State(
            u=jnp.asarray(u), v=jnp.asarray(v), w=jnp.asarray(w),
            s=jnp.asarray(s)), 1e-3, unroll=True)
        st, _ = tdyn.rk_step(PT, state_from_numpy(u, v, w, s, "cpu", F64),
                             1e-3)
        for a, b in zip(st[:4], sj[:4]):
            assert _rel(a, b) <= 1e-12
        assert (st.sfc is None) == (key != "surface_bc")
        if st.sfc is not None:
            # a sum of flux anomalies (differences of near-equal fluxes)
            assert _rel(st.sfc, sj.sfc) <= 1e-10
        return

    def force_j(P, state, h1, h2, h3, hs, aux=None):
        return h1, h2 + 0.25, h3, hs

    def force_t(P, state, h1, h2, h3, hs, aux=None):
        h2 += 0.25
        return h1, h2, h3, hs

    PJ.update(bodyforce=force_j, adv_form="divergence")
    PT.update(bodyforce=force_t, adv_form="divergence")
    assert plans_from_jax(PJ, "cpu", F64, bodyforce=force_t)["bodyforce"] \
        is force_t
    with pytest.raises(ValueError, match="bodyforce"):
        plans_from_jax(PJ, "cpu", F64)
    sj, _ = jdyn.rk_step(PJ, jdyn.State(u=jnp.asarray(u), v=jnp.asarray(v),
                                        w=jnp.asarray(w), s=jnp.asarray(s)),
                         1e-3, unroll=True)
    st, _ = tdyn.rk_step(PT, state_from_numpy(u, v, w, s, "cpu", F64), 1e-3)
    for a, b in zip(st[:4], sj[:4]):
        assert _rel(a, b) <= 1e-12


def test_step_takes_a_functional_bodyforce():
    """A hook that returns new tensors, as tlab_tpu's do, instead of adding
    into the rows it is given: the step copies them into its tendency.  One
    step against tlab_tpu's with the same hook, to 1e-12."""
    PJ, PT, (u, v, w, s) = _setup()

    def force(P, state, h1, h2, h3, hs, aux=None):
        return h1 - 0.5 * state.w, h2 + 0.25, h3, hs + 0.125 * state.s

    PJ["bodyforce"] = PT["bodyforce"] = force
    sj, _ = jdyn.rk_step(PJ, jdyn.State(u=jnp.asarray(u), v=jnp.asarray(v),
                                        w=jnp.asarray(w), s=jnp.asarray(s)),
                         1e-3, unroll=True)
    st, _ = tdyn.rk_step(PT, state_from_numpy(u, v, w, s, "cpu", F64), 1e-3)
    free, _ = tdyn.rk_step({**PT, "bodyforce": None},
                           state_from_numpy(u, v, w, s, "cpu", F64), 1e-3)
    for a, b in zip(st[:4], sj[:4]):
        assert _rel(a, b) <= 1e-12
    # the force is felt: u (from w) and the scalar move
    assert min(_rel(free[0], sj[0]), _rel(free[3], sj[3])) > 1e-6


def _taylor_green(grid, reynolds=100.0):
    """The port's plan and the 2-D Taylor-Green state u = sin x cos y,
    v = -cos x sin y (an exact solution with free-slip walls at y = 0, pi),
    as tests/test_dycore.py builds them for tlab_tpu."""
    fdm = tbuild_fdm_plan(grid)
    nsp = TNSParams(reynolds=reynolds, schmidt=())
    P = tdyn.build_device_plans(
        fdm, nsp, tdyn.WallBCs.from_velocity_kind("freeslip", "freeslip",
                                                  scalar_bcs=()),
        dtype=F64, device="cpu")
    X = grid.x.nodes[:, None, None]
    Y = grid.y.nodes[None, :, None]
    u = np.sin(X) * np.cos(Y) * np.ones(grid.shape)
    v = -np.cos(X) * np.sin(Y) * np.ones(grid.shape)
    state = state_from_numpy(u, v, np.zeros(grid.shape),
                             np.zeros((0,) + grid.shape), "cpu", F64)
    return nsp, P, state, X, Y


@pytest.mark.parametrize("stretched", [False, True])
def test_taylor_green_decay(stretched):
    """50 RK4 steps of the full port loop against the exact decay (limits
    of tests/test_dycore.py; the stretched y grid exercises the Jacobian-
    corrected D2 and a nonuniform factorized Poisson plan)."""
    Grid, make_axis = tgrid.Grid, tgrid.make_axis
    if stretched:
        s = np.linspace(0.0, 1.0, 65)
        grid = Grid(make_axis(np.arange(48) * (2.0 * np.pi / 48), True),
                    make_axis(np.pi * (s + 0.10 * np.sin(np.pi * s)), False),
                    make_axis(np.zeros(1), False))
    else:
        grid = tgrid.uniform_grid(64, 65, 1, 2.0 * np.pi, np.pi, 1.0)
    nsp, P, state, X, Y = _taylor_green(grid)
    dt = 2e-3
    state, _ = tdyn.rk_loop_stacked(P, state, dt, 50)
    u_exact = np.sin(X) * np.cos(Y) * np.exp(-nsp.visc * 2.0 * dt * 50)
    err = np.max(np.abs(state.u.numpy() - u_exact))
    assert err < (5e-4 if stretched else 2e-5), err


def test_divergence_stays_small():
    grid = tgrid.uniform_grid(64, 65, 1, 2.0 * np.pi, np.pi, 1.0)
    _, P, state, _, _ = _taylor_green(grid)
    for _ in range(10):
        state, _ = tdyn.rk_step(P, state, 2e-3)
    dmin, dmax = tdyn.dilatation_minmax(P, state)
    assert max(abs(float(dmin)), abs(float(dmax))) < 1e-4


def test_wall_value_enforcement():
    """Noise on no-slip wall rows is cleaned at the first step and the
    rows stay at the wall reference (tests/test_dycore.py:126)."""
    grid = tgrid.uniform_grid(16, 33, 8, 2 * np.pi, 1.0, np.pi)
    P = tdyn.build_device_plans(tbuild_fdm_plan(grid),
                                TNSParams(reynolds=100.0, schmidt=()),
                                tdyn.WallBCs(s=()), dtype=F64, device="cpu")
    rng = np.random.default_rng(0)
    u, v, w = (0.01 * rng.standard_normal(grid.shape) for _ in range(3))
    st = state_from_numpy(u, v, w, np.zeros((0,) + grid.shape), "cpu", F64)
    assert float(st.v[:, 0, :].abs().max()) > 1e-4
    st1, _ = tdyn.rk_step(P, st, 1e-4)
    for a in (st1.u, st1.v, st1.w):
        assert float(a[:, (0, -1), :].abs().max()) < 1e-15


def test_scalar_limits_clip_as_jax():
    """[Control] ScalLimit (the default): the scalars are clipped to
    [MinScalar, MaxScalar] after every substep, as tlab_tpu's step does
    with P["scal_bounds"]."""
    PJ, PT, (u, v, w, s) = _setup()
    s = s + 0.2 * np.random.default_rng(6).standard_normal(s.shape)
    PJ["scal_bounds"] = ((0.1,), (0.9,))
    PT["scal_bounds"] = tdyn.scalar_bounds((0.1,), (0.9,), F64, "cpu")
    assert _same(plans_from_jax(PJ, "cpu", F64)["scal_bounds"],
                 PT["scal_bounds"])
    sj, _ = jdyn.rk_loop_stacked(PJ, jdyn.State(
        u=jnp.asarray(u), v=jnp.asarray(v), w=jnp.asarray(w),
        s=jnp.asarray(s)), 1e-3, 2)
    st, _ = tdyn.rk_loop_stacked(PT, state_from_numpy(u, v, w, s, "cpu",
                                                      F64), 1e-3, 2)
    assert float(st.s.min()) == 0.1 and float(st.s.max()) == 0.9
    for a, b in zip(st[:4], sj[:4]):
        assert _rel(a, b) <= 1e-12


def test_visc_scale_scales_every_diffusivity():
    """aux={"visc_scale": f} equals a plan with visc and diff times f, and
    matches tlab_tpu's aux."""
    PJ, PT, (u, v, w, s) = _setup()
    st = state_from_numpy(u, v, w, s, "cpu", F64)
    got, _ = tdyn.rk_step(PT, st, 1e-3, aux={"visc_scale": 1.5})
    P2 = dict(PT, visc=PT["visc"] * 1.5,
              diff=tuple(d * 1.5 for d in PT["diff"]))
    want, _ = tdyn.rk_step(P2, st, 1e-3)
    sj, _ = jdyn.rk_step(PJ, jdyn.State(
        u=jnp.asarray(u), v=jnp.asarray(v), w=jnp.asarray(w),
        s=jnp.asarray(s)), 1e-3, aux={"visc_scale": jnp.asarray(1.5)})
    for a, b, c in zip(got[:4], want[:4], sj[:4]):
        assert _rel(a, b) <= 1e-14 and _rel(a, c) <= 1e-12
    # an inflow's planes without a buffer change nothing (as tlab_tpu's);
    # the factorize tables are the plan's
    same, _ = tdyn.rk_step(PT, st, 1e-3, aux={"visc_scale": 1.5,
                                              "refs_x": {}})
    for a, b in zip(same[:4], got[:4]):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="Do not port"):
        tdyn.rk_step(PT, st, 1e-3, aux={"fac_tables": None})


def test_two_dimensional_plan_has_no_z_operator():
    """nz == 1: no z operator in the plan, so no z Burgers term (and on the
    card no K3 launch); x and y keep their [D1; D2] operators."""
    grid = tgrid.uniform_grid(16, 12, 1, 2.0, 1.0, 1.0)
    P = tdyn.build_device_plans(
        tbuild_fdm_plan(grid), TNSParams(reynolds=100.0, schmidt=(1.0,)),
        tdyn.WallBCs.from_velocity_kind("freeslip", "freeslip"),
        dtype=F64, device="cpu")
    assert "d12z" not in P and "d1z" not in P and "iodz" not in P
    assert "d12x" in P and "d12y" in P
    Q = torch.ones(4, 16, 12, 1, dtype=F64)
    assert not tdyn._burgers_all(P, "z", 2, Q, Q[0], None).any()
