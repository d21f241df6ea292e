"""The incompressible options beyond the main path against tlab_tpu, float64
on the CPU: the skew-symmetric and divergence advection forms, dealiasing,
TermDivergence=none, the direct eigen Poisson solver, the staggered
pressure (factorized and eigen), and the pressure filter (compact and
Helmholtz).

Each option is switched on in the golden slice's case file (32x33x16, RK3),
loaded by both packages' Simulation.from_case, and stepped from the same
noisy state: one rk_step and a 5-step run agree to 1e-10 of max|field|
(measured ~2e-13).  Then the properties of tests/test_advection_forms.py
and tests/test_stagger.py on the port, with those files' limits."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from test_golden import INI
from tlab_tpu.config import Ini as JIni, load_case as jload_case
from tlab_tpu.dycore import incompressible as jdyn
from tlab_tpu.runtime import Simulation as JSimulation
from tlab_tpu.tools.initialize import initial_state as jinitial_state
from tlab_tpu_torch import grid as tgrid
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.convert import (plans_from_jax, state_from_numpy,
                                    state_to_numpy)
from tlab_tpu_torch.dycore import incompressible as tdyn
from tlab_tpu_torch.fdm.plan import build_fdm_plan
from tlab_tpu_torch.physics.params import NSParams
from tlab_tpu_torch.runtime import Simulation

F64 = torch.float64
TOL = 1e-10

torch.set_num_threads(2)

STAG = ("Staggering", "StaggerHorizontalPressure", "yes")
DIRECT = ("Main", "EllipticOrder", "compactdirect6")
OPTIONS = {
    "skewsymmetric": [("Main", "TermAdvection", "skewsymmetric")],
    "divergence": [("Main", "TermAdvection", "divergence")],
    "dealiasing": [("Dealiasing", "Type", "compact")],
    "dealiasing_x_only": [("Dealiasing", "Type", "explicit6"),
                          ("Dealiasing", "ActiveY", "no"),
                          ("Dealiasing", "ActiveZ", "no")],
    "no_divergence_removal": [("Main", "TermDivergence", "none")],
    "direct_eigen": [DIRECT],
    "staggered_factorized": [STAG],
    "staggered_eigen": [STAG, DIRECT],
    "pfilter_compact": [("PressureFilter", "Type", "compact")],
    "pfilter_helmholtz": [("PressureFilter", "Type", "helmholtz"),
                          ("PressureFilter", "Parameters", "1.5")],
    "staggered_skew_filtered": [STAG, ("PressureFilter", "Type", "compact"),
                                ("Main", "TermAdvection", "skewsymmetric")],
}
# the plan keys each option must set, in both packages
PLAN_KEYS = {
    "skewsymmetric": ("adv_form",), "divergence": ("adv_form",),
    "dealiasing": ("dealias",), "dealiasing_x_only": ("dealias",),
    "no_divergence_removal": ("remove_divergence",),
    "direct_eigen": (), "staggered_factorized": ("stag", "ell_fac"),
    "staggered_eigen": ("stag", "ell_stag"),
    "pfilter_compact": ("pfilter",), "pfilter_helmholtz": ("pfilter",),
    "staggered_skew_filtered": ("stag", "pfilter", "adv_form"),
}


def case_text(edits, base=INI):
    text = base
    for section, key, value in edits:
        if f"[{section}]\n" in text:
            text = text.replace(f"[{section}]\n",
                                f"[{section}]\n{key}={value}\n", 1)
        else:
            text += f"[{section}]\n{key}={value}\n"
    return text


@pytest.fixture(scope="module")
def start():
    """tlab_tpu's initial state of the golden case plus wall-clean noise,
    so that every term of the step is exercised."""
    st = jinitial_state(JSimulation.from_case(jload_case(JIni(text=INI))),
                        seed=5)
    rng = np.random.default_rng(1)
    env = np.sin(np.pi * np.linspace(0.0, 1.0, 33))[None, :, None]
    u, v, w = (np.asarray(a) + 0.05 * env * rng.standard_normal(a.shape)
               for a in (st.u, st.v, st.w))
    return u, v, w, np.asarray(st.s)


def both(edits):
    text = case_text(edits)
    return JSimulation.from_case(jload_case(JIni(text=text))), \
        Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                             device="cpu")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _jstate(u, v, w, s):
    return jdyn.State(u=jnp.asarray(u), v=jnp.asarray(v), w=jnp.asarray(w),
                      s=jnp.asarray(s))


def assert_steps_match(jsim, tsim, start, n_steps=5, dt=2e-3):
    sj, st = _jstate(*start), state_from_numpy(*start, "cpu", F64)
    for i in range(n_steps):
        sj, pj = jdyn.rk_step(jsim.P, sj, dt, unroll=True)
        st, pt = tdyn.rk_step(tsim.P, st, dt)
        if i in (0, n_steps - 1):
            for a, b in zip(state_to_numpy(st), state_to_numpy(sj)):
                assert _rel(a, b) <= TOL, i
            assert _rel(pt, pj) <= TOL, i
    return sj, st


def _close(a, b, where):
    """Plan leaves: tensors to 1e-12 of their max, the rest equal."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _close(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        scale = max(float(b.abs().max()), 1e-300)
        assert float((a - b).abs().max()) <= 1e-12 * scale, where
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{where}[{i}]")
    else:
        assert a == b or (callable(a) and callable(b)), where


@pytest.mark.parametrize("name", list(OPTIONS))
def test_option_matches_jax(name, start):
    jsim, tsim = both(OPTIONS[name])
    for key in PLAN_KEYS[name]:
        assert jsim.P.get(key) is not None and tsim.P.get(key) is not None
    assert ("ell_fac" in tsim.P) == ("ell_fac" in jsim.P)
    assert_steps_match(jsim, tsim, start)


@pytest.mark.parametrize("name", ["staggered_eigen", "pfilter_helmholtz",
                                  "dealiasing_x_only",
                                  "staggered_skew_filtered"])
def test_plans_from_jax_carries_the_option(name, start):
    """convert.plans_from_jax of tlab_tpu's plan equals the port's own, and
    steps to the same state."""
    jsim, tsim = both(OPTIONS[name])
    PT = plans_from_jax(jsim.P, "cpu", F64)
    # ell_fac: complex eigen data of another eig call; ell_dd: tlab_tpu
    # builds it with the plan, the port at first use (Simulation.ell)
    skip = {"ell_fac", "ell_dd"}
    assert "ell_dd" in PT and "ell_dd" not in tsim.P
    _close({k: v for k, v in PT.items() if k not in skip},
           {k: v for k, v in tsim.P.items() if k not in skip}, "P")
    st = state_from_numpy(*start, "cpu", F64)
    a, _ = tdyn.rk_step(PT, st, 2e-3)
    b, _ = tdyn.rk_step(tsim.P, st, 2e-3)
    for x, y in zip(a[:4], b[:4]):
        assert _rel(x, y) <= 1e-12


def test_from_case_builds_the_elliptic_plans(start):
    """Simulation.ell: the Neumann plan is the step's, the Dirichlet one is
    built at first use; poisson_ref takes the direct branch where the case
    asks for the direct solver."""
    from tlab_tpu.constants import BC as JBC
    from tlab_tpu_torch.constants import BC
    jsim, tsim = both(OPTIONS["direct_eigen"])
    assert "ell_fac" not in tsim.P and tsim.ell(BC.NN) is tsim.P["ell"]
    assert list(tsim.ell_plans) == [BC.NN]
    f = np.random.default_rng(2).standard_normal(tsim.grid.shape)
    for bc, jbc in ((BC.NN, JBC.NN), (BC.DD, JBC.DD)):
        got = tsim.poisson_ref(bc, torch.from_numpy(f))
        want = jsim.poisson_ref(jbc, jnp.asarray(f))
        assert _rel(got, want) <= 1e-11
    assert sorted(tsim.ell_plans, key=lambda b: b.name) == [BC.DD, BC.NN]
    ut, vt, wt = tsim.solenoidal(*(torch.from_numpy(a) for a in start[:3]))
    uj, vj, wj = jsim.solenoidal(*(jnp.asarray(a) for a in start[:3]))
    assert max(_rel(ut, uj), _rel(vt, vj), _rel(wt, wj)) <= 1e-11


def test_dilatation_of_a_staggered_run_is_on_the_pressure_nodes(start):
    jsim, tsim = both(OPTIONS["staggered_factorized"])
    sj, st = assert_steps_match(jsim, tsim, start, n_steps=1)
    for a, b in zip(tdyn.dilatation_minmax(tsim.P, st),
                    jdyn.dilatation_minmax(jsim.P, sj)):
        assert abs(float(a) - float(b)) <= 1e-10 * abs(float(b))
    d = tdyn.divergence_staggered(tsim.P, st.u, st.v, st.w)
    assert float(d.max()) == float(tdyn.dilatation_minmax(tsim.P, st)[1])
    assert float(d.max()) != float(tdyn.divergence(tsim.P, st.u, st.v,
                                                   st.w).max())


# ---------------------------------------------------------------------------
# tests/test_advection_forms.py on the port
# ---------------------------------------------------------------------------

def make_P(form, nx=48, ny=48, nz=1):
    grid = tgrid.uniform_grid(nx, ny, nz, 2.0 * np.pi, 1.0, 1.0)
    P = tdyn.build_device_plans(
        build_fdm_plan(grid), NSParams(reynolds=1e10, schmidt=(1.0,)),
        tdyn.WallBCs.from_velocity_kind("freeslip", "freeslip",
                                        scalar_bcs=(("neumann", "neumann"),)),
        dtype=F64, device="cpu")
    if form != "convective":
        P["adv_form"] = form
    return P, grid


def test_skewsymmetric_advection_is_energy_neutral_periodic():
    """Along the periodic x direction the compact D1 is exactly
    antisymmetric, so sum_f f * adv_skew(f) = 0 to round-off."""
    P, grid = make_P("skewsymmetric")
    rng = np.random.default_rng(0)
    f = torch.from_numpy(rng.standard_normal((2,) + grid.shape))
    c = torch.from_numpy(rng.standard_normal(grid.shape))
    nu = torch.zeros((2, 1, 1, 1), dtype=F64)
    adv = tdyn._burgers_all(P, "x", 0, f, c, nu)      # pure advection
    scale = float((f * adv).abs().sum())
    assert abs(float((f * adv).sum())) < 1e-12 * scale
    adv_c = tdyn._burgers_all(make_P("convective")[0], "x", 0, f, c, nu)
    assert abs(float((f * adv_c).sum())) > 1e-6 * scale


def test_divergence_form_product_rule():
    """div-form = conv-form + f * d1(c) to the scheme's order (6th)."""
    errs = []
    for nx in (48, 96):
        P, grid = make_P("divergence", nx=nx)
        Pc, _ = make_P("convective", nx=nx)
        x = grid.x.nodes[:, None, None] * np.ones(grid.shape)
        f = torch.from_numpy(np.sin(2 * x))[None]
        c = torch.from_numpy(np.cos(3 * x))
        nu = torch.zeros((1, 1, 1, 1), dtype=F64)
        adv_d = tdyn._burgers_all(P, "x", 0, f, c, nu)
        adv_c = tdyn._burgers_all(Pc, "x", 0, f, c, nu)
        dc = tdyn._d1(Pc, "x", 0, c)
        errs.append(float((adv_d - (adv_c - f * dc[None])).abs().max()))
    assert errs[0] < 2e-4
    assert errs[0] / max(errs[1], 1e-16) > 2 ** 5, errs


def test_unknown_advection_form_raises(start):
    _, tsim = both(())
    P = dict(tsim.P, adv_form="upwind")
    with pytest.raises(ValueError, match="advection form"):
        tdyn.rk_step(P, state_from_numpy(*start, "cpu", F64), 1e-3)


def test_inviscid_ke_conservation_skewsymmetric():
    """Freeslip inviscid box: skewsymmetric advection conserves total KE
    at least as well as the convective form over 20 RK4 steps."""
    nx, ny, nz = 48, 48, 1
    ke_drift = {}
    for form in ("convective", "skewsymmetric"):
        P, grid = make_P(form, nx, ny, nz)
        x = grid.x.nodes[:, None, None] * np.ones((nx, ny, nz))
        y = grid.y.nodes[None, :, None] * np.ones((nx, ny, nz))
        psi = (np.sin(2.0 * x) + 0.5 * np.cos(3.0 * x)) \
            * np.sin(np.pi * y) ** 2
        u = np.gradient(psi, grid.y.nodes, axis=1)
        v = -(2.0 * np.cos(2.0 * x) - 1.5 * np.sin(3.0 * x)) \
            * np.sin(np.pi * y) ** 2
        st = state_from_numpy(u, v, np.zeros_like(u),
                              np.zeros((1, nx, ny, nz)), "cpu", F64)
        ke0 = float((st.u ** 2 + st.v ** 2).sum())
        st, _ = tdyn.rk_loop_stacked(P, st, 2e-3, 20)
        ke_drift[form] = abs(float((st.u ** 2 + st.v ** 2).sum()) / ke0 - 1.0)
    assert ke_drift["skewsymmetric"] < 1e-3, ke_drift
    assert ke_drift["skewsymmetric"] < ke_drift["convective"] * 1.05


# ---------------------------------------------------------------------------
# tests/test_stagger.py on the port
# ---------------------------------------------------------------------------

def test_staggered_projection_divergence():
    """After one substep the STAGGERED divergence of the forcing update is
    at solver accuracy (the staggered projection annihilates it)."""
    from test_stagger import CASE
    sim = Simulation.from_case(load_case(Ini(text=CASE)), dtype=F64,
                               device="cpu")
    P = sim.P
    assert "stag" in P and "ell_fac" in P and "ell_stag" not in P
    nx, ny, nz = sim.grid.shape
    y = sim.grid.y.nodes
    x = sim.grid.x.nodes[:, None, None]
    zc = sim.grid.z.nodes[None, None, :]
    kx = 2 * np.pi / sim.grid.x.scale
    kz = 2 * np.pi / sim.grid.z.scale
    env = np.sin(np.pi * y / y[-1])[None, :, None]
    u = (np.sin(kx * x) + 0.3 * np.cos(2 * kx * x + kz * zc)) * env
    v = 0.2 * np.sin(2 * np.pi * y / y[-1])[None, :, None] \
        * np.cos(kx * x) * np.ones_like(zc)
    w = 0.4 * np.sin(kz * zc) * np.cos(kx * x) * env
    Q = torch.from_numpy(np.stack([u * np.ones_like(zc), v,
                                   w * np.ones((nx, 1, 1)),
                                   np.zeros((nx, ny, nz))]))
    div0 = tdyn.divergence_staggered(P, Q[0], Q[1], Q[2])
    dte = 0.01
    H, p = tdyn.substep_rhs_stacked(P, Q, torch.zeros_like(Q), dte)
    new = Q + dte * H
    div = tdyn.divergence_staggered(P, new[0], new[1], new[2])
    red = float(div[:, 1:-1, :].abs().max() / div0[:, 1:-1, :].abs().max())
    assert red < 2e-3, red
    assert bool(torch.isfinite(p).all())
