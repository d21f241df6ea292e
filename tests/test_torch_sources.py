"""The Boussinesq body forces of the port (physics/gravity.py, rotation.py,
forcing.py, runtime.make_sources) against tlab_tpu's, float64 on the CPU, on
the same inputs made from a seed with NumPy: every buoyancy type, both
Coriolis types, the homogeneous forcing and the subsidence.  The functions
and the hook's tendency agree to 1e-12 of the result's max, one RK step to
1e-11 of max|field|.  Then the internal-wave frequency of
tests/test_stratified.py on the port."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from test_golden import INI
from test_stratified import INI_TEXT as WAVE_INI
from test_torch_options import case_text
from tlab_tpu.config import Ini as JIni, load_case as jload_case
from tlab_tpu.dycore import incompressible as jdyn
from tlab_tpu.physics import forcing as jforc
from tlab_tpu.physics import gravity as jgrav
from tlab_tpu.physics import rotation as jrot
from tlab_tpu.runtime import Simulation as JSimulation
from tlab_tpu.runtime import make_sources as jmake_sources
from tlab_tpu.tools.initialize import initial_state as jinitial_state
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.convert import state_from_numpy, state_to_numpy
from tlab_tpu_torch.dycore import incompressible as tdyn
from tlab_tpu_torch.dycore.state import State
from tlab_tpu_torch.physics import forcing as tforc
from tlab_tpu_torch.physics import gravity as tgrav
from tlab_tpu_torch.physics import rotation as trot
from tlab_tpu_torch.runtime import Simulation, make_sources

F64 = torch.float64
TOL = 1e-12

torch.set_num_threads(2)

BUOYANCY = [("homogeneous", (0.7,)), ("linear", (1.5, -0.5, 0.25)),
            ("linear", (2.0,)), ("bilinear", (1.0, 0.5, -0.3)),
            ("quadratic", (1.2, 0.6)), ("normalizedmean", (0.9,)),
            ("subtractmean", (1.1,)), ("none", (0.0,))]


def _rel(a, b):
    """max|a - b| / max|b| over the finite entries; the others (the
    normalizedmean type divides by a zero reference in both packages) must
    be non-finite in both."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ok = np.isfinite(b)
    assert np.array_equal(ok, np.isfinite(a))
    if not ok.any():
        return 0.0
    scale = np.max(np.abs(b[ok]))
    err = np.max(np.abs(a[ok] - b[ok]))
    return err / scale if scale > 0 else err


def _fields(ns=2, shape=(8, 12, 6), seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((ns,) + shape), \
        1.0 + rng.random(shape[1])             # reference profile, > 0


@pytest.mark.parametrize("btype, params", BUOYANCY)
def test_buoyancy_field_matches_jax(btype, params):
    s, ref = _fields()
    kw = dict(type=btype, vector=(0.0, -0.5, 0.0), parameters=params)
    got = tgrav.buoyancy_field(tgrav.BuoyancyProps(**kw),
                               torch.from_numpy(s), torch.from_numpy(ref))
    want = jgrav.buoyancy_field(jgrav.BuoyancyProps(**kw), jnp.asarray(s),
                                jnp.asarray(ref))
    assert got.dtype == F64 and tuple(got.shape) == want.shape
    assert _rel(got, want) <= TOL
    # the same function on NumPy arrays, as background_profile calls it
    assert _rel(tgrav.buoyancy_field(tgrav.BuoyancyProps(**kw), s, ref),
                want) <= TOL


@pytest.mark.parametrize("btype, params", BUOYANCY)
def test_background_profile_matches_jax(btype, params):
    y = np.linspace(0.0, 2.0, 17)
    profs = [lambda yy: 0.5 * np.tanh(yy - 1.0), lambda yy: 0.1 * yy]
    for vector in ((0.0, -0.5, 0.0), (1.0, 0.0, 0.0)):
        kw = dict(type=btype, vector=vector, parameters=params)
        got = tgrav.background_profile(tgrav.BuoyancyProps(**kw), profs, y)
        want = np.asarray(jgrav.background_profile(
            jgrav.BuoyancyProps(**kw), profs, y))
        assert isinstance(got, np.ndarray) and got.dtype == np.float64
        assert got.shape == want.shape == (17,)
        assert _rel(got, want) <= TOL


@pytest.mark.parametrize("btype, params", [("quadratic", (1.2, 0.6)),
                                           ("linear", (1.0,))])
def test_buoyancy_source_matches_jax(btype, params):
    g = np.random.default_rng(1).random((8, 12, 6))
    kw = dict(type=btype, parameters=params)
    got = tgrav.buoyancy_source(tgrav.BuoyancyProps(**kw),
                                torch.from_numpy(g))
    want = jgrav.buoyancy_source(jgrav.BuoyancyProps(**kw), jnp.asarray(g))
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("ctype", ["explicit", "normalized", "none"])
def test_coriolis_tendency_matches_jax(ctype):
    (u, v, w), _ = _fields(3)
    kw = dict(type=ctype, vector=(0.3, 1.0, -0.4), parameters=(0.2, 1.5))
    got = trot.coriolis_tendency(trot.CoriolisProps(**kw),
                                 *(torch.from_numpy(a) for a in (u, v, w)))
    want = jrot.coriolis_tendency(jrot.CoriolisProps(**kw),
                                  *(jnp.asarray(a) for a in (u, v, w)))
    for a, b in zip(got, want):
        if isinstance(b, float):
            assert a == b == 0.0         # a component the type leaves alone
        else:
            assert _rel(a, b) <= TOL


# ---------------------------------------------------------------------------
# make_sources and the step's bodyforce hook
# ---------------------------------------------------------------------------

def _gravity(btype, params, vector="0,-1,0"):
    return [("Main", "TermBodyForce", btype), ("Gravity", "Vector", vector),
            ("Gravity", "Parameters", ",".join(str(p) for p in params)),
            ("Parameters", "Froude", "2.0")]


ROTATION = {"explicit": [("Rotation", "Type", "explicit"),
                         ("Rotation", "Vector", "0.2,1.0,0.5"),
                         ("Parameters", "Rossby", "3.0")],
            "normalized": [("Rotation", "Type", "normalized"),
                           ("Rotation", "Vector", "0,1,0"),
                           ("Rotation", "Parameters", "0.3,1.2"),
                           ("Parameters", "Rossby", "1.5")]}
SOURCES = {
    **{f"buoyancy_{t}_{i}": _gravity(t, p)
       for i, (t, p) in enumerate(BUOYANCY[:-1])
       if t != "bilinear"},           # bilinear needs two scalars: below
    "buoyancy_along_x_and_z": _gravity("linear", (1.0,), "0.5,0,-0.25"),
    "coriolis_explicit": ROTATION["explicit"],
    "coriolis_normalized": ROTATION["normalized"],
    "homogeneous": [("SpecialForcing", "Type", "homogeneous"),
                    ("SpecialForcing", "Parameters", "0.3"),
                    ("SpecialForcing", "Vector", "1,0,1")],
    "subsidence": [("Subsidence", "Type", "ConstantDivergenceLocal"),
                   ("Subsidence", "Parameters", "0.4")],
    "stratified_rotating": _gravity("linear", (1.0,))
    + ROTATION["explicit"] + [("Main", "TermSubsidence",
                               "ConstantDivergenceLocal"),
                              ("Subsidence", "Parameters", "0.1")],
}
TWO_SCALARS = [("Parameters", "Schmidt", "1.0,0.7"),
               ("Scalar", "ProfileScalar2", "Tanh"),
               ("Scalar", "ThickScalar2", "0.2"),
               ("Scalar", "DeltaScalar2", "0.5"),
               ("BoundaryConditions", "Scalar2Jmin", "neumann"),
               ("BoundaryConditions", "Scalar2Jmax", "neumann")]
SOURCES["buoyancy_bilinear"] = _gravity("bilinear", (1.0, 0.5, -0.3)) \
    + TWO_SCALARS


def _replace_keys(edits):
    """case_text prepends keys; [Parameters] Schmidt must replace the
    golden case's own."""
    base = INI
    for section, key, value in edits:
        if f"\n{key}=" in base and key == "Schmidt":
            base = base.replace("Schmidt=1.0", f"Schmidt={value}")
            edits = [e for e in edits if e[1] != "Schmidt"]
    return case_text(edits, base)


def _both(name):
    text = _replace_keys(SOURCES[name])
    return JSimulation.from_case(jload_case(JIni(text=text))), \
        Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                             device="cpu")


def _state(jsim, seed=3):
    st = jinitial_state(jsim, seed=seed)
    rng = np.random.default_rng(seed)
    env = np.sin(np.pi * np.linspace(0.0, 1.0, st.u.shape[1]))[None, :, None]
    u, v, w = (np.asarray(a) + 0.05 * env * rng.standard_normal(a.shape)
               for a in (st.u, st.v, st.w))
    return u, v, w, np.asarray(st.s)


@pytest.mark.parametrize("name", list(SOURCES))
def test_sources_match_jax(name):
    """The hook's tendency on zero tendencies, then one RK step."""
    jsim, tsim = _both(name)
    fj, ft = jsim.P["bodyforce"], tsim.P["bodyforce"]
    assert fj is not None and ft is not None
    u, v, w, s = _state(jsim)
    sj = jdyn.State(u=jnp.asarray(u), v=jnp.asarray(v), w=jnp.asarray(w),
                    s=jnp.asarray(s))
    st = state_from_numpy(u, v, w, s, "cpu", F64)
    zj = jnp.zeros_like(sj.u)
    want = fj(jsim.P, sj, zj, zj, zj, jnp.zeros_like(sj.s))
    H = torch.zeros((3 + s.shape[0],) + u.shape, dtype=F64)
    got = ft(tsim.P, st, H[0], H[1], H[2], H[3:])
    assert got[0].data_ptr() == H[0].data_ptr()      # added in place
    nonzero = 0
    for a, b in zip(got, want):
        assert _rel(a, b) <= TOL
        nonzero += not (np.asarray(b) == 0).all()
    assert nonzero >= 1
    for only in ("buoyancy_only", "coriolis_only"):
        assert hasattr(ft, only) == hasattr(fj, only)
        if hasattr(ft, only):
            for a, b in zip(getattr(ft, only)(st), getattr(fj, only)(sj)):
                assert _rel(a, b) <= TOL
    sj2, pj = jdyn.rk_step(jsim.P, sj, 2e-3, unroll=True)
    st2, pt = tdyn.rk_step(tsim.P, st, 2e-3)
    for a, b in zip(state_to_numpy(st2), state_to_numpy(sj2)):
        assert _rel(a, b) <= 1e-11
    assert _rel(pt, pj) <= 1e-10


def test_wall_rows_of_a_stratified_step_match_jax():
    """The port adds the sources into the stacked tendency in place and sets
    its wall rows in place; tlab_tpu restacks.  The wall rows of one
    substep's tendency (the Neumann rows of u, w and s, the nt row reading
    the updated j=0 row; buoyancy on the rows of v) agree to round-off:
    1e-12 of max|H|, which the q/dte forcing of the projection sets."""
    jsim, tsim = _both("stratified_rotating")
    u, v, w, s = _state(jsim, seed=4)
    Q = np.concatenate([u[None], v[None], w[None], s])
    H0 = 0.1 * np.random.default_rng(5).standard_normal(Q.shape)
    HJ, _ = jdyn.substep_rhs_stacked(jsim.P, jnp.asarray(Q),
                                     jnp.asarray(H0), 1e-3)
    HT, _ = tdyn.substep_rhs_stacked(tsim.P, torch.from_numpy(Q),
                                     torch.from_numpy(H0.copy()), 1e-3)
    HJ, HT = np.asarray(HJ), HT.numpy()
    scale = np.max(np.abs(HJ))
    for j in (0, -1):
        assert np.max(np.abs(HT[:, :, j, :] - HJ[:, :, j, :])) <= 1e-12 * scale
        assert np.max(np.abs(HJ[(0, 2, 3), :, j, :])) > 0    # Neumann rows
        assert np.max(np.abs(HT[1, :, j, :])) == 0.0         # v: Dirichlet
    assert np.max(np.abs(HT - HJ)) <= 1e-12 * scale


def test_no_source_gives_no_hook():
    case = load_case(Ini(text=INI))
    sim = Simulation.from_case(case, dtype=F64, device="cpu")
    assert make_sources(case, sim.grid, F64, "cpu") is None
    assert sim.P["bodyforce"] is None
    jcase = jload_case(JIni(text=INI))
    assert jmake_sources(jcase, JSimulation.from_case(jcase).grid,
                         jnp.float64) is None
    # a gravity type without a vector is no source either
    text = case_text([("Main", "TermBodyForce", "Linear")])
    case = load_case(Ini(text=text))
    assert make_sources(case, sim.grid, F64, "cpu") is None


@pytest.mark.parametrize("edits, what", [
    ([("Infrared", "Type", "grayliquid")], "Infrared"),
    ([("Radiation", "Type", "bulk1dlocal")], "Infrared"),
    ([("Sedimentation", "Type", "airwatersimplified")], "Sedimentation"),
    ([("Chemistry", "Type", "quadratic")], "Chemistry"),
    ([("SpecialForcing", "Type", "wavemaker")], "SpecialForcing"),
    ([("Thermodynamics", "Type", "anelastic")], "anelastic"),
    ([("Thermodynamics", "Mixture", "AirWaterLinear")], "airwaterlinear"),
    (_gravity("explicit", (1.0,)), "explicit"),
])
def test_make_sources_builds_what_tlab_tpu_builds(edits, what):
    """The options make_sources refused until they were ported: with no
    anelastic background each gives the hook tlab_tpu's make_sources gives
    (none for an inactive option: sedimentation without Settling, a
    wavemaker without waves, the explicit buoyancy without a background),
    with the same tendency (1e-12 of each row's max)."""
    text = case_text(edits)
    case, jcase = load_case(Ini(text=text)), jload_case(JIni(text=text))
    grid = Simulation.from_case(load_case(Ini(text=INI)), dtype=F64,
                                device="cpu").grid
    hook = make_sources(case, grid, F64, "cpu")
    jhook = jmake_sources(jcase, JSimulation.from_case(jcase).grid,
                          jnp.float64)
    assert (hook is None) == (jhook is None)
    if hook is None:
        return
    jsim = JSimulation.from_case(jcase)
    u, v, w, s = _state(jsim)
    sj = jdyn.State(u=jnp.asarray(u), v=jnp.asarray(v), w=jnp.asarray(w),
                    s=jnp.asarray(s))
    zj = jnp.zeros_like(sj.u)
    want = jhook(jsim.P, sj, zj, zj, zj, jnp.zeros_like(sj.s))
    H = torch.zeros((3 + s.shape[0],) + u.shape, dtype=F64)
    P = Simulation.from_case(case, dtype=F64, device="cpu").P
    got = hook(P, state_from_numpy(u, v, w, s, "cpu", F64), H[0], H[1],
               H[2], H[3:])
    for a, b in zip(got, want):
        assert _rel(a, b) <= TOL


def test_subsidence_and_homogeneous_functions_match_jax():
    jsim, tsim = _both("subsidence")
    a = np.random.default_rng(6).standard_normal(tsim.grid.shape)
    y = tsim.grid.y.nodes
    got = tforc.subsidence_source(
        tforc.SubsidenceProps("constantdivergencelocal", 0.4), tsim.P,
        torch.from_numpy(y), torch.from_numpy(a))
    want = jforc.subsidence_source(
        jforc.SubsidenceProps("constantdivergencelocal", 0.4), jsim.P, y,
        jnp.asarray(a))
    assert _rel(got, want) <= TOL
    for text in ("[SpecialForcing]\nType=homogeneous\nParameters=0.3\n"
                 "Vector=0,1\n", "[SpecialForcing]\nType=Homogeneous\n",
                 "[SpecialForcing]\nType=wavemaker\n", ""):
        assert tforc.homogeneous_from_ini(Ini(text=text)) == \
            jforc.homogeneous_from_ini(JIni(text=text))


def test_internal_wave_frequency():
    """tests/test_stratified.py on the port: the standing mode (kx, ky) of
    a linear stratification N = 1 oscillates at omega = N kx / |k| (its
    limit: 0.02 of the amplitude over 200 RK4 steps)."""
    sim = Simulation.from_case(load_case(Ini(text=WAVE_INI)), dtype=F64,
                               device="cpu")
    nx, ny, nz = sim.grid.shape
    X = sim.grid.x.nodes[:, None, None]
    Y = sim.grid.y.nodes[None, :, None]
    kx, ky, A = 1.0, 1.0, 1e-4
    v0 = A * np.cos(kx * X) * np.sin(ky * Y) * np.ones((nx, ny, nz))
    u0 = -A * (ky / kx) * np.sin(kx * X) * np.cos(ky * Y) \
        * np.ones((nx, ny, nz))
    s0 = np.broadcast_to(Y, (nx, ny, nz))     # total scalar = background y
    state = state_from_numpy(u0, v0, np.zeros((nx, ny, nz)), s0[None],
                             "cpu", F64)
    omega = kx / np.sqrt(kx ** 2 + ky ** 2)
    dt, n_steps = 0.02, 200
    probe = [float(state.v[nx // 8, ny // 2, 0])]
    for _ in range(n_steps):
        state, _ = tdyn.rk_step(sim.P, state, dt)
        probe.append(float(state.v[nx // 8, ny // 2, 0]))
    probe = np.asarray(probe) / probe[0]
    assert np.max(np.abs(probe - np.cos(omega * dt * np.arange(n_steps + 1)))) \
        < 0.02
    assert isinstance(state, State)
