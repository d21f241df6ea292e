"""The other source terms of the port (physics/radiation.py,
microphysics.py, chemistry.py, the wavemaker of forcing.py, and their
wiring in runtime.make_sources) against tlab_tpu's, float64 on the CPU, on
the same inputs made from a seed with NumPy.

The functions agree to 1e-12 of the result's max; the hook's tendency on a
state to 1e-12 of each row's max, one RK step to 1e-10 of max|field|; the
wavemaker's three steps with the time advancing to 1e-10, and `dns.run`'s
log (one RK step a window) in its printed digits.  Also: the reference's
own conditions for a source to act (Settling, the wavemaker's waves), the
optically thick gray RTE in float32 on the port alone
(tests/test_sources_extra.py's), and [IniFields] NormalizeR's initial
state to 1e-11 (the initializers' limit)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from test_anelastic import INI_TEXT
from test_golden import INI
from test_torch_anelastic import INI_3D
from test_torch_options import case_text
from tlab_tpu.config import Ini as JIni, load_case as jload_case
from tlab_tpu.dycore import incompressible as jdyn
from tlab_tpu.fdm.plan import build_deriv_plan as jbuild_deriv_plan
from tlab_tpu.physics import chemistry as jchem
from tlab_tpu.physics import forcing as jforc
from tlab_tpu.physics import microphysics as jmic
from tlab_tpu.physics import radiation as jrad
from tlab_tpu.physics import thermo as jthermo
from tlab_tpu.runtime import Simulation as JSimulation
from tlab_tpu.tools import dns as jdns
from tlab_tpu.tools.initialize import initial_state as jinitial_state
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.convert import state_from_numpy, state_to_numpy
from tlab_tpu_torch.dycore import incompressible as tdyn
from tlab_tpu_torch.grid import make_axis
from tlab_tpu_torch.physics import chemistry as tchem
from tlab_tpu_torch.physics import forcing as tforc
from tlab_tpu_torch.physics import microphysics as tmic
from tlab_tpu_torch.physics import radiation as trad
from tlab_tpu_torch.physics import thermo as tthermo
from tlab_tpu_torch.runtime import Simulation, make_sources
from tlab_tpu_torch.tools import dns as tdns
from tlab_tpu_torch.tools.initialize import initial_state

F64 = torch.float64
TOL = 1e-12

torch.set_num_threads(2)


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    scale = np.max(np.abs(b))
    return np.max(np.abs(a - b)) / scale if scale > 0 else np.max(np.abs(a))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float64))


def _field(shape=(5, 24, 4), seed=0, lo=0.0, hi=1.0):
    return lo + (hi - lo) * np.random.default_rng(seed).random(shape)


# ---------------------------------------------------------------------------
# the functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flux_bottom", [0.0, 0.4])
def test_infrared_source_matches(flux_bottom):
    y = np.linspace(0.0, 1.0, 24)
    Jt, Jb = jrad.int1_cumulative_matrices(jbuild_deriv_plan(
        make_axis(y, False)))
    props = dict(type="grayliquid", kappa=3.0, flux_top=1.2,
                 flux_bottom=flux_bottom)
    ql, rho = _field(seed=1), 1.0 + 0.1 * _field((24,), seed=2)
    got = trad.infrared_source(trad.RadiationProps(**props), _t(Jt), _t(Jb),
                               _t(ql), _t(rho))
    want = jrad.infrared_source(jrad.RadiationProps(**props),
                                jnp.asarray(Jt), jnp.asarray(Jb),
                                jnp.asarray(ql), jnp.asarray(rho))
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("flux_top", [None, "field"])
@pytest.mark.parametrize("emissivity", [1.0, 0.6])
def test_infrared_gray_source_matches(flux_top, emissivity):
    y = np.sort(_field((24,), seed=3))
    a, b = _field(seed=4, lo=0.2, hi=3.0), _field(seed=5, lo=0.5, hi=1.5)
    ft = None if flux_top is None else _field((5, 4), seed=6)
    props = dict(type="gray", flux_top=0.7)
    got = trad.infrared_gray_source(
        trad.RadiationProps(**props), y, _t(a), _t(b), emissivity=emissivity,
        return_fluxes=True, flux_top=None if ft is None else _t(ft))
    want = jrad.infrared_gray_source(
        jrad.RadiationProps(**props), y, jnp.asarray(a), jnp.asarray(b),
        emissivity=emissivity, return_fluxes=True, flux_top=ft)
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL


def test_infrared_band_source_matches():
    y = np.linspace(0.0, 1.0, 20)
    bands = [_field((4, 20, 3), seed=s, lo=0.1, hi=2.0) for s in (7, 8)]
    T = _field((4, 20, 3), seed=9, lo=0.9, hi=1.1)
    beta = ((0.6, 1e-3, 1e-6), (0.4, -1e-3, -1e-6))
    kw = dict(type="band", beta=0.1, bcs_top=(0.3, 0.2), nbands=2)
    got = trad.infrared_band_source(trad.RadiationProps(**kw), y,
                                    [_t(a) for a in bands], _t(T), beta,
                                    emissivity=0.9)
    want = jrad.infrared_band_source(jrad.RadiationProps(**kw), y,
                                     [jnp.asarray(a) for a in bands],
                                     jnp.asarray(T), beta, emissivity=0.9)
    assert _rel(got, want) <= TOL


def test_gray_optically_thick_f32_no_overflow():
    """tests/test_sources_extra.py's thick layers (tau ~ 150 a layer) on
    the port: finite in float32, the recurrences having no exp(+tau)."""
    y = np.linspace(0.0, 1.0, 33)
    a = torch.full((2, 33, 2), 5000.0, dtype=torch.float32)
    b = torch.full((2, 33, 2), 1.0, dtype=torch.float32)
    src, fdn, fup = trad.infrared_gray_source(
        trad.RadiationProps(type="gray", flux_top=1.0), y, a, b,
        return_fluxes=True, emissivity=1.0)
    assert src.dtype == torch.float32
    for x in (src, fdn, fup):
        assert bool(torch.isfinite(x).all())


@pytest.fixture(scope="module")
def plans():
    """tlab_tpu's and the port's plans of the 3-D anelastic case."""
    return JSimulation.from_case(jload_case(JIni(text=INI_3D))), \
        Simulation.from_case(load_case(Ini(text=INI_3D)), dtype=F64,
                             device="cpu")


@pytest.mark.parametrize("kind", ["airwater", "airwatersimplified"])
@pytest.mark.parametrize("exponent", [0.0, 2.0 / 3.0])
def test_sedimentation_matches(plans, kind, exponent):
    jsim, tsim = plans
    shape = tsim.grid.shape
    s = np.stack([_field(shape, seed=10, lo=0.9, hi=1.0),
                  _field(shape, seed=11, lo=0.0, hi=0.02),
                  _field(shape, seed=17, lo=0.0, hi=0.01)])
    ql = _field(shape, seed=12, lo=-1e-3, hi=5e-3)
    stat = _field(shape, seed=13, lo=-1.0, hi=1.0)
    kw = dict(type=kind, parameters=(0.1, 0.05), exponent=exponent)
    jp, tp = jmic.MicrophysicsProps(**kw), tmic.MicrophysicsProps(**kw)
    for isc in range(3):
        assert tmic.param(tp, isc) == jmic.param(jp, isc)
        if kind == "airwatersimplified":
            got = tmic.sedimentation_simplified(tp, tsim.P, isc, _t(ql))
            want = jmic.sedimentation_simplified(jp, jsim.P, isc,
                                                 jnp.asarray(ql))
        else:
            got = tmic.sedimentation_airwater(tp, tsim.P, isc, _t(s),
                                              _t(ql), _t(stat))
            want = jmic.sedimentation_airwater(jp, jsim.P, isc,
                                               jnp.asarray(s),
                                               jnp.asarray(ql),
                                               jnp.asarray(stat))
        assert _rel(got, want) <= TOL
    tpar = tthermo.ThermoParams()
    jpar = jthermo.ThermoParams()
    ep = _field((1, shape[1], 1), seed=14)
    assert _rel(tmic.liquid_static_energy(tpar, _t(s[0]), _t(s[0]), _t(ep)),
                jmic.liquid_static_energy(jpar, s[0], s[0], ep)) <= TOL


@pytest.mark.parametrize("kind, ns", [("quadratic", 1), ("quadratic", 3),
                                      ("quadratic3", 8), ("ozone", 4),
                                      ("layeredrelaxation", 2),
                                      ("none", 2)])
def test_chemistry_matches(kind, ns):
    s = _field((ns, 4, 10, 3), seed=15)
    y = np.linspace(0.0, 1.0, 10)
    kw = dict(type=kind, damkohler=(0.5, 1.0, 0.0, 2.0, 1.5, 1.0, 0.7, 0.2),
              parameters=(0.8, 0.3, 0.25), ymean=(0.4, 0.6))
    jp, tp = jchem.ChemistryProps(**kw), tchem.ChemistryProps(**kw)
    assert tchem.active_scalars(tp, ns) == jchem.active_scalars(jp, ns)
    for i in range(ns):
        assert _rel(tchem.source(tp, _t(s), i, _t(y)),
                    jchem.source(jp, jnp.asarray(s), i, y)) <= TOL


WAVE = "[SpecialForcing]\nType=wavemaker\nParameters=0.5\n" \
    "Wave1=0.05, 4.0, 30.0, 2.0\nWave2=0.02, 2.0, -60.0, 1.0\n" \
    "Envelope=1.0, 0.5, 0.5, 0.3\n"


def test_wavemaker_source_matches():
    props_t = tforc.wavemaker_from_ini(Ini(text=WAVE))
    props_j = jforc.wavemaker_from_ini(JIni(text=WAVE))
    jsim = JSimulation.from_case(jload_case(JIni(text=INI_3D)))
    env, ph = tforc.wavemaker_fields(props_t, jsim.grid)
    q = _field(jsim.grid.shape, seed=16, lo=-1.0, hi=1.0)
    for iq in (0, 1):
        for t in (0.0, 0.37):
            got = tforc.wavemaker_source(props_t, _t(env), _t(ph), iq, _t(q),
                                         t)
            want = jforc.wavemaker_source(props_j, env, ph, iq,
                                          jnp.asarray(q), t)
            assert _rel(got, want) <= TOL
    assert tforc.localize_wavemaker(env, ph, None) == (env, ph)
    # on a rank mesh: the rank's block of both tables (pure slicing)
    import types
    nx, nz = env.shape[0], env.shape[2]
    for ix, iz in ((0, 0), (1, 1)):
        comm = {"mesh": types.SimpleNamespace(px=2, pz=2, ix=ix, iz=iz)}
        e, p = tforc.localize_wavemaker(_t(env), _t(ph), comm)
        xs = slice(ix * nx // 2, (ix + 1) * nx // 2)
        zs = slice(iz * nz // 2, (iz + 1) * nz // 2)
        assert torch.equal(e, _t(env)[xs, :, zs])
        assert torch.equal(p, _t(ph)[:, xs])


# ---------------------------------------------------------------------------
# make_sources: the hook's tendency and one RK step
# ---------------------------------------------------------------------------

GRAY = ("[Infrared]\nType=gray\nScalar=1\nBoundaryConditions=0.2, 1.0\n"
        "AbsorptionComponent1=5.0\nAbsorptionComponent2=0.1\n"
        "AbsorptionComponent3=0.01\nBeta=0.1\n")
BAND = ("[Infrared]\nType=band\nScalar=1\n"
        "BoundaryConditions=0.2, 0.1, 1.0\n"
        "AbsorptionComponent1=5.0, 2.0\nAbsorptionComponent2=0.1, 0.05\n"
        "AbsorptionComponent3=0.01, 0.0\nBetaCoefficient1=0.6\n"
        "BetaCoefficient2=0.0\nBetaCoefficient3=0.0\nBeta=0.1\n")
SETTLING = [("Parameters", "Settling", "0.2")]
TWO_SCALARS = [("Parameters", "Schmidt", "1.0,0.7"),
               ("Scalar", "ProfileScalar2", "Tanh"),
               ("Scalar", "ThickScalar2", "0.2"),
               ("Scalar", "DeltaScalar2", "0.5"),
               ("Scalar", "MeanScalar2", "0.5"),
               ("BoundaryConditions", "Scalar2Jmin", "neumann"),
               ("BoundaryConditions", "Scalar2Jmax", "neumann")]


def _golden(edits, extra=""):
    text = INI.replace("Schmidt=1.0\n", "") if any(
        k == "Schmidt" for _, k, _ in edits) else INI
    return case_text(edits, text) + extra


HOOKS = {
    "grayliquid": _golden([], "[Infrared]\nType=grayliquid\nScalar=1\n"
                              "BoundaryConditions=1.2, 0.3\n"
                              "AbsorptionComponent1=4.0\n"),
    "bulk1dlocal": _golden([], "[Infrared]\nType=Bulk1dLocal\n"
                               "Parameters=0.5, 0.1, 0.2\n"),
    "legacy_keys": _golden([], "[Radiation]\nType=grayliquid\n"
                               "[Infrared]\nKappa=2.0\nFluxTop=0.7\n"),
    "gray": INI_3D + GRAY,
    "band": INI_3D + BAND,
    "gray_2d": INI_TEXT + GRAY,
    "sedimentation_airwater": case_text(
        SETTLING + [("Sedimentation", "Type", "airwater"),
                    ("Sedimentation", "Exponent", "0.5")], INI_3D),
    "sedimentation_simplified": case_text(
        SETTLING + [("Sedimentation", "Type", "airwatersimplified"),
                    ("Sedimentation", "Parameters", "1.0, 0.5")], INI_3D),
    "sedimentation_scalar_liquid": _golden(
        TWO_SCALARS + SETTLING
        + [("Microphysics", "Type", "airwatersimplified")]),
    "chemistry_logistic": _golden([("Chemistry", "Type", "quadratic"),
                                   ("Chemistry", "Parameters", "2.0")]),
    "chemistry_layered": _golden(
        TWO_SCALARS + [("Chemistry", "Type", "layeredrelaxation"),
                       ("Chemistry", "Parameters", "0.5, 0.1, 0.2"),
                       ("Parameters", "Damkohler", "1.0, 0.0")]),
    "wavemaker": _golden([], WAVE),
    "everything": INI_3D + GRAY + WAVE + "[Chemistry]\nType=quadratic\n"
    "[Sedimentation]\nType=airwater\n[Rotation]\nType=explicit\n"
    "Vector=0,1,0\n",
    "linear_liquid_radiation": _golden(
        [("Thermodynamics", "Mixture", "AirWaterLinear"),
         ("Thermodynamics", "Parameters", "-11.1,0.005625"),
         ("Main", "TermBodyForce", "Linear"),
         ("Gravity", "Vector", "0,-1,0"),
         ("Gravity", "Parameters", "0.5,2.0,0.1")],
        "[Infrared]\nType=grayliquid\nBoundaryConditions=1.0, 0.0\n"),
}
HOOKS["everything"] = HOOKS["everything"].replace(
    "[Parameters]\n", "[Parameters]\nSettling=0.1\n", 1)


def _both(text):
    return JSimulation.from_case(jload_case(JIni(text=text))), \
        Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                             device="cpu")


def _state(jsim, seed=3):
    st = jinitial_state(jsim, seed=seed)
    rng = np.random.default_rng(seed)
    env = np.sin(np.pi * np.linspace(0.0, 1.0, st.u.shape[1]))[None, :, None]
    u, v, w = (np.asarray(a) + 0.02 * env * rng.standard_normal(a.shape)
               for a in (st.u, st.v, st.w))
    s = np.asarray(st.s) + 1e-3 * env[None] * rng.standard_normal(st.s.shape)
    return u, v, w, s


@pytest.mark.parametrize("name", list(HOOKS))
def test_hook_matches(name):
    """The hook's tendency on zero rows at t = 0.3, then one RK step at
    that time; the attributes ir_field, rad_props and time_dependent."""
    jsim, tsim = _both(HOOKS[name])
    fj, ft = jsim.P["bodyforce"], tsim.P["bodyforce"]
    assert fj is not None and ft is not None
    assert ft.time_dependent == fj.time_dependent
    assert (ft.rad_props is None) == (fj.rad_props is None)
    if ft.rad_props is not None:
        assert ft.rad_props.type == fj.rad_props.type
        assert ft.rad_props == type(ft.rad_props)(
            **{k: getattr(fj.rad_props, k)
               for k in ft.rad_props.__dataclass_fields__})
    u, v, w, s = _state(jsim)
    sj = jdyn.State(u=jnp.asarray(u), v=jnp.asarray(v), w=jnp.asarray(w),
                    s=jnp.asarray(s))
    st = state_from_numpy(u, v, w, s, "cpu", F64)
    aux = {"rtime": 0.3}
    zj = jnp.zeros_like(sj.u)
    want = fj(jsim.P, sj, zj, zj, zj, jnp.zeros_like(sj.s), aux=aux)
    H = torch.zeros((3 + s.shape[0],) + u.shape, dtype=F64)
    got = ft(tsim.P, st, H[0], H[1], H[2], H[3:], aux=aux)
    nonzero = 0
    for a, b in zip(got, want):
        if np.asarray(b).ndim == 4:
            for ai, bi in zip(a, b):
                assert _rel(ai, bi) <= TOL
        else:
            assert _rel(a, b) <= TOL
        nonzero += not (np.asarray(b) == 0).all()
    assert nonzero >= 1
    if ft.ir_field is not None:
        assert _rel(ft.ir_field(st), fj.ir_field(sj)) <= TOL
    sj2, _ = jdyn.rk_step(jsim.P, sj, 2e-3, aux=aux, unroll=True)
    st2, _ = tdyn.rk_step(tsim.P, st, 2e-3, aux=aux)
    for a, b in zip(state_to_numpy(st2), sj2[:4]):
        assert _rel(a, b) <= 1e-10


@pytest.mark.parametrize("extra, active", [
    ("[Sedimentation]\nType=airwater\n", False),          # Settling = 0
    ("[SpecialForcing]\nType=wavemaker\n", False),        # no wave
    ("[SpecialForcing]\nType=wavemaker\nWave1=0.1, 1.0, 0.0, 1.0\n", True),
    ("[Parameters]\nSettling=0.1\n[Sedimentation]\nType=airwater\n",
     True),
])
def test_the_reference_conditions_for_a_source(extra, active):
    """A source acts only where tlab_tpu's conditions say: sedimentation
    with a nonzero [Parameters] Settling, the wavemaker with at least one
    wave (its x amplitudes, zero at angle 0, are listed all the same)."""
    text = INI + extra
    jcase, tcase = jload_case(JIni(text=text)), load_case(Ini(text=text))
    grid = Simulation.from_case(tcase, dtype=F64, device="cpu").grid
    from tlab_tpu.runtime import make_sources as jmake_sources
    jhook = jmake_sources(jcase, JSimulation.from_case(jcase).grid,
                          jnp.float64)
    thook = make_sources(tcase, grid, F64, "cpu")
    assert (thook is not None) is (jhook is not None) is active


def test_wavemaker_steps_follow_the_time(tmp_path):
    """Three RK steps with aux["rtime"] advancing as dns.run hands it over,
    against tlab_tpu's; a phase frozen at t = 0 differs."""
    jsim, tsim = _both(HOOKS["wavemaker"])
    u, v, w, s = _state(jsim, seed=4)
    sj = jdyn.State(u=jnp.asarray(u), v=jnp.asarray(v), w=jnp.asarray(w),
                    s=jnp.asarray(s))
    st = state_from_numpy(u, v, w, s, "cpu", F64)
    frozen = st
    dt = 0.05
    for n in range(3):
        aux = {"rtime": n * dt}
        sj, _ = jdyn.rk_step(jsim.P, sj, dt, aux=aux, unroll=True)
        st, _ = tdyn.rk_step(tsim.P, st, dt, aux=aux)
        frozen, _ = tdyn.rk_step(tsim.P, frozen, dt, aux={"rtime": 0.0})
    for a, b in zip(state_to_numpy(st), sj[:4]):
        assert _rel(a, b) <= 1e-10
    assert _rel(state_to_numpy(frozen)[0], sj.u) > 1e-6


def test_dns_run_with_the_wavemaker_matches(tmp_path):
    """dns.run hands the step the start-of-step time and takes one RK step
    a window, as tlab_tpu's (inner_steps=3 asked)."""
    text = HOOKS["wavemaker"] + "[Iteration]\nIteraLog=1\n"
    jsim, tsim = _both(text)
    u, v, w, s = _state(jsim, seed=5)
    runs = []
    for mod, sim, state, sub in (
            (jdns, jsim, jdyn.State(u=jnp.asarray(u), v=jnp.asarray(v),
                                    w=jnp.asarray(w), s=jnp.asarray(s)),
             "jax"),
            (tdns, tsim, state_from_numpy(u, v, w, s, "cpu", F64), "torch")):
        out = tmp_path / sub
        out.mkdir()
        runs.append(mod.run(sim, state, outdir=str(out), n_steps=3,
                            inner_steps=3, checkpoint=False,
                            log_path=str(out / "dns.out")))
    rj, rt = runs
    assert rt.log.lines == rj.log.lines
    assert len([ln for ln in rt.log.lines if not ln.startswith("#")]) == 4
    assert rt.itime == rj.itime == 3
    for a, b in zip(state_to_numpy(rt.state), state_to_numpy(rj.state)):
        assert _rel(a, b) <= 1e-10


def test_normalize_r_initial_state_matches():
    """[IniFields] NormalizeR adds the IR source with fluxes scaled to it
    to the radiatively active scalar (iniscal, scal_main.f90:120-131)."""
    text = HOOKS["grayliquid"].replace("[IniFields]\n",
                                       "[IniFields]\nNormalizeR=0.4\n")
    assert "NormalizeR=0.4" in text
    jsim, tsim = _both(text)
    sj = jinitial_state(jsim, seed=7)
    st = initial_state(tsim, seed=7)
    for a, b in zip(state_to_numpy(st), state_to_numpy(sj)):
        assert np.max(np.abs(a - b)) <= 1e-11 * max(np.max(np.abs(b)), 1.0)
    plain = initial_state(Simulation.from_case(
        load_case(Ini(text=HOOKS["grayliquid"])), dtype=F64, device="cpu"),
        seed=7)
    assert float((st.s - plain.s).abs().max()) > 1e-6
