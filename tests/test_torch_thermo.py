"""The port's moist thermodynamics (tlab_tpu_torch/physics/thermo.py) against
tlab_tpu.physics.thermo, float64 on the CPU, on the same inputs made from a
seed with NumPy: every field function at saturated and unsaturated points,
to 1e-12 of the result's max; the host constants (psat_coeffs, the
ThermoParams properties) exactly; hydrostatic_background to 1e-13 of each
profile's max (the port's copy runs its own tensor equilibrium in float64).
Then the port's own properties: the saturation adjustment satisfies its
equations, a float32 call evaluates in float64, and the options with no
ported caller (the exponential psat fit, the compressible units) raise."""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tlab_tpu.physics import thermo as jt
from tlab_tpu_torch.physics import thermo as tt

TOL = 1e-12
F64 = torch.float64

PARAMS = {
    "cloudtop": dict(scale_height_inv=1.0 / 8700.0),
    "anelastic_test": dict(scale_height_inv=1.0 / 20.0),
    "smoothed": dict(scale_height_inv=0.01, dsmooth=0.1),
    "dimensional": dict(scale_height_inv=9.81, nondimensional=False),
    "airvapor": dict(mixture="airvapor", scale_height_inv=0.01),
    "air": dict(mixture="air", scale_height_inv=0.01),
}


def _pair(name):
    kw = PARAMS[name]
    return jt.ThermoParams(**kw), tt.ThermoParams(**kw)


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    scale = np.max(np.abs(b))
    err = np.max(np.abs(a - b))
    return err / scale if scale > 0 else err


def _fields(tp, shape=(6, 20, 5), seed=0):
    """(h, qt, p, ep): h and qt about a stratocumulus top, half the points
    saturated; p, ep as (1, ny, 1) profiles."""
    rng = np.random.default_rng(seed)
    ny = shape[1]
    y = np.linspace(0.0, 1.0, ny)
    if tp.nondimensional:
        T = 0.95 + 0.04 * rng.random(shape)
        p = (1.0 - 0.1 * y)[None, :, None]
    else:
        T = 283.0 + 12.0 * rng.random(shape)
        p = (1.0e5 - 1.0e4 * y)[None, :, None]
    ep = (tp.gratio * tp.scale_height_inv * y)[None, :, None]
    jtp = jt.ThermoParams(**dataclasses.asdict(tp))
    qs = np.asarray(jtp.qsat(jnp.asarray(T), jnp.asarray(p)))
    qt = qs * (0.6 + 0.8 * rng.random(shape))
    h = (tp.Cd + qt * tp.Cdv) * T + ep
    return h, qt, np.broadcast_to(p, (1, ny, 1)).copy(), ep


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float64))


def test_psat_coeffs_match_exactly():
    for T_ref, p_ref in ((298.0, 1.0e5), (1.0, 1.0), (273.15, 9.4e4)):
        assert tt.psat_coeffs(T_ref, p_ref) == jt.psat_coeffs(T_ref, p_ref)
    assert tt.FLATAU == jt.FLATAU
    assert (tt.RGAS, tt.WGHT_V, tt.WGHT_D, tt.LV_273) == \
        (jt.RGAS, jt.WGHT_V, jt.WGHT_D, jt.LV_273)


@pytest.mark.parametrize("name", list(PARAMS))
def test_thermo_params_match_exactly(name):
    kw = PARAMS[name]
    j, t = jt.ThermoParams(**kw), tt.ThermoParams(**kw)
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    props = [n for n, v in vars(jt.ThermoParams).items()
             if isinstance(v, property)]
    assert props == [n for n, v in vars(tt.ThermoParams).items()
                     if isinstance(v, property)]
    for prop in props:
        assert getattr(t, prop) == getattr(j, prop), prop


@pytest.mark.parametrize("kw, item", [
    (dict(psat_mode="bolton"), "Flatau")], ids=["bolton"])
def test_unported_thermo_options_raise(kw, item):
    """The exponential psat fit (no case file selects it) keeps its field,
    as in tlab_tpu, and is refused."""
    jt.ThermoParams(**kw)
    with pytest.raises(NotImplementedError, match=item):
        tt.ThermoParams(**kw)


@pytest.mark.parametrize("kw", [dict(rratio=0.7, cratio_inv=0.4),
                                dict(cratio_inv=0.4)],
                         ids=["compressible", "cratio"])
def test_compressible_units_match_jax(kw):
    """The compressible units, refused until ROADMAP A13b: RRATIO scales
    Rd and the psat table, CRATIO_INV stays a field; every property and
    psat on T equal tlab_tpu's."""
    j, t = jt.ThermoParams(**kw), tt.ThermoParams(**kw)
    props = [n for n, v in vars(jt.ThermoParams).items()
             if isinstance(v, property)]
    for prop in props:
        assert getattr(t, prop) == getattr(j, prop), prop
    T = np.linspace(0.85, 1.05, 11)
    assert _rel(t.psat(torch.from_numpy(T)), j.psat(jnp.asarray(T))) <= TOL


@pytest.mark.parametrize("name", list(PARAMS))
def test_psat_dpsat_qsat_match(name):
    j, t = _pair(name)
    h, qt, p, ep = _fields(j)
    T = (h - ep) / (j.Cd + qt * j.Cdv)
    assert _rel(t.psat(_t(T)), j.psat(jnp.asarray(T))) <= TOL
    assert _rel(t.dpsat(_t(T)), j.dpsat(jnp.asarray(T))) <= TOL
    assert _rel(t.qsat(_t(T), _t(p)), j.qsat(jnp.asarray(T),
                                             jnp.asarray(p))) <= TOL
    assert _rel(tt.psat_polynomial(j.psat_cf, _t(T)),
                jt.psat_polynomial(j.psat_cf, jnp.asarray(T))) <= TOL
    assert _rel(tt.dpsat_polynomial(j.psat_cf, _t(T)),
                jt.dpsat_polynomial(j.psat_cf, jnp.asarray(T))) <= TOL


@pytest.mark.parametrize("name", list(PARAMS))
def test_equilibrium_matches(name):
    """(T, ql) and the Newton error at saturated and unsaturated points;
    the error is the round-off of a converged Newton, held to the same
    order (tlab_tpu's eager value is the same arithmetic)."""
    j, t = _pair(name)
    h, qt, p, ep = _fields(j)
    Tj, qlj, ej = jt.equilibrium_T_ql(j, *(jnp.asarray(a) for a in
                                           (h, qt, p, ep)), with_err=True)
    Tt, qlt, et = tt.equilibrium_T_ql(t, *(_t(a) for a in (h, qt, p, ep)),
                                      with_err=True)
    sat = np.asarray(qlj) > 0
    if j.mixture == "airwater":
        assert 0.2 < sat.mean() < 0.9          # both kinds of points
    assert _rel(Tt, Tj) <= TOL
    assert _rel(qlt, qlj) <= TOL
    assert Tt.dtype == qlt.dtype == et.dtype == F64
    assert abs(float(et) - float(ej)) <= 1e-11
    T2, ql2 = tt.equilibrium_T_ql(t, *(_t(a) for a in (h, qt, p, ep)))
    assert torch.equal(T2, Tt) and torch.equal(ql2, qlt)
    assert _rel(tt.temperature_unsaturated(t, *(_t(a) for a in
                                                (h, qt, ep))),
                jt.temperature_unsaturated(j, h, qt, ep)) <= TOL
    assert _rel(tt.mixture_R(t, _t(qt), qlt), jt.mixture_R(j, qt, qlj)) \
        <= TOL


def _bg(j, ny=20):
    y = np.linspace(0.0, 1.0, ny)
    h = 0.97 + 0.02 * np.tanh((y - 0.6) / 0.1) + j.scale_height_inv * y
    qt = 0.01 - 0.006 * np.tanh((y - 0.6) / 0.1)
    return y, h, qt


@pytest.mark.parametrize("name", ["cloudtop", "anelastic_test", "air"])
@pytest.mark.parametrize("d1y", [False, True])
def test_hydrostatic_background_matches(name, d1y):
    j, t = _pair(name)
    y, h, qt = _bg(j)
    kw = dict(p_ref=0.94, y_ref=0.75)
    if d1y:
        from tlab_tpu_torch.fdm.plan import build_deriv_plan
        from tlab_tpu_torch.grid import make_axis
        kw["d1y"] = build_deriv_plan(make_axis(y, False)).d1[0]
    bj = jt.hydrostatic_background(j, y, h, qt, **kw)
    bt = tt.hydrostatic_background(t, y, h, qt, **kw)
    assert list(bt) == list(bj)
    for k in bj:
        assert isinstance(bt[k], np.ndarray) and bt[k].dtype == np.float64
        assert _rel(bt[k], bj[k]) <= 1e-13, k


@pytest.mark.parametrize("name", ["cloudtop", "anelastic_test", "airvapor"])
def test_buoyancy_and_diagnostics_match(name):
    j, t = _pair(name)
    y, h, qt = _bg(j)
    bgj = jt.hydrostatic_background(j, y, h, qt, p_ref=0.94)
    bgt = {k: torch.from_numpy(v) for k, v in
           tt.hydrostatic_background(t, y, h, qt, p_ref=0.94).items()}
    rng = np.random.default_rng(1)
    s = np.stack([np.broadcast_to(h[None, :, None], (5, 20, 4)),
                  np.broadcast_to(qt[None, :, None], (5, 20, 4))]) \
        + np.stack([3e-3, 1e-3])[:, None, None, None] \
        * rng.standard_normal((2, 5, 20, 4))
    assert _rel(tt.buoyancy_explicit(t, _t(s), bgt),
                jt.buoyancy_explicit(j, jnp.asarray(s), bgj)) <= TOL
    dj = jt.diagnostic_fields(j, jnp.asarray(s), bgj)
    dt = tt.diagnostic_fields(t, _t(s), bgt)
    assert list(dt) == list(dj)
    for k in dj:
        assert _rel(dt[k], dj[k]) <= TOL, k
    T, ql = tt.equilibrium_state(t, _t(s), bgt)
    assert torch.equal(T, dt["T"]) and torch.equal(ql, dt["ql"])
    ej = float(jt.equilibrium_newton_error(j, jnp.asarray(s), bgj))
    et = float(tt.equilibrium_newton_error(t, _t(s), bgt))
    assert abs(et - ej) <= 1e-11
    # one scalar only: qt = 0
    assert _rel(tt.buoyancy_explicit(t, _t(s[:1]), bgt),
                jt.buoyancy_explicit(j, jnp.asarray(s[:1]), bgj)) <= TOL


@pytest.mark.parametrize("dsmooth", [0.0, 0.1])
def test_airwater_pt_matches(dsmooth):
    kw = dict(scale_height_inv=0.01, dsmooth=dsmooth)
    j, t = jt.ThermoParams(**kw), tt.ThermoParams(**kw)
    h, qt, p, ep = _fields(j, seed=2)
    T = (h - ep) / (j.Cd + qt * j.Cdv)
    got = tt.airwater_pt(t, _t(qt), _t(p), _t(T))
    want = jt.airwater_pt(j, jnp.asarray(qt), jnp.asarray(p), jnp.asarray(T))
    assert _rel(got, want) <= TOL
    assert float(torch.max(got)) > 0.0


@pytest.mark.parametrize("params, ns", [((2.0,), 1), ((-1.5, 3.0), 2),
                                        ((-1.5, 3.0, 0.05), 2),
                                        ((2.0, 0.1), 1),
                                        ((1.0, -2.0, 0.5, 0.02), 3)])
def test_airwater_linear_matches(params, ns):
    s = np.random.default_rng(3).standard_normal((ns, 4, 6, 3)) * 0.5
    assert _rel(tt.airwater_linear(params, _t(s)),
                jt.airwater_linear(params, jnp.asarray(s))) <= TOL
    for a, b in zip(tt.airwater_linear_source(params, _t(s)),
                    jt.airwater_linear_source(params, jnp.asarray(s))):
        assert _rel(a, b) <= TOL


def test_saturation_adjustment_satisfies_its_equations():
    """Port alone: the saturated points solve h = cp T - ql Lv0 + ep with
    ql = qt - eps psat/(p - psat)(1 - qt); the unsaturated ones have ql = 0
    and T = (h - ep)/(Cd + qt Cdv)."""
    t = tt.ThermoParams(scale_height_inv=1.0 / 8700.0)
    h, qt, p, ep = (_t(a) for a in _fields(t, seed=4))
    T, ql = tt.equilibrium_T_ql(t, h, qt, p, ep)
    sat = ql > 0
    cp = t.Cd + qt * t.Cdv + ql * t.Cvl
    # to the Newton's own round-off: its last step is ~5e-12 of T
    res = cp * T - ql * t.Lv0 + ep - h
    assert float(res.abs().max()) <= 1e-10
    ps = t.psat(T)
    qv = t.rd_ov_rv / (p / ps - 1.0) * (1.0 - qt)
    assert float((ql - (qt - qv))[sat].abs().max()) <= 1e-12
    assert bool((qv[~sat] >= qt[~sat]).all())
    assert bool((ql >= 0).all() and (ql <= qt).all())


def test_float32_fields_evaluate_in_float64():
    """A float32 state gets float32 results computed in float64: T and ql
    equal the float64 results of the same (float32-rounded) inputs,
    rounded once.  The polynomial in float32 would cancel to 3e-3 of T."""
    t = tt.ThermoParams(scale_height_inv=1.0 / 8700.0)
    h, qt, p, ep = (_t(a).float() for a in _fields(t, seed=5))
    T32, ql32 = tt.equilibrium_T_ql(t, h, qt, p, ep)
    T64, ql64 = tt.equilibrium_T_ql(t, *(a.double() for a in (h, qt, p, ep)))
    assert T32.dtype == ql32.dtype == torch.float32
    assert torch.equal(T32, T64.float()) and torch.equal(ql32, ql64.float())
    assert t.psat(T32).dtype == torch.float32
    assert torch.equal(t.psat(T32), t.psat(T32.double()).float())
