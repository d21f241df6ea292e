"""The anelastic equation set and the moist thermodynamics through the port's
step, time loop and statistics, against tlab_tpu, float64 on the CPU.

- tests/test_anelastic.py's case (Equations=anelastic, 32x40x1) and a 3-D
  copy (16x24x8): the plans, P["anelastic"] included, agree exactly; one RK
  step and five agree to 1e-10 of max|field|; the logged dilatation, the
  constraint residual div(rho_bar u), agrees to 1e-10 of its max; with
  tlab_tpu's own plan carried across (convert.plans_from_jax), the
  conservative forms' branch too.  Then that file's two properties on the
  port: the background stays still (max|v| < 1e-8 over 5 steps), a warm
  bubble rises.
- A 32x24x16 copy of examples/cloudtop_anelastic/tlab.ini (its keys, a
  smaller grid) through the CLI, `inigrid | ini | dns`, 4 steps, in both
  packages: as the example (Equations=incompressible with [Thermodynamics]
  Type=anelastic), with Equations=anelastic, and with the lagged dt
  ([Iteration] DtLag=yes: NewtonRs of the stepped state beside the
  previous window's CFL, both from the window's one read).  dns.out agrees in every
  printed digit but NewtonRs, the round-off of a converged Newton (~3e-12),
  which XLA's fused arithmetic moves: the port's logged value equals
  tlab_tpu's eager evaluation of the port's state in its printed digits.
  The avg files agree to 1e-8 of each column's max (9 printed digits; 1e-13
  absolute for the columns that vanish analytically; 5e-8 for rP and Pot,
  which carry the projection's singular mode, see SINGULAR_RTOL).
- Mixture=AirWaterLinear (the diagnostic liquid column) through
  make_sources and one step, with and without its Parameters.

The heavier tests step cases; torch runs on 2 threads (the test workers
share the machine's cores)."""
import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from test_anelastic import INI_TEXT
from test_torch_options import case_text
from tlab_tpu.config import Ini as JIni, load_case as jload_case
from tlab_tpu.dycore import incompressible as jdyn
from tlab_tpu.physics import thermo as jthermo
from tlab_tpu.physics.profiles import Profile as JProfile
from tlab_tpu.runtime import Simulation as JSimulation
from tlab_tpu.tools import cli as jcli
from tlab_tpu.tools.initialize import initial_state as jinitial_state
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.convert import (plans_from_jax, state_from_numpy,
                                    state_to_numpy)
from tlab_tpu_torch.dycore import incompressible as tdyn
from tlab_tpu_torch.io import fields_io as tio
from tlab_tpu_torch.physics.profiles import Profile
from tlab_tpu_torch.runtime import Simulation, make_anelastic, make_sources
from tlab_tpu_torch.stats import averages as tavg
from tlab_tpu_torch.tools import cli
from tlab_tpu_torch.utils.fortran_fmt import fort_e

F64 = torch.float64
TOL = 1e-10
REPO = pathlib.Path(__file__).resolve().parent.parent
CLOUDTOP = REPO / "examples" / "cloudtop_anelastic" / "tlab.ini"

torch.set_num_threads(2)


def _edit(text, changes):
    """The case text with {(section, key): value} changed; each key must be
    there already."""
    for (section, key), value in changes.items():
        text, n = re.subn(rf"(\[{section}\][^\[]*?^{key}=)[^\n]*",
                          rf"\g<1>{value}", text, flags=re.M | re.S)
        assert n == 1, (section, key)
    return text


INI_3D = _edit(INI_TEXT, {("Grid", "Imax"): "16", ("Grid", "Jmax"): "24",
                          ("Grid", "Kmax"): "8", ("Grid", "ZPeriodic"): "yes",
                          ("IniGridOx", "points_1"): "17",
                          ("IniGridOy", "points_1"): "24",
                          ("IniGridOz", "periodic"): "yes",
                          ("IniGridOz", "points_1"): "9"})
CASES = {"2d": INI_TEXT, "3d": INI_3D}


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    scale = np.max(np.abs(b))
    return np.max(np.abs(a - b)) / scale if scale > 0 else np.max(np.abs(a))


def _both(text, neutral=False):
    """tlab_tpu's and the port's Simulation of `text`.  neutral: the h
    profile of test_anelastic.make_sim (linear, with ep, so that the
    background is a neutral atmosphere)."""
    jcase, tcase = jload_case(JIni(text=text)), load_case(Ini(text=text))
    if neutral:
        kw = dict(type="linear", mean=1.0 + 0.5 * (1.0 / 20.0),
                  delta=-1.0 / 20.0, thick=1.0, ymean=0.5)
        jcase = dataclasses.replace(
            jcase, scal_profiles=(JProfile(**kw), jcase.scal_profiles[1]))
        tcase = dataclasses.replace(
            tcase, scal_profiles=(Profile(**kw), tcase.scal_profiles[1]))
    return JSimulation.from_case(jcase), \
        Simulation.from_case(tcase, dtype=F64, device="cpu")


def _state(jsim, seed=3):
    """tlab_tpu's initial state plus wall-clean noise in every field."""
    st = jinitial_state(jsim, seed=seed)
    rng = np.random.default_rng(seed)
    ny = st.u.shape[1]
    env = np.sin(np.pi * np.linspace(0.0, 1.0, ny))[None, :, None]
    u, v, w = (np.asarray(a) + 0.02 * env * rng.standard_normal(a.shape)
               for a in (st.u, st.v, st.w))
    s = np.asarray(st.s) + 1e-3 * env[None] * rng.standard_normal(st.s.shape)
    return u, v, w, s


def _jstate(u, v, w, s):
    return jdyn.State(u=jnp.asarray(u), v=jnp.asarray(v), w=jnp.asarray(w),
                      s=jnp.asarray(s))


@pytest.mark.parametrize("dim", list(CASES))
def test_plans_match(dim):
    jsim, tsim = _both(CASES[dim])
    assert set(jsim.P["anelastic"]) == set(tsim.P["anelastic"]) \
        == {"rho", "rho_inv"}
    for k in ("rho", "rho_inv"):
        assert np.array_equal(tsim.P["anelastic"][k].numpy(),
                              np.asarray(jsim.P["anelastic"][k]))
    assert "adv_form" not in tsim.P and tsim.P["bodyforce"] is not None
    carried = plans_from_jax(jsim.P, "cpu", F64,
                             bodyforce=tsim.P["bodyforce"])
    for k in ("rho", "rho_inv"):
        assert torch.equal(carried["anelastic"][k], tsim.P["anelastic"][k])
    # the background: make_anelastic's profiles, cast once to the run's
    # dtype on its device
    ane = make_anelastic(tsim.case, tsim.grid, torch.float32, "cpu")
    assert all(v.dtype == torch.float32 for v in ane["bg"].values())
    assert torch.equal(ane["rho"], tsim.P["anelastic"]["rho"].float())


@pytest.mark.parametrize("dim", list(CASES))
def test_steps_match(dim):
    """One RK step and five, and the logged dilatation div(rho_bar u)."""
    jsim, tsim = _both(CASES[dim])
    u, v, w, s = _state(jsim)
    sj, st = _jstate(u, v, w, s), state_from_numpy(u, v, w, s, "cpu", F64)
    for n in range(5):
        sj, pj = jdyn.rk_step(jsim.P, sj, 2e-3, unroll=True)
        st, pt = tdyn.rk_step(tsim.P, st, 2e-3)
        if n in (0, 4):
            for a, b in zip(state_to_numpy(st), sj[:4]):
                assert _rel(a, b) <= TOL, n
            assert _rel(pt, pj) <= TOL
    dj = [float(d) for d in jdyn.dilatation_minmax(jsim.P, sj)]
    dt = [float(d) for d in tdyn.dilatation_minmax(tsim.P, st)]
    assert abs(dt[0] - dj[0]) <= TOL * abs(dj[0])
    assert abs(dt[1] - dj[1]) <= TOL * abs(dj[1])
    # the constraint residual is not div u
    div_u = tdyn.divergence(tsim.P, st.u, st.v, st.w)
    assert float(div_u.max()) != dt[1]


@pytest.mark.parametrize("form", ["divergence", "skewsymmetric"])
def test_carried_plan_takes_the_conservative_branch(form):
    """A case file keeps the anelastic set convective; a plan carried across
    with adv_form set reaches the conservative forms' 1/rho_bar weighting,
    as in tlab_tpu."""
    jsim, tsim = _both(INI_3D)
    PJ = dict(jsim.P, adv_form=form)
    PT = plans_from_jax(PJ, "cpu", F64, bodyforce=tsim.P["bodyforce"])
    u, v, w, s = _state(jsim, seed=4)
    sj, _ = jdyn.rk_step(PJ, _jstate(u, v, w, s), 2e-3, unroll=True)
    st, _ = tdyn.rk_step(PT, state_from_numpy(u, v, w, s, "cpu", F64), 2e-3)
    for a, b in zip(state_to_numpy(st), sj[:4]):
        assert _rel(a, b) <= TOL


@pytest.mark.parametrize("edits", [
    [("Staggering", "StaggerHorizontalPressure", "yes")],
    [("Main", "EllipticOrder", "compactdirect6")],
    [("Main", "TermDivergence", "none")],
    [("Main", "TermAdvection", "skewsymmetric")],
], ids=["staggered", "direct_eigen", "no_divergence_term",
        "skewsymmetric_ignored"])
def test_options_with_the_anelastic_set_match(edits):
    """The anelastic weighting on the staggered and the direct-eigen
    projections and without the q/dte term; TermAdvection stays convective
    for this set, as in tlab_tpu."""
    text = case_text(edits, INI_3D)
    jsim, tsim = _both(text)
    assert ("adv_form" in tsim.P) == ("adv_form" in jsim.P) is False \
        or edits[0][1] != "TermAdvection"
    u, v, w, s = _state(jsim, seed=5)
    sj, _ = jdyn.rk_step(jsim.P, _jstate(u, v, w, s), 2e-3, unroll=True)
    st, _ = tdyn.rk_step(tsim.P, state_from_numpy(u, v, w, s, "cpu", F64),
                         2e-3)
    for a, b in zip(state_to_numpy(st), sj[:4]):
        assert _rel(a, b) <= TOL


def test_background_is_steady():
    """tests/test_anelastic.py::test_background_is_steady on the port."""
    _, sim = _both(INI_TEXT, neutral=True)
    nx, ny, nz = sim.grid.shape
    y = sim.grid.y.nodes
    s = np.stack([np.broadcast_to(p(y)[None, :, None], (nx, ny, nz))
                  for p in sim.case.scal_profiles])
    zero = np.zeros((nx, ny, nz))
    state = state_from_numpy(zero, zero, zero, s, "cpu", F64)
    out = state
    for _ in range(5):
        out, _ = tdyn.rk_step(sim.P, out, 1e-3)
    assert float(out.v.abs().max()) < 1e-8
    assert float((out.s[0] - state.s[0]).abs().max()) < 1e-8


def test_warm_bubble_rises():
    """tests/test_anelastic.py::test_warm_bubble_rises on the port."""
    _, sim = _both(INI_TEXT, neutral=True)
    nx, ny, nz = sim.grid.shape
    y = sim.grid.y.nodes
    X = sim.grid.x.nodes[:, None, None]
    Y = y[None, :, None]
    h, qt = (p(y) for p in sim.case.scal_profiles)
    bubble = 0.01 * np.exp(-(((X - 1.0) / 0.2) ** 2 + ((Y - 0.3) / 0.1) ** 2))
    s = np.stack([np.broadcast_to(h[None, :, None], (nx, ny, nz)) + bubble,
                  np.broadcast_to(qt[None, :, None], (nx, ny, nz))])
    zero = np.zeros((nx, ny, nz))
    state = state_from_numpy(zero, zero, zero, s, "cpu", F64)
    for _ in range(20):
        state, _ = tdyn.rk_step(sim.P, state, 2e-3)
    vmax = float(state.v.max())
    assert vmax > 1e-5, vmax
    ix = np.argmin(np.abs(sim.grid.x.nodes - 1.0))
    assert float(state.v[ix, :, 0].max()) > 0.5 * vmax


# ---------------------------------------------------------------------------
# examples/cloudtop_anelastic through the CLI of both packages
# ---------------------------------------------------------------------------

CLOUD_SMALL = {("Grid", "Imax"): "32", ("Grid", "Jmax"): "24",
               ("Grid", "Kmax"): "16", ("IniGridOx", "points_1"): "33",
               ("IniGridOy", "points_1"): "24",
               ("IniGridOz", "points_1"): "17",
               ("Iteration", "End"): "4", ("Iteration", "Restart"): "4",
               ("Iteration", "Statistics"): "2"}


# This case's buoyancy grows a horizontally uniform v that the factorized
# projection's singular (kx = kz = 0) mode leaves (its NN_Sing constraint
# is a difference of O(1) numbers): that v agrees to 1.4e-8 of its max
# between the packages after 4 steps, and so the mean pressure and the
# potential energy (1.4e-8 to 1.8e-8 of their max)
SINGULAR_RTOL = 5e-8


def _cloudtop(tmp, equations):
    """`equations` with "+DtLag": the lagged dt ([Iteration] DtLag=yes)."""
    equations, _, lag = equations.partition("+")
    text = _edit(CLOUDTOP.read_text(),
                 {**CLOUD_SMALL, ("Main", "Equations"): equations})
    if lag:
        text = text.replace("IteraLog=1\n", "IteraLog=1\nDtLag=yes\n", 1)
        assert "DtLag=yes" in text
    out = {}
    for pkg in ("jax", "port"):
        d = tmp / pkg
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
        out[pkg] = d
    return text, out["jax"], out["port"]


@pytest.mark.parametrize("equations", ["incompressible", "anelastic",
                                       "incompressible+DtLag"])
def test_cloudtop_case_through_the_cli_matches(tmp_path, equations):
    text, dj, dt = _cloudtop(tmp_path, equations)
    lj = (dj / "dns.out").read_text().splitlines()
    lt = (dt / "dns.out").read_text().splitlines()
    assert len(lj) == len(lt) == 3 + 5
    assert lj[:3] == lt[:3] and "NewtonRs#" in lt[1]
    for a, b in zip(lj[3:], lt[3:]):
        assert a.split()[:9] == b.split()[:9]
        assert float(a.split()[9]) < 1e-10 and float(b.split()[9]) < 1e-10
    # the port's NewtonRs is tlab_tpu's eager function of the port's state
    sim = Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                               device="cpu")
    u, v, w, s, _, _ = tio.read_state(str(dt / "flow"), str(dt / "scal"), 4,
                                      2)
    ane = make_anelastic(sim.case, sim.grid, F64, "cpu")
    tp = jthermo.ThermoParams(**dataclasses.asdict(ane["tp"]))
    err = float(jthermo.equilibrium_newton_error(
        tp, jnp.asarray(s), {k: v.numpy() for k, v in ane["bg"].items()}))
    assert lt[-1].split()[9] == fort_e(err, 3).strip()
    for name in ("avg2", "avg4", "avg4s1", "avg4s2"):
        _, gj, cj = tavg.read_avg(str(dj / name))
        _, gt, ct = tavg.read_avg(str(dt / name))
        assert gj == gt and list(cj) == list(ct)
        for k in cj:
            rtol = SINGULAR_RTOL if k in ("rP", "Pot") else 1e-8
            assert np.max(np.abs(ct[k] - cj[k])) <= max(
                rtol * np.max(np.abs(cj[k])), 1e-13), (name, k)
    _, _, flow = tavg.read_avg(str(dt / "avg4"))
    if equations.startswith("incompressible"):
        # tlab_tpu fills no background for this combination: its explicit
        # buoyancy reads as zero in the tables (ROADMAP, reference side)
        for k in ("rB", "Buo", "rT", "rRref", "PotTemp"):
            assert np.max(np.abs(flow[k])) == 0.0, k
        assert np.all(flow["rR"] == 1.0)
    else:
        for k in ("rR", "rT", "fT", "rRref", "rTref", "rB", "RhoFluxY",
                  "BuoyFreq_fr", "LapseRate_eq", "PotTemp", "PotTemp_v",
                  "SaturationPressure", "rPref", "RelativeHumidity",
                  "Dewpoint", "LapseRate_dew"):
            assert np.max(np.abs(flow[k])) > 0.0, k


def test_newton_column_needs_airwater_and_no_third_damkohler(tmp_path):
    """dns.out has the NewtonRs column only for the AirWater mixture with
    [Parameters] Damkohler(3) <= 0, as in tlab_tpu."""
    from tlab_tpu_torch.tools import dns as tdns
    for extra, want in (("", True), ("Damkohler=0,0,1\n", False)):
        text = _edit(CLOUDTOP.read_text(), CLOUD_SMALL).replace(
            "[Parameters]\n", "[Parameters]\n" + extra)
        sim = Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                                   device="cpu")
        assert (tdns.newton_error_fn(sim) is not None) is want
    text = _edit(INI_TEXT, {("Thermodynamics", "Mixture"): "airvapor"})
    sim = Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                               device="cpu")
    assert tdns.newton_error_fn(sim) is None


# ---------------------------------------------------------------------------
# Mixture=AirWaterLinear: the diagnostic liquid column
# ---------------------------------------------------------------------------

AWL = [("Main", "TermBodyForce", "Linear"), ("Gravity", "Vector", "0,-1,0"),
       ("Gravity", "Parameters", "0.5,2.0,0.1"),
       ("Parameters", "Froude", "2.0"),
       ("Thermodynamics", "Mixture", "AirWaterLinear")]


@pytest.mark.parametrize("params", ["-11.111111111,0.0056250", None])
def test_airwaterlinear_matches(params):
    """The buoyancy of the augmented stack (liquid appended; zero liquid in
    the background profile) as a tendency and over one RK step; without
    Parameters the linear mixture is off, as in tlab_tpu."""
    from test_golden import INI
    edits = AWL + ([("Thermodynamics", "Parameters", params)]
                   if params else [])
    text = case_text(edits, INI)
    jsim, tsim = _both(text)
    u, v, w, s = _state(jsim, seed=6)
    sj = _jstate(u, v, w, s)
    st = state_from_numpy(u, v, w, s, "cpu", F64)
    fj, ft = jsim.P["bodyforce"], tsim.P["bodyforce"]
    zj = jnp.zeros_like(sj.u)
    want = fj(jsim.P, sj, zj, zj, zj, jnp.zeros_like(sj.s))
    H = torch.zeros((3 + s.shape[0],) + u.shape, dtype=F64)
    got = ft(tsim.P, st, H[0], H[1], H[2], H[3:])
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-12
    assert float(H[1].abs().max()) > 0.0
    for a, b in zip(ft.buoyancy_only(st), fj.buoyancy_only(sj)):
        assert _rel(a, b) <= 1e-12
    sj2, _ = jdyn.rk_step(jsim.P, sj, 2e-3, unroll=True)
    st2, _ = tdyn.rk_step(tsim.P, st, 2e-3)
    for a, b in zip(state_to_numpy(st2), sj2[:4]):
        assert _rel(a, b) <= TOL
    # make_sources of the same case, called directly
    hook = make_sources(tsim.case, tsim.grid, F64, "cpu")
    assert hook is not None and hook.time_dependent is False
