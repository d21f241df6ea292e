"""The port's compressible AirWater set (the compressible half of
tlab_tpu_torch/physics/thermo.py, the AirWater functions of
dycore/compressible.py and dycore/nscbc.py, attach_buffer_compressible,
the AirWater initial state and the loop's NewtonRs column) against
tlab_tpu's, float64 on the CPU:

- the thermodynamics function by function to 1e-13 (airwater_rp/_re/_ph_re,
  the thermal and caloric equations of state, the compressible units, the
  compressible hydrostatic background), the float32 inputs' Newton in
  float64, and what tests/test_thermo_mixtures.py:57-150 holds tlab_tpu to;
- tests/data/case14_small3d.ini (the reference's Case14 family: a moist
  cloud top in the compressible internal-energy set, NSCBC outflow, a
  relaxation buffer): the context, the initial state, the buffer and
  NSCBC references, one right-hand side, one RK step and five, and the
  case through both command lines (dns.out in every printed digit, the
  avg files), which also holds chip_smoke.py's 13c witness to tlab_tpu.

The x and z momenta of Case14 are the imbalance of a pressure of ~8.2e4 at
a Mach number of 0.0029 (zero at the start): the round-off of the pressure
gradient and the saturation inversion's sensitivity leave 3e-6 of
max|rho u| between two summation orders after one step, and tlab_tpu
shows the same against itself with rho moved by one ulp (ROADMAP C).  So
the momenta are held to 1e-10 of the acoustic momentum rho c, and the avg
columns to 1e-8 of their max or to 10x the spread the port's own run shows
under a one-ulp perturbation of rho, whichever is larger."""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from threadpoolctl import threadpool_limits

from tlab_tpu.config import Ini as JIni, load_case as jload_case
from tlab_tpu.dycore import compressible as jcomp
from tlab_tpu.physics import thermo as jt
from tlab_tpu.runtime import Simulation as JSimulation
from tlab_tpu.stats import averages as javg
from tlab_tpu.tools import cli as jcli
from tlab_tpu.tools.initialize import \
    compressible_initial_state as jcomp_state
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.dycore import compressible as tcomp
from tlab_tpu_torch.io import fields_io as tio
from tlab_tpu_torch.physics import thermo as tt
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.stats import averages as tavg
from tlab_tpu_torch.tools import cli
from tlab_tpu_torch.tools import dns as tdns
from tlab_tpu_torch.tools.initialize import compressible_initial_state

F64 = torch.float64
TOL = 1e-10
REPO = pathlib.Path(__file__).resolve().parent.parent
CASE14 = REPO / "tests" / "data" / "case14_small3d.ini"
MACH = 0.00286207

torch.set_num_threads(2)
threadpool_limits(1, user_api="blas")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.max(np.abs(b))
    return np.max(np.abs(a - b)) / scale if scale > 0 \
        else np.max(np.abs(a - b))


def _params():
    return (jt.compressible_airwater_params(mach=MACH),
            tt.compressible_airwater_params(mach=MACH))


def _fields(tp, n=200, seed=0):
    """Saturated and unsaturated points of the Case14 range: (qt, rho, T,
    ql, e, p) as NumPy, consistent through tlab_tpu's equations of state."""
    rng = np.random.default_rng(seed)
    qt = 0.002 + 0.012 * rng.random(n)
    rho = 0.95 + 0.04 * rng.random(n)
    T = 0.94 + 0.03 * rng.random(n)
    ql = np.where(rng.random(n) < 0.5, 0.0, 0.3 * qt * rng.random(n))
    e = np.asarray(jt.caloric_energy(tp, qt, ql, T))
    p = np.asarray(jt.thermal_pressure(tp, qt, ql, rho, T))
    return qt, rho, T, ql, e, p


def test_compressible_units_match_jax():
    """compressible_airwater_params: every property of tlab_tpu's class,
    the RRATIO-scaled Rd and psat among them, equal."""
    j, t = _params()
    props = [n for n, v in vars(jt.ThermoParams).items()
             if isinstance(v, property)]
    for prop in props:
        assert getattr(t, prop) == getattr(j, prop), prop
    assert t.rratio == j.rratio and t.cratio_inv == j.cratio_inv
    assert t.Rd == t.rratio and t.psat_cf == j.psat_cf


def test_thermodynamics_match_jax():
    """The inversions from (rho, p), (rho, e) and (p, h), and the thermal
    and caloric equations of state, on saturated and unsaturated points."""
    j, t = _params()
    qt, rho, T, ql, e, p = _fields(j)
    h = np.asarray(jt.caloric_enthalpy(j, qt, ql, T))

    def both(name, *args, **kw):
        a = getattr(tt, name)(t, *(torch.from_numpy(x) for x in args), **kw)
        b = getattr(jt, name)(j, *(jnp.asarray(x) for x in args), **kw)
        return a, b

    for name, args in (("airwater_rp", (qt, p, rho)),
                       ("airwater_re", (qt, e, rho)),
                       ("airwater_ph_re", (qt, p, h))):
        got, ref = both(name, *args)
        for a, b in zip(got, ref):
            assert _rel(a, b) <= 1e-13, name
    for name, args in (("thermal_density", (qt, ql, p, T)),
                       ("thermal_pressure", (qt, ql, rho, T)),
                       ("caloric_enthalpy", (qt, ql, T)),
                       ("caloric_energy", (qt, ql, T))):
        got, ref = both(name, *args)
        assert _rel(got, ref) <= 1e-15, name


def test_float32_inputs_take_the_newton_in_float64():
    """In a float32 run the inversion gets float32 fields: it evaluates in
    float64 and returns float32, the float64 result rounded."""
    _, t = _params()
    qt, rho, _, _, e, _ = _fields(t)
    a64 = tt.airwater_re(t, *(torch.from_numpy(x) for x in (qt, e, rho)))
    x32 = [torch.from_numpy(x).float() for x in (qt, e, rho)]
    a32 = tt.airwater_re(t, *x32)
    r64 = tt.airwater_re(t, *(x.double() for x in x32))
    for got, ref in zip(a32, r64):
        assert got.dtype == torch.float32
        assert torch.equal(got, ref.float())
    assert _rel(a32[0].double(), a64[0]) <= 1e-6


def test_hydrostatic_background_matches_jax():
    """Gravity_Hydrostatic_Enthalpy's compressible branch on Case14's
    profiles, with the compact cumulative integral and the trapezoid."""
    jsim = JSimulation.from_case(jload_case(str(CASE14)))
    j, t = _params()
    y = jsim.grid.y.nodes
    h = 0.963 - 0.0379 * np.tanh((y - 0.5) / 0.0125)
    qt = 0.00625 + 0.00475 * np.tanh((y - 0.5) / 0.0125)
    d1y = np.asarray(jsim.P["d1y"])
    for d1 in (d1y, None):
        a = tt.hydrostatic_background_compressible(
            t, y, h, qt, 82043.2, 0.5, -100.0, d1y=d1)
        b = jt.hydrostatic_background_compressible(
            j, y, h, qt, 82043.2, 0.5, -100.0, d1y=d1)
        assert set(a) == set(b)
        for k in a:
            assert _rel(a[k], b[k]) <= 1e-13, k


# tests/test_thermo_mixtures.py:57-150 on the port's functions

def test_airwater_rp_recovers_a_saturated_state():
    tp = tt.ThermoParams()
    T_star, qt = 0.95, 0.02
    ps = float(tp.psat(torch.tensor(T_star, dtype=F64)))
    qv_star = 0.015
    rho = ps / (qv_star * T_star * tp.Rv)
    p = rho * T_star * (tp.Rd * (1.0 - qt) + tp.Rv * qv_star)
    T, ql, _ = tt.airwater_rp(tp, *(torch.tensor(x, dtype=F64)
                                    for x in (qt, p, rho)))
    assert abs(float(T) - T_star) < 1e-10
    assert abs(float(ql) - (qt - qv_star)) < 1e-10
    p_dry = rho * T_star * (tp.Rd + 0.005 * tp.Rdv)
    T2, ql2, _ = tt.airwater_rp(tp, *(torch.tensor(x, dtype=F64)
                                      for x in (0.005, p_dry, rho)))
    assert float(ql2) == 0.0 and abs(float(T2) - T_star) < 1e-12


def test_airwater_re_recovers_a_saturated_state():
    tp = tt.ThermoParams()
    T_star, qv = 0.93, 0.012
    ps = float(tp.psat(torch.tensor(T_star, dtype=F64)))
    rho = ps / (qv * T_star * tp.Rv)
    for qt, nr, tol in ((0.0135, 3, 1e-7), (0.025, 25, 1e-8)):
        ql = qt - qv
        cpm = tp.Cd + qt * tp.Cdv + ql * tp.Cvl
        rm = tp.Rd + qt * tp.Rdv - ql * tp.Rv
        e = cpm * T_star - ql * tp.Lv0 - tp.cratio_inv * rm * T_star
        T, qlr, _ = tt.airwater_re(tp, *(torch.tensor(x, dtype=F64)
                                         for x in (qt, e, rho)), nr=nr)
        assert abs(float(T) - T_star) < tol
        assert abs(float(qlr) - ql) < tol


def test_airwater_ph_re_agrees_with_the_masked_newton():
    """The iterative (rho, e) route and the anelastic masked Newton solve
    the same (p, h) problem."""
    tp = tt.ThermoParams()
    rng = np.random.default_rng(5)
    n = 64
    p = torch.from_numpy(0.7 + 0.3 * rng.random(n))
    T_tgt = torch.from_numpy(0.88 + 0.1 * rng.random(n))
    qs0 = tp.qsat(T_tgt, p)
    sat = torch.from_numpy(rng.random(n) < 0.5)
    qt = torch.where(sat, qs0 + 2e-3 * torch.from_numpy(rng.random(n)),
                     0.5 * qs0)
    ql_t = torch.clamp(qt - tp.qsat(T_tgt, p), min=0.0)
    h = (tp.Cd + qt * tp.Cdv + ql_t * tp.Cvl) * T_tgt - ql_t * tp.Lv0
    T1, ql1 = tt.equilibrium_T_ql(tp, h, qt, p, torch.zeros_like(h))
    T2, ql2, _ = tt.airwater_ph_re(tp, qt, p, h, niter=8, nr=6)
    assert float((T1 - T2).abs().max()) < 2e-6
    assert float((ql1 - ql2).abs().max()) < 2e-6


# Case14

def _sims(text=None, dtype=F64):
    text = text or CASE14.read_text()
    return (JSimulation.from_case(jload_case(JIni(text=text))),
            Simulation.from_case(load_case(Ini(text=text)), dtype=dtype,
                                 device="cpu"))


@pytest.fixture(scope="module")
def case14():
    """Both simulations of Case14 and their initial states."""
    jsim, tsim = _sims()
    Uj = jcomp_state(jsim)
    Ut = compressible_initial_state(tsim)
    return jsim, tsim, Uj, Ut


def _momentum_scale(U):
    """max(rho) / M: the acoustic momentum rho c the step integrates (the
    sound speed is 1/M in these units, T ~ 1)."""
    return float(np.max(np.asarray(U.rho))) / MACH


def _close_state(a, b, tol=TOL):
    """rho, rho e and rho qt to tol of their max; the momenta to tol of the
    acoustic momentum (module docstring)."""
    scale = _momentum_scale(b)
    for name in ("rho", "rhoE"):
        assert _rel(getattr(a, name), getattr(b, name)) <= tol, name
    assert _rel(a.rhos, b.rhos) <= tol
    for name in ("rhou", "rhov", "rhow"):
        d = np.max(np.abs(np.asarray(getattr(a, name))
                          - np.asarray(getattr(b, name))))
        assert d <= tol * scale, (name, d, scale)


def test_context_matches_jax():
    """Simulation.comp of Case14: the compressible units (gamma0 replaces
    the case's gamma), the NSCBC outflow spec of any non-periodic y with
    [BoundaryConditions] SigmaOut/SigmaInf/BetaTransverse, the gravity, the
    diffusion factor, the energy variable."""
    jsim, tsim = _sims()
    jc, tc = jsim.comp, tsim.comp
    for key in ("gamma", "mach", "bounds", "gvec", "schmidt", "sfactor",
                "prandtl", "form", "energy", "ly", "lx"):
        assert tc[key] == jc[key], key
    assert dataclasses.asdict(tc["aw"]) == dataclasses.asdict(jc["aw"])
    assert dataclasses.asdict(tc["nscbc"]) == dataclasses.asdict(jc["nscbc"])
    assert tc["mixture"] is None and jc["mixture"] is None
    assert tc["nscbc"].ctan == 0.25 and tc["nscbc"].cinf == 0.25


def test_total_energy_airwater_is_refused_as_jax():
    text = CASE14.read_text().replace("Equations=internal",
                                      "Equations=total")
    with pytest.raises(NotImplementedError, match="internal-energy"):
        JSimulation.from_case(jload_case(JIni(text=text)))
    with pytest.raises(NotImplementedError, match="internal-energy"):
        Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                             device="cpu")


def test_initial_state_matches_jax(case14):
    """_airwater_compressible_state: the hydrostatic column, the density,
    the PlaneDiscrete displacement re-solved pointwise, e."""
    _, _, Uj, Ut = case14
    for a, b in zip(Ut, Uj):
        assert _rel(a, b) <= 1e-12


def test_buffer_and_nscbc_references_match_jax(case14):
    """attach_buffer_compressible: the plane-mean references of the
    conservative fields, tau, and the per-side NSCBC reference state from
    the wall rows (p through the saturation inversion: 1e-11)."""
    jsim, tsim, Uj, Ut = case14
    jsim.attach_buffer_compressible(Uj)
    tsim.attach_buffer_compressible(Ut)
    jb, tb = jsim.comp["buffer"], tsim.comp["buffer"]
    assert _rel(tb["tau"], jb["tau"]) == 0.0
    assert set(tb["refs"]) == set(jb["refs"])
    for k in jb["refs"]:
        assert _rel(tb["refs"][k], jb["refs"][k]) <= 1e-13, k
    for side in ("refs_ymin", "refs_ymax"):
        a = np.asarray(getattr(tsim.comp["nscbc"], side))
        b = np.asarray(getattr(jsim.comp["nscbc"], side))
        assert np.all(np.abs(a - b) <= 1e-11 * np.abs(b) + 1e-15), side


def test_rhs_and_primitives_match_jax(case14):
    """primitive_airwater, gamma_airwater and one rhs_airwater_internal on
    Case14's state with a velocity: the density, energy and qt tendencies
    to 1e-10 of their max, the momenta's to 1e-10 of the size of the
    pressure-gradient terms (max|p| over the smallest spacing)."""
    jsim, tsim, Uj, _ = case14
    rng = np.random.default_rng(2)
    vel = [0.3 * rng.standard_normal(Uj.rho.shape) for _ in range(3)]
    Uj = Uj._replace(rhou=Uj.rho * vel[0], rhov=Uj.rho * vel[1],
                     rhow=Uj.rho * vel[2])
    Ut = tcomp.CompState(*(torch.from_numpy(np.array(a)) for a in Uj))
    jc, tc = jsim.comp, tsim.comp
    pj = jcomp.primitive_airwater(Uj, jc["aw"])
    pt = tcomp.primitive_airwater(Ut, tc["aw"])
    for a, b in zip(pt, pj):
        assert _rel(a, b) <= 1e-13
    qt = np.asarray(Uj.rhos[0] / Uj.rho)
    assert _rel(tcomp.gamma_airwater(tc["aw"], torch.from_numpy(qt), pt[5],
                                     pt[3]),
                jcomp.gamma_airwater(jc["aw"], qt, pj[5], pj[3])) <= 1e-15
    hj, _ = jcomp.rhs_airwater_internal(jsim.P, Uj, jc["aw"], jsim.nsp.visc,
                                        jc["prandtl"], jc["schmidt"],
                                        gvec=jc["gvec"])
    ht, _ = tcomp.rhs_airwater_internal(tsim.P, Ut, tc["aw"], tsim.nsp.visc,
                                        tc["prandtl"], tc["schmidt"],
                                        gvec=tc["gvec"])
    for name in ("rho", "rhoE", "rhos"):
        assert _rel(getattr(ht, name), getattr(hj, name)) <= TOL, name
    pterm = float(np.max(np.abs(np.asarray(pj[4])))) \
        * float(np.max(np.asarray(jsim.P["iodx"])))
    for name in ("rhou", "rhov", "rhow"):
        d = np.max(np.abs(np.asarray(getattr(ht, name))
                          - np.asarray(getattr(hj, name))))
        assert d <= TOL * pterm, (name, d, pterm)


def test_rk_steps_match_jax(case14):
    """rk_step_airwater with the NSCBC outflow and the buffer, each
    package's references attached from the same state: one RK4 step and
    five of Case14's dt; NewtonRs (the max over the substeps) equal."""
    jsim, tsim, Uj, _ = case14
    Ut = tcomp.CompState(*(torch.from_numpy(np.array(a)) for a in Uj))
    jsim.attach_buffer_compressible(Uj)
    tsim.attach_buffer_compressible(Ut)
    jc, tc = jsim.comp, tsim.comp
    step = jax.jit(lambda U: jcomp.rk_step_airwater(
        jsim.P, U, 1.28e-5, jc["aw"], jsim.nsp.visc, jc["prandtl"],
        jc["schmidt"], nscbc=jc["nscbc"], ly=jc["ly"], gvec=jc["gvec"],
        buffer=jc["buffer"]))
    for n in range(1, 6):
        Uj, ej = step(Uj)
        Ut, et = tcomp.rk_step_airwater(
            tsim.P, Ut, 1.28e-5, tc["aw"], tsim.nsp.visc, tc["prandtl"],
            tc["schmidt"], nscbc=tc["nscbc"], ly=tc["ly"], gvec=tc["gvec"],
            buffer=tc["buffer"])
        if n in (1, 5):
            _close_state(Ut, Uj)
            # the last Newton step, a polynomial that cancels terms of
            # ~1e3 down to ~1e-1: XLA's fused arithmetic moves it by ~5e-9
            assert abs(float(et) - float(ej)) <= 1e-7 * float(ej)
    cj = float(jcomp.acoustic_cfl_max_airwater(jsim.P, Uj, jc["aw"]))
    ct = float(tcomp.acoustic_cfl_max_airwater(tsim.P, Ut, tc["aw"]))
    assert abs(ct - cj) <= 1e-13 * cj


@pytest.fixture(scope="module")
def case14_runs(tmp_path_factory):
    """inigrid, ini and dns of Case14 as it is (10 steps, avg at 5 and 10)
    through both command lines, float64."""
    top = tmp_path_factory.mktemp("case14")
    outs = {}
    for name, main, extra in (("torch", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, ["--cpu"])):
        out = top / name
        out.mkdir()
        (out / "tlab.ini").write_text(CASE14.read_text())
        common = ["--ini", str(out / "tlab.ini"), "--outdir", str(out),
                  "--x64", *extra]
        for command in ("inigrid", "ini", "dns"):
            assert main([command, *common]) == 0
        outs[name] = out
    return outs


def _spread(out, seeds=(1, 2, 3)):
    """The port's own avg tables from the initial state with rho moved by
    one ulp (a random sign a point), one run a seed: name -> column -> max
    over seeds of max|perturbed - unperturbed|."""
    sim = Simulation.from_case(load_case(str(out / "tlab.ini")), dtype=F64,
                               device="cpu")
    U0, _, _ = tio.read_comp_state(str(out / "flow"), 0)
    U0 = tcomp.CompState(*(torch.from_numpy(np.asarray(a)) for a in U0))
    spread = {}
    for seed in seeds:
        rng = np.random.default_rng(seed)
        sign = torch.from_numpy(rng.choice([-1.0, 1.0], U0.rho.shape))
        U = U0._replace(rho=U0.rho * (1.0 + np.finfo(float).eps * sign))
        run_dir = out / f"ulp{seed}"
        run_dir.mkdir()
        tdns.run(sim, U, outdir=str(run_dir), checkpoint=False)
        for name in ("avg5", "avg5s1", "avg10", "avg10s1"):
            _, _, cols = tavg.read_avg(str(run_dir / name))
            _, _, ref = tavg.read_avg(str(out / name))
            for k in cols:
                d = float(np.max(np.abs(cols[k] - ref[k])))
                spread.setdefault(name, {})[k] = max(
                    spread.get(name, {}).get(k, 0.0), d)
    return spread


def test_case14_through_both_clis(case14_runs):
    """dns.out in every printed digit, NewtonRs included; rho, rho e and
    rho qt to 1e-10 of their max, the momenta to 1e-10 of rho c; the avg
    files' columns to 1e-8 of their max (1e-13 absolute where a column
    vanishes) or to 10x the port's own one-ulp spread (module docstring),
    and most columns to the first."""
    t, j = case14_runs["torch"], case14_runs["jax"]
    text = (t / "dns.out").read_text()
    assert text == (j / "dns.out").read_text()
    assert "NewtonRs" in text
    Ut, _, _ = tio.read_comp_state(str(t / "flow"), 10)
    Uj, _, _ = tio.read_comp_state(str(j / "flow"), 10)
    _close_state(Ut, Uj)
    spread = _spread(t)
    strict = floor = 0
    for name in ("avg5", "avg5s1", "avg10", "avg10s1"):
        _, gj, cj = javg.read_avg(str(j / name))
        _, gt, ct = tavg.read_avg(str(t / name))
        assert gt == gj and list(ct) == list(cj)
        for n in cj:
            d = float(np.max(np.abs(cj[n] - ct[n])))
            limit = max(1e-8 * float(np.max(np.abs(cj[n]))), 1e-13)
            if d <= limit:
                strict += 1
                continue
            floor += 1
            assert name in spread, (name, n, d, limit)
            assert d <= 10.0 * spread[name][n], (name, n, d, spread[name][n])
    print(f"\ncase14 avg columns: {strict} to 1e-8 of their max, {floor} "
          "within 10x the one-ulp spread")
    assert strict > 4 * floor, (strict, floor)


def test_chip_smoke_witness_is_jax(case14_runs):
    """chip_smoke.py's 13c constants are tlab_tpu's float64 run: its
    dns.out rows, and its final state's plane means and max|rho u|."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    j = case14_runs["jax"]
    rows = [" ".join(r.split()) for r in (j / "dns.out").read_text()
            .splitlines() if not r.startswith("#")]
    assert tuple(rows) == chip_smoke.C14_ROWS
    Uj, _, _ = tio.read_comp_state(str(j / "flow"), 10)
    U = tcomp.CompState(*(torch.from_numpy(np.asarray(a)) for a in Uj))
    got = chip_smoke.plane_means(U)
    for k, v in chip_smoke.C14_MEANS.items():
        assert got[k] == pytest.approx(v, rel=1e-14), k
