"""The port's ideal-gas compressible set (tlab_tpu_torch/dycore/
compressible.py, physics/eos.py, the compressible branches of runtime,
tools/initialize, io/fields_io, tools/dns and stats/averages) against
tlab_tpu's, float64 on the CPU: the equations of state exactly, the two
energy formulations' tendencies in both Euler forms with walls and with a
periodic y, RK steps with gravity and the scalar bounds, the acoustic CFL
and the diffusion number, the initial state of tests/data/
case02_small3d.ini with and without NormalizeP, the restart files byte for
byte, that case through both command lines (dns.out with its pressure and
density columns, the avg tables), a 3 + 2 = 5 restart, and the parts that
raised until ROADMAP A13b ported them (the characteristic boundaries, a
mixture and the buffer of the step; the case options) built and stepped
as tlab_tpu's (tests/test_torch_{nscbc,mixtures,airwater}.py hold them
whole)."""
import os
import shutil

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from threadpoolctl import threadpool_limits

from tlab_tpu import grid as jgrid
from tlab_tpu.config import Ini as JIni, load_case as jload_case
from tlab_tpu.dycore import compressible as jcomp
from tlab_tpu.dycore import incompressible as jdyn
from tlab_tpu.fdm.plan import build_fdm_plan
from tlab_tpu.io import fields_io as jio
from tlab_tpu.physics import eos as jeos
from tlab_tpu.physics.params import NSParams
from tlab_tpu.runtime import Simulation as JSimulation
from tlab_tpu.stats import averages as javg
from tlab_tpu.tools import cli as jcli
from tlab_tpu.tools.initialize import \
    compressible_initial_state as jcomp_state
from tlab_tpu_torch import grid as tgrid
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.dycore import compressible as tcomp
from tlab_tpu_torch.dycore import incompressible as tdyn
from tlab_tpu_torch.fdm.plan import build_fdm_plan as tbuild_fdm_plan
from tlab_tpu_torch.io import fields_io as tio
from tlab_tpu_torch.physics import eos as teos
from tlab_tpu_torch.physics.params import NSParams as TNSParams
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.stats import averages as tavg
from tlab_tpu_torch.tools import cli
from tlab_tpu_torch.tools.initialize import compressible_initial_state

F64 = torch.float64
TOL = 1e-10
GAMMA, MACH = 1.4, 0.3
DATA = os.path.join(os.path.dirname(__file__), "data")
CASE02 = os.path.join(DATA, "case02_small3d.ini")

# the test workers share the machine's cores: with every worker's products
# on all of them, the threads spin on each other and a step takes 20x longer
torch.set_num_threads(2)
# the same holds for NumPy's BLAS, which the host plans call many times
# (small inverses and solves, each waking every BLAS thread)
threadpool_limits(1, user_api="blas")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def test_eos_matches_exactly():
    rng = np.random.default_rng(0)
    T = 0.5 + rng.random(50)
    rho = 0.5 + rng.random(50)
    for transport in ("none", "powerlaw", "sutherland"):
        gj = jeos.GasParams(gamma=1.3, mach=0.4, transport=transport)
        gt = teos.GasParams(gamma=1.3, mach=0.4, transport=transport)
        for name, args in (("temperature_from_e", (T,)),
                           ("energy_from_t", (T,)),
                           ("pressure", (rho, T)), ("density", (rho, T)),
                           ("temperature_from_rho_p", (rho, T)),
                           ("sound_speed2", (T,)), ("viscosity", (T,))):
            a = np.asarray(getattr(teos, name)(
                gt, *(torch.from_numpy(x) for x in args)))
            b = np.asarray(getattr(jeos, name)(
                gj, *(jnp.asarray(x) for x in args)))
            # the rational laws exactly; pow's last bit is the library's
            tol = 0.0 if name != "viscosity" or transport == "none" \
                else 4 * np.finfo(float).eps
            assert np.max(np.abs(a - b) / np.abs(b)) <= tol, (name, transport)


def _plans(periodic_y: bool, ns: int = 1):
    """Both packages' compressible plans of a 32 x (17 walls | 16
    periodic) x 8 box (tlab_tpu's tests/test_compressible.py's setup)."""
    def grid(mod):
        gx = mod.make_axis(np.arange(32) * (2 * np.pi / 32), True)
        gy = mod.make_axis(np.arange(16) / 16.0, True) if periodic_y \
            else mod.make_axis(np.linspace(0.0, 1.0, 17) ** 1.1, False)
        gz = mod.make_axis(np.arange(8) * (1.0 / 8), True)
        return mod.Grid(gx, gy, gz)

    kw = dict(reynolds=300.0, schmidt=(0.8,) * ns)
    sbc = (("neumann", "neumann"),) * ns
    PJ = jdyn.build_device_plans(
        build_fdm_plan(grid(jgrid)), NSParams(**kw),
        jdyn.WallBCs.from_velocity_kind("freeslip", "freeslip",
                                        scalar_bcs=sbc),
        dtype=jnp.float64, with_elliptic=False)
    PJ["y_periodic"] = periodic_y
    PT = tdyn.build_device_plans(
        tbuild_fdm_plan(grid(tgrid)), TNSParams(**kw),
        tdyn.WallBCs.from_velocity_kind("freeslip", "freeslip",
                                        scalar_bcs=sbc),
        dtype=F64, device="cpu", with_elliptic=False)
    PT["y_periodic"] = periodic_y
    assert "ell" not in PT and "ell_fac" not in PT
    return PJ, PT


def _states(PT, energy="total", ns=1, seed=1):
    """(tlab_tpu CompState, port CompState) of one random smooth-ish
    primitive state."""
    shape = PT["sizes"]
    rng = np.random.default_rng(seed)
    rho = 1.0 + 0.05 * rng.standard_normal(shape)
    u, v, w = (0.1 * rng.standard_normal(shape) for _ in range(3))
    T = 1.0 + 0.05 * rng.standard_normal(shape)
    s = rng.random((ns,) + tuple(shape)) if ns else None
    prim = (rho, u, v, w, T)
    Uj = jcomp.from_primitive(*(jnp.asarray(a) for a in prim), GAMMA, MACH,
                              s=None if s is None else jnp.asarray(s),
                              energy=energy)
    Ut = tcomp.from_primitive(*(torch.from_numpy(a) for a in prim), GAMMA,
                              MACH,
                              s=None if s is None else torch.from_numpy(s),
                              energy=energy)
    return Uj, Ut


def _close(a, b, tol=TOL):
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            assert _rel(x, y) <= tol


@pytest.mark.parametrize("periodic_y", [False, True], ids=["walls",
                                                           "periodic"])
@pytest.mark.parametrize("energy, form", [("total", "divergence"),
                                          ("total", "skewsymmetric"),
                                          ("internal", "divergence")])
def test_rhs_matches_jax(periodic_y, energy, form):
    PJ, PT = _plans(periodic_y)
    Uj, Ut = _states(PT, energy)
    if energy == "internal":
        hj = jcomp.rhs_compressible_internal(PJ, Uj, GAMMA, MACH, 1 / 300,
                                             0.7)
        ht = tcomp.rhs_compressible_internal(PT, Ut, GAMMA, MACH, 1 / 300,
                                             0.7)
    else:
        hj = jcomp.rhs_compressible(PJ, Uj, GAMMA, MACH, 1 / 300, 0.7,
                                    form=form)
        ht = tcomp.rhs_compressible(PT, Ut, GAMMA, MACH, 1 / 300, 0.7,
                                    form=form)
    _close(ht, hj)


def test_rhs_with_a_transport_law_matches_jax():
    PJ, PT = _plans(False)
    Uj, Ut = _states(PT)
    gj = jeos.GasParams(GAMMA, MACH, transport="sutherland")
    gt = teos.GasParams(GAMMA, MACH, transport="sutherland")
    _close(tcomp.rhs_compressible(PT, Ut, GAMMA, MACH, 1 / 300, 0.7, gas=gt),
           jcomp.rhs_compressible(PJ, Uj, GAMMA, MACH, 1 / 300, 0.7, gas=gj))


@pytest.mark.parametrize("periodic_y, energy, form, gvec", [
    (False, "total", "skewsymmetric", (0.0, -0.5, 0.0)),
    (False, "internal", "divergence", (0.0, -0.5, 0.0)),
    (True, "total", "divergence", (0.0, 0.0, 0.0)),
])
def test_rk_steps_match_jax(periodic_y, energy, form, gvec):
    """One RK4 step and five, with gravity and the scalar clipped to [0.1,
    0.9] each substep (the random scalar spans [0, 1])."""
    PJ, PT = _plans(periodic_y)
    PJ["scal_bounds"] = ((0.1,), (0.9,))
    PT["scal_bounds"] = tdyn.scalar_bounds((0.1,), (0.9,), F64, "cpu")
    Uj, Ut = _states(PT, energy)
    kw = dict(form=form, energy=energy, gvec=gvec)
    for n in range(1, 6):
        Uj = jcomp.rk_step_compressible(PJ, Uj, 1e-3, GAMMA, MACH, 1 / 300,
                                        0.7, **kw)
        Ut = tcomp.rk_step_compressible(PT, Ut, 1e-3, GAMMA, MACH, 1 / 300,
                                        0.7, **kw)
        if n in (1, 5):
            _close(Ut, Uj)
    s = Ut.rhos / Ut.rho[None]
    assert float(s.min()) >= 0.1 - 1e-15 and float(s.max()) <= 0.9 + 1e-15


@pytest.mark.parametrize("energy", ["total", "internal"])
def test_cfl_and_diffusion_number_match_jax(energy):
    PJ, PT = _plans(False)
    Uj, Ut = _states(PT, energy)
    assert abs(float(tcomp.acoustic_cfl_max(PT, Ut, GAMMA, MACH,
                                            energy=energy))
               - float(jcomp.acoustic_cfl_max(PJ, Uj, GAMMA, MACH,
                                              energy=energy))) \
        <= 1e-13 * float(jcomp.acoustic_cfl_max(PJ, Uj, GAMMA, MACH,
                                                energy=energy))
    dj = float(jcomp.diffusion_number_max(PJ, Uj, 0.004))
    assert abs(float(tcomp.diffusion_number_max(PT, Ut, 0.004)) - dj) \
        <= 1e-13 * dj


def test_a13b_arguments_step_as_jax():
    """rk_step_compressible's nscbc, mix and buffer arguments, which raised
    until ROADMAP A13b: one RK4 step with each, to 1e-10 of each field's
    max (an outflow at ymin over a wall at ymax; the unidecomp mixture of
    the state's one scalar; a buffer relaxing toward plane means)."""
    from tlab_tpu.dycore import nscbc as jn
    from tlab_tpu.physics import mixtures as jmx
    from tlab_tpu_torch.dycore import nscbc as tn
    from tlab_tpu_torch.physics import mixtures as tmx
    PJ, PT = _plans(False)
    Uj, _ = _states(PT, "internal")
    Ut = tcomp.CompState(*(torch.from_numpy(np.array(a)) for a in Uj))
    tau = np.linspace(1.0, 0.0, PT["sizes"][1]) ** 2
    refs = {k: np.asarray(getattr(Uj, k)).mean(axis=(0, 2))
            for k in ("rho", "rhou", "rhov", "rhow", "rhoE")}
    spec = dict(ymin="outflow", ymax="wall", p_inf=1.0 / (GAMMA * MACH ** 2))
    for kj, kt in (
            ({"nscbc": jn.NSCBCSpec(**spec)}, {"nscbc": tn.NSCBCSpec(**spec)}),
            ({"mix": jmx.build_mixture("unidecomp")},
             {"mix": tmx.build_mixture("unidecomp")}),
            ({"buffer": {"tau": jnp.asarray(tau)[None, :, None],
                         "refs": {k: jnp.asarray(v)[None, :, None]
                                  for k, v in refs.items()}}},
             {"buffer": {"tau": torch.from_numpy(tau)[None, :, None],
                         "refs": {k: torch.from_numpy(v)[None, :, None]
                                  for k, v in refs.items()}}})):
        a = tcomp.rk_step_compressible(PT, Ut, 1e-3, GAMMA, MACH, 1 / 300,
                                       0.7, energy="internal", **kt)
        b = jcomp.rk_step_compressible(PJ, Uj, 1e-3, GAMMA, MACH, 1 / 300,
                                       0.7, energy="internal", **kj)
        for x, y in zip(a, b):
            if y is not None:
                assert _rel(x, y) <= TOL, list(kt)


@pytest.mark.parametrize("edit, item", [
    ("VelocityJmin=freeslip", "VelocityJmin=outflow"),
    ("[BufferZone]\nType=none", "[BufferZone]\nType=relaxation\n"
                                "PointsJmax=8"),
    ("[Flow]", "[Thermodynamics]\nMixture=AirWater\n[Flow]"),
])
def test_from_case_builds_the_a13b_options(edit, item):
    """The case options that raised until ROADMAP A13b: case02 with an
    outflow at Jmin, a relaxation buffer, or the AirWater mixture builds
    tlab_tpu's context (the NSCBC spec, the AirWater units with outflow
    at both y ends), and the buffer attaches tlab_tpu's references."""
    import dataclasses
    with open(CASE02) as fh:
        text = fh.read()
    assert edit in text
    text = text.replace(edit, item)
    tsim = Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                                device="cpu")
    jsim = JSimulation.from_case(jload_case(JIni(text=text)))
    tc, jc = tsim.comp, jsim.comp
    assert (tc["nscbc"] is None) == (jc["nscbc"] is None)
    if tc["nscbc"] is not None:
        assert dataclasses.asdict(tc["nscbc"]) == \
            dataclasses.asdict(jc["nscbc"])
    assert (tc["aw"] is None) == (jc["aw"] is None)
    if tc["aw"] is not None:
        assert dataclasses.asdict(tc["aw"]) == dataclasses.asdict(jc["aw"])
        assert tc["gamma"] == jc["gamma"] != GAMMA
        return
    Uj = jcomp_state(jsim, seed=5)
    Ut = tcomp.CompState(*(torch.from_numpy(np.array(a)) for a in Uj))
    jsim.attach_buffer_compressible(Uj)
    tsim.attach_buffer_compressible(Ut)
    assert ("buffer" in tc) == ("buffer" in jc) == ("relaxation" in item)
    if "buffer" in tc:
        assert _rel(tc["buffer"]["tau"], jc["buffer"]["tau"]) == 0.0
        # plane means in another summation order than XLA's: 1e-13 of the
        # largest (a mean that vanishes, <rho v>, is round-off in both)
        big = max(float(np.max(np.abs(np.asarray(v))))
                  for v in jc["buffer"]["refs"].values())
        for k, v in jc["buffer"]["refs"].items():
            assert np.max(np.abs(np.asarray(tc["buffer"]["refs"][k])
                                 - np.asarray(v))) <= 1e-13 * big, k


def _case02(normalize_p=None, steps=None, start=0, restart=None,
            stats=None):
    with open(CASE02) as fh:
        text = fh.read()
    if normalize_p is not None:
        text = text.replace("NormalizeK=0.02",
                            f"NormalizeK=0.02\nNormalizeP={normalize_p}")
    if steps is not None:
        text = text.replace("End=10", f"End={steps}")
    text = text.replace("Start=0", f"Start={start}")
    if restart is not None:
        text = text.replace("Restart=10", f"Restart={restart}")
    if stats is not None:
        text = text.replace("Statistics=5", f"Statistics={stats}")
    return text


@pytest.mark.parametrize("normalize_p", [None, 1.0])
def test_initial_state_matches_jax(normalize_p):
    """The compressible initial state of case02_small3d.ini: velocity, the
    density and the energy to 1e-11 of their max (the initializers'
    limit); NormalizeP moves the density."""
    text = _case02(normalize_p)
    jsim = JSimulation.from_case(jload_case(JIni(text=text)))
    tsim = Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                                device="cpu")
    Uj = jcomp_state(jsim, seed=5)
    Ut = compressible_initial_state(tsim, seed=5)
    _close(Ut, Uj, 1e-11)
    moved = float((Ut.rho - 1.0).abs().max())
    assert (moved > 1e-6) == (normalize_p is not None)


def test_restart_files_are_byte_for_byte(tmp_path):
    text = _case02()
    jsim = JSimulation.from_case(jload_case(JIni(text=text)))
    Uj = jcomp_state(jsim, seed=5)
    Ut = tcomp.CompState(*(None if a is None else torch.from_numpy(
        np.asarray(a)) for a in Uj))
    jio.write_comp_state(str(tmp_path / "j"), 3, Uj, 0.25, 1e-3)
    tio.write_comp_state(str(tmp_path / "t"), 3, Ut, 0.25, 1e-3)
    for tag in ("1", "2", "3", "4", "5", "s1"):
        assert (tmp_path / f"t.3.{tag}").read_bytes() == \
            (tmp_path / f"j.3.{tag}").read_bytes()
    back, rtime, visc = tio.read_comp_state(str(tmp_path / "t"), 3)
    assert (rtime, visc) == (0.25, 1e-3)
    for a, b in zip(back, Uj):
        assert np.array_equal(a, np.asarray(b))


@pytest.fixture(scope="module")
def case02_runs(tmp_path_factory):
    """ini + dns of case02_small3d.ini cut to 5 steps (statistics at 5)
    through both command lines."""
    top = tmp_path_factory.mktemp("case02")
    text = _case02(steps=5, restart=5)
    outs = {}
    for name, main, extra in (("torch", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, ["--cpu"])):
        out = top / name
        out.mkdir()
        (out / "tlab.ini").write_text(text)
        common = ["--ini", str(out / "tlab.ini"), "--outdir", str(out),
                  "--x64", *extra]
        assert main(["ini", *common]) == 0
        assert main(["dns", *common]) == 0
        outs[name] = out
    return outs


def test_case02_through_both_clis(case02_runs):
    """dns.out to every printed digit (its PMin PMax RMin RMax columns),
    the conservative fields to 1e-10 of their max, every avg column to 1e-8
    of its max, the Favre ones filled."""
    t, j = case02_runs["torch"], case02_runs["jax"]
    text = (t / "dns.out").read_text()
    assert text == (j / "dns.out").read_text()
    assert "PMin       PMax       RMin       RMax" in text
    rows = [r.split() for r in text.splitlines() if not r.startswith("#")]
    assert len(rows) == 6 and all(len(r) == 11 for r in rows)
    assert all(float(r[4]) == 1.2 for r in rows)             # TimeCFL
    for tag in ("1", "2", "3", "4", "5", "s1"):
        a = tio.read_field(str(t / f"flow.5.{tag}"))[0]
        b = jio.read_field(str(j / f"flow.5.{tag}"))[0]
        assert np.max(np.abs(a - b)) <= TOL * np.max(np.abs(b)), tag
    for name in ("avg5", "avg5s1"):
        _, gj, cj = javg.read_avg(str(j / name))
        _, gt, ct = tavg.read_avg(str(t / name))
        assert gt == gj and list(ct) == list(cj)
        for n in cj:
            assert np.max(np.abs(cj[n] - ct[n])) <= max(
                1e-8 * np.max(np.abs(cj[n])), 1e-13), (name, n)
    _, _, flow = tavg.read_avg(str(t / "avg5"))
    for n in ("rR", "fU", "fT", "re", "fh", "rs", "C2", "Rho_ac", "RhoDil1",
              "Gyy", "Dyy"):
        assert np.isfinite(flow[n]).all() and np.abs(flow[n]).max() > 0, n
    assert np.all(flow["rR"] != 1.0)


def test_restart_3_plus_2_is_5(case02_runs, tmp_path):
    """3 steps, the restart files, 2 more: the fields of step 5 bit for bit
    (the dt of each step comes from the state, which the files hold
    exactly), dns.out rows 4 and 5 equal."""
    ref = case02_runs["torch"]
    for f in os.listdir(ref):
        if f.startswith("flow.0."):
            shutil.copy(ref / f, tmp_path / f)
    common = ["--ini", str(tmp_path / "tlab.ini"), "--outdir",
              str(tmp_path), "--device", "cpu", "--x64"]
    (tmp_path / "tlab.ini").write_text(_case02(steps=3, restart=3))
    assert cli.main(["dns", *common]) == 0
    (tmp_path / "tlab.ini").write_text(_case02(steps=5, start=3, restart=5))
    assert cli.main(["dns", *common]) == 0
    for tag in ("1", "2", "3", "4", "5", "s1"):
        assert (tmp_path / f"flow.5.{tag}").read_bytes() == \
            (ref / f"flow.5.{tag}").read_bytes(), tag
    rows = {int(r.split()[1]): r for r in
            (tmp_path / "dns.out").read_text().splitlines()
            if not r.startswith("#")}
    ref_rows = {int(r.split()[1]): r for r in
                (ref / "dns.out").read_text().splitlines()
                if not r.startswith("#")}
    assert rows[4] == ref_rows[4] and rows[5] == ref_rows[5]


@pytest.mark.parametrize("keys", [
    "[Iteration]\nDtLag=yes\n",
    "[Control]\nFlowLimit=yes\nMaxDensity=1.0001\n",
], ids=["dtlag", "bounds"])
def test_case02_loop_keys_through_both_clis(tmp_path, keys):
    """The compressible loop's own keys through both command lines, 4
    steps with a restart file each: DtLag (dt from the previous step's CFL)
    and a [Control] density bound the run passes (status 2, tlab.err, the
    restart files of the step it stops at): dns.out to every printed digit,
    tlab.err and the last fields alike."""
    section = keys.split("\n", 1)[0]
    text = _case02(steps=4, restart=1)
    text = text.replace(section + "\n", keys, 1) if section in text \
        else text + "\n" + keys
    outs = {}
    for name, main, extra in (("torch", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, ["--cpu"])):
        out = tmp_path / name
        out.mkdir()
        (out / "tlab.ini").write_text(text)
        common = ["--ini", str(out / "tlab.ini"), "--outdir", str(out),
                  "--x64", *extra]
        assert main(["ini", *common]) == 0
        main(["dns", *common])
        outs[name] = out
    t, j = outs["torch"], outs["jax"]
    log = (t / "dns.out").read_text()
    assert log == (j / "dns.out").read_text()
    rows = [r.split() for r in log.splitlines() if not r.startswith("#")]
    stopped = section == "[Control]"
    assert [r[0] for r in rows][-1] == ("2" if stopped else "0")
    assert (t / "tlab.err").exists() == stopped == (j / "tlab.err").exists()
    last = rows[-1][1]
    if stopped:
        assert int(last) < 4
        assert (t / "tlab.err").read_text() == (j / "tlab.err").read_text()
    for tag in ("1", "2", "3", "4", "5", "s1"):
        a = tio.read_field(str(t / f"flow.{last}.{tag}"))[0]
        b = jio.read_field(str(j / f"flow.{last}.{tag}"))[0]
        assert np.max(np.abs(a - b)) <= TOL * np.max(np.abs(b)), tag
