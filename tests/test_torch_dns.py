"""The port's DNS time loop (tlab_tpu_torch/tools/dns.py) against tlab_tpu's,
float64 on the CPU, both started from the same state.

dns.out holds 7 (time) or 4 (the other columns) printed digits, so "every
numeric column to 1e-9 relative" asks for the same printed digits; the
final states agree to 1e-10 of max|field| (measured ~1e-14 after 10
steps).  Restart identity within the port is bit for bit."""
import os

import numpy as np
import pytest
import torch

from tlab_tpu.config import Ini as JIni, load_case as jload_case
from tlab_tpu.dycore import incompressible as jdyn
from tlab_tpu.dycore.state import State as JState
from tlab_tpu.stats import averages as javg
from tlab_tpu.io import fields_io as jio
from tlab_tpu.runtime import Simulation as JSimulation
from tlab_tpu.tools import dns as jdns
from tlab_tpu.tools.initialize import initial_state as jinitial_state
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.convert import state_from_numpy, state_to_numpy
from tlab_tpu_torch.io import fields_io as tio
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.stats import averages as tavg
from tlab_tpu_torch.tools import dns as tdns
from tlab_tpu_torch.tools.initialize import initial_state

DATA = os.path.join(os.path.dirname(__file__), "data")
CASE3D = os.path.join(DATA, "case01_small3d.ini")
CASE2D = os.path.join(DATA, "case01_small.ini")
F64 = torch.float64

# the test workers share the machine's cores: with every worker's products
# on all of them, the threads spin on each other and a step takes 20x longer
torch.set_num_threads(2)


def _text(extra="", replace=()):
    with open(CASE3D) as fh:
        text = fh.read()
    for old, new in replace:
        assert old in text
        text = text.replace(old, new)
    return text + extra


@pytest.fixture(scope="module")
def start():
    """tlab_tpu's initial state of the 3-D case, as NumPy arrays."""
    st = jinitial_state(JSimulation.from_case(jload_case(CASE3D)), seed=7)
    return tuple(np.asarray(a) for a in (st.u, st.v, st.w, st.s))


def _run_both(tmp_path, start, text, n_steps=10, **kw):
    """The same run through both packages; returns (jax run, port run)."""
    jsim = JSimulation.from_case(jload_case(JIni(text=text)))
    tsim = Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                                device="cpu")
    u, v, w, s = start
    runs = []
    for mod, sim, state, sub in (
            (jdns, jsim, JState(u=u, v=v, w=w, s=s), "jax"),
            (tdns, tsim, state_from_numpy(u, v, w, s, "cpu", F64), "torch")):
        out = tmp_path / sub
        out.mkdir()
        runs.append(mod.run(sim, state, outdir=str(out), n_steps=n_steps,
                            log_path=str(out / "dns.out"), **kw))
    return runs


def _rows(log):
    return [[float(x) for x in ln.split()] for ln in log.lines
            if not ln.startswith("#")]


def _assert_same_run(rj, rt, n_rows):
    rows_j, rows_t = _rows(rj.log), _rows(rt.log)
    assert len(rows_j) == len(rows_t) == n_rows
    for a, b in zip(rows_j, rows_t):
        assert len(a) == len(b) == 9
        for x, y in zip(a, b):
            assert abs(x - y) <= 1e-9 * abs(x), (a, b)
    assert rt.itime == rj.itime
    assert abs(rt.rtime - rj.rtime) <= 1e-12 * abs(rj.rtime)
    for a, b in zip(state_to_numpy(rj.state), state_to_numpy(rt.state)):
        assert np.max(np.abs(a - b)) <= 1e-10 * np.max(np.abs(a))


def test_ten_adaptive_steps_match_jax(tmp_path, start):
    rj, rt = _run_both(tmp_path, start, _text())
    _assert_same_run(rj, rt, 11)
    assert rt.log.lines[:3] == rj.log.lines[:3]         # header and row 0
    names = sorted(os.listdir(tmp_path / "torch"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        "avg10", "avg10s1", "avg5", "avg5s1", "dns.out", "flow.10.1",
        "flow.10.2", "flow.10.3", "scal.10.1", "tlab.log"]
    # each package reads the other's restart
    got = tio.read_state(str(tmp_path / "jax" / "flow"),
                         str(tmp_path / "jax" / "scal"), 10, 1)
    for a, b in zip(got[:4], state_to_numpy(rj.state)):
        assert np.array_equal(a, b)
    got = jio.read_state(str(tmp_path / "torch" / "flow"),
                         str(tmp_path / "torch" / "scal"), 10, 1)
    for a, b in zip(got[:4], state_to_numpy(rt.state)):
        assert np.array_equal(a, b)
    log = (tmp_path / "torch" / "tlab.log").read_text()
    assert "Devices          : cpu" in log and "float64" in log


STRATIFIED = """
[Gravity]
Type=Linear
Vector=0.0,-1.0,0.0
Parameters=1.0

[Rotation]
Type=explicit
Vector=0.0,1.0,0.25
"""
CASE_FILTER = os.path.join(DATA, "case_filter_small3d.ini")


def _case_runs(tmp_path, text, n_steps=10):
    """`ini` then `dns` of one case text through both packages.  The two
    initial states agree to 1e-11 of max|field| (the initializers' limit);
    both runs then start from tlab_tpu's, so that the fields can be held to
    1e-12.  Returns (jax run, port run)."""
    jsim = JSimulation.from_case(jload_case(JIni(text=text)))
    tsim = Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                                device="cpu")
    sj = jinitial_state(jsim, seed=7)
    st = initial_state(tsim, seed=7)
    for a, b in zip(state_to_numpy(st), state_to_numpy(sj)):
        assert np.max(np.abs(a - b)) <= 1e-11 * max(np.max(np.abs(b)), 1.0)
    runs = []
    st = state_from_numpy(*state_to_numpy(sj), "cpu", F64)
    for mod, sim, state, sub in ((jdns, jsim, sj, "jax"),
                                 (tdns, tsim, st, "torch")):
        out = tmp_path / sub
        out.mkdir()
        runs.append(mod.run(sim, state, outdir=str(out), n_steps=n_steps,
                            log_path=str(out / "dns.out")))
    return runs


def _assert_same_files(tmp_path, rj, rt, steps, field_tol):
    """dns.out to every printed digit, the final fields to `field_tol` of
    max|field|, every avg column of the files to 1e-8 of its max: they
    hold 9 printed digits, so two values that differ at round-off can
    print one unit of the last digit apart (1e-13 absolute for the columns
    that vanish analytically).  `_tables` holds the tables in memory to
    1e-9."""
    text_j = (tmp_path / "jax" / "dns.out").read_text()
    text_t = (tmp_path / "torch" / "dns.out").read_text()
    assert text_t == text_j
    assert len(_rows(rt.log)) == steps + 1
    for a, b in zip(state_to_numpy(rj.state), state_to_numpy(rt.state)):
        assert np.max(np.abs(a - b)) <= field_tol * np.max(np.abs(a))
    for name in (f"avg{steps}", f"avg{steps}s1"):
        _, gj, cj = javg.read_avg(str(tmp_path / "jax" / name))
        _, gt, ct = tavg.read_avg(str(tmp_path / "torch" / name))
        assert gt == gj and list(ct) == list(cj)
        for n in cj:                 # the files hold 9 printed digits
            assert np.max(np.abs(cj[n] - ct[n])) <= max(
                1e-8 * np.max(np.abs(cj[n])), 1e-13), (name, n)


def _tables(rj, rt):
    """Both packages' tables of their final states, with the pressure of
    one more tlab_tpu step: every written column to 1e-9 of its max."""
    pj = jdyn.rk_step(rj.sim.P, rj.state, 1e-3)[1]
    flow_j, scal_j = javg.make_stats_tables_fn(rj.sim)(rj.state, pj)
    flow_t, scal_t = tavg.stats_tables(
        rt.sim, rt.state, torch.from_numpy(np.array(pj)))
    for ref, got, groups in ((flow_j, flow_t, tavg.FLOW_GROUPS),
                             (scal_j[0], scal_t[0], tavg.scal_groups(1))):
        # the written columns (the tables also carry the legacy aliases)
        for n in (n for _, names in groups for n in names.split()):
            a = np.asarray(ref[n], np.float64)
            b = np.asarray(got[n], np.float64)
            assert np.isfinite(b).all(), n
            assert np.max(np.abs(a - b)) <= max(1e-9 * np.max(np.abs(a)),
                                                1e-13), n
    return flow_t, scal_t[0]


def test_filter_case_matches_jax(tmp_path):
    """tests/data/case_filter_small3d.ini: the [Filter] cadence (compact,
    every 2 steps) and the Helmholtz [PressureFilter]."""
    with open(CASE_FILTER) as fh:
        text = fh.read()
    rj, rt = _case_runs(tmp_path, text)
    assert rt.sim.filter_matrices() is not None
    assert "helmholtz_alpha" in rt.sim.P["pfilter"]
    _assert_same_files(tmp_path, rj, rt, 10, 1e-12)
    _tables(rj, rt)
    # the filter is applied: the same run without it ends elsewhere
    (tmp_path / "plain").mkdir()
    _, plain = _port_run(tmp_path / "plain",
                         text.replace("[Filter]\nType=compact",
                                      "[Filter]\nType=none"),
                         initial_state(rt.sim, seed=7), n_steps=10)
    assert float((plain.state.u - rt.state.u).abs().max()) > 1e-6


def test_stratified_rotating_case_matches_jax(tmp_path):
    """case01_small3d.ini with a linear stratification and an explicit
    Coriolis force: dns.out, fields, and the avg tables with their buoyancy
    and Coriolis columns."""
    rj, rt = _case_runs(tmp_path, _text(STRATIFIED))
    assert rt.sim.P["bodyforce"] is not None
    _assert_same_files(tmp_path, rj, rt, 10, 1e-12)
    flow, scal = _tables(rj, rt)
    for n in ("rB", "Byy", "Buo", "Pot", "Fxx", "Fxz"):
        assert np.max(np.abs(flow[n])) > 0, n
    for n in ("Bsv", "Fsu", "Fsw"):
        assert np.max(np.abs(scal[n])) > 0, n
    assert not np.any(flow["Bxx"]) and not np.any(flow["Fyy"])
    _, _, written = tavg.read_avg(str(tmp_path / "torch" / "avg10"))
    assert np.max(np.abs(written["rB"])) > 0


def test_filter_cadence_forces_single_steps(tmp_path):
    """With a [Filter] the window is one step, as in tlab_tpu: the log has
    a row a step whatever inner_steps asks for."""
    with open(CASE_FILTER) as fh:
        text = fh.read()
    _, run = _port_run(tmp_path, text, n_steps=4, inner_steps=2)
    assert [int(r[1]) for r in _rows(run.log)] == [0, 1, 2, 3, 4]


def test_inner_steps_window_matches_jax(tmp_path, start):
    """inner_steps=5: dt is fixed within a window, the log has a row a
    window."""
    rj, rt = _run_both(tmp_path, start, _text(), inner_steps=5)
    _assert_same_run(rj, rt, 3)
    assert [int(r[1]) for r in _rows(rt.log)] == [0, 5, 10]


def test_fixed_time_step_matches_jax(tmp_path, start):
    text = _text(replace=[("TimeStep=-0.016", "TimeStep=0.004")])
    rj, rt = _run_both(tmp_path, start, text, n_steps=4)
    _assert_same_run(rj, rt, 5)
    assert all(r[3] == 0.004 for r in _rows(rt.log))
    assert rt.rtime == pytest.approx(0.016, rel=1e-14)


def test_visc_change_ramp_matches_jax(tmp_path, start):
    """A restart viscosity of twice the case's relaxes to it over
    [ViscChange] Time; the ramp ends inside the run."""
    text = _text("\n[ViscChange]\nTime=0.05\n")
    rj, rt = _run_both(tmp_path, start, text, n_steps=6, restart_visc=2e-3)
    _assert_same_run(rj, rt, 7)
    visc = [r[6] for r in _rows(rt.log)]
    assert visc[0] == 2e-3 and visc[-1] == 1e-3
    assert all(a >= b for a, b in zip(visc, visc[1:])) and visc[1] < 2e-3


def test_dt_lag_matches_jax(tmp_path, start):
    text = _text(replace=[("IteraLog=1", "IteraLog=1\nDtLag=yes")])
    rj, rt = _run_both(tmp_path, start, text, n_steps=4)
    _assert_same_run(rj, rt, 5)


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

def _port_run(tmp_path, text_or_path, state=None, seed=7, **kw):
    case = load_case(text_or_path if os.path.exists(text_or_path)
                     else Ini(text=text_or_path))
    sim = Simulation.from_case(case, dtype=F64, device="cpu")
    if state is None:
        state = initial_state(sim, seed=seed)
    return sim, tdns.run(sim, state, outdir=str(tmp_path),
                         log_path=str(tmp_path / "dns.out"), **kw)


def test_max_dilatation_aborts(tmp_path, start):
    """[Control] MaxDilatation: status 3, tlab.err, and a checkpoint of the
    step that broke the bound."""
    text = _text("\n[Control]\nMaxDilatation=1e-6\n")
    _, run = _port_run(tmp_path, text,
                       state_from_numpy(*start, "cpu", F64))
    rows = _rows(run.log)
    assert len(rows) == 2 and rows[-1][0] == 3 and run.itime == 1
    assert "Dilatation out of bounds at It1" in \
        (tmp_path / "tlab.err").read_text()
    u = tio.read_field(str(tmp_path / "flow.1.1"))[0]
    assert np.array_equal(u, run.state.u.numpy())
    assert (tmp_path / "scal.1.1").exists()


def test_nan_aborts(tmp_path, start):
    state = state_from_numpy(*start, "cpu", F64)
    state.u[3, 4, 5] = float("nan")
    _, run = _port_run(tmp_path, _text(), state)
    last = run.log.lines[-1].split()
    assert last[0] == "1" and last[4] == "NaN" and run.itime == 1
    assert (tmp_path / "flow.1.1").exists()     # the post-mortem checkpoint
    _, run = _port_run(tmp_path, _text(), state, nan_abort=False, n_steps=2)
    assert run.itime == 2


def test_single_precision_restart_and_profiling(tmp_path, start):
    text = _text(replace=[("[Main]", "[Main]\nFileType=single\n"
                                     "Profiling=yes")])
    _, run = _port_run(tmp_path, text,
                       state_from_numpy(*start, "cpu", F64), n_steps=10)
    assert (tmp_path / "flow.10.1").stat().st_size == \
        20 + 16 + 4 * 128 * 64 * 16
    prof = (tmp_path / "dns.prof").read_text().splitlines()
    assert "on cpu" in prof[0] and "TPU" not in prof[0]
    assert len(prof) == 3 + 10
    assert run.log.lines[-1].startswith("# profiling:")


def test_runtime_watchdog_stops_the_run(tmp_path, start):
    text = _text(replace=[("IteraLog=1", "IteraLog=1\nRuntime=0.0")])
    _, run = _port_run(tmp_path, text,
                       state_from_numpy(*start, "cpu", F64))
    assert run.itime == 1 and (tmp_path / "flow.1.1").exists()
    assert "Maximum walltime" in (tmp_path / "tlab.err").read_text()


def test_obs_log(tmp_path, start):
    text = _text(replace=[("IteraLog=1", "IteraLog=1\nObsLog=Ekman")])
    _, run = _port_run(tmp_path, text,
                       state_from_numpy(*start, "cpu", F64), n_steps=2)
    rows = (tmp_path / "dns.obs").read_text().splitlines()
    assert len(rows) == 2 and len(rows[0].split()) == 6


def test_restart_identity(tmp_path, start):
    """4 + 4 steps through a restart file equal 8 steps straight, bit for
    bit: <f8 files hold the state exactly and rtime travels in the header."""
    state = state_from_numpy(*start, "cpu", F64)
    text = _text(replace=[("Restart=10", "Restart=4")])
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    _, straight = _port_run(tmp_path / "a", text, state, n_steps=8)
    sim, first = _port_run(tmp_path / "b", text, state, n_steps=4)
    u, v, w, s, rtime, visc = tio.read_state(
        str(tmp_path / "b" / "flow"), str(tmp_path / "b" / "scal"), 4, 1)
    assert rtime == first.rtime and visc == sim.nsp.visc
    _, second = _port_run(tmp_path / "b", text,
                          state_from_numpy(u, v, w, s, "cpu", F64),
                          itime=4, rtime=float(rtime), n_steps=4,
                          restart_visc=float(visc))
    assert second.itime == straight.itime == 8
    assert second.rtime == straight.rtime
    for a, b in zip(second.state[:4], straight.state[:4]):
        assert torch.equal(a, b)
    assert second.log.lines[-4:] == straight.log.lines[-4:]


@pytest.mark.parametrize("kw, item", [(dict(mesh=object()), "A17")])
def test_unported_arguments_raise(tmp_path, start, kw, item):
    sim = Simulation.from_case(load_case(CASE3D), dtype=F64, device="cpu")
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        tdns.run(sim, state_from_numpy(*start, "cpu", F64),
                 outdir=str(tmp_path), n_steps=1, **kw)


def test_particles_once_refused_run_as_jax(tmp_path, start):
    """dns.run with particles (pstate, particle_props), refused until they
    were ported: 4 steps of the 3-D case with 200 tracers through both
    packages, restarts at step 2 and 4: dns.out in its printed digits, the
    final flow and positions to 1e-10 of their max, part.2 and part.4."""
    from tlab_tpu.particles import core as jpc
    from tlab_tpu_torch.particles import core as tpc
    from tlab_tpu_torch.particles.io import read_particles
    text = _text(replace=[("Restart=10", "Restart=2")])
    jsim = JSimulation.from_case(jload_case(JIni(text=text)))
    tsim = Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                                device="cpu")
    u, v, w, s = start
    runs = []
    for mod, sim, state, pmod, kw, sub in (
            (jdns, jsim, JState(u=u, v=v, w=w, s=s), jpc, {}, "jax"),
            (tdns, tsim, state_from_numpy(u, v, w, s, "cpu", F64), tpc,
             {"device": "cpu"}, "torch")):
        out = tmp_path / sub
        out.mkdir()
        ps = pmod.init_particles(sim.grid, 200, seed=4, **kw)
        runs.append(mod.run(sim, state, outdir=str(out), n_steps=4,
                            log_path=str(out / "dns.out"), pstate=ps,
                            particle_props=pmod.ParticleProps()))
    rj, rt = runs
    _assert_same_run(rj, rt, 5)
    x = rt.pstate.x.numpy()
    assert np.max(np.abs(x - np.asarray(rj.pstate.x))) <= 1e-10 * \
        np.max(np.abs(x))
    for it in (2, 4):
        a, _ = read_particles(str(tmp_path / "jax" / f"part.{it}"),
                              device="cpu")
        b, _ = read_particles(str(tmp_path / "torch" / f"part.{it}"),
                              device="cpu")
        assert torch.equal(a.tags, b.tags)
        assert float((a.x - b.x).abs().max()) <= 1e-10 * float(
            a.x.abs().max())


@pytest.mark.parametrize("extra, prefix", [
    ("\n[SavePlanes]\nPlanesJ=3\n", "planes"),
    ("\n[SaveTowers]\nStride=4,4,4\n", "tower.")])
def test_case_options_once_refused_run_as_jax(tmp_path, start, extra,
                                              prefix):
    """[SavePlanes] and [SaveTowers], refused until this slice: 4 steps of
    the 3-D case (planes every 2 steps, restarts and the towers' flush at
    2 and 4) through both packages: the same run, the same files, each
    equal to the run's round-off."""
    text = _text(extra, replace=[("Restart=10", "Restart=2"),
                                 ("IteraLog=1", "IteraLog=1\nSavePlanes=2")])
    rj, rt = _run_both(tmp_path, start, text, n_steps=4)
    _assert_same_run(rj, rt, 5)
    names = sorted(n for n in os.listdir(tmp_path / "jax")
                   if n.startswith(prefix))
    assert names and names == sorted(
        n for n in os.listdir(tmp_path / "torch") if n.startswith(prefix))
    dt, tol = ("<f4", 1e-6) if prefix == "planes" else ("<f8", 1e-10)
    for n in names:
        a = np.fromfile(tmp_path / "jax" / n, dt)
        b = np.fromfile(tmp_path / "torch" / n, dt)
        assert np.abs(a - b).max() <= tol * np.abs(a).max(), n


@pytest.mark.parametrize("key", ["Pdfs", "Spectrums", "Intermittency"])
def test_inrun_statistics_match_jax(tmp_path, start, key):
    """[Statistics] Pdfs / Spectrums / Intermittency (+ Correlations), once
    refused: 2 steps with statistics every step through both packages: the
    same files; the spectra to 1e-6 of their max (float32 files of states
    1e-14 apart), the plane fractions to tlab_tpu's float32 rounding, the
    pdf counts within one sample a row (the sample on a trimmed edge,
    ROADMAP C 24)."""
    from tlab_tpu_torch.io import reference_formats as rf
    extra = f"\n[Statistics]\n{key}=yes\nCorrelations=yes\n"
    rj, rt = _run_both(tmp_path, start, _text(extra, [(
        "Statistics=5", "Statistics=1")]), n_steps=2)
    names = sorted(n for n in os.listdir(tmp_path / "jax")
                   if n[:3] in ("pdf", "int", "xsp", "zsp", "xcr", "zcr"))
    assert names == sorted(n for n in os.listdir(tmp_path / "torch")
                           if n[:3] in ("pdf", "int", "xsp", "zsp", "xcr",
                                        "zcr"))
    assert len(names) == {"Pdfs": 8, "Spectrums": 32, "Intermittency": 2}[key]
    for n in names:
        a, b = tmp_path / "torch" / n, tmp_path / "jax" / n
        if n.startswith("pdf"):
            ca, cb = rf.read_pdf_file(str(a))[2], rf.read_pdf_file(str(b))[2]
            assert np.all(np.abs(ca[:, :32] - cb[:, :32]).sum(1) <= 1), n
        elif n.startswith("int"):
            ga = tavg.read_table(str(a))["gamma"]
            gb = javg.read_table(str(b))["gamma"]
            assert np.max(np.abs(ga - gb)) <= 1e-7, n
        else:
            fa, fb = np.fromfile(a, "<f4"), np.fromfile(b, "<f4")
            assert np.max(np.abs(fa - fb)) <= 1e-6 * np.max(np.abs(fb)), n


def test_phase_average_matches_jax(tmp_path, start):
    """[Iteration] PhaseAvg=2, once refused: 4 steps with a restart at 4
    through both packages: phavg4.npz with 2 accumulations in 2 slots, the
    sums (the diagnostic pressure's among them) to 1e-10."""
    text = _text(replace=[("IteraLog=1", "IteraLog=1\nPhaseAvg=2"),
                          ("Restart=10", "Restart=4")])
    _run_both(tmp_path, start, text, n_steps=4)
    a = np.load(tmp_path / "torch" / "phavg4.npz")
    b = np.load(tmp_path / "jax" / "phavg4.npz")
    assert sorted(a.files) == sorted(b.files)
    assert list(a["counts"]) == list(b["counts"]) == [1, 1]
    for k in ("sums", "stress_sums"):
        assert np.max(np.abs(a[k] - b[k])) <= 1e-10 * np.max(np.abs(b[k]))


def test_inflow_runs_as_jax(tmp_path, start):
    """dns.run's `inflow`, refused until it was ported: the 3-D case in
    spatial mode with Imin/Imax strips fed by an inflow box taken from the
    start (dycore/inflow.from_temporal_snapshot, swept at the co-flow's
    speed), 4 steps through both packages: dns.out in every printed digit,
    the final state to 1e-10."""
    from tlab_tpu.dycore import inflow as jinflow
    from tlab_tpu_torch.dycore import inflow as tinflow
    text = _text(replace=[("Type=temporal", "Type=spatial"),
                          ("[BufferZone]\nType=none",
                           "[BufferZone]\nType=relaxation\nPointsImin=6\n"
                           "PointsImax=6")])
    jsim = JSimulation.from_case(jload_case(JIni(text=text)))
    tsim = Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                                device="cpu")
    u, v, w, s = start
    rng = np.random.default_rng(9)
    box = JState(u=u + 0.1 * rng.standard_normal(u.shape), v=v, w=w, s=s)
    lx = float(jsim.grid.x.scale)
    runs = []
    for mod, sim, state, inflow, sub in (
            (jdns, jsim, JState(u=u, v=v, w=w, s=s),
             jinflow.from_temporal_snapshot(box, 1.0, lx, adapt=0.01),
             "jax"),
            (tdns, tsim, state_from_numpy(u, v, w, s, "cpu", F64),
             tinflow.from_temporal_snapshot(box, 1.0, lx, adapt=0.01),
             "torch")):
        out = tmp_path / sub
        out.mkdir()
        runs.append(mod.run(sim, state, outdir=str(out), n_steps=4,
                            log_path=str(out / "dns.out"), inflow=inflow))
    rj, rt = runs
    assert (tmp_path / "torch" / "dns.out").read_text() == \
        (tmp_path / "jax" / "dns.out").read_text()
    for a, b in zip(state_to_numpy(rj.state), state_to_numpy(rt.state)):
        assert np.max(np.abs(a - b)) <= 1e-10 * np.max(np.abs(a))
    assert sorted(rt.sim.P["buffer"]) == ["refs_x", "tau_x"]


def test_step_rejects_unported_aux_keys(start):
    sim = Simulation.from_case(load_case(CASE3D), dtype=F64, device="cpu")
    step, _ = tdns.make_step_functions(sim)
    with pytest.raises(NotImplementedError, match="Do not port"):
        step(state_from_numpy(*start, "cpu", F64), 1e-3,
             extra={"fac_tables": None})
    # the step's time passes through to the body forces
    state, _, diag = step(state_from_numpy(*start, "cpu", F64), 1e-3,
                          extra={"rtime": 0.5})
    assert diag.shape == (3,) and bool(torch.isfinite(diag).all())


# ---------------------------------------------------------------------------
# the five checks of tests/test_case_e2e.py, on the port (2-D case)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def case_run(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("case01")
    sim, run = _port_run(outdir, CASE2D, n_steps=10)
    return sim, run, outdir


def test_log_structure(case_run):
    sim, run, outdir = case_run
    data_lines = [ln for ln in run.log.lines if not ln.startswith("#")]
    assert len(data_lines) == 11
    assert (outdir / "dns.out").read_text().splitlines() == \
        "\n".join(run.log.lines).splitlines()


def test_cfl_tracks_target(case_run):
    cfl = [r[4] for r in _rows(case_run[1].log)[1:]]
    assert all(abs(c - 1.2) < 0.05 for c in cfl), cfl


def test_no_nans_and_bounded(case_run):
    state = case_run[1].state
    assert bool(torch.isfinite(state.u).all())
    assert float(state.u.abs().max()) < 2.0
    # passive scalar bounded by its initial range (tanh in [0, 1])
    assert float(state.s.max()) < 1.05 and float(state.s.min()) > -0.05
    assert float(state.w.abs().max()) == 0.0         # 2-D: no z motion


def test_dilatation_decays(case_run):
    rows = _rows(case_run[1].log)
    assert abs(rows[-1][8]) < abs(rows[1][8])


def test_restart_roundtrip(case_run):
    sim, run, outdir = case_run
    u, v, w, s, rtime, visc = tio.read_state(
        str(outdir / "flow"), str(outdir / "scal"), run.itime,
        sim.nsp.n_scalars)
    assert np.array_equal(u, run.state.u.numpy())
    assert np.array_equal(s[0], run.state.s[0].numpy())
    assert rtime == run.rtime and visc == sim.nsp.visc
