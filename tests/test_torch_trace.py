"""The port's span registry (tlab_tpu_torch/utils/trace.py) on the CPU:
off it records no span while its counters and phases count; on, nested
spans' parents and self times, their profiler ranges (none on host clocks
alone), a function imported by name, the library calls of a substep as
its code path implies them, the Burgers kernels' counter, and [Main]
Tracing=yes through the dns command, whose tlab.trace chip_smoke.py reads
and which ends with the registry's table."""
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from tlab_tpu_torch import entry
from tlab_tpu_torch.dycore import incompressible as dyn
from tlab_tpu_torch.dycore.state import stack
from tlab_tpu_torch.ops import burgers
from tlab_tpu_torch.physics import thermo
from tlab_tpu_torch.physics.thermo import buoyancy_explicit
from tlab_tpu_torch.tools import cli
from tlab_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASE = os.path.join(REPO, "tests", "data", "case01_small3d.ini")


@pytest.fixture(autouse=True)
def registry():
    """Each test starts with the registry off and empty, and leaves it so
    for the tests that share the process."""
    trace.stop()
    trace.reset()
    yield
    trace.stop()
    trace.reset()


def test_off_spans_record_nothing_while_counters_and_phases_count():
    site = trace.span("a.span")
    assert trace.span("a.span") is site          # one shared object
    with trace.span("a.span"):
        trace.count("a.counter", 3)
        with trace.trace("a.phase 10"):
            pass

    @trace.span("a.span")
    def f(x):
        return x + 1

    assert f(1) == 2
    t = trace.totals()
    assert t["spans"] == {}
    assert t["counters"]["a.counter"] == 3
    # the phase counts under its name less the iteration number
    assert t["phases"]["a.phase"]["calls"] == 1
    assert t["phases"]["a.phase"]["host_ms"] >= 0.0


def test_nested_spans_parents_and_self_time():
    trace.start()

    @trace.span("t.inner")
    def inner():
        time.sleep(0.03)
        trace.count("t.n", 2)

    with trace.span("t.outer"):
        time.sleep(0.02)
        inner()
        inner()
    s = trace.totals()["spans"]
    out, inn = s["t.outer"], s["t.inner"]
    assert (out["calls"], inn["calls"]) == (1, 2)
    assert out["parents"] == [] and inn["parents"] == ["t.outer"]
    assert inn["host_ms"] >= 60.0 and out["host_ms"] >= 80.0
    # self time: the duration less what the child spans cover
    assert out["self_ms"] == pytest.approx(out["host_ms"] - inn["host_ms"],
                                           abs=1e-6)
    assert 20.0 <= out["self_ms"] < out["host_ms"] - 60.0 + 1e-6
    assert inn["self_ms"] == pytest.approx(inn["host_ms"], abs=1e-9)
    # the counts inside a span are its own and its parents'
    assert inn["counts"] == {"t.n": 4} and out["counts"] == {"t.n": 4}
    assert out["device_ms"] is None             # no card: no events


def test_a_span_inside_its_own_name_counts_once():
    trace.start()
    with trace.span("t.same"):
        with trace.span("t.same"):
            time.sleep(0.01)
    s = trace.totals()["spans"]["t.same"]
    assert s["calls"] == 1 and s["self_ms"] == pytest.approx(s["host_ms"])


def test_reset_keeps_the_phases_when_asked():
    with trace.trace("runtime.from_case"):
        trace.count("t.n")
    trace.start()
    with trace.span("t.s"):
        pass
    trace.reset(keep_phases=True)
    t = trace.totals()
    assert t["spans"] == {} and "t.n" not in t["counters"]
    assert t["phases"]["runtime.from_case"]["calls"] == 1
    trace.reset()
    assert trace.totals()["phases"] == {}


def _tlab_ranges(tmp_path, prof) -> dict:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return {e["name"]: e for e in events
            if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith("tlab.")}


def test_the_spans_are_profiler_ranges_nested_as_the_spans(tmp_path):
    trace.start()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("t.outer"):
            with trace.span("t.inner"):
                torch.ones(4).sum()
    ranges = _tlab_ranges(tmp_path, prof)
    assert set(ranges) == {"tlab.t.outer", "tlab.t.inner"}
    out, inn = ranges["tlab.t.outer"], ranges["tlab.t.inner"]
    assert out["ts"] <= inn["ts"]
    assert inn["ts"] + inn["dur"] <= out["ts"] + out["dur"]


def test_host_clocks_alone_open_no_profiler_range(tmp_path):
    """start(host_only=True), as the benchmark's traced runs turn it on:
    the spans' host times and counts, and nothing on the device's side."""
    trace.start(host_only=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("t.outer"):
            with trace.span("t.inner"):
                trace.count("t.n")
                torch.ones(4).sum()
    assert _tlab_ranges(tmp_path, prof) == {}
    s = trace.totals()["spans"]
    assert s["t.inner"]["parents"] == ["t.outer"]
    assert s["t.outer"]["counts"] == {"t.n": 1}
    assert s["t.outer"]["device_ms"] is None
    assert s["t.outer"]["host_ms"] >= s["t.inner"]["host_ms"] > 0.0


def test_a_function_imported_by_name_is_traced():
    tp = thermo.ThermoParams(scale_height_inv=1.0 / 8700.0)
    y = np.linspace(0.0, 1.0, 20)
    h = 0.97 + 0.02 * np.tanh((y - 0.6) / 0.1) + tp.scale_height_inv * y
    qt = 0.01 - 0.006 * np.tanh((y - 0.6) / 0.1)
    bg = {k: torch.from_numpy(v) for k, v in
          thermo.hydrostatic_background(tp, y, h, qt, p_ref=0.94).items()}
    s = torch.from_numpy(np.stack([
        np.broadcast_to(h[None, :, None], (5, 20, 4)),
        np.broadcast_to(qt[None, :, None], (5, 20, 4))]).copy())
    trace.start()
    b = buoyancy_explicit(tp, s, bg)
    assert b.shape == (5, 20, 4)
    assert trace.totals()["spans"]["physics.thermo"]["calls"] == 1


def test_library_calls_of_one_substep_follow_the_code_path():
    """The shear layer on the CPU (float64: the Burgers term takes the
    dense [D1;D2] product, one a direction), one substep:
    cuBLAS  3  [D1;D2] products (the Burgers term, x y z)
          + 3  d1 products of the forcing's divergence
          + 7  the Poisson solve's modal sweeps (2 x 2) and u'_N (3)
          + 4  its singular modes, all in one batch (2 sweeps of 2)
          + 2  d1 products of the pressure gradient (x, z)
          + 6  wall rows: u, w (free-slip) and s (Neumann), 2 each
    cuFFT  10  the Poisson solve: f, and the two walls' data, forward
               (rfft over x, fft over z), p and dp/dy back (ifft, irfft)
    and one step's diagnostics add the dilatation's 3 d1 products."""
    _, P, state = entry.build(16, 24, 8, torch.float64, "cpu", seed=0)
    n_sing = len(P["ell_fac"]["sing_idx"])
    assert n_sing == 4                   # {0, Nyquist} x {0, Nyquist}
    Q = stack(state)
    trace.start()
    with trace.span("t.substep"):
        dyn.substep_rhs_stacked(P, Q, torch.zeros_like(Q), 1e-3)
    counts = trace.totals()["spans"]["t.substep"]["counts"]
    assert counts == {"library.cublas": 3 + 3 + 7 + 4 + 2 + 6,
                      "library.cufft": 10,
                      "ops.poisson.sing_columns": n_sing}
    trace.reset()
    with trace.span("t.diag"):
        dyn.cfl_advective_max(P, state)
        dyn.dilatation_minmax(P, state)
    assert trace.totals()["spans"]["t.diag"]["counts"] == {
        "library.cublas": 3}


def test_the_poisson_solve_counts_its_singular_columns():
    """One poisson_factorize call of a 4-mode 'nn' plan: its span counts
    the 4 singular columns, solved as one batch, and 11 products (the
    regular solve's 7 and the batch's 2 sweeps of 2)."""
    from tlab_tpu_torch import grid as tgrid
    from tlab_tpu_torch.fdm.plan import build_fdm_plan
    from tlab_tpu_torch.ops import elliptic_factorize as fac
    fdm = build_fdm_plan(tgrid.uniform_grid(16, 24, 8, 2.0, 1.0, 1.5))
    dev = fac.device_factorize_plan(fac.build_factorize_plan(fdm),
                                    torch.float64, "cpu")
    assert len(dev["sing_idx"]) == 4
    f = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (16, 24, 8)))
    trace.start()
    fac.poisson_factorize(dev, f)
    counts = trace.totals()["spans"]["ops.poisson"]["counts"]
    assert counts["ops.poisson.sing_columns"] == 4
    assert counts["library.cublas"] == 7 + 4


def test_the_burgers_launches_are_the_kernels_own_counters():
    """ops.burgers.k is the sum of every contract's launches, counted once;
    reset() sets them to 0, so that each traced command reports its own."""
    burgers.reset_launches()
    burgers.contract_launches["highest"][0] += 2
    burgers.contract_launches["high"][2] += 1
    try:
        assert trace.totals()["counters"]["ops.burgers.k"] == 3
        trace.reset()
        assert trace.totals()["counters"]["ops.burgers.k"] == 0
        assert burgers.contract_launches == {
            name: [0, 0, 0] for name in burgers.CONTRACTS}
    finally:
        burgers.reset_launches()


def _small_case(path, extra_main: str) -> str:
    """case01_small3d.ini at 32x24x8, statistics and a restart at step 2,
    with `extra_main` in [Main]."""
    text = open(CASE).read()
    for old, new in (("Imax=128", "Imax=32"), ("Jmax=64", "Jmax=24"),
                     ("Kmax=16", "Kmax=8"), ("points_1=129", "points_1=33"),
                     ("points_1=64", "points_1=24"),
                     ("points_1=17", "points_1=9"),
                     ("Restart=10", "Restart=2"),
                     ("Statistics=5", "Statistics=2"),
                     ("[Main]\n", f"[Main]\n{extra_main}\n")):
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    with open(path, "w") as fh:
        fh.write(text)
    return str(path)


def test_tracing_yes_writes_what_chip_smoke_reads_and_the_table(tmp_path):
    sys.path.insert(0, REPO)
    import chip_smoke
    ini = _small_case(tmp_path / "tlab.ini", "Tracing=yes")
    common = ["--ini", ini, "--outdir", str(tmp_path), "--device", "cpu",
              "--x64"]
    for command in ("inigrid", "ini"):
        assert cli.main([command, *common]) == 0
    assert cli.main(["dns", *common, "--steps", "2"]) == 0
    assert not trace.enabled()             # the command closed the file
    path = tmp_path / "tlab.trace"
    read = chip_smoke.read_trace(str(path))
    for msg in ("initial_state", "inirand_fields", "statistics 2",
                "checkpoint 2", "io.read_state"):
        assert read[msg][1] >= 0.0, msg
    rate = chip_smoke.step_rate(read, 2, 5)
    assert rate["seconds"] > 0.0
    text = path.read_text()
    assert "ENTERING building step functions" not in text
    # the dns command's table: its last lines before "trace closed"
    tail = text[text.rindex("tool dns starting"):].splitlines()
    body = [ln.split(None, 1)[1] for ln in tail]
    assert body[-1] == "trace closed"
    rows = {ln.split()[0]: ln.split() for ln in body
            if ln.split()[0] in ("tools.dns.step", "tools.dns.read",
                                 "ops.poisson", "stats.files",
                                 "runtime.from_case", "library.cufft")}
    assert rows["tools.dns.step"][1] == "2"      # calls
    assert rows["tools.dns.read"][1] == "2"
    assert rows["ops.poisson"][1] == "10"        # 2 steps x 5 substeps
    assert rows["stats.files"][1] == "1"
    assert rows["runtime.from_case"][1] == "1"
    assert rows["library.cufft"][1] == "100"
