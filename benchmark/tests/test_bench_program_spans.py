"""The per-layer metrics that read the program's span registry
(tlab_tpu_torch/utils/trace.py): each read on a made-up registry and
context, and a traced CPU run of the shear layer's statistics cell that
reports all four."""
import dataclasses
import math
import types

import pytest

from harness import cell as cellmod
from harness import spec
from tlab_tpu_torch.ops import burgers
from tlab_tpu_torch.utils import trace

NEW = ("host_issue_ms_per_substep", "library_calls_per_substep",
       "stats_files_ms_per_write", "setup_plans_s")
SEED = 2 ** 31 + 777
TINY = (16, 48, 8)


@pytest.fixture(autouse=True)
def registry():
    trace.stop()
    trace.reset()
    burgers.reset_launches()
    yield
    trace.stop()
    trace.reset()
    burgers.reset_launches()


def _ctx(logged, substeps=10, writes=2):
    return {"substeps": substeps, "substeps_per_step": 5,
            "window": types.SimpleNamespace(stats_s=[0.1] * writes),
            "log": logged.append}


def test_importing_a_metric_turns_the_registry_on_and_keeps_the_phases():
    with trace.trace("runtime.from_case"):
        trace.count("library.cublas", 5)
    spec.metric("setup_plans_s")
    with trace.span("tools.dns.step"):
        pass
    t = trace.totals()
    assert "tools.dns.step" in t["spans"]          # the registry is on
    # ... on host clocks alone: no CUDA events, no profiler ranges
    assert t["spans"]["tools.dns.step"]["device_ms"] is None
    assert not trace._events and not trace._ranges
    assert "library.cublas" not in t["counters"]   # the set-up's, cleared
    assert t["phases"]["runtime.from_case"]["calls"] == 1


def test_each_metric_reads_a_made_up_registry():
    mods = {name: spec.metric(name) for name in NEW}
    with trace.trace("runtime.from_case"):
        pass
    for _ in range(2):                              # two steps of 5
        with trace.span("tools.dns.step"):
            trace.count("library.cublas", 30)
            trace.count("library.cufft", 50)
    with trace.span("stats.write"):
        with trace.span("stats.files"):
            trace.count("library.cublas", 1000)    # not the step's
    burgers.contract_launches["highest"][:] = [10, 10, 10]
    logged = []
    ctx = _ctx(logged)
    t = trace.totals()
    assert mods["host_issue_ms_per_substep"].read(ctx) == pytest.approx(
        t["spans"]["tools.dns.step"]["host_ms"] / 10)
    assert len(logged) == 1 and "tools.dns.step" in logged[0]
    assert mods["library_calls_per_substep"].read(ctx) == (160 + 30) / 10
    assert mods["stats_files_ms_per_write"].read(ctx) == pytest.approx(
        t["spans"]["stats.files"]["host_ms"] / 2)
    assert mods["setup_plans_s"].read(ctx) == pytest.approx(
        t["phases"]["runtime.from_case"]["host_ms"] * 1e-3)
    # nothing to read: no write in the window, no step
    assert mods["stats_files_ms_per_write"].read(_ctx([], writes=0)) is None
    trace.reset()
    assert mods["host_issue_ms_per_substep"].read(_ctx([])) is None
    assert mods["library_calls_per_substep"].read(_ctx([])) is None


def test_a_program_without_the_registry_reads_none(monkeypatch):
    """The benchmark's files laid over a program whose utils/trace.py has
    no registry: the metrics import and read None."""
    bare = types.ModuleType("tlab_tpu_torch.utils.trace")
    monkeypatch.setitem(__import__("sys").modules,
                        "tlab_tpu_torch.utils.trace", bare)
    import tlab_tpu_torch.utils as utils
    monkeypatch.setattr(utils, "trace", bare, raising=False)
    for name in NEW:
        assert spec.metric(name).read(_ctx([])) is None, name


def test_a_traced_run_reports_the_four():
    c = spec.find_cell("shear3d.stats")
    assert set(NEW) <= {m["name"] for m in c.per_layer}
    # a write every 2nd step and a short profiled stretch, so that a slow
    # CPU writes inside a short window
    c = dataclasses.replace(c, traffic=dict(
        c.traffic, statistics_every=2, trace_first_step=1, trace_steps=2))
    r = cellmod.run(c, SEED, 1.0, True, device="cpu", shape=TINY,
                    log=lambda msg: None)
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(NEW) <= set(m)
    for name in NEW:
        assert math.isfinite(m[name]) and m[name] > 0.0, name
    # the CPU's float64 step: no kernel launch; the counts of one step of
    # the shear layer (tests/test_torch_trace.py writes them out): per
    # substep 21 + 4 (the singular modes, one batch: 2 sweeps of 2)
    # cuBLAS and 10 cuFFT calls, and the step's diagnostics 3 cuBLAS calls
    # over 5 substeps
    assert m["library_calls_per_substep"] == pytest.approx(
        21 + 4 + 10 + 3 / 5)
