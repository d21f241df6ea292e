"""The harness on the CPU: its arithmetic on made-up numbers, the
roofline's count, finding a cell's files by name, a tiny dry run of each
cell through the plain path, the faults the comparison must catch, and
the check that nothing it runs loads JAX or the JAX package."""
import ast
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from harness import cell as cellmod
from harness import check, devtrace, numbers, spec, window

BENCH = spec.BENCH_DIR
ROOT = spec.ROOT
SEED = 2 ** 31 + 12345
TINY = (16, 48, 8)          # the shear layer resolved enough to stay finite
CELLS = [w["name"] for w in spec.load_json(ROOT / "BENCHMARK.json")
         ["workloads"]]


def quiet(msg):
    pass


def window_s(name, base):
    """A window long enough at TINY for the statistics cadence (every
    10th step) to write inside it on a slow CPU."""
    return 3.0 if name.endswith(".stats") else base


def test_rate_and_percentile():
    assert numbers.rate(100.0, 4.0) == 25.0
    xs = list(range(1, 101))
    v, beyond = numbers.percentile(xs, 95.0)
    assert v == pytest.approx(np.percentile(xs, 95.0))
    assert beyond == 5
    v, beyond = numbers.percentile([3.0] * 10 + [7.0], 95.0)
    assert v == pytest.approx(np.percentile([3.0] * 10 + [7.0], 95.0))
    assert beyond == 1
    with pytest.raises(ValueError):
        numbers.rate(1.0, 0.0)


def test_union_busy_and_gaps():
    ivs = [(1.0, 3.0), (0.0, 2.0), (5.0, 6.0), (5.5, 5.7)]
    assert numbers.union(ivs) == [(0.0, 3.0), (5.0, 6.0)]
    assert numbers.busy_within(ivs, 0.0, 10.0) == pytest.approx(4.0)
    assert numbers.busy_within(ivs, 2.0, 5.5) == pytest.approx(1.5)
    assert numbers.gaps(ivs, 0.0, 10.0) == [(3.0, 5.0), (6.0, 10.0)]
    assert numbers.gaps(ivs, -1.0, 4.0) == [(-1.0, 0.0), (3.0, 4.0)]


def _ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur}


def test_devtrace_summary_of_a_made_up_trace():
    events = [_ev(devtrace.STRETCH, "user_annotation", 0.0, 1000.0),
              _ev("bench.step", "user_annotation", 0.0, 400.0),
              _ev("bench.read", "user_annotation", 400.0, 600.0),
              _ev("aten::mm", "cpu_op", 50.0, 70.0),
              _ev("cudaStreamSynchronize", "cuda_runtime", 400.0, 590.0),
              _ev("aten::item", "cpu_op", 400.0, 590.0),
              _ev("k_a", "kernel", 100.0, 100.0),
              _ev("k_b", "kernel", 150.0, 150.0),
              _ev("k_a", "kernel", 500.0, 20.0),
              _ev("Memcpy DtoH", "gpu_memcpy", 990.0, 5.0),
              _ev("k_out", "kernel", 2000.0, 10.0)]       # outside
    s = devtrace.summarize(events)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx((200.0 + 20.0 + 5.0) * 1e-6)
    ops = dict(s["device_ops"])
    assert ops["k_a"] == pytest.approx(120e-6)
    assert "k_out" not in ops
    assert ops["k_b"] == pytest.approx(150e-6)
    gaps = dict(s["idle_gaps"])
    assert gaps["bench.step/aten::mm"] == pytest.approx(100e-6)
    assert gaps["bench.read/aten::item"] == pytest.approx(
        (200.0 + 470.0) * 1e-6)
    assert gaps[f"gaps under {devtrace.NAMED_GAP_US:g} us"] == \
        pytest.approx(5e-6)
    assert sum(gaps.values()) + s["busy_s"] == pytest.approx(1e-3)


def test_device_busy_per_substep_reads_the_stretch():
    read = spec.metric("device_busy_ms_per_substep").read
    t = {"busy_s": 0.6, "window_s": 0.8, "device_events": 9, "steps": 6}
    assert read({"trace": t, "substeps_per_step": 5}) == pytest.approx(20.0)
    assert read({"trace": None, "substeps_per_step": 5}) is None
    assert read({"trace": dict(t, device_events=0),
                 "substeps_per_step": 5}) is None


def test_peak_takes_off_what_is_held_for_the_harness(monkeypatch):
    mem = {"max": 0, "resets": 0}
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda: mem["max"])
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda: mem.update(resets=mem["resets"] + 1))
    pk = window._Peak(True)
    mem["max"] = 100
    pk.close()
    pk.extra, mem["max"] = 30, 120       # 30 held through this stretch
    pk.close()
    assert pk.peak == 100 and mem["resets"] == 2
    pk.extra, mem["max"] = 0, 105
    pk.close()
    assert pk.peak == 105
    x = torch.zeros(1000)                # 4000 B: one block of 4096
    assert window._Peak.nbytes(x[:10], x[5:], None, torch.zeros(3)) \
        == 4096 + 512


def test_the_window_holds_a_write_against_the_peak_after_its_step(
        monkeypatch):
    """The bytes of the write kept for the comparison come off the peak
    only in the stretches after the step that follows the write."""
    extras = []

    class Rec(window._Peak):
        def close(self):
            extras.append(self.extra)
    monkeypatch.setattr(window, "_Peak", Rec)
    c = spec.find_cell("shear3d.stats")
    r = cellmod.run(c, SEED, window_s("shear3d.stats", 1.0), False,
                    device="cpu", shape=TINY, log=quiet)
    writes = r["attempted"] // 10
    held = [e for e in extras if e]
    assert writes >= 1 and len(extras) >= 2 * writes
    assert extras[:2] == [0, 0]          # the first write, the step after
    assert len(set(held)) == 1
    assert held[0] >= 4 * 4 * TINY[0] * TINY[1] * TINY[2]


def test_roofline_burgers_hand_count():
    b = spec.roofline("burgers").bound((8, 6, 4), 4)
    n = 8 * 6 * 4
    # [D1;D2] along x: 2 operators x 2 n_x^2 a line, n/n_x lines, 4 fields
    ops = sum(4 * 2 * 2 * m * m * (n // m) for m in (8, 6, 4))
    assert b["ops"] == ops
    assert b["bytes"] == 3 * (2 * 4 + 1) * n * 4
    assert b["seconds"] == pytest.approx(max(ops / 165e12, b["bytes"]
                                             / 3.35e12))
    big = spec.roofline("burgers").bound((512, 256, 256), 4)
    # the kernel table's bound_ms of K1 + K2 + K3 (1.666 + 0.833 + 0.833)
    assert big["by"] == "operations"
    assert 1e3 * big["seconds"] == pytest.approx(3.332, abs=2e-3)


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_found_by_name(name):
    c = spec.find_cell(name)
    w = {x["name"]: x for x in spec.load_json(ROOT / "BENCHMARK.json")
         ["workloads"]}[name]
    assert c.config["name"] == w["config"]
    assert c.traffic == spec.load_json(BENCH / "traffic"
                                       / f"{w['traffic']}.json")
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.metric(m["name"]).read)
    assert "setup_s" in {m["name"] for m in c.end_to_end}


def test_a_new_file_beside_them_is_taken_up(tmp_path):
    """A configuration, a mix, a metric and a cell added as new files and
    entries, with no existing file edited, run."""
    root = tmp_path / "co"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    bench = spec.load_json(ROOT / "BENCHMARK.json")
    cfg = json.loads((BENCH / "configs" / "shear3d.json").read_text())
    cfg["name"] = "shear_small"
    cfg["ini"] = spec.resized(cfg["ini"], TINY)
    (root / "benchmark/configs/shear_small.json").write_text(json.dumps(cfg))
    (root / "benchmark/traffic/fixed.json").write_text(json.dumps(
        {"why": "a test", "statistics_every": 3, "trace_first_step": 1,
         "trace_steps": 2}))
    (root / "benchmark/metrics/steps_done.py").write_text(
        "def read(ctx):\n    return float(ctx['window'].steps)\n")
    limits = json.loads((BENCH / "limits/shear3d.stats.json").read_text())
    (root / "benchmark/limits/shear_small.fixed.json").write_text(
        json.dumps({k: 1.0 for k in limits}))
    bench["configs"].append({"name": "shear_small", "source": "a test",
                             "file": "benchmark/configs/shear_small.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "shear_small.fixed",
                               "config": "shear_small", "traffic": "fixed",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "steps_done", "unit": "steps",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["shear_small.fixed"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        assert p.read_bytes() == data
    c = spec.find_cell("shear_small.fixed", bench_dir=root / "benchmark")
    assert c.traffic["statistics_every"] == 3
    r = cellmod.run(c, SEED, 0.5, False, device="cpu", log=quiet)
    assert r["metrics"]["steps_done"]["value"] == r["attempted"]
    assert "stats" in r["checks"] and r["correct"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_dry_run_of_each_cell(name, trace):
    c = spec.find_cell(name)
    r = cellmod.run(c, SEED, window_s(name, 1.0), bool(trace), device="cpu",
                    shape=TINY, log=quiet)
    # the limits are set at the cell's own size: here the verdict is only
    # that every number was read
    assert all(math.isfinite(v["value"]) for v in r["checks"].values())
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(c.limits)
    assert r["attempted"] > 0 and r["failed"] == 0
    if trace:
        # the CPU has no device spans; what the host clock reads is there
        assert set(r["metrics"]) <= {m["name"] for m in c.per_layer}
    else:
        assert set(r["metrics"]) == {m["name"] for m in c.end_to_end}
        for m in r["metrics"].values():
            assert math.isfinite(m["value"])


@pytest.fixture(scope="module")
def sound():
    """Each cell at TINY with its limits set to ten times what a sound run
    reads there (the cells' own limits were set at their own sizes)."""
    out = {}
    for name in CELLS:
        c = spec.find_cell(name)
        r = cellmod.run(c, SEED, window_s(name, 0.5), False, device="cpu",
                        shape=TINY, log=quiet)
        c.limits = {k: 10.0 * v["value"] + 1e-12
                    for k, v in r["checks"].items()}
        out[name] = c
    return out


def _unchanged(step):
    def bad(state, dt, extra=None):
        _, p, diag = step(state, dt)
        return state, p, diag
    return bad


def _half(step):
    """Half of the grid in x left where it was, in every field of either
    equation set's state."""
    def bad(state, dt, extra=None):
        new, p, diag = step(state, dt)
        h = state[0].shape[0] // 2
        for a, b in zip(new, state):
            if a is not None and b is not None:
                a[..., :h, :, :] = b[..., :h, :, :]
        return new, p, diag
    return bad


def _altered(step):
    """One value of the second field (v, or rho u) altered."""
    def bad(state, dt, extra=None):
        new, p, diag = step(state, dt)
        d = float((new[1] - state[1]).abs().max())
        new[1][3, new[1].shape[1] // 2, 2] += 0.01 * d
        return new, p, diag
    return bad


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(sound, name, fault):
    r = cellmod.run(sound[name], SEED, window_s(name, 0.5), False,
                    device="cpu", shape=TINY, log=quiet, patch=fault)
    assert not r["correct"]


def test_an_altered_statistics_table_is_not_correct(sound, monkeypatch):
    from tlab_tpu_torch.stats import averages as pavg
    to_host = pavg.to_host

    def bad(flow, scals):
        f, s = to_host(flow, scals)
        f["Rxx"] = f["Rxx"] * (1.0 + 1e-3)
        return f, s
    monkeypatch.setattr(pavg, "to_host", bad)
    r = cellmod.run(sound["shear3d.stats"], SEED,
                    window_s("shear3d.stats", 0.5), False, device="cpu",
                    shape=TINY, log=quiet)
    assert not r["correct"]
    assert r["checks"]["stats"]["value"] > r["checks"]["stats"]["limit"]


def test_forbidden_names_compared_whole():
    sys.path.insert(0, str(BENCH))
    import run
    mods = {"tlab_tpu_torch.ops": 1, "tlab_tpu.ops": 1, "jaxlib": 1,
            "jax_like": 1, "flax.core": 1, "numpy": 1}
    assert run.loaded_forbidden(mods) == ["flax.core", "jaxlib",
                                          "tlab_tpu.ops"]


def test_nothing_run_loads_jax_or_the_jax_package():
    """A dry run of a cell in a fresh process, then sys.modules."""
    code = f"""
import sys
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]
import run
from harness import cell, spec
r = cell.run(spec.find_cell("shear3d.stats"), 7, 0.3, True, device="cpu",
             shape={TINY!r}, log=lambda m: None)
r = cell.run(spec.find_cell("cloudtop.loop"), 7, 0.3, False, device="cpu",
             shape={TINY!r}, log=lambda m: None)
print(run.loaded_forbidden())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        tops = {n.split(".", 1)[0] for n in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "tlab_tpu",
                           "tlab_tpu_torch", "harness"}, path
    code = f"""
import sys
sys.path[:0] = [{str(BENCH)!r}]
import reference.step, reference.averages, reference.poisson
print(sorted({{n.split(".", 1)[0] for n in sys.modules}}
             & {{"jax", "jaxlib", "flax", "tlab_tpu", "tlab_tpu_torch"}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"),
                          "--workload", "shear3d.loop", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_verdict_needs_every_number():
    ok, rows = check.verdict({"a": 1.0}, {"a": 2.0, "b": 1.0})
    assert not ok and rows[1][0] == "b" and math.isnan(rows[1][1])
    assert check.verdict({"a": 1.0, "b": 0.5}, {"a": 2.0, "b": 1.0})[0]
    assert not check.verdict({"a": math.nan}, {"a": 2.0})[0]
    with pytest.raises(KeyError):
        check.verdict({"c": 1.0}, {"a": 2.0})


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_small_run_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = spec.find_cell(name)
    r = cellmod.run(c, SEED, 2.0, True, device="cuda", shape=(64, 48, 32),
                    log=quiet)
    assert r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0.0
    assert {m["name"] for m in c.per_layer} == set(r["metrics"])
