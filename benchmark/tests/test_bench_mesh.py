"""The mesh cell's harness on the CPU: its ranks spawned over gloo at a
small grid, through the port's mesh path (harness/mesh.py): a sound run
is correct, the ranks stop on the same step, a fault planted in the timed
path is caught, and its gaps are the one-device path's; the mesh's checks,
the all-to-all readers and their roofline's count."""
import copy
import math
import subprocess
import sys
import time

import pytest
import torch

from harness import cell as cellmod
from harness import collectives, devtrace, mesh, spec

SEED = 2 ** 31 + 4321
SMALL = (64, 16, 64)
NAME = "shear3d_mesh4.loop"


def quiet(msg):
    pass


def _run(c, seconds=1.0, shape=SMALL, **kw):
    lines = []
    r = cellmod.run(c, SEED, seconds, False, device="cpu", shape=shape,
                    log=lines.append, **kw)
    return r, lines


def _steps_by_rank(lines):
    line = next(x for x in lines if "steps by rank" in x)
    inner = line.split("steps by rank [", 1)[1].split("]", 1)[0]
    return [int(v) for v in inner.split(",")]


@pytest.fixture(scope="module")
def sound_run():
    return _run(spec.find_cell(NAME))


def test_a_sound_mesh_run_is_correct(sound_run):
    r, lines = sound_run
    assert r["correct"], r["checks"]
    assert r["device"]["count"] == 4 and r["failed"] == 0
    assert list(r)[-2:] == ["ranks_forbidden", "checks"]
    assert r["ranks_forbidden"] == []
    assert set(r["checks"]) == set(spec.find_cell(NAME).limits)
    assert set(r["metrics"]) == {m["name"] for m in
                                 spec.find_cell(NAME).end_to_end}
    steps = _steps_by_rank(lines)
    assert len(set(steps)) == 1 and steps[0] == r["attempted"] > 0


def _slow_step(step):
    """The last rank's step 40 ms slower: its own clock would stop it at
    another step than rank 0's."""
    def slow(state, dt, extra=None):
        time.sleep(0.04)
        return step(state, dt, extra)
    return slow


def test_every_rank_stops_on_rank_0s_step():
    r, lines = _run(spec.find_cell(NAME), seconds=1.5, patch=_slow_step)
    steps = _steps_by_rank(lines)
    assert len(set(steps)) == 1 and steps[0] == r["attempted"] > 1
    assert r["correct"], r["checks"]


def _unchanged(step):
    def bad(state, dt, extra=None):
        _, p, diag = step(state, dt)
        return state, p, diag
    return bad


def _half(step):
    def bad(state, dt, extra=None):
        new, p, diag = step(state, dt)
        h = state.u.shape[0] // 2
        for a, b in zip((new.u, new.v, new.w, new.s[0]),
                        (state.u, state.v, state.w, state.s[0])):
            a[:h] = b[:h]
        return new, p, diag
    return bad


def _altered(step):
    def bad(state, dt, extra=None):
        new, p, diag = step(state, dt)
        d = float((new.v - state.v).abs().max())
        new.v[3, new.v.shape[1] // 2, 2] += 0.01 * d
        return new, p, diag
    return bad


def _no_exchange(step):
    """Every transpose without its exchange: each rank keeps its own
    chunks where its peers' should arrive (planted on every rank)."""
    from tlab_tpu_torch.parallel import mesh as pmesh

    def local(self, a, axis, split, concat):
        n = self.shape[axis]
        a = a.unflatten(split, (n, a.shape[split] // n)).movedim(split, 0)
        return a.movedim(0, concat).flatten(concat, concat + 1).contiguous()

    def bad(state, dt, extra=None):
        saved = pmesh.Mesh.all_to_all
        pmesh.Mesh.all_to_all = local
        try:
            return step(state, dt, extra)
        finally:
            pmesh.Mesh.all_to_all = saved
    return bad


@pytest.mark.parametrize("fault,rank", [(_unchanged, -1), (_half, -1),
                                        (_altered, -1), (_no_exchange, None)])
def test_a_fault_on_the_mesh_is_not_correct(sound_run, fault, rank):
    """The limits ten times what the sound run reads at SMALL (the cell's
    own were set at its own size), as test_bench_harness's faults."""
    c = spec.find_cell(NAME)
    c.limits = {k: 10.0 * v["value"] + 1e-12
                for k, v in sound_run[0]["checks"].items()}
    r = mesh.run(c, SEED, 0.5, False, device="cpu", shape=SMALL, log=quiet,
                 patch=fault, patch_rank=rank)
    assert not r["correct"]


def test_the_gaps_are_the_one_device_paths():
    """The warm step from the same fields at the same grid, in float64: on
    the mesh and on one device the program meets the reference to
    round-off."""
    c = spec.find_cell(NAME)
    c.config = copy.deepcopy(c.config)
    c.config["dtype"] = "float64"
    on_mesh, _ = _run(c, seconds=0.3)
    one = copy.deepcopy(c)
    one.chips = 1
    del one.config["ini"]["Parallel"]
    alone, _ = _run(one, seconds=0.3)
    for k in ("start_u", "start_v", "start_w", "start_s1", "start_diag"):
        a, b = on_mesh["checks"][k]["value"], alone["checks"][k]["value"]
        assert a <= 1e-11 and b <= 1e-11, (k, a, b)


def test_mesh_shape_and_refusals():
    c = spec.find_cell(NAME)
    ini = c.config["ini"]
    assert mesh.mesh_shape(ini) == (2, 2)
    assert mesh.mesh_shape({"Grid": {}}) == (1, 1)
    assert mesh.check_cell(c, ini) == (2, 2)
    wrong = copy.deepcopy(c)
    wrong.chips = 2
    with pytest.raises(ValueError, match="asks for 2"):
        mesh.check_cell(wrong, ini)
    with pytest.raises(ValueError, match="incompatible"):
        mesh.check_cell(c, spec.resized(ini, (16, 16, 6)))
    stats = copy.deepcopy(c)
    stats.traffic = dict(stats.traffic, statistics_every=10)
    with pytest.raises(NotImplementedError):
        mesh.run(stats, SEED, 0.1, False, device="cpu", shape=SMALL,
                 log=quiet)


def _ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur}


def test_alltoall_readers_on_a_made_up_trace():
    events = [_ev(devtrace.STRETCH, "user_annotation", 0.0, 1000.0),
              _ev("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
                  "kernel", 100.0, 30.0),
              _ev("ncclKernel_SendRecv_RING_SIMPLE_Sum_int8_t", "kernel",
                  200.0, 20.0),
              _ev("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "kernel",
                  300.0, 5.0),
              _ev("burgers_col", "kernel", 400.0, 100.0)]
    t = dict(devtrace.summarize(events), steps=2)
    assert t["ops"]["burgers_col"] == (pytest.approx(100e-6), 1)
    assert collectives.alltoall(t) == (pytest.approx(50e-6), 2)
    assert collectives.alltoall(dict(t, ops={"burgers_col": (1.0, 1)})) \
        is None
    ctx = {"trace": t, "substeps_per_step": 5, "shape": (8, 4, 8),
           "fields": 4, "word_bytes": 4, "mesh": (2, 2), "card": "x",
           "bench_dir": spec.BENCH_DIR, "log": quiet}
    assert spec.metric("alltoall_ms_per_substep").read(ctx) == \
        pytest.approx(50e-3 / 10)
    assert spec.metric("alltoall_calls_per_substep").read(ctx) == 0.2
    pct = spec.metric("alltoall_roofline").read(ctx)
    b = spec.roofline("alltoall").bound((8, 4, 8), 4, 4, 2, 2)
    assert pct == pytest.approx(100.0 * b["seconds"] / 5e-6)
    for name in ("alltoall_ms_per_substep", "alltoall_calls_per_substep",
                 "alltoall_roofline"):
        assert spec.metric(name).read(dict(ctx, trace=None)) is None


def test_roofline_alltoall_hand_count():
    b = spec.roofline("alltoall").bound((1024, 384, 1024), 4, 4, 2, 2)
    n = 1024 * 384 * 1024
    # a rank keeps a quarter of its quarter between the x-plane and the
    # z-plane layouts; 4 fields and their Burgers terms, the Poisson
    # right-hand side and the pressure: 10 crossings
    assert b["bytes"] == 10 * (n / 4) * 0.75 * 4
    assert b["seconds"] == pytest.approx(b["bytes"] / 450e9)
    assert spec.roofline("alltoall").bound((8, 4, 8), 4, 4, 1, 1)[
        "bytes"] == 0.0
    assert math.isclose(b["bytes"] / 2 ** 30, 2.8125)


def test_the_mesh_path_is_taken_only_above_one_chip(monkeypatch):
    called = []
    monkeypatch.setattr(mesh, "run", lambda *a, **k: called.append(a))
    c = spec.find_cell("shear3d.loop")
    r = cellmod.run(c, SEED, 0.2, False, device="cpu", shape=(16, 48, 8),
                    log=quiet)
    assert not called and r["device"]["count"] == 1
    cellmod.run(spec.find_cell(NAME), SEED, 0.2, False, device="cpu",
                shape=SMALL, log=quiet)
    assert len(called) == 1


def test_run_refuses_the_mesh_cell_without_its_cards():
    if torch.cuda.device_count() >= 4:
        pytest.skip("four cards are here")
    out = subprocess.run([sys.executable, str(spec.BENCH_DIR / "run.py"),
                          "--workload", NAME, "--seed", "1", "--seconds",
                          "1", "--trace", "0"], capture_output=True,
                         text=True, cwd=spec.ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_control_reads_far_above_the_program_on_the_mesh(sound_run):
    """The control (the reference in float32 with TF32 products in the
    program's place, harness/cell.py's judge) at SMALL on the mesh's
    gathered fields: its worst number at least ten times the program's."""
    prog = sound_run[0]
    ctl, _ = _run(spec.find_cell(NAME), control="tf32")
    ratio = max(ctl["checks"][k]["value"] / prog["checks"][k]["value"]
                for k in prog["checks"] if prog["checks"][k]["value"] > 0)
    assert ratio >= 10.0
