"""One run of one cell: set-up, the measured window, the readings, and the
comparison with the reference once the window has closed.

Set-up builds the cell's Simulation with Simulation.from_case from the
configuration's case in its dtype, makes the initial fields on the device
from the seed (harness/fields.py), takes one warm step through the step
that tools.dns.make_step_functions returns (and one statistics write
where the traffic writes statistics), and keeps that step's result on the
host for the comparison.  What differs between the equation sets (the
state, its fields, the dt rule) the Simulation's entry of harness/sets.py
gives: the warm step's dt is that of the loop the set runs in, tools/
dns.py::_run (dycore.incompressible.next_dt, tools/dns.py:1025) or
_run_compressible (its next_dt, tools/dns.py:1273-1281).  A compressible
cell whose traffic writes statistics is refused at set-up: the reference
has no Favre tables.  The window then steps on from the warm step's
state (harness/window.py).  A traced run wraps the spans that its metrics
read around the program's entry points for the whole window and profiles
a steady stretch of it (harness/devtrace.py).
"""
from __future__ import annotations

import gc
import importlib
import shutil
import tempfile
import time

from harness import check, devtrace, fields, sets, spec, window
from harness.spans import Spans


def _smi(*args) -> str:
    """What nvidia-smi prints with `args`, or why it could not."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", *args], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unread ({type(e).__name__})"
    if out.returncode:
        return (f"nvidia-smi unread (exit {out.returncode}: "
                f"{(out.stderr or out.stdout).strip()[-300:]})")
    return out.stdout.strip()


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    return (_smi("--query-gpu=name,power.limit", "--format=csv,noheader")
            or "nvidia-smi: no output").splitlines()[0]


def _topology() -> str:
    """How the cards are linked: nvidia-smi topo -m, and where that fails
    (it does on some hosts), each card's NVLink links (nvlink --status)
    and the peer-to-peer matrix of reads (topo -p2p r)."""
    out = _smi("topo", "-m")
    if not out.startswith("nvidia-smi unread"):
        return out
    return "\n".join([f"topo -m: {out}", _smi("nvlink", "--status"),
                      _smi("topo", "-p2p", "r")])


def reference_model(cell: spec.Cell):
    """The Model class of the configuration's reference module,
    reference/<name>.py (its "reference" key; reference/step.py where it
    has none)."""
    name = cell.config.get("reference", "step")
    return importlib.import_module(f"reference.{name}").Model


def _stats_every(cell: spec.Cell, case) -> int:
    every = cell.traffic.get("statistics_every", 0)
    return case.it_stats if every == "case" else int(every)


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", shape=None, t_start: float = None,
        log=print, patch=None, control: str = "") -> dict:
    """The run's result object (the contract's keys, "checks" last).
    shape: a smaller grid (tests); patch(step) -> step: a fault planted in
    the timed path (tests); control: judge the reference put in the
    program's place from the same inputs instead of the program's
    outputs: "tf32" in float32 with TF32 products (the control's
    readings); "fp32" wholly in plain float32, its Poisson solve and
    background too, or "bg32" in float64 on a float32 background
    (witnesses of what float32 itself reads;
    benchmark/tests/controls.py; the benchmark's own runs never do).
    A cell on more than one card runs as its mesh's ranks
    (harness/mesh.py)."""
    if cell.chips > 1:
        from harness import mesh
        return mesh.run(cell, seed, seconds, trace, device=device,
                        shape=shape, t_start=t_start, log=log, patch=patch,
                        control=control)
    import torch
    from tlab_tpu_torch.config import Ini, load_case
    from tlab_tpu_torch.ops import _build, burgers
    from tlab_tpu_torch.runtime import Simulation
    from tlab_tpu_torch.tools import dns

    t_start = time.time() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    ini = cell.config["ini"] if shape is None \
        else spec.resized(cell.config["ini"], shape)
    dtype = getattr(torch, cell.config["dtype"])
    sim = Simulation.from_case(load_case(Ini(text=spec.ini_text(ini))),
                               dtype=dtype, device=device)
    case = sim.case
    eqs = sets.of(sim)
    every = _stats_every(cell, case)
    if every and not eqs.stats:
        raise ValueError(
            f"{cell.name}: the {eqs.name} set writes Favre-averaged "
            "statistics, and no Favre-table reference exists yet to judge "
            "them; give the cell a traffic mix without statistics")
    q0 = fields.initial_stack(cell.config, ini, seed, device, dtype,
                              cell.bench_dir)
    step, diagnostics = dns.make_step_functions(sim)
    if patch is not None:
        step = patch(step)
    dt0 = eqs.next_dt(sim, diagnostics(eqs.unstack(q0)).tolist())
    out1, p1, diag1 = step(eqs.unstack(q0), dt0)
    start = {"new": eqs.stack(out1).cpu(), "dt": dt0,
             "diag": diag1.tolist()}
    del q0
    outdir = tempfile.mkdtemp(prefix="bench-stats-")
    try:
        if every:
            dns.write_statistics(sim, out1, outdir, 1, dt0, p=p1)
        per_layer = {m["name"]: spec.metric(m["name"], cell.bench_dir)
                     for m in cell.per_layer} if trace else {}
        spans = None
        if trace and cuda:
            spans = Spans()
            spans.install([s for mod in per_layer.values()
                           for s in getattr(mod, "SPANS", ())])
        if trace:
            devtrace.warm(device)
        burgers.reset_launches()
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.time() - t_start
        tr = cell.traffic
        # the window owns the state: no name here keeps a step's fields
        carry = {"state": out1}
        del out1, p1, diag1
        win = window.run(sim, step, carry, eqs.next_dt(
            sim, start["diag"]), 1, dt0, seconds, every,
            outdir, trace_at=(tr["trace_first_step"], tr["trace_steps"])
            if trace else None)
        peak = win.peak_bytes
        launches = {k: list(v) for k, v in burgers.contract_launches.items()}
        span_ms = None
        if spans is not None:
            torch.cuda.synchronize()
            span_ms = spans.totals_ms()
            spans.remove()
        n_sub = len(sim.P["rk"]["kdt"])
        nfields = eqs.n_fields(sim)
        grid = tuple(sim.grid.shape)
        built = {k: round(v["seconds"], 3) for k, v in _build.builds.items()}
        del sim, step, diagnostics
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        card = torch.cuda.get_device_name(0) if cuda else "cpu"
        if cuda:
            ctx_card = _card()
            log(f"[bench] card: {ctx_card}")
        log(f"[bench] {cell.name} seed {seed}: {card}; grid {grid}; "
            f"set-up {setup_s:.3f} s (builds {built}); window "
            f"{win.seconds:.3f} s, {win.steps} steps, {len(win.stats_s)} "
            f"statistics writes; peak {peak} B")
        if win.step_s:
            ms = sorted(1e3 * t for t in win.step_s)
            log(f"[bench] step ms: min {ms[0]:.3f} median "
                f"{ms[len(ms) // 2]:.3f} max {ms[-1]:.3f}; statistics "
                f"writes ms: " + " ".join(f"{1e3 * t:.1f}"
                                          for t in win.stats_s[:40]))
        log(f"[bench] burgers.contract_launches {launches} "
            f"({win.steps * n_sub} substeps)")
        ctx = {"window": win, "points": grid[0] * grid[1] * grid[2],
               "substeps_per_step": n_sub, "substeps": win.steps * n_sub,
               "setup_s": setup_s, "peak_bytes": peak, "spans": span_ms,
               "trace": win.trace, "shape": grid, "fields": nfields,
               "word_bytes": torch.finfo(dtype).bits // 8,
               "card": ctx_card if cuda else card,
               "bench_dir": cell.bench_dir,
               "log": log}
        metrics = read_metrics(cell, trace, per_layer, ctx)
        readings = _compare(cell, eqs, ini, seed, device, dtype, start,
                            win, outdir, every, log, control)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    return result_of(cell, readings, win.steps, win.failed, metrics, cuda,
                     card, 1, peak, win.trace if trace else None, log)


def read_metrics(cell, trace: bool, per_layer: dict, ctx: dict) -> dict:
    """{name: {value, unit}} of the cell's per-layer metrics (trace) or
    end-to-end ones, each read by its file from ctx; a reader that finds
    nothing to read leaves its metric out."""
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        mod = per_layer.get(m["name"]) \
            or spec.metric(m["name"], cell.bench_dir)
        v = mod.read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return metrics


def result_of(cell, readings, steps, failed, metrics, cuda, card, count,
              peak, trace_summary, log) -> dict:
    """The run's result object: the contract's keys, "checks" last, each
    number compared beside its limit; a failed window is not correct."""
    correct, rows = check.verdict(readings, cell.limits)
    if failed:
        correct = False
        log(f"[bench] failed: {failed}")
    result = {"correct": bool(correct), "attempted": steps,
              "failed": int(failed is not None), "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": card, "count": count,
                         "memory_peak_bytes": int(peak)}}
    if trace_summary:
        result["device"]["busy_s"] = trace_summary["busy_s"]
        result["device"]["window_s"] = trace_summary["window_s"]
        result["breakdown"] = {"device_ops": trace_summary["device_ops"],
                               "idle_gaps": trace_summary["idle_gaps"]}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return result


def _compare(cell, eqs, ini, seed, device, dtype, start, win, outdir,
             every, log, control="") -> dict:
    """The numbers of the comparison with the reference (judge), the
    program's state already freed but for what is judged."""
    import torch

    if win.failed:
        return {}
    last = win.last
    judged = {"old": eqs.stack(last["state"]),
              "new": eqs.stack(last["new"]),
              "dt": last["dt"], "diag": last["diag"]}
    held = win.stats
    win.last = win.stats = None
    del last
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    q0 = fields.initial_stack(cell.config, ini, seed, device, dtype,
                              cell.bench_dir)
    return judge(cell, ini, device, q0, start, judged, held, outdir, every,
                 log, control)


def judge(cell, ini, device, q0, start, last, held, outdir, every, log,
          control="") -> dict:
    """The numbers of harness/check.py from the configuration's reference
    on `device`: the warm step from q0 (start: its "new" stack, "dt",
    "diag"), the window's last step (last: "old", "new" stacks, "dt",
    "diag"), and the last statistics write (held) where there is one.
    The stacks may live on any device.  control: the reference put in the
    program's place (run's docstring)."""
    import torch
    from reference import averages

    Model = reference_model(cell)
    eqs = sets.of_case(ini)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    q_old, q_new = last["old"], last["new"]
    dt, diag = last["dt"], last["diag"]
    new0, diag0 = start["new"], start["diag"]
    if control:
        ctl = Model(ini, device, torch.float64 if control == "bg32"
                    else torch.float32, tf32=control == "tf32",
                    bg32=control in ("bg32", "fp32"),
                    poisson32=control == "fp32")
        new0 = ctl.step(q0, start["dt"])[0]
        diag0 = ctl.diagnostics(new0)[0]
        q_new = ctl.step(q_old, dt)[0]
        diag = ctl.diagnostics(q_new)[0]
        if not (every and held is not None):
            del ctl                     # the tables of one model at a time
    model = Model(ini, device)
    own = {}
    out = check.step_gaps(model, "start", q0, new0, start["dt"], diag0, own,
                          eqs)
    del q0, new0
    out.update(check.step_gaps(model, "last", q_old, q_new, dt, diag, own,
                               eqs))
    log(f"[bench] the {eqs.name} set's vector gaps over each component's "
        "own change: "
        + " ".join(f"{k} {v:.4g}" for k, v in own.items()))
    del q_old, q_new
    if every and held is not None:
        it = held["itime"]
        q = eqs.stack(held["state"])
        if control:
            flow, scal = averages.tables(ctl, q, held["p"])
            tables = [{n: v for n, (v, _) in t.items()}
                      for t in [flow] + scal]
        else:
            tables = [averages.read_avg(f"{outdir}/avg{it}")] + [
                averages.read_avg(f"{outdir}/avg{it}s{i + 1}")
                for i in range(q.shape[0] - 3)]
        gap, where = check.stats_gap(model, q, held["p"], tables)
        out.update(gap)
        log(f"[bench] statistics of iteration {it}: worst column {where}")
    ref_peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"[bench] the reference's comparison took "
        f"{time.perf_counter() - t0:.3f} s, its peak {ref_peak} B")
    return out
