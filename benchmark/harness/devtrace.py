"""The device's side of a traced run: torch.profiler over a steady stretch
of the window, reduced from its Chrome trace.

The stretch is a record_function range "bench.stretch" around whole steps,
each of which ends in the host's read, so every device operation it
causes lies inside it.  From the trace: the device events (kernels,
copies, fills) and their union; the stretch's length; the device time by
operation name; and the idle gaps between device events, each named by
the harness's range ("bench.step", "bench.read", ...) and the innermost
host operation running at the gap's middle.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile

from harness import numbers

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STRETCH = "bench.stretch"
# gaps shorter than this are counted together, unnamed
NAMED_GAP_US = 20.0


def warm(device) -> None:
    """Start and stop the profiler once on a trivial operation, so that
    the tracer's own start (seconds, the first time in a process) falls
    in the set-up and not in the window."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        (torch.ones(8, device=device) + 1.0).sum().item()


class Profile:
    """A context that profiles the host and the device and leaves the
    trace's summary in .summary."""

    def __init__(self):
        self.summary = None

    def __enter__(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._range = torch.profiler.record_function(STRETCH)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                self.summary = summarize(json.load(fh)["traceEvents"])
        finally:
            os.unlink(path)
        return False


def summarize(events) -> dict:
    """{window_s, busy_s, device_events, device_ops, idle_gaps, ops} of a
    Chrome trace's events (times in microseconds); ops: every device
    operation's name -> (seconds, calls)."""
    stretch = [e for e in events if e.get("name") == STRETCH
               and e.get("cat") == "user_annotation"]
    if not stretch:
        raise ValueError("no stretch range in the trace")
    lo = float(stretch[0]["ts"])
    hi = lo + float(stretch[0]["dur"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e
           and float(e["ts"]) < hi and float(e["ts"]) + float(e["dur"]) > lo]
    ivs = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev]
    busy = numbers.busy_within(ivs, lo, hi)
    by_op: dict = {}
    calls: dict = {}
    for e in dev:
        by_op[e["name"]] = by_op.get(e["name"], 0.0) + float(e["dur"]) * 1e-6
        calls[e["name"]] = calls.get(e["name"], 0) + 1
    ranges = _sorted_ranges(e for e in events
                            if e.get("cat") == "user_annotation"
                            and e.get("name", "").startswith("bench.")
                            and e.get("name") != STRETCH)
    ops = _sorted_ranges(e for e in events if e.get("cat") == "cpu_op")
    idle: dict = {}
    for s, e in numbers.gaps(ivs, lo, hi):
        if e - s < NAMED_GAP_US:
            name = f"gaps under {NAMED_GAP_US:g} us"
        else:
            mid = 0.5 * (s + e)
            name = f"{_inner(ranges, mid) or 'outside a step'}/" \
                   f"{_inner(ops, mid) or 'python'}"
        idle[name] = idle.get(name, 0.0) + (e - s) * 1e-6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gap_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (hi - lo) * 1e-6, "busy_s": busy * 1e-6,
            "device_events": len(dev),
            "device_ops": [[n, v] for n, v in top],
            "idle_gaps": [[n, v] for n, v in gap_top],
            "ops": {n: (v, calls[n]) for n, v in by_op.items()}}


def _sorted_ranges(evs):
    rs = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                 e["name"]) for e in evs)
    return [r[0] for r in rs], rs


def _inner(table, t, depth=256):
    """The name of the latest-starting range of `table` that holds t."""
    starts, rs = table
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - depth, -1), -1):
        if rs[j][1] >= t:
            return rs[j][2]
    return None
