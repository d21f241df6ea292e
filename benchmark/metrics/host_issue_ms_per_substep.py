"""The host's time to launch a substep: the host ms of the program's span
tools.dns.step (the step function of tools.dns.make_step_functions, which
the window calls once a step: rk_step, the scalar clip, the diagnostics),
summed over the window, over its substeps.  The card runs asynchronously,
so this is the time the host takes to issue the step's work; where it
exceeds the device's busy time a substep, the host sets the pace.

It reads the program's span registry (tlab_tpu_torch/utils/trace.py).
Importing this file turns the registry on, on host clocks and counters
alone (no CUDA events, no profiler ranges: the profiled stretch and the
device's readings see no more than the spans' host work), and clears its
spans and counters, keeping the phase totals of the set-up: the harness
imports the per-layer metric files of a traced run after the warm step
and before the window (harness/cell.py), so the registry holds the
window's work when read(ctx) runs.  read also logs the registry's table
once a run.  A program without the registry reads None."""
from tlab_tpu_torch.utils import trace

if hasattr(trace, "totals"):
    trace.start(host_only=True)
    trace.reset(keep_phases=True)


def read(ctx):
    if not hasattr(trace, "totals") or not ctx["substeps"]:
        return None
    ctx["log"]("[bench] the program's spans, phases and counters:\n"
               + trace.table())
    step = trace.totals()["spans"].get("tools.dns.step")
    if step is None:
        return None
    return step["host_ms"] / ctx["substeps"]
