"""The set-up's plans: the host seconds of the program's phase
runtime.from_case (Simulation.from_case: the FDM plan, the device plans,
the elliptic plans with the direct eigen plan, the anelastic background
and its tables), of the set-up's one call.  Phases are timed on the host
clock whether the registry is on or off, since the set-up runs before
anything can turn it on.

It reads the program's span registry (tlab_tpu_torch/utils/trace.py).
Importing this file turns the registry on, on host clocks and counters
alone (no CUDA events, no profiler ranges: the profiled stretch and the
device's readings see no more than the spans' host work), and clears its
spans and counters, keeping the phase totals of the set-up: the harness
imports the per-layer metric files of a traced run after the warm step
and before the window (harness/cell.py).  A program without the registry
reads None."""
from tlab_tpu_torch.utils import trace

if hasattr(trace, "totals"):
    trace.start(host_only=True)
    trace.reset(keep_phases=True)


def read(ctx):
    if not hasattr(trace, "totals"):
        return None
    phase = trace.totals()["phases"].get("runtime.from_case")
    if phase is None:
        return None
    return phase["host_ms"] * 1e-3
