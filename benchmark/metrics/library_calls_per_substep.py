"""The library calls a substep makes: the program's counters of the dense
products (library.cublas) and the Poisson solve's transforms
(library.cufft) counted inside its span tools.dns.step (the window's
steps, not its statistics writes), and the Burgers kernels' launches
(ops.burgers.k, ops/burgers.py's own counters, which the harness sets to
0 before the window; no statistics write launches them), over the
window's substeps.  A count: it repeats exactly while the code path
stands, and a fusion moves it.

It reads the program's span registry (tlab_tpu_torch/utils/trace.py).
Importing this file turns the registry on, on host clocks and counters
alone (no CUDA events, no profiler ranges: the profiled stretch and the
device's readings see no more than the spans' host work), and clears its
spans and counters, keeping the phase totals of the set-up: the harness
imports the per-layer metric files of a traced run after the warm step
and before the window (harness/cell.py), so the registry holds the
window's work when read(ctx) runs.  A program without the registry reads
None."""
from tlab_tpu_torch.utils import trace

if hasattr(trace, "totals"):
    trace.start(host_only=True)
    trace.reset(keep_phases=True)


def read(ctx):
    if not hasattr(trace, "totals") or not ctx["substeps"]:
        return None
    t = trace.totals()
    step = t["spans"].get("tools.dns.step")
    if step is None:
        return None
    calls = step["counts"].get("library.cublas", 0) \
        + step["counts"].get("library.cufft", 0) \
        + t["counters"].get("ops.burgers.k", 0)
    return calls / ctx["substeps"]
