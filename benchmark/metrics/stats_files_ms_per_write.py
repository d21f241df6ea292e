"""The host's time to write the avg files of a statistics write: the host
ms of the program's span stats.files (tools.dns._write_tables: the
tables, already on the host, formatted and written), over the window's
writes.  The rest of stats_ms_per_write is the device reduction and its
one copy (stats.tables) and the in-run pdfs and spectra.

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
    writes = len(ctx["window"].stats_s)
    if not hasattr(trace, "totals") or not writes:
        return None
    files = trace.totals()["spans"].get("stats.files")
    if files is None:
        return None
    return files["host_ms"] / writes
