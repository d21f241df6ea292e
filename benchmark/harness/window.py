"""The measured window: the DNS loop of tlab_tpu_torch.tools.dns as `dns`
takes it, stopped on a clock.

A copy of the loop's few lines, of the loop that the Simulation's
equation set runs in (harness/sets.py): tools/dns.py::_run (as
profile_step's profile_dns_step copies it) or _run_compressible
(tools/dns.py:1206-1397).  The step that make_step_functions returns
(the RK step, then the diagnostics: CFL and dilatation, or the acoustic
CFL, the pressure and density extrema and the diffusion-number density),
the host's one read of the diagnostics, the adaptive dt at the case's
TimeCFL by the set's rule (_run's dycore.incompressible.next_dt,
tools/dns.py:1025 and 1069, or _run_compressible's next_dt, tools/
dns.py:1273-1276 and 1312), and, where the traffic asks for it,
write_statistics at its cadence.  The loop is closed: each step waits
for the last one's read.  `dns.run` itself cannot stop on a clock, so it
is not called.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Optional


@dataclasses.dataclass
class Window:
    steps: int = 0
    seconds: float = 0.0
    step_s: list = dataclasses.field(default_factory=list)
    stats_s: list = dataclasses.field(default_factory=list)
    failed: Optional[str] = None
    last: Optional[dict] = None        # the last step: q_old, q_new, dt, diag
    stats: Optional[dict] = None       # the last write: state, p, itime
    trace: Optional[dict] = None       # devtrace summary of the stretch
    peak_bytes: int = 0                # the program's peak (see _Peak)


class _Peak:
    """torch.cuda.max_memory_allocated() of the program alone, from the
    process's start to the window's end.  The window keeps the last
    statistics write's state and pressure for the comparison.  Until the
    step after the write has ended the loop holds them itself; from then
    on they are the harness's alone, and their bytes are taken off the
    peak of each stretch in which they are held."""

    def __init__(self, cuda: bool):
        self.cuda, self.peak, self.extra = cuda, 0, 0

    def close(self):
        """End the current stretch: fold its peak, less the bytes held
        for the harness through it, into the program's peak."""
        if self.cuda:
            import torch
            self.peak = max(self.peak, torch.cuda.max_memory_allocated()
                            - self.extra)
            torch.cuda.reset_peak_memory_stats()

    @staticmethod
    def nbytes(*tensors) -> int:
        """The bytes of the distinct storages of `tensors`, as the caching
        allocator counts them (blocks of 512 bytes)."""
        seen = {}
        for t in tensors:
            if t is not None:
                st = t.untyped_storage()
                seen[st.data_ptr()] = -(-st.nbytes() // 512) * 512
        return sum(seen.values())


def run(sim, step, carry: dict, dt: float, itime: int, rtime: float,
        seconds: float, stats_every: int, outdir: str,
        trace_at: Optional[tuple] = None, agree=None) -> Window:
    """Steps from carry["state"] (taken out of the dict, so that only the
    loop holds the fields) until `seconds` have passed, the last step run
    to its end.  trace_at: (first step, steps) of the profiled stretch.
    agree(stop) -> stop: the ranks of a mesh take rank 0's decision after
    each step, outside the timed step (harness/mesh.py), so that every
    rank runs the same steps."""
    import torch
    from tlab_tpu_torch.tools import dns
    from harness import devtrace, sets

    def rng(name):
        if trace_at is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    eqs = sets.of(sim)
    state = carry.pop("state")
    win = Window()
    prof = None
    peak = _Peak(state[0].is_cuda)
    pending = 0           # a write's bytes, still the loop's own this step
    t0 = time.perf_counter()
    while True:
        if trace_at is not None and win.steps == trace_at[0]:
            prof = devtrace.Profile().__enter__()
        ts = time.perf_counter()
        with rng("bench.step"):
            new, p, diag = step(state, dt)
        with rng("bench.read"):
            vals = diag.tolist()               # the loop's one sync a step
        itime += 1
        rtime += dt
        win.steps += 1
        if not all(math.isfinite(v) for v in vals):
            win.failed = f"non-finite diagnostics {vals} at step {itime}"
        with rng("bench.dt"):
            new_dt = eqs.next_dt(sim, vals)
        if stats_every and itime % stats_every == 0 and not win.failed:
            tw = time.perf_counter()
            with rng("bench.statistics"):
                dns.write_statistics(sim, new, outdir, itime, rtime, p=p)
            win.stats_s.append(time.perf_counter() - tw)
            peak.close()
            peak.extra = 0
            win.stats = {"state": new, "p": p, "itime": itime}
            pending = peak.nbytes(*new, p)
        te = time.perf_counter()
        win.step_s.append(te - ts)
        if prof is not None and win.steps == trace_at[0] + trace_at[1]:
            prof.__exit__(None, None, None)
            win.trace, prof = dict(prof.summary, steps=trace_at[1]), None
        stop = te - t0 >= seconds or win.failed is not None
        if agree is not None:
            stop = agree(stop)
        if stop:
            win.seconds = te - t0
            win.last = {"state": state, "new": new, "dt": dt, "diag": vals}
            break
        state, dt = new, new_dt
        if pending and win.stats["state"] is not state:
            peak.close()                # the loop has let go of the write
            peak.extra, pending = pending, 0
    if prof is not None:
        prof.__exit__(None, None, None)
        win.trace = dict(prof.summary, steps=win.steps - trace_at[0])
    peak.close()
    win.peak_bytes = peak.peak
    return win
