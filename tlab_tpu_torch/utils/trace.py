"""Tracing: the tlab.trace file -- the reference's TRACE_ON analog -- and
one registry of the run's spans, phases and counters.

The reference (compile flag TRACE_ON, e.g. rhs_flow_global_2.f90:44)
writes 'ENTERING/LEAVING <routine>' lines to tlab.trace around every
routine call.  Here the file covers the host-side phases (plans, initial
fields, I/O, statistics) and the logged iterations of the dns loop, with
wall-clock timestamps relative to init(), and ends with the registry's
table() (close()).  Enable it with [Main] Tracing=yes or TLAB_TPU_TRACE=1;
lines go to <outdir>/tlab.trace, and the registry is on for the run.

The registry, kept in memory as per-name totals (nothing is written per
call):

- span(name): a layer of the step, as a context manager (`with
  span("ops.poisson"):`) or as a decorator where the function is defined
  (`@span("ops.poisson")`), so that every alias of the function is traced.
  Off (the default) a span tests one module-level flag: no clock read, no
  allocation.  On (start()), each span records its parent (the enclosing
  span) and its host time (time.perf_counter_ns); unless started
  host_only, also, on CUDA, a pair of timing events on the current stream
  and, while a torch.profiler is recording, a range "tlab.<name>", which
  puts it on the profiler's device trace.  Totals: calls, host ms, host self ms (less
  what the child spans cover), device ms (summed after one synchronise,
  when read), the counters counted inside it.  A span opened directly
  inside a span of the same name (a thermo function calling another) is
  part of it: it is counted once.
- trace(name): a phase, run at most once a statistics write or once a run
  (set-up, statistics, checkpoints, I/O).  Its ENTERING/LEAVING lines go
  to the file where one is open; its host time is summed always, on or
  off (two clock reads), under its name less a trailing iteration number
  ("statistics 10" -> "statistics"); with the registry on it is also a
  span of that name.
- count(name, n=1): an integer counter, always on.  A module that keeps
  its own counter registers it with source(): the Burgers kernels' launch
  counts (ops.burgers.contract_launches) are reported as "ops.burgers.k"
  and set to 0 by reset(), and nothing is counted twice.

The spans and counters of the port:

  tools.dns.step        the step function of tools.dns.make_step_functions
  tools.dns.read        the dns loop's one host read a step
  dycore.substep        dycore.incompressible.substep_rhs_stacked
  dycore.d1             the first-derivative products (dense or banded)
  dycore.d12            the compressible set's [D1;D2] products
  dycore.diagnostics    cfl_advective_max, dilatation_minmax
  dycore.mixture        the mixture's caloric Newton (compressible)
  dycore.nscbc          the NSCBC corrections (compressible)
  dycore.buffer         the compressible buffer relaxation
  ops.burgers           dycore.incompressible._burgers_all
  ops.poisson           ops.elliptic_factorize.poisson_factorize
  physics.thermo        buoyancy_explicit, equilibrium_newton_error,
                        equilibrium_state, airwater_re
  stats.write           tools.dns.write_statistics(_compressible)
  stats.tables          the device reduction and its one copy to the host
  stats.files           the avg files: formatting and writing on the host
  stats.pdfs_spectra    the in-run pdfs and spectra
  library.cublas        count: dense products (ops.derivative.apply_along,
                        the Poisson solve's complex products, the wall rows)
  library.cufft         count: the Poisson solve's transforms
  ops.burgers.k         count: the launches of K1-K3 (ops.burgers)
  ops.derivative.k      count: the launches of the compressible set's
                        derivative products (ops.burgers.deriv1, deriv12)
  dycore.comp_fused.k   count: the launches of the compressible RHS's
                        fused pointwise kernels (ops.comp_rhs)
  runtime.from_case     phase: Simulation.from_case; its children
                        runtime.fdm_plan, runtime.tables,
                        runtime.device_plans, runtime.elliptic_plans

The port runs one host thread a process (a mesh's ranks are processes),
so the registry keeps one stack of open spans and takes no lock.
"""
from __future__ import annotations

import contextlib
import functools
import os
import time

import torch

_state = {"fh": None, "t0": 0.0, "path": None}

_on = False                 # the registry records spans
_events = False             # ... with CUDA timing events
_ranges = False             # ... and profiler ranges
_stack: list = []           # the open spans, innermost last
_sites: dict = {}           # name -> its one _Site
_spans: dict = {}           # name -> _Total
_phases: dict = {}          # name -> [calls, host ns]
_counters: dict = {}        # name -> n
_sources: dict = {}         # name -> (read, reset) of a module's counter

# device events a name keeps unread before it folds the finished ones
_FOLD_AT = 1024


class _Total:
    __slots__ = ("calls", "host_ns", "self_ns", "device_ms", "timed",
                 "pending", "parents", "counts")

    def __init__(self):
        self.calls = self.host_ns = self.self_ns = 0
        self.device_ms = 0.0
        self.timed = False              # CUDA events were recorded
        self.pending = []               # (start, end) CUDA events
        self.parents = set()
        self.counts = {}

    def fold(self, wait: bool) -> None:
        """Add the finished event pairs' ms to device_ms (all of them after
        a synchronise, wait=True)."""
        done = 0
        for start, end in self.pending:
            if not (wait or end.query()):
                break
            self.device_ms += start.elapsed_time(end)
            done += 1
        del self.pending[:done]


class _Frame:
    __slots__ = ("site", "parent", "t0", "start", "rf", "child_ns",
                 "counts", "depth")

    def __init__(self, site, parent):
        self.site, self.parent = site, parent
        self.child_ns, self.counts, self.depth = 0, None, 0
        self.start = self.rf = None


def _add(into: dict, counts: dict) -> None:
    for k, n in counts.items():
        into[k] = into.get(k, 0) + n


class _Site:
    """The one context object of a span name: a no-op while the registry
    is off; on, entering it opens a span on the stack."""
    __slots__ = ("name", "label")

    def __init__(self, name: str):
        self.name, self.label = name, f"tlab.{name}"

    def __enter__(self):
        if _on:
            _open(self)

    def __exit__(self, *exc):
        if _on:
            _close(self)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with self:
                return fn(*args, **kwargs)
        return traced


def _open(site: _Site) -> None:
    top = _stack[-1] if _stack else None
    if top is not None and top.site is site:
        top.depth += 1                  # the same span, one level deeper
        return
    fr = _Frame(site, top)
    if _events:
        fr.start = torch.cuda.Event(enable_timing=True)
        fr.start.record()
    if _ranges and torch._C._autograd._profiler_enabled():
        fr.rf = torch.profiler.record_function(site.label)
        fr.rf.__enter__()
    _stack.append(fr)
    fr.t0 = time.perf_counter_ns()


def _close(site: _Site) -> None:
    t1 = time.perf_counter_ns()
    if not _stack or _stack[-1].site is not site:
        return                          # opened before start()
    fr = _stack[-1]
    if fr.depth:
        fr.depth -= 1
        return
    _stack.pop()
    if fr.rf is not None:
        fr.rf.__exit__(None, None, None)
    tot = _spans.get(site.name)
    if tot is None:
        tot = _spans[site.name] = _Total()
    if fr.start is not None:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        tot.timed = True
        tot.pending.append((fr.start, end))
        if len(tot.pending) >= _FOLD_AT:
            tot.fold(wait=False)
    dur = t1 - fr.t0
    tot.calls += 1
    tot.host_ns += dur
    tot.self_ns += dur - fr.child_ns
    parent = fr.parent
    if parent is not None:
        tot.parents.add(parent.site.name)
        parent.child_ns += dur
    if fr.counts:
        _add(tot.counts, fr.counts)
        if parent is not None:
            if parent.counts is None:
                parent.counts = {}
            _add(parent.counts, fr.counts)


def span(name: str) -> _Site:
    """The span `name` (see the module's docstring): a context manager and
    a decorator; the same object for every call with this name."""
    site = _sites.get(name)
    if site is None:
        site = _sites.setdefault(name, _Site(name))
    return site


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`, and, with the registry on, to the
    counts of the innermost open span."""
    _counters[name] = _counters.get(name, 0) + n
    if _on and _stack:
        top = _stack[-1]
        if top.counts is None:
            top.counts = {}
        top.counts[name] = top.counts.get(name, 0) + n


def source(name: str, read, reset) -> None:
    """Report a module's own counter as the counter `name`: read() -> n,
    reset() sets it to 0 (with reset())."""
    _sources[name] = (read, reset)


def start(host_only: bool = False) -> None:
    """Turn the registry on: host clocks and counters, and unless
    host_only CUDA timing events where a card is there and profiler
    ranges while a profiler records."""
    global _on, _events, _ranges
    _events = not host_only and torch.cuda.is_available()
    _ranges = not host_only
    _on = True


def stop() -> None:
    """Turn the registry off; the open spans are dropped."""
    global _on
    _on = False
    _stack.clear()


def reset(keep_phases: bool = False) -> None:
    """Clear the spans and the counters, the registered sources' too, and
    the phases unless keep_phases (the set-up's phases run before anything
    can turn the registry on)."""
    _spans.clear()
    _counters.clear()
    for _, clear in _sources.values():
        clear()
    if not keep_phases:
        _phases.clear()


def _phase_key(name: str) -> str:
    head, _, tail = name.rpartition(" ")
    return head if head and tail.isdigit() else name


def totals() -> dict:
    """{"spans": {name: {calls, host_ms, self_ms, device_ms, parents,
    counts}}, "phases": {name: {calls, host_ms}}, "counters": {name: n}}.
    device_ms is None where the spans had no CUDA events; reading it
    synchronises the card once."""
    if any(t.pending for t in _spans.values()):
        torch.cuda.synchronize()
    spans = {}
    for name, t in _spans.items():
        t.fold(wait=True)
        spans[name] = {"calls": t.calls, "host_ms": t.host_ns * 1e-6,
                       "self_ms": t.self_ns * 1e-6,
                       "device_ms": t.device_ms if t.timed else None,
                       "parents": sorted(t.parents),
                       "counts": dict(t.counts)}
    phases = {name: {"calls": c, "host_ms": ns * 1e-6}
              for name, (c, ns) in _phases.items()}
    counters = dict(_counters)
    for name, (read, _) in _sources.items():
        counters[name] = read()
    return {"spans": spans, "phases": phases, "counters": counters}


def table() -> str:
    """The text of totals(): one line a span, phase and counter."""
    t = totals()

    def ms(v):
        return "-" if v is None else f"{v:.3f}"

    lines = [f"{'span':<24} {'calls':>7} {'host_ms':>12} {'self_ms':>12} "
             f"{'device_ms':>12}  parents; counts"]
    for name, s in sorted(t["spans"].items()):
        counts = " ".join(f"{k}={n}" for k, n in sorted(s["counts"].items()))
        lines.append(f"{name:<24} {s['calls']:>7} {ms(s['host_ms']):>12} "
                     f"{ms(s['self_ms']):>12} {ms(s['device_ms']):>12}  "
                     f"{','.join(s['parents']) or '-'}; {counts or '-'}")
    lines.append(f"{'phase':<24} {'calls':>7} {'host_ms':>12}")
    for name, p in sorted(t["phases"].items()):
        lines.append(f"{name:<24} {p['calls']:>7} {ms(p['host_ms']):>12}")
    lines.append(f"{'counter':<24} {'n':>7}")
    for name, n in sorted(t["counters"].items()):
        lines.append(f"{name:<24} {n:>7}")
    return "\n".join(lines)


# -- the tlab.trace file ---------------------------------------------------

def enabled() -> bool:
    return _state["fh"] is not None


def init(outdir: str = ".", force: bool = False) -> None:
    """Open tlab.trace and turn the registry on, cleared; idempotent for
    the SAME outdir, but a different outdir re-targets the trace so
    back-to-back runs in one process each get their own file."""
    path = os.path.join(outdir, "tlab.trace")
    if _state["fh"] is not None and not force:
        if _state["path"] == path:
            return
        close()
    _state["fh"] = open(path, "a")
    _state["path"] = path
    _state["t0"] = time.monotonic()
    reset()
    start()
    point("trace initialized")


def maybe_init(case, outdir: str = ".") -> None:
    """init() when [Main] Tracing=yes or TLAB_TPU_TRACE is set."""
    ini = getattr(case, "ini", None)
    want = os.environ.get("TLAB_TPU_TRACE", "") not in ("", "0")
    if ini is not None:
        want = want or ini.get_bool("Main", "Tracing", False)
    if want:
        init(outdir)


def point(msg: str) -> None:
    fh = _state["fh"]
    if fh is None:
        return
    t = time.monotonic() - _state["t0"]
    fh.write(f"{t:12.6f}  {msg}\n")
    fh.flush()


@contextlib.contextmanager
def trace(name: str):
    """The phase `name` (see the module's docstring): an ENTERING/LEAVING
    pair with its elapsed time where the file is open (the reference's
    tfile lines), its host time summed always."""
    key = _phase_key(name)
    if _state["fh"] is not None:
        point(f"ENTERING {name}")
    t0 = time.perf_counter_ns()
    try:
        with span(key):
            yield
    finally:
        dt = time.perf_counter_ns() - t0
        ph = _phases.get(key)
        if ph is None:
            ph = _phases[key] = [0, 0]
        ph[0] += 1
        ph[1] += dt
        if _state["fh"] is not None:
            point(f"LEAVING  {name}  ({dt * 1e-9:.6f} s)")


def close() -> None:
    """Write the registry's table, close tlab.trace, turn the registry
    off."""
    if _state["fh"] is not None:
        for line in table().splitlines():
            point(line)
        point("trace closed")
        _state["fh"].close()
        _state["fh"] = None
        _state["path"] = None
        stop()
