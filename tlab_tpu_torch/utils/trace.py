"""Tracing facility -- the reference's TRACE_ON analog (copy of
tlab_tpu/utils/trace.py).

The reference (compile flag TRACE_ON, e.g. rhs_flow_global_2.f90:44)
writes 'ENTERING/LEAVING <routine>' lines to tlab.trace around every
routine call.  Here the trace covers the host-side phases (config parse,
plan construction, IC generation, I/O, statistics) and the logged
iterations of the dns loop.

Enable with [Main] Tracing=yes or TLAB_TPU_TRACE=1; lines go to
<outdir>/tlab.trace with wall-clock timestamps relative to init().
"""
from __future__ import annotations

import contextlib
import os
import time

_state = {"fh": None, "t0": 0.0, "path": None}


def enabled() -> bool:
    return _state["fh"] is not None


def init(outdir: str = ".", force: bool = False) -> None:
    """Open tlab.trace; idempotent for the SAME outdir, but a different
    outdir re-targets the trace so back-to-back runs in one process each
    get their own file."""
    path = os.path.join(outdir, "tlab.trace")
    if _state["fh"] is not None and not force:
        if _state["path"] == path:
            return
        close()
    _state["fh"] = open(path, "a")
    _state["path"] = path
    _state["t0"] = time.monotonic()
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
    """ENTERING/LEAVING pair with elapsed time (reference tfile lines)."""
    if _state["fh"] is None:
        yield
        return
    point(f"ENTERING {name}")
    t0 = time.monotonic()
    try:
        yield
    finally:
        point(f"LEAVING  {name}  ({time.monotonic() - t0:.6f} s)")


def close() -> None:
    fh = _state["fh"]
    if fh is not None:
        point("trace closed")
        fh.close()
        _state["fh"] = None
        _state["path"] = None
