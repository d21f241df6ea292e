"""CUDA-event spans around the program's module attributes (a copy of
tlab_tpu_torch/tools/profile_step.py's Spans, which is sound): a pair of
events on the stream around each call of a wrapped function, summed after
a synchronise.  The events synchronise nothing, so the spans add up to the
stream's time and cost the traced run two event records a call.

Each per-layer metric that reads a span names what it wraps in its own
file (metrics/<name>.py: SPANS, (module, attribute, span) triples).
"""
from __future__ import annotations

import importlib

import torch


class Spans:
    """CUDA-event pairs by name, summed after a synchronise."""

    def __init__(self):
        self.pairs: dict = {}
        self._saved: list = []

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.pairs.setdefault(name, []).append((start, end))
            return out
        return timed

    def install(self, table) -> None:
        """Wrap each (module, attribute, span) of `table`, once each."""
        for modname, attr, name in dict.fromkeys(table):
            mod = importlib.import_module(modname)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self.wrap(name, fn))

    def remove(self) -> None:
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()

    def totals_ms(self) -> dict:
        """{span: summed ms, calls}; call after a synchronise."""
        return {name: (sum(a.elapsed_time(b) for a, b in pairs), len(pairs))
                for name, pairs in self.pairs.items()}
