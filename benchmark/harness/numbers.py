"""The arithmetic of the metrics: rates, percentiles and the union of
device intervals, on plain numbers so that tests can feed them made-up
step times and intervals."""
from __future__ import annotations

import math


def rate(work: float, seconds: float) -> float:
    """Work a second over the whole window."""
    if seconds <= 0:
        raise ValueError("an empty window")
    return work / seconds


def percentile(values, q: float):
    """(the q-th percentile of `values` by linear interpolation between
    the order statistics (numpy's default), the number of samples beyond
    it)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    val = xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
    return val, sum(1 for x in xs if x > val)


def union(intervals):
    """The disjoint union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def busy_within(intervals, lo: float, hi: float) -> float:
    """The length of the union of `intervals` inside [lo, hi]."""
    total = 0.0
    for s, e in union(intervals):
        s, e = max(s, lo), min(e, hi)
        if e > s:
            total += e - s
    return total


def gaps(intervals, lo: float, hi: float):
    """The idle (start, end) stretches of [lo, hi] outside `intervals`."""
    out = []
    t = lo
    for s, e in union(intervals):
        if e <= lo or s >= hi:
            continue
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out
