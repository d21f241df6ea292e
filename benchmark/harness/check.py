"""Whether what the timed path produced is correct: the comparison with
the plain reference (benchmark/reference), run once the window has closed.

Three things are judged, each as numbers held to the cell's limits
(limits/<cell>.json):

- a step's change of each field, start_<f> and last_<f>: the widest gap
  between the program's change q_new - q_old and the reference's float64
  change from the same q_old and dt, over the reference's widest change
  of that field (of the largest component, for the components of the
  set's vector: the velocity, or the momentum), or over the set's floor
  of that field's scale where that is larger (harness/sets.py).  The
  fields are the equation set's (sets.names).  "start" is the first step,
  from the benchmark's own initial fields; "last" is the window's last
  step, from the program's own state (the reference cannot make that
  state itself without following every step before it).
- that step's diagnostics, <check>_diag, as the set judges them
  (sets.<Set>.diag_gap): in the incompressible set the larger of the CFL
  number's relative gap and the dilatation extrema's gap over the size of
  the divergence's terms, both of the program's new state (no lower
  precision moves the CFL number, an elementwise maximum; the
  dilatation's derivative products carry the number's upper reading); in
  the compressible set, whose diagnostics are pointwise, against the
  reference's diagnostics of its own new state.
- stats: the last avg tables written in the window against the
  reference's columns of the same state and pressure (reference/
  averages.py), the worst column's gap over its scale.
"""
from __future__ import annotations

import math

import torch

from harness import sets


def step_gaps(model, tag, q_old, q_new, dt, diag, own=None, eqs=None):
    """The numbers of one step: q_old, q_new (F, nx, ny, nz) the program's
    state before and after it, on any device, diag its diagnostics as the
    host read them, eqs the equation set's entry (harness/sets.py; the
    incompressible set's where None).  own: a dict that gets each vector
    component's gap over its own change as well (printed, not judged).
    Field by field on the reference's device, so that a grid of a card's
    size fits."""
    from harness import sets
    eqs = eqs or sets.Incompressible
    names = sets.names(eqs, q_old.shape[0])
    floors = eqs.floors(model, q_old, dt)
    d_ref = model.step(q_old, dt)[0].to(torch.float64)
    ref_diag = eqs.diag_reference(model, d_ref, floors)

    def field(q, i):
        return q[i].to(model.device).to(torch.float64)

    for i in range(d_ref.shape[0]):
        d_ref[i] -= field(q_old, i)
    size = [float(torch.max(torch.abs(d))) for d in d_ref]
    mine = list(size)
    # a vector's change: each component's gap is taken over the largest
    # component's change; every other field over its own
    vec = list(eqs.vector)
    for i in vec:
        size[i] = max(mine[j] for j in vec)
    size = [max(s, f) for s, f in zip(size, floors)]
    out = {}
    for i in range(d_ref.shape[0]):
        d_prog = field(q_new, i) - field(q_old, i)
        gap = float(torch.max(torch.abs(d_prog - d_ref[i])))
        out[f"{tag}_{names[i]}"] = gap / size[i]
        if own is not None and i in vec:
            own[f"{tag}_{names[i]}"] = gap / mine[i]
        del d_prog
    del d_ref
    out[f"{tag}_diag"] = eqs.diag_gap(model, q_new, diag, ref_diag)
    return out


def stats_gap(model, q, p, tables):
    """The worst column gap of `tables` (the flow table, then one a
    scalar, each {column: values}) against the reference's tables of the
    stack q and pressure p: ({"stats": gap}, "table column")."""
    from reference import averages
    flow, scal = averages.tables(model, q, p)
    worst, where = -1.0, None
    for k, (table, ref) in enumerate(zip(tables, [flow] + scal)):
        name, g = averages.gap(table, ref)
        if g > worst:
            worst, where = g, f"{'flow' if k == 0 else f's{k}'} {name}"
    return {"stats": worst}, where


def verdict(readings: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number of the cell's limits
    read, finite and at or under its limit; a number without a limit is a
    fault of the cell."""
    unknown = set(readings) - set(limits)
    if unknown:
        raise KeyError(f"no limit for the numbers {sorted(unknown)}")
    rows = []
    ok = True
    for name, limit in limits.items():
        value = readings.get(name, math.nan)      # a number never read fails
        rows.append((name, value, limit))
        ok = ok and math.isfinite(value) and value <= limit
    return ok, rows
