"""Plain float64 plane statistics of an incompressible state, the columns
of tlab's avg<it> and avg<it>s<i> tables (avg_flow_xz.f90,
avg_scal_xz.f90) that a shear-layer run writes and this reference
recomputes: the means, the second to fourth moments, the mean vorticity
and its variance, and the mean gradients.

Each column comes with a scale of the same reduction taken over the
magnitudes of its terms, so that a column that vanishes (the mean of v
between walls) is judged against the size of what it sums and not
against its own round-off.
"""
from __future__ import annotations

import torch

from reference.step import Model

FLOW = ("rU rV rW rP Tke Rxx Ryy Rzz Rxy Rxz Ryz rP2 Wx Wy Wz Wx2 Wy2 Wz2 "
        "rU3 rU4 rV3 rV4 rW3 rW4 U_y1 V_y1 W_y1").split()
SCALAR = "rS fS rS_y fS_y Rsu Rsv Rsw fS2 fS3 fS4 rS2 rS3 rS4".split()


def _pavg(a):
    return torch.mean(a, dim=(0, 2))


def tables(model: Model, q, p):
    """({flow column: (value, scale)}, [{scalar column: (value, scale)}])
    of the stack q (3 + ns, nx, ny, nz) and the pressure p, float64."""
    q = q.to(model.device, torch.float64)
    p = p.to(model.device, torch.float64)
    d1y = model.d1[1].to(torch.float64)

    def dy(prof, mag):
        return d1y @ prof, torch.abs(d1y) @ mag

    def d1(a, axis):
        return model.d1_along(a.to(model.dtype), axis).to(torch.float64)

    u, v, w = q[0], q[1], q[2]
    means = {n: (_pavg(f), _pavg(torch.abs(f)))
             for n, f in (("U", u), ("V", v), ("W", w), ("P", p))}
    fl = {n: f - means[n][0][None, :, None]
          for n, f in (("U", u), ("V", v), ("W", w), ("P", p))}
    out = {f"r{n}": means[n] for n in "UVWP"}
    for n, a, b in (("Rxx", "U", "U"), ("Ryy", "V", "V"), ("Rzz", "W", "W"),
                    ("Rxy", "U", "V"), ("Rxz", "U", "W"), ("Ryz", "V", "W"),
                    ("rP2", "P", "P")):
        out[n] = (_pavg(fl[a] * fl[b]), _pavg(torch.abs(fl[a] * fl[b])))
    out["Tke"] = tuple(0.5 * (out["Rxx"][k] + out["Ryy"][k] + out["Rzz"][k])
                       for k in (0, 1))
    for n, (a, ia, b, ib) in (("Wx", (w, 1, v, 2)), ("Wy", (u, 2, w, 0)),
                              ("Wz", (v, 0, u, 1))):
        ga, gb = d1(a, ia), d1(b, ib)
        om = ga - gb
        mag = torch.abs(ga) + torch.abs(gb)
        m = _pavg(om)
        out[n] = (m, _pavg(mag))
        out[n + "2"] = (_pavg((om - m[None, :, None]) ** 2), _pavg(mag ** 2))
    for n in "UVW":
        for k in (3, 4):
            out[f"r{n}{k}"] = (_pavg(fl[n] ** k), _pavg(torch.abs(fl[n]) ** k))
        out[f"{n}_y1"] = dy(*means[n])
    scal = []
    for i in range(q.shape[0] - 3):
        s = q[3 + i]
        rS, mS = _pavg(s), _pavg(torch.abs(s))
        sf = s - rS[None, :, None]
        t = {"rS": (rS, mS), "fS": (rS, mS), "rS_y": dy(rS, mS),
             "fS_y": dy(rS, mS)}
        for n, f in (("Rsu", fl["U"]), ("Rsv", fl["V"]), ("Rsw", fl["W"])):
            t[n] = (_pavg(sf * f), _pavg(torch.abs(sf * f)))
        for k in (2, 3, 4):
            t[f"rS{k}"] = t[f"fS{k}"] = (_pavg(sf ** k),
                                         _pavg(torch.abs(sf) ** k))
        scal.append(t)
    return out, scal


def read_avg(path: str) -> dict:
    """The columns of an avg<it> text table by name (its `I J Y ...`
    header line, then one row a plane)."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    head = next(i for i, ln in enumerate(lines) if ln.startswith("I J Y"))
    names = lines[head].split()[3:]
    rows = [[float(x) for x in ln.split()[3:]] for ln in lines[head + 1:]
            if ln.strip()]
    cols = torch.tensor(rows, dtype=torch.float64).T
    return dict(zip(names, cols))


def gap(table: dict, ref: dict):
    """(the worst column, its gap): max over rows of |program - reference|
    over the max of the column's scale."""
    worst, name = -1.0, None
    for n, (val, scale) in ref.items():
        got = table[n].to(val.device)
        g = float(torch.max(torch.abs(got - val))
                  / torch.clamp(torch.max(scale), min=1e-300))
        if g > worst:
            worst, name = g, n
    return name, worst
