"""Thermodynamic state utilities: cloud mixing diagrams
(reference src/tools/cloud: state.x/smooth.x/saturation.x/reversal.x; port
of tlab_tpu/tools/cloudstate.py).

Evaluate the airwater equilibrium over ranges of (h, qt) at fixed pressure:
mixing lines, saturation boundaries, buoyancy reversal diagnostics.  The
moist thermodynamics evaluate in float64 on `device` (physics/thermo.py:
its polynomial cancels in float32); results come back as NumPy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from tlab_tpu_torch import device as _device
from tlab_tpu_torch.physics import thermo


def _f64(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float64, device=device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def equilibrium_state(tp: thermo.ThermoParams, p: float, h: float,
                      qt: float, device="cuda") -> dict:
    """The state.x p-h case: {p, h, qt, T, ql, qv, qsat, R, rho} of one
    parcel in equilibrium, as Python floats."""
    dev = _device.resolve(device)
    one = torch.ones(1, dtype=torch.float64, device=dev)
    T, ql = thermo.equilibrium_T_ql(tp, h * one, qt * one, p * one,
                                    0.0 * one)
    qs = float(tp.qsat(T, _f64(p, dev))[0])
    R = float(thermo.mixture_R(tp, qt * one, ql)[0])
    T0, ql0 = float(T[0]), float(ql[0])
    return {"p": p, "h": h, "qt": qt, "T": T0, "ql": ql0, "qv": qt - ql0,
            "qsat": qs, "R": R, "rho": p / (R * T0)}


def mixing_diagram(tp: thermo.ThermoParams, h1, qt1, h2, qt2, p: float,
                   n: int = 101, device="cuda") -> dict:
    """States along the mixing line chi in [0,1] between parcels 1 and 2.

    Returns dict of (n,) arrays: chi, h, qt, T, ql, b (buoyancy relative to
    parcel 2, the environment) -- the buoyancy-reversal diagnostic of
    cloud-top mixing (reference saturation.x/state.x role).
    """
    dev = _device.resolve(device)
    chi = np.linspace(0.0, 1.0, n)
    h = (1 - chi) * h1 + chi * h2
    qt = (1 - chi) * qt1 + chi * qt2
    qt_t = _f64(qt, dev)
    T, ql = thermo.equilibrium_T_ql(tp, _f64(h, dev), qt_t,
                                    _f64(np.full(n, p), dev),
                                    _f64(np.zeros(n), dev))
    R = thermo.mixture_R(tp, qt_t, ql)
    # density temperature relative to the environment state (chi = 1)
    Tv = T * R / tp.Rd
    b = (Tv - Tv[-1]) / Tv[-1]
    return {"chi": chi, "h": h, "qt": qt, "T": _np(T), "ql": _np(ql),
            "b": _np(b)}


def saturation_curve(tp: thermo.ThermoParams, T_range, p: float,
                     device="cuda") -> np.ndarray:
    """qsat(T) at fixed pressure."""
    dev = _device.resolve(device)
    return _np(tp.qsat(_f64(T_range, dev), _f64(p, dev)))


def vapor_table(tp: thermo.ThermoParams, p: float, h: float, qt_range,
                path: str = None, device="cuda") -> dict:
    """Sweep qt at fixed (p, h) and tabulate the equilibrium partition
    (reference smooth.x p-h case, src/tools/cloud/smooth.f90:86-95:
    vapor.dat columns qt, ql, qv, qs(T), T)."""
    dev = _device.resolve(device)
    qt = np.asarray(qt_range, float)
    n = qt.shape[0]
    T, ql = thermo.equilibrium_T_ql(tp, _f64(np.full(n, h), dev),
                                    _f64(qt, dev), _f64(np.full(n, p), dev),
                                    _f64(np.zeros(n), dev))
    qs = _np(tp.qsat(T, _f64(p, dev)))
    ql = _np(ql)
    out = {"qt": qt, "ql": ql, "qv": qt - ql, "qs": qs, "T": _np(T)}
    if path is not None:
        cols = np.column_stack([out[k] for k in ("qt", "ql", "qv", "qs",
                                                 "T")])
        np.savetxt(path, cols, header="qt ql qv qs T")
    return out


def buoyancy_reversal(tp: thermo.ThermoParams, h1, qt1, h2, qt2, p: float,
                      n: int = 201, device="cuda") -> dict:
    """Buoyancy-reversal diagnostics of the mixing line (reference
    reversal.x): returns the mixing diagram plus the minimum-buoyancy
    mixture (chi_star, b_star) and the saturation crossing chi_s where
    ql -> 0 (cloud-top evaporative cooling instability criterion)."""
    d = mixing_diagram(tp, h1, qt1, h2, qt2, p, n=n, device=device)
    i_min = int(np.argmin(d["b"]))
    sat = d["ql"] > 1e-12
    # last saturated index along the line from the cloudy end (chi = 0)
    chi_s = d["chi"][np.max(np.where(sat)[0])] if sat.any() else 0.0
    d.update({"chi_star": float(d["chi"][i_min]),
              "b_star": float(d["b"][i_min]), "chi_s": float(chi_s)})
    return d
