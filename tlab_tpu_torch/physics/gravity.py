"""Buoyancy/body-force term (cf. reference src/physics/gravity.f90), port of
tlab_tpu/physics/gravity.py.

b(s) is an algebraic function of the scalars minus a reference background
profile; the force entering the momentum tendency is vector * b with the
Froude number folded into the vector (reference Gravity_Initialize:96-101).

buoyancy_field works on torch tensors (the step, the statistics) and on
NumPy arrays alike (background_profile, float64 at plan time).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BuoyancyProps:
    type: str = "none"            # none|homogeneous|linear|bilinear|quadratic|normalizedmean|subtractmean
    vector: tuple = (0.0, 0.0, 0.0)   # g_i / Froude
    parameters: tuple = (0.0,)

    @property
    def active(self):
        return tuple(abs(v) > 0.0 for v in self.vector)


def _full(s, value):
    """A field of s's library, dtype and device filled with `value`."""
    if isinstance(s, torch.Tensor):
        return torch.full(tuple(s.shape[1:]), value, dtype=s.dtype,
                          device=s.device)
    return np.full(s.shape[1:], value, s.dtype)


def buoyancy_field(props: BuoyancyProps, s, ref):
    """b(s) - ref broadcast over y (reference Gravity_Buoyancy:232-342).

    s: (ns, nx, ny, nz); ref: (ny,) background buoyancy profile, of the
    same library (and device) as s.
    """
    p = props.parameters
    refb = ref[None, :, None]
    ns = s.shape[0]
    t = props.type
    if t == "homogeneous":
        return _full(s, p[0]) - refb * 0.0
    if t == "linear":
        c0 = p[ns] if len(p) > ns else 0.0
        b = c0 - refb
        for i in range(ns):
            ci = p[i] if i < len(p) else 0.0
            if ci != 0.0:
                b = b + ci * s[i]
        return b
    if t == "bilinear":
        return p[0] * s[0] + p[1] * s[1] + p[2] * s[0] * s[1] - refb
    if t == "quadratic":
        c0 = -p[0] / (p[1] / 2.0) ** 2
        return c0 * s[0] * (s[0] - p[1]) - refb
    if t == "normalizedmean":
        return p[0] * (s[0] / refb - 1.0)
    if t == "subtractmean":
        return p[0] * (s[0] - refb)
    return _full(s, 0.0)


def background_profile(props: BuoyancyProps, s_profiles, y: np.ndarray):
    """bbackground(y) from the scalar mean profiles
    (reference tlab_background.f90:217-223): float64 NumPy, (ny,)."""
    if props.type == "none" or not props.active[1]:
        return np.zeros_like(y)
    sb = np.stack([prof(y) for prof in s_profiles]) if s_profiles else \
        np.zeros((0, y.shape[0]))
    with np.errstate(divide="ignore", invalid="ignore"):
        # normalizedmean divides by the zero reference here, as tlab_tpu
        b = buoyancy_field(props,
                           np.asarray(sb, np.float64)[:, None, :, None],
                           np.zeros_like(y))
    return np.reshape(b[:, :, 0], (-1,))


def buoyancy_source(props: BuoyancyProps, gradient):
    """Evaporative/buoyancy source b''(s) |grad s|^2 (reference
    Gravity_Buoyancy_Source, gravity.f90:346-376): zero for the
    homogeneous/linear/bilinear types, 2 c0 |grad s|^2 for quadratic."""
    if props.type == "quadratic":
        p = props.parameters
        c0 = -p[0] / (p[1] / 2.0) ** 2
        return 2.0 * c0 * gradient
    return torch.zeros_like(gradient)
