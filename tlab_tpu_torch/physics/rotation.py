"""Coriolis force (cf. reference src/physics/rotation.f90), port of
tlab_tpu/physics/rotation.py.

explicit:    h += -2 Omega x u  written with the Rossby number folded into
             the rotation vector (reference Rotation_Coriolis:118-124).
normalized:  Ekman-layer form, angular velocity along Oy, geostrophic wind
             (cos a, 0, -sin a) * G (reference :126-140).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CoriolisProps:
    type: str = "none"           # none | explicit | normalized
    vector: tuple = (0.0, 0.0, 0.0)   # f_i / Rossby
    parameters: tuple = (0.0, 1.0)    # (rotation angle, geostrophic speed)


def coriolis_tendency(props: CoriolisProps, u, v, w):
    """Returns (r1, r2, r3) additive momentum tendencies; a component the
    type leaves alone is the float 0.0."""
    f1, f2, f3 = props.vector
    if props.type == "explicit":
        return (f3 * v - f2 * w, f1 * w - f3 * u, f2 * u - f1 * v)
    if props.type == "normalized":
        angle, G = props.parameters[0], props.parameters[1]
        geo_u = np.cos(angle) * G
        geo_w = -np.sin(angle) * G
        return (f2 * (geo_w - w), 0.0, f2 * (u - geo_u))
    return (0.0, 0.0, 0.0)
