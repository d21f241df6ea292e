"""Coriolis-force properties (cf. reference src/physics/rotation.f90).

The case file's description of the term, as tlab_tpu/physics/rotation.py
keeps it: the Rossby number is folded into the rotation vector.  Parsed
so that every case file loads; the term itself is not ported.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CoriolisProps:
    type: str = "none"           # none | explicit | normalized
    vector: tuple = (0.0, 0.0, 0.0)   # f_i / Rossby
    parameters: tuple = (0.0, 1.0)    # (rotation angle, geostrophic speed)
