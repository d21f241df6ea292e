"""Buoyancy/body-force properties (cf. reference src/physics/gravity.f90).

The case file's description of the term, as tlab_tpu/physics/gravity.py
keeps it: the Froude number is folded into the vector.  The port parses
it so that every case file loads; the term itself is not ported
(runtime._off_path_options refuses a case that switches it on).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BuoyancyProps:
    type: str = "none"            # none|homogeneous|linear|bilinear|quadratic|normalizedmean|subtractmean
    vector: tuple = (0.0, 0.0, 0.0)   # g_i / Froude
    parameters: tuple = (0.0,)

    @property
    def active(self):
        return tuple(abs(v) > 0.0 for v in self.vector)
