"""Buffer/sponge-zone specification (reference
src/tools/dns/boundary_buffer.f90), as tlab_tpu/dycore/buffer.py keeps it.

Parsed so that every case file loads; the relaxation itself is not ported.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BufferSpec:
    type: str = "none"           # none | relaxation | filter | both
    points_jmin: int = 0
    points_jmax: int = 0
    points_imin: int = 0         # streamwise strips (spatial mode)
    points_imax: int = 0
    strength: float = 1.0
    sigma: float = 2.0
