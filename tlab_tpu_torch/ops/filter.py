"""3-D field filter specification (reference src/operators/opr_filter.f90),
as tlab_tpu/ops/filter.py keeps it.

Parsed so that every case file loads; the filters themselves are not ported.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FilterSpec:
    type: str = "none"       # none|compact|explicit6|explicit4|tophat|adm|helmholtz
    parameters: tuple = (0.49,)
    active: tuple = (True, True, True)
    step: int = 0            # domain-filter cadence (0 = off)
    # y-direction wall closure (reference BcsJmin/BcsJmax,
    # opr_filter.f90:160-185): 'biased' (default) | 'zero'
    bcs_j: tuple = ("biased", "biased")
