"""Governing-equation parameters (nondimensional numbers).

Equivalent of the reference's NavierStokes module state
(src/physics/navierstokes.f90:11-34).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from tlab_tpu_torch.constants import EquationSet


@dataclasses.dataclass(frozen=True)
class NSParams:
    equations: EquationSet = EquationSet.INCOMPRESSIBLE
    reynolds: float = 100.0
    schmidt: Tuple[float, ...] = (1.0,)
    prandtl: float = 1.0
    froude: float = 1.0
    rossby: float = 1.0
    stokes: float = 0.0
    settling: float = 0.0
    mach: float = 0.0

    @property
    def visc(self) -> float:
        """1/Re, the molecular-transport prefactor used by all operators."""
        return 1.0 / self.reynolds

    @property
    def n_scalars(self) -> int:
        return len(self.schmidt)

    def diffusivity(self, i: int) -> float:
        return self.visc / self.schmidt[i]
