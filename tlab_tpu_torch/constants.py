"""Shared constants and enums.

Mirrors the semantics of the reference's boundary-condition tags
(reference src/base/tlab_constants.f90) without copying its layout.
"""
from __future__ import annotations

import enum


class BC(enum.IntEnum):
    """Boundary-condition cases for derivative/BVP operators along a line.

    Naming: first letter = condition at the minimum end, second at the maximum
    end. D = Dirichlet (function value), N = Neumann (first derivative).
    """

    DD = 0          # no special treatment (biased boundary stencils)
    ND = 1          # Neumann at min end
    DN = 2          # Neumann at max end
    NN = 3          # Neumann at both ends
    PERIODIC = 4


class Scheme(enum.Enum):
    """Compact finite-difference schemes (cf. reference fdm_derivative.f90:51-58)."""

    COMPACT_JACOBIAN_4 = "CompactJacobian4"
    COMPACT_JACOBIAN_6 = "CompactJacobian6"
    COMPACT_JACOBIAN_6_PENTA = "CompactJacobian6Penta"
    COMPACT_JACOBIAN_6_HYPER = "CompactJacobian6Hyper"
    COMPACT_DIRECT_4 = "CompactDirect4"
    COMPACT_DIRECT_6 = "CompactDirect6"


class EquationSet(enum.Enum):
    INCOMPRESSIBLE = "incompressible"
    ANELASTIC = "anelastic"
    INTERNAL = "internal"
    TOTAL = "total"


# axis indices, named after the reference convention: x streamwise (axis 0),
# y vertical / inhomogeneous (axis 1), z spanwise (axis 2)
AXIS_X, AXIS_Y, AXIS_Z = 0, 1, 2
