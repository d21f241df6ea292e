"""The least time one RK substep's right-hand side of the compressible
internal-energy set (Equations=internal, reference/compressible.py's
equations) can take on the card, from the shapes alone: the work of the
equations, not how the program does it.

Operations, a point:
- the first derivatives the equations need, along each direction with
  more than one point: the continuity's mass flux (1), the momentum
  fluxes (3), the velocity gradient (3, which give the dissipation, the
  dilatation and p div u), the dilatation's gradient (1), the energy flux
  (1), and for each scalar its flux (1) and its gradient (1), with the
  density's gradient (1) where there is a scalar: 12 a direction, 36 in
  all, for one scalar;
- the second derivatives: the Laplacians of u, v, w and T and of each
  scalar, 5 a direction, 15 in all, for one scalar;
- each derivative at the compact scheme's banded cost a point: the first
  derivative's 5-point explicit side (2 differences, 2 products, 1 sum)
  and its tridiagonal solve with stored factors (5), D1_FLOPS = 10; the
  second derivative's 7-point symmetric side (10) and its solve (5),
  D2_FLOPS = 15;
- the pointwise algebra, ALGEBRA_FLOPS + SCALAR_FLOPS a scalar: the
  primitives (8), the momentum fluxes and p (9), the sums of the
  continuity and the dilatation (4), the momentum's sums and viscous terms
  (24), the dissipation (29), the energy (12), each scalar's flux,
  Laplacian and cross term (17).
at the fp32-accurate rate of the tensor cores (harness/peaks.py), an
upper bound of any fp32 rate of the card, so that the count is a floor
for dense products, banded solves and fused kernels alike.

Bytes: the state read once and the tendency written once, 2 F N words.
The bound is the larger of the two times.
"""
from __future__ import annotations

from harness import peaks

D1_FLOPS = 10
D2_FLOPS = 15
ALGEBRA_FLOPS = 86
SCALAR_FLOPS = 17


def derivatives(shape, fields: int) -> tuple:
    """(first, second) derivatives a substep of F = 5 + ns fields needs."""
    ns = fields - 5
    axes = sum(1 for m in shape if m > 1)
    first = (9 + 2 * ns + (1 if ns else 0)) * axes
    second = (4 + ns) * axes
    return first, second


def bound(shape, fields: int, word_bytes: int = 4) -> dict:
    """{ops, bytes, seconds, by, d1, d2} of one substep's right-hand side
    of F = 5 + ns fields."""
    nx, ny, nz = shape
    n = nx * ny * nz
    d1, d2 = derivatives(shape, fields)
    per_point = d1 * D1_FLOPS + d2 * D2_FLOPS + ALGEBRA_FLOPS \
        + SCALAR_FLOPS * (fields - 5)
    ops = float(per_point * n)
    nbytes = 2 * fields * n * word_bytes
    t_ops = ops / peaks.FP32_ACCURATE_FLOPS
    t_bytes = nbytes / peaks.HBM_BYTES_PER_S
    return {"ops": ops, "bytes": nbytes, "seconds": max(t_ops, t_bytes),
            "by": "operations" if t_ops >= t_bytes else "bytes",
            "d1": d1, "d2": d2}
