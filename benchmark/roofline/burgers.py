"""The least time one RK substep's Burgers term nu d2(q) - u_i d1(q) can
take on the card, from the shapes alone: the work, not how it is done.

Operations: the [D1;D2] products along each axis, 2 n^2 a line of n
points for each of the two operators, for each field, counted once:
4 F N n_axis a direction for N points and F fields.  Bytes: along each
direction the fields and the advecting velocity read once and the
result written once, (2F + 1) N words.  Peaks: harness/peaks.py, the
fp32-accurate rate of the tensor cores (495 TFLOP/s of TF32 over the 3
passes an fp32-accurate product takes) and 3.35 TB/s.  The arithmetic is
that of the kernel table's bound_ms in PERF.md.
"""
from __future__ import annotations

from harness import peaks


def bound(shape, fields: int, word_bytes: int = 4) -> dict:
    """{ops, bytes, seconds, by} of one substep's Burgers term."""
    nx, ny, nz = shape
    n = nx * ny * nz
    ops = sum(4.0 * fields * n * m for m in shape if m > 1)
    nbytes = sum((2 * fields + 1) * n * word_bytes for m in shape if m > 1)
    t_ops = ops / peaks.FP32_ACCURATE_FLOPS
    t_bytes = nbytes / peaks.HBM_BYTES_PER_S
    return {"ops": ops, "bytes": nbytes, "seconds": max(t_ops, t_bytes),
            "by": "operations" if t_ops >= t_bytes else "bytes"}
