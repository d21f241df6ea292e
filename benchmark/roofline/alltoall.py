"""The least time one RK substep's transposes can take on a (px, pz) mesh
of P = px pz ranks, from the shapes alone: the bytes each rank must send,
at one card's NVLink rate.

The model is the pencil decomposition of the configuration ([Parallel]
Mesh): y is never split, and each x or z derivative, and each transform
of the Poisson solve, works on whole lines, as tlab's transposition
engine has it.  A layout in which a rank holds whole x and whole y lines
holds whole x-y planes, a set of z's; one with whole z and y lines holds
a set of x's.  Between two such layouts, with N/P points a rank in each,
a rank keeps N/P^2 points and sends N/P (1 - 1/P), whatever the path.
Each advected field reaches both layouts (one crossing) and its Burgers
terms from both meet again (a second); the Poisson right-hand side goes
to its modes' layout and the pressure comes back: 2 F + 2 crossings a
substep for F fields.  The divergence, the pressure gradient and the
diagnostics move more, and are not counted: the count is a floor, which
no fusion of transposes passes.  A derivative along split lines (a
partitioned compact solve) would need a count of its own.  Words are the
fields' own; the complex modes hold as many words as the real field.
Rate: harness/peaks.py's NVLink bytes a second out of one card.
"""
from __future__ import annotations

from harness import peaks


def bound(shape, fields: int, word_bytes: int, px: int, pz: int) -> dict:
    """{bytes, rate, seconds} that leave each rank in one substep."""
    nx, ny, nz = shape
    ranks = px * pz
    crossing = nx * ny * nz / ranks * (1.0 - 1.0 / ranks) * word_bytes
    nbytes = (2 * fields + 2) * crossing
    return {"bytes": nbytes, "rate": peaks.NVLINK_BYTES_PER_S,
            "seconds": nbytes / peaks.NVLINK_BYTES_PER_S}
