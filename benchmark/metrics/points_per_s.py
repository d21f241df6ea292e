"""Grid points times RK substeps completed in the window, over the
window's seconds (host clock): the reference's headline unit.  On a mesh
the whole grid's points over rank 0's window."""
from harness import numbers


def read(ctx):
    w = ctx["window"]
    return numbers.rate(ctx["points"] * w.steps * ctx["substeps_per_step"],
                        w.seconds)
