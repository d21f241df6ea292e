"""The device time of the mesh's all-to-alls a substep, on rank 0: the
NCCL send/receive kernels of the traced stretch (harness/collectives.py),
over the stretch's substeps.  It holds the wait for the slowest rank."""
from harness import collectives


def read(ctx):
    got = collectives.alltoall(ctx.get("trace"))
    if got is None:
        return None
    t = ctx["trace"]
    return 1e3 * got[0] / (t["steps"] * ctx["substeps_per_step"])
