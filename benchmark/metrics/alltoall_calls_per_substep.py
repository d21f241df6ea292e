"""The all-to-alls a substep, on rank 0: the NCCL send/receive kernels of
the traced stretch (one a dist.all_to_all_single; harness/collectives.py),
over the stretch's substeps.  A count: it repeats exactly while the code
path stands, and a fusion of transposes moves it."""
from harness import collectives


def read(ctx):
    got = collectives.alltoall(ctx.get("trace"))
    if got is None:
        return None
    t = ctx["trace"]
    return got[1] / (t["steps"] * ctx["substeps_per_step"])
