"""The all-to-alls' share of their roofline on rank 0: the least time of
roofline/alltoall.py (the bytes a substep must send out of a rank, at the
card's NVLink rate) over the measured all-to-all time a substep."""
from harness import collectives, spec


def read(ctx):
    got = collectives.alltoall(ctx.get("trace"))
    if got is None or got[0] <= 0.0 or "mesh" not in ctx:
        return None
    t = ctx["trace"]
    ms = 1e3 * got[0] / (t["steps"] * ctx["substeps_per_step"])
    b = spec.roofline("alltoall", ctx["bench_dir"]).bound(
        ctx["shape"], ctx["fields"], ctx["word_bytes"], *ctx["mesh"])
    pct = 100.0 * 1e3 * b["seconds"] / ms
    ctx["log"](f"alltoall roofline: {b['bytes']:.6g} B a rank at "
               f"{b['rate']:.4g} B/s = {1e3 * b['seconds']:.4f} ms against "
               f"{ms:.4f} ms a substep = {pct:.2f}% ({ctx['card']})")
    return pct
