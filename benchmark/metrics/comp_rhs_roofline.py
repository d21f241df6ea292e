"""The compressible right-hand side's share of its roofline: the least
time of roofline/comp_rhs.py over the measured device time a substep."""
from harness import spec

SPANS = (("tlab_tpu_torch.dycore.compressible", "rhs_compressible_internal",
          "comp_rhs"),
         ("tlab_tpu_torch.dycore.compressible", "rhs_compressible",
          "comp_rhs"))


def read(ctx):
    spans = ctx.get("spans") or {}
    if "comp_rhs" not in spans or spans["comp_rhs"][0] <= 0.0:
        return None
    ms = spans["comp_rhs"][0] / ctx["substeps"]
    b = spec.roofline("comp_rhs", ctx["bench_dir"]).bound(
        ctx["shape"], ctx["fields"], ctx["word_bytes"])
    pct = 100.0 * 1e3 * b["seconds"] / ms
    ctx["log"](f"comp_rhs roofline: {b['d1']} d1 and {b['d2']} d2 a "
               f"substep, bound {1e3 * b['seconds']:.4f} ms by {b['by']} "
               f"against {ms:.4f} ms a substep = {pct:.2f}% ({ctx['card']})")
    return pct
