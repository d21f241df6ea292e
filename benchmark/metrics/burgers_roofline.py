"""The Burgers term's share of its roofline: the least time of
roofline/burgers.py over the measured device time a substep."""
from harness import spec

SPANS = (("tlab_tpu_torch.dycore.incompressible", "_burgers_all",
          "burgers"),)


def read(ctx):
    spans = ctx.get("spans") or {}
    if "burgers" not in spans or spans["burgers"][0] <= 0.0:
        return None
    ms = spans["burgers"][0] / ctx["substeps"]
    b = spec.roofline("burgers", ctx["bench_dir"]).bound(
        ctx["shape"], ctx["fields"], ctx["word_bytes"])
    pct = 100.0 * 1e3 * b["seconds"] / ms
    ctx["log"](f"burgers roofline: bound {1e3 * b['seconds']:.4f} ms by "
               f"{b['by']} against {ms:.4f} ms a substep = {pct:.2f}% "
               f"({ctx['card']})")
    return pct
