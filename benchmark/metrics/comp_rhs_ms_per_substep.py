"""The compressible right-hand side's device time a substep: CUDA events
around dycore.compressible's rhs_compressible_internal and
rhs_compressible (the internal- and total-energy sets' tendencies, which
rk_step_compressible calls through the module once a substep), summed
over the window, over its substeps."""

SPANS = (("tlab_tpu_torch.dycore.compressible", "rhs_compressible_internal",
          "comp_rhs"),
         ("tlab_tpu_torch.dycore.compressible", "rhs_compressible",
          "comp_rhs"))


def read(ctx):
    spans = ctx.get("spans") or {}
    if "comp_rhs" not in spans:
        return None
    return spans["comp_rhs"][0] / ctx["substeps"]
