"""The Burgers term's device time a substep: CUDA events around
dycore.incompressible._burgers_all (K1-K3, or the dense products where
the gate refuses them), summed over the window, over its substeps."""

SPANS = (("tlab_tpu_torch.dycore.incompressible", "_burgers_all",
          "burgers"),)


def read(ctx):
    spans = ctx.get("spans") or {}
    if "burgers" not in spans:
        return None
    return spans["burgers"][0] / ctx["substeps"]
