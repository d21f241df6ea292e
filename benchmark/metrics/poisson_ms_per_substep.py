"""The pressure Poisson solve's device time a substep: CUDA events around
ops.elliptic_factorize.poisson_factorize (cuFFT and the batched complex
products), summed over the window, over its substeps."""

SPANS = (("tlab_tpu_torch.ops.elliptic_factorize", "poisson_factorize",
          "poisson"),)


def read(ctx):
    spans = ctx.get("spans") or {}
    if "poisson" not in spans:
        return None
    return spans["poisson"][0] / ctx["substeps"]
