"""The AirWater thermodynamics' device time a substep: CUDA events around
the physics.thermo entry points that the anelastic step calls through the
module (buoyancy_explicit each substep, equilibrium_newton_error in the
step's diagnostics), summed over the window, over its substeps."""

SPANS = (("tlab_tpu_torch.physics.thermo", "buoyancy_explicit", "thermo"),
         ("tlab_tpu_torch.physics.thermo", "equilibrium_newton_error",
          "thermo"))


def read(ctx):
    spans = ctx.get("spans") or {}
    if "thermo" not in spans:
        return None
    return spans["thermo"][0] / ctx["substeps"]
