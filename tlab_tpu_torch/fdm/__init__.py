from tlab_tpu_torch.fdm.plan import DerivPlan, FdmPlan, build_fdm_plan  # noqa: F401
