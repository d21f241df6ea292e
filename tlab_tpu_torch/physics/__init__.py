from tlab_tpu_torch.physics.params import NSParams  # noqa: F401
