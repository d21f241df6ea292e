"""Dynamical cores (the incompressible main path)."""
from tlab_tpu_torch.dycore.state import State  # noqa: F401
