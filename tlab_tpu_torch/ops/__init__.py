"""Operators: derivatives, the fused Burgers kernel, the factorized Poisson."""
from tlab_tpu_torch.ops.derivative import apply_along, der1, der2, der12  # noqa: F401
