"""Device and dtype policy of the port.

There is no global default device: every plan, state and kernel call names
its device.  Asking for CUDA where there is none is an error, never a quiet
run on the CPU.
"""
from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """torch.device for `device` ('cpu', 'cuda', 'cuda:1', a torch.device);
    raises if CUDA is asked for and not available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def full_fp32_matmul() -> None:
    """Keep float32 products in full float32 on the card.

    TF32 keeps a 10-bit mantissa (~3 digits).  The compact-derivative
    operators are held to float64 at ~1e-5 per RK step, and the factorized
    Poisson modal sweeps recombine eigenvectors with cond(V) up to ~1e7
    (ops/elliptic_factorize.py), where TF32 round-off turns into garbage.
    Both switches are set explicitly because their defaults differ
    (matmul off, cuDNN on) and have changed between releases."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def complex_dtype(dtype: torch.dtype) -> torch.dtype:
    """The complex type paired with a real working dtype."""
    if dtype == torch.float32:
        return torch.complex64
    if dtype == torch.float64:
        return torch.complex128
    raise TypeError(f"no complex pair for {dtype}")
