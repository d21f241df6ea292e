"""Derivative application: dense operator products along one array axis.

A compact-FD derivative is one product with the precomputed dense operator
(tlab_tpu.fdm.plan).  The operator M (m, n) maps the n source nodes along
`axis` to m output nodes (m == n for derivatives, m == 2n for the stacked
[D1; D2]).  Works on 3-D fields and 4-D stacks alike: the caller passes the
axis index valid for the tensor itself.

The products here run in full float32 (device.full_fp32_matmul) at every
setting.  The compressible set's float32 products on the card do not come
here: they run 3xTF32 in the kernels of ops/burgers.py (deriv1, deriv12),
within fp32 round-off of these.  The TPU's precision knob
(tlab_tpu/ops/derivative.py:33-59), TLAB_TPU_MATMUL_PRECISION, reaches the
port's fused Burgers kernels alone: op_precision names their arithmetic
contract.
"""
from __future__ import annotations

import math
import os

import torch

from tlab_tpu_torch.utils import trace as _trace

# tlab_tpu's precision names, from the cheapest to the most exact
PRECISIONS = ("default", "high", "highest")


def op_precision(dtype):
    """The arithmetic contract of the float32 Burgers kernels
    (ops/burgers.py: "default" one bf16 pass, "high" 3-pass bf16, "highest"
    3xTF32), the counterpart of tlab_tpu's op_precision: for float32 the
    value of TLAB_TPU_MATMUL_PRECISION, read at each call (tlab_tpu reads it
    at each trace), lower-cased; None for any other dtype.

    Unset means "highest", where tlab_tpu means "high": off a TPU tlab_tpu
    computes full fp32 whatever the name, and every witness and limit of
    the port is such a computation.  An unknown value raises ValueError
    (tlab_tpu takes "high" for its kernel and HIGHEST for its einsums).
    The port's other products keep their arithmetic at every setting: the
    dense products here full fp32, the compressible set's float32 products
    on the card 3xTF32 (ops/burgers.py deriv1, deriv12), as tlab_tpu's
    einsums stay HIGHEST."""
    if dtype != torch.float32:
        return None
    name = os.environ.get("TLAB_TPU_MATMUL_PRECISION", "highest").lower()
    if name not in PRECISIONS:
        raise ValueError(f"TLAB_TPU_MATMUL_PRECISION={name!r}: expected "
                         f"one of {PRECISIONS}")
    return name


def apply_along(M: torch.Tensor, u: torch.Tensor, axis: int) -> torch.Tensor:
    """out = M @ u along `axis` (one GEMM, batched over the leading axes)."""
    _trace.count("library.cublas")
    n = u.shape[axis]
    if axis == u.ndim - 1:
        return torch.matmul(u, M.T)
    lead = math.prod(u.shape[:axis])
    out = torch.matmul(M, u.reshape(lead, n, -1))
    return out.reshape(*u.shape[:axis], M.shape[0], *u.shape[axis + 1:])


def der1(plan_d1: torch.Tensor, u: torch.Tensor, axis: int) -> torch.Tensor:
    """First derivative along `axis`."""
    return apply_along(plan_d1, u, axis)


def der2(plan_d2: torch.Tensor, u: torch.Tensor, axis: int) -> torch.Tensor:
    """Second derivative along `axis`."""
    return apply_along(plan_d2, u, axis)


def der12(plan_d12: torch.Tensor, u: torch.Tensor, axis: int):
    """(d1 u, d2 u) from one product with the stacked (2n, n) operator."""
    n = u.shape[axis]
    out = apply_along(plan_d12, u, axis)
    return out.narrow(axis, 0, n), out.narrow(axis, n, n)
