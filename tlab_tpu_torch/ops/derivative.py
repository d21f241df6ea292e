"""Derivative application: dense operator products along one array axis.

A compact-FD derivative is one product with the precomputed dense operator
(tlab_tpu.fdm.plan).  The operator M (m, n) maps the n source nodes along
`axis` to m output nodes (m == n for derivatives, m == 2n for the stacked
[D1; D2]).  Works on 3-D fields and 4-D stacks alike: the caller passes the
axis index valid for the tensor itself.

Float32 products run in full float32 (device.full_fp32_matmul); the TPU's
precision knob (tlab_tpu/ops/derivative.py:33-59) has no counterpart.
"""
from __future__ import annotations

import math

import torch


def apply_along(M: torch.Tensor, u: torch.Tensor, axis: int) -> torch.Tensor:
    """out = M @ u along `axis` (one GEMM, batched over the leading axes)."""
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
