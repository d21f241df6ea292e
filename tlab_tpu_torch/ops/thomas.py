"""Batched substructured solves for long compact-FDM lines (port of
tlab_tpu/ops/pallas_thomas.py, which has held no Pallas code since its
sequential Thomas kernel was removed: its plans and its two einsum
functions are what this module keeps).

The dense formulation (fdm/plan.py) applies a compact scheme as one N x N
product, 2N multiply-adds a point.  For long lines the PARTITIONED solve
costs 2L a point instead: the line is split into S segments of length L,
each solved by a precomputed dense L x L inverse, and the 2S interface
unknowns are closed by a small precomputed 2S x 2S inverse.  The algebra is
an exact block LU of the same matrix (Wang 1981's partition method), so the
result agrees with the dense product to round-off.

The plans are host float64 NumPy, built exactly as tlab_tpu builds them
(`dtype` is the NumPy type of the arrays); device_plan casts them once to
the run's dtype on its device.  partitioned_solve and banded_der1 work on
tensors: per-segment batched GEMMs in full float32 (device.full_fp32_matmul)
or float64, as tlab_tpu's einsums are.  The slabs of banded_der1 are a
strided view of the padded lines (Tensor.unfold), not S stacked copies.
"""
from __future__ import annotations

import numpy as np
import torch

from tlab_tpu_torch import device as _device


# ---------------------------------------------------------------------------
# Host plans (the NumPy of tlab_tpu/ops/pallas_thomas.py)
# ---------------------------------------------------------------------------

def partitioned_plan(A: np.ndarray, L: int = 128, dtype=np.float32,
                     periodic: bool = False):
    """Host-side substructuring of a shared (quasi-)tridiagonal A.

    A may carry arbitrary boundary ROWS (the compact schemes' biased
    rows live inside the first/last segment blocks); only the
    off-segment couplings must be the single sub/superdiagonal elements,
    true for tridiagonal A away from the wall rows.  periodic=True adds
    the circulant corner couplings A[0, n-1]/A[n-1, 0] (the
    Sherman-Morrison analog lives in the interface system for free)."""
    A = np.asarray(A, np.float64)
    n = A.shape[0]
    if n % L:
        # choose the largest power-of-two-ish block that divides n
        for cand in (256, 128, 64, 32, 16, 8):
            if n % cand == 0 and cand < n:
                L = cand
                break
        else:
            raise ValueError(f"n={n} has no usable segment size")
    S = n // L
    Tinv = np.zeros((S, L, L))
    xL = np.zeros((S, L))
    xR = np.zeros((S, L))
    for s in range(S):
        sl = slice(s * L, (s + 1) * L)
        Ts = A[sl, sl]
        Tinv[s] = np.linalg.inv(Ts)
        if s > 0:
            a_edge = A[s * L, s * L - 1]          # coupling to prev last
            xL[s] = Tinv[s, :, 0] * a_edge
        if s < S - 1:
            c_edge = A[(s + 1) * L - 1, (s + 1) * L]  # coupling to next
            xR[s] = Tinv[s, :, L - 1] * c_edge
    if periodic:
        # wrap couplings: segment 0 first row <- u[n-1]; last segment's
        # last row <- u[0]
        xL[0] = Tinv[0, :, 0] * A[0, n - 1]
        xR[S - 1] = Tinv[S - 1, :, L - 1] * A[n - 1, 0]

    # interface system M z = v_edges over z = [u_s[0], u_s[L-1]]_s
    M = np.eye(2 * S)
    for s in range(S):
        i0, i1 = 2 * s, 2 * s + 1
        sp_ = (s - 1) % S if periodic else s - 1
        sn_ = (s + 1) % S if periodic else s + 1
        if s > 0 or periodic:
            M[i0, 2 * sp_ + 1] += xL[s, 0]
            M[i1, 2 * sp_ + 1] += xL[s, L - 1]
        if s < S - 1 or periodic:
            M[i0, 2 * sn_] += xR[s, 0]
            M[i1, 2 * sn_] += xR[s, L - 1]
    Minv = np.linalg.inv(M)
    nt = np.dtype(dtype)
    return {"Tinv": np.asarray(Tinv, nt), "xL": np.asarray(xL, nt),
            "xR": np.asarray(xR, nt), "Minv": np.asarray(Minv, nt),
            "S": S, "L": L, "n": n, "periodic": bool(periodic)}


def banded_plan(A1: np.ndarray, B1: np.ndarray, dtype=np.float32,
                band: int = 8, seg: int = 128, periodic: bool = False):
    """Fused substructured derivative: per segment s the stage-1 result
    of the partitioned solve of A with rhs = B u is

        v_s = (Tinv_s @ B[rows_s, slab_s]) u[slab_s]

    with slab_s = [sL - band, (s+1)L + band) (B is banded; boundary
    biased rows live inside the first/last slab -- or wrap around for
    periodic/circulant schemes).  One matmul pass total -- flops/point
    2(L + 2 band) instead of the dense path's 2N."""
    A1 = np.asarray(A1, np.float64)
    B1 = np.asarray(B1, np.float64)
    n = A1.shape[0]
    part = partitioned_plan(A1, L=seg, dtype=dtype, periodic=periodic)
    S, L = part["S"], part["L"]
    pad = band
    W = L + 2 * pad
    F = np.zeros((S, L, W))
    Tinv = np.asarray(part["Tinv"], np.float64)
    for s in range(S):
        rows = np.arange(s * L, (s + 1) * L)
        g0 = s * L - pad                          # slab's first column
        blk = np.zeros((L, W))
        placed = 0.0
        for rl, r in enumerate(rows):
            for c in np.nonzero(B1[r])[0]:
                d = (c - g0) % n if periodic else c - g0
                if 0 <= d < W:
                    blk[rl, d] += B1[r, c]
                    placed += abs(B1[r, c])
        total = np.abs(B1[rows]).sum()
        if total - placed > 1e-9 * max(total, 1.0):
            raise ValueError("B bandwidth exceeds the slab pad")
        F[s] = Tinv[s] @ blk
    nt = np.dtype(dtype)
    return {"part": part, "F": np.asarray(F, nt), "pad": pad,
            "n": n, "band": band, "periodic": bool(periodic)}


def device_plan(plan: dict, dtype=torch.float32, device="cuda") -> dict:
    """A partitioned or banded plan with its arrays as tensors in `dtype`
    on `device` (the integers and flags stay Python values)."""
    dev = _device.resolve(device)
    out = {}
    for key, val in plan.items():
        if isinstance(val, dict):
            out[key] = device_plan(val, dtype, dev)
        elif isinstance(val, np.ndarray):
            out[key] = torch.as_tensor(np.asarray(val, np.float64)).to(
                dev, dtype)
        else:
            out[key] = val
    return out


# ---------------------------------------------------------------------------
# Tensor functions
# ---------------------------------------------------------------------------

def _interface(part: dict, v):
    """The interface closure and corrections of the partitioned solve on
    v (m, S, L), the per-segment solutions: z = Minv [v_s[0], v_s[L-1]]_s,
    then u_s = v_s - xL_s z_{s-1,last} - xR_s z_{s+1,first}."""
    m, S, L = v.shape
    v_edges = torch.stack([v[:, :, 0], v[:, :, L - 1]], dim=2).reshape(
        m, 2 * S)
    z = torch.matmul(v_edges, part["Minv"].T).reshape(m, S, 2)
    if part.get("periodic"):
        zprev = torch.roll(z[:, :, 1], 1, dims=1)
        znext = torch.roll(z[:, :, 0], -1, dims=1)
    else:
        zero = z.new_zeros((m, 1))
        zprev = torch.cat([zero, z[:, :-1, 1]], dim=1)           # (m, S)
        znext = torch.cat([z[:, 1:, 0], zero], dim=1)
    return v - part["xL"][None] * zprev[:, :, None] \
        - part["xR"][None] * znext[:, :, None]


def partitioned_solve(plan: dict, rhs):
    """Solve A u = rhs for all lines: rhs (m, N) -> u (m, N)."""
    _device.full_fp32_matmul()
    S, L, n = plan["S"], plan["L"], plan["n"]
    m = rhs.shape[0]
    d = rhs.reshape(m, S, L)
    # one GEMM per segment, batched over s: (S, m, L) = d_s @ Tinv_s^T
    v = torch.matmul(d.transpose(0, 1), plan["Tinv"].transpose(1, 2))
    return _interface(plan, v.transpose(0, 1)).reshape(m, n)


def banded_der1(plan: dict, u, axis: int):
    """D1 u along `axis` via the fused substructured solve; u any rank."""
    _device.full_fp32_matmul()
    part = plan["part"]
    n, S, L = plan["n"], part["S"], part["L"]
    pad = plan["pad"]
    u_m = torch.movedim(u, axis, -1)
    lead = u_m.shape[:-1]
    u2 = u_m.reshape(-1, n)
    if plan.get("periodic"):
        up = torch.cat([u2[:, -pad:], u2, u2[:, :pad]], dim=1)
    else:
        up = torch.nn.functional.pad(u2, (pad, pad))
    # (m, S, L + 2 pad): segment s's slab is columns [sL, sL + L + 2 pad)
    # of the padded lines, a strided view
    slabs = up.unfold(1, L + 2 * pad, L)
    # one GEMM per segment, batched over s: (S, m, L) = slab_s @ F_s^T
    v = torch.matmul(slabs.transpose(0, 1), plan["F"].transpose(1, 2))
    out = _interface(part, v.transpose(0, 1))
    return torch.movedim(out.reshape(*lead, n), -1, axis)
