"""Fused Burgers term res_f = nu_f * D2(x_f) - c * D1(x_f) along one axis.

Replaces tlab_tpu/ops/pallas_burgers.py::fused_burgers, the Pallas TPU
kernels _kern_x (axis 0), _kern_y (axis 1) and _kern_z (axis 2), with the
hand-written CUDA kernels of csrc/burgers.cu: K1 ``burgers_x`` and K2
``burgers_y`` apply the operator from the left (D @ X, "column" form), K3
``burgers_z`` from the right (X @ D^T, "row" form).

What bounds it on an H100.  Per output point the dense [D1; D2] product is
2n multiply-adds (n = 512 along x, 256 along y and z at 512x256x256)
against ~9 bytes of device-memory traffic (x in, result out, conv shared by
the F fields): ~230 flop/byte along x and ~115 along y and z, far above the
fp32-FMA ridge of ~20 flop/byte (67 TFLOP/s over 3.35 TB/s).  In fp32 FMA
the kernels are therefore bound by operations.  The TPU kernel's point, the
fusion, is kept for the bytes: the combine runs in the GEMM epilogue from
two register accumulators (D1 rows and D2 rows), so the 2F-field product
that the plain version writes and reads back (~6F+1 field passes per axis)
never reaches device memory (2F+1 passes).  Bytes become the bound once
the product moves to the tensor cores (wgmma, TF32 or 3xTF32), which is
later work.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from tlab_tpu_torch import device as _device
from tlab_tpu_torch.ops import _build
from tlab_tpu_torch.ops.derivative import der12

# kernel launches per axis (K1, K2, K3); counted where a launch is made
launches = [0, 0, 0]

ENTRY_POINTS = ("burgers_x", "burgers_y", "burgers_z")
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_MAX_GRID_Y = 65535


def fused_burgers_plain(d12, x, conv, nu, axis: int):
    """The plain PyTorch version: one [D1; D2] product, then the combine."""
    _device.full_fp32_matmul()
    d1x, d2x = der12(d12, x, axis + 1)
    return nu.reshape(-1, 1, 1, 1) * d2x - conv[None] * d1x


def _check(d12, x, conv, nu, axis: int) -> None:
    if axis not in (0, 1, 2):
        raise ValueError(f"axis must be 0, 1 or 2, got {axis}")
    if x.ndim != 4:
        raise ValueError(f"x must be (F, nx, ny, nz), got {tuple(x.shape)}")
    F, nx, ny, nz = x.shape
    n = x.shape[axis + 1]
    for name, t, shape in (("d12", d12, (2 * n, n)), ("x", x, x.shape),
                           ("conv", conv, (nx, ny, nz)), ("nu", nu, (F,))):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.numel() >= 2 ** 31:
        raise ValueError("x has 2**31 elements or more (32-bit sizes)")
    batch = (F, F * nx, 1)[axis]
    if batch > _MAX_GRID_Y:
        raise ValueError(f"batch {batch} exceeds the launch grid's y limit")


def fused_burgers(d12, x, conv, nu, axis: int):
    """res = nu * D2(x) - conv * D1(x) along spatial axis `axis` (0..2) of
    the stacked fields x (F, nx, ny, nz), as tlab_tpu's fused_burgers.

    d12: (2n, n) stacked [D1; D2]; conv: (nx, ny, nz); nu: (F,).
    Returns (F, nx, ny, nz)."""
    if x.device.type == "cpu":
        return fused_burgers_plain(d12, x, conv, nu, axis)
    _check(d12, x, conv, nu, axis)
    out = torch.empty_like(x)
    fn = getattr(_build.library("burgers"), ENTRY_POINTS[axis])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    F, nx, ny, nz = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(d12.data_ptr(), x.data_ptr(), conv.data_ptr(),
                 nu.data_ptr(), out.data_ptr(), F, nx, ny, nz, stream)
    if err != 0:
        raise RuntimeError(f"{ENTRY_POINTS[axis]} launch failed: "
                           f"cudaError {err}")
    launches[axis] += 1
    return out
