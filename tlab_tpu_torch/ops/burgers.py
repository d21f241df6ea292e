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
fp32-FMA ridge of ~20 flop/byte (67 TFLOP/s over 3.35 TB/s).  The kernels
are bound by operations, so the unit decides.  K1 and K2 run on the tensor
cores (wgmma, TF32 operands) with the 3-pass split of the Pallas kernel's
``_dot``: x = x_hi + x_lo, d = d_hi + d_lo, each part rounded to TF32, and
x_lo.d_hi + x_hi.d_lo + x_hi.d_hi summed in fp32.  hi + lo carries ~22
significant bits and the dropped lo.lo term is ~2^-22 relative, so the
result agrees with a full-fp32 product to fp32 round-off, at three times
the TF32 work (495 TFLOP/s peak) instead of fp32 FMA.  K3 is still fp32
FMA.  The operator's split is a constant of the plan: ``pack_operator``
makes it once for each operator tensor, already in the tile layout the
kernel copies into shared memory.  The TPU kernel's point, the fusion, is
kept for the bytes: the combine runs in the epilogue from two accumulators
(D1 rows and D2 rows), so the 2F-field product that the plain version
writes and reads back (~6F+1 field passes per axis) never reaches device
memory (2F+1 passes).

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
# operator tensor -> its packed split, for the last few operators seen; an
# entry keeps its operator alive, so a key's address cannot be reused
_PACKS_KEPT = 8
_packs: dict = {}


def fused_burgers_plain(d12, x, conv, nu, axis: int):
    """The plain PyTorch version: one [D1; D2] product, then the combine."""
    _device.full_fp32_matmul()
    d1x, d2x = der12(d12, x, axis + 1)
    return nu.reshape(-1, 1, 1, 1) * d2x - conv[None] * d1x


def tf32_round(v):
    """float32 `v` rounded to TF32 (10 explicit mantissa bits), nearest
    even, on the bit pattern; the result is a float32 whose 13 low mantissa
    bits are zero."""
    bits = v.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def tf32_split(v):
    """(hi, lo) with hi = tf32(v) and lo = tf32(v - hi)."""
    hi = tf32_round(v)
    return hi, tf32_round(v - hi)


def fused_burgers_split_plain(d12, x, conv, nu, axis: int, passes: int = 3):
    """The arithmetic of the tensor-core kernels in plain PyTorch, on any
    device: operands split into TF32 hi + lo, the products x_lo.d_hi,
    x_hi.d_lo and x_hi.d_hi summed in float32 (small terms first), then
    the combine.  `passes=1` keeps x_hi.d_hi alone, a single TF32 pass.
    The tests hold the split's accuracy with it; the main path never calls
    it."""
    _device.full_fp32_matmul()
    d_hi, d_lo = tf32_split(d12)
    x_hi, x_lo = tf32_split(x)
    if passes == 3:
        terms = ((d_hi, x_lo), (d_lo, x_hi), (d_hi, x_hi))
    elif passes == 1:
        terms = ((d_hi, x_hi),)
    else:
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    d1x = d2x = 0.0
    for d, xx in terms:
        a, b = der12(d, xx, axis + 1)
        d1x, d2x = d1x + a, d2x + b
    return nu.reshape(-1, 1, 1, 1) * d2x - conv[None] * d1x


def pack_operator(d12, rows: int, depth: int):
    """The split operator in the layout K1 and K2 copy into shared memory.

    d12 (2n, n) = [D1; D2] is split into TF32 hi + lo, zero-padded to
    multiples of the tile (rows x depth), and written tile by tile as
    (row tile, K tile, {D1 hi, D1 lo, D2 hi, D2 lo}, rows, depth), each
    tile K-major with its 16-byte chunks in the 64-byte swizzle of the
    wgmma descriptor: chunk c of row r sits at chunk c ^ ((r >> 1) & 3).
    """
    if depth != 16:
        raise ValueError("the 64-byte swizzle needs a K-tile of 16 floats")
    n = d12.shape[1]
    hi, lo = tf32_split(d12.reshape(2, n, n))
    q = torch.stack((hi[0], lo[0], hi[1], lo[1]))
    at, kt = -(-n // rows), -(-n // depth)
    q = torch.nn.functional.pad(q, (0, kt * depth - n, 0, at * rows - n))
    q = q.reshape(4, at, rows, kt, depth // 4, 4)
    r = torch.arange(rows, device=d12.device)
    c = torch.arange(depth // 4, device=d12.device)
    src = c[None, :] ^ ((r[:, None] >> 1) & 3)            # (rows, chunks)
    q = q.gather(4, src[None, None, :, None, :, None].expand_as(q))
    return q.permute(1, 3, 0, 2, 4, 5).contiguous()


def _packed(d12, lib):
    """pack_operator(d12) at the kernel's tile sizes, made once for each
    operator tensor."""
    key = (d12.data_ptr(), tuple(d12.shape), d12.device, d12._version)
    hit = _packs.get(key)
    if hit is None:
        rows, depth = ctypes.c_int(), ctypes.c_int()
        lib.burgers_col_tiles.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.burgers_col_tiles.restype = None
        lib.burgers_col_tiles(ctypes.byref(rows), ctypes.byref(depth))
        while len(_packs) >= _PACKS_KEPT:
            _packs.pop(next(iter(_packs)))
        hit = _packs[key] = (d12, pack_operator(d12, rows.value,
                                                depth.value))
    return hit[1]


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


def fused_burgers(d12, x, conv, nu, axis: int):
    """res = nu * D2(x) - conv * D1(x) along spatial axis `axis` (0..2) of
    the stacked fields x (F, nx, ny, nz), as tlab_tpu's fused_burgers.

    d12: (2n, n) stacked [D1; D2]; conv: (nx, ny, nz); nu: (F,).
    Returns (F, nx, ny, nz)."""
    if x.device.type == "cpu":
        return fused_burgers_plain(d12, x, conv, nu, axis)
    _check(d12, x, conv, nu, axis)
    out = torch.empty_like(x)
    lib = _build.library("burgers")
    fn = getattr(lib, ENTRY_POINTS[axis])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    F, nx, ny, nz = x.shape
    with torch.cuda.device(x.device):
        # K1 and K2 take the operator split and tiled, K3 as it stands
        op = _packed(d12, lib) if axis < 2 else d12
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(op.data_ptr(), x.data_ptr(), conv.data_ptr(),
                 nu.data_ptr(), out.data_ptr(), F, nx, ny, nz, stream)
    if err != 0:
        raise RuntimeError(f"{ENTRY_POINTS[axis]} launch failed: "
                           f"cudaError {err}")
    launches[axis] += 1
    return out
