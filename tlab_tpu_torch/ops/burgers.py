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
are bound by operations, so the unit decides.  All three run on the tensor
cores (wgmma), in one of the three arithmetic contracts of the Pallas
kernel's ``_dot`` (``prec_name``, CONTRACTS):

- "highest", the port's default: TF32 operands and the 3-pass split x =
  x_hi + x_lo, d = d_hi + d_lo, each part rounded to TF32, and x_lo.d_hi +
  x_hi.d_lo + x_hi.d_hi summed in fp32.  hi + lo carries ~22 significant
  bits and the dropped lo.lo term is ~2^-22 relative, so the result agrees
  with a full-fp32 product to fp32 round-off, at three times the TF32 work
  (495 TFLOP/s peak) instead of fp32 FMA.  Entry points burgers_x/y/z.
- "high", tlab_tpu's default: the same split with bf16 parts, _dot's own
  3-pass bf16 (~16 bits, ~5e-6 of the largest result from fp64), three
  times the bf16 work (989 TFLOP/s peak).  burgers_x_high, ...
- "default": one bf16 pass, x_hi.d_hi (~3e-3 from fp64); at F = 4 and
  512x256x256 its work is below the bytes it must move.  burgers_x_default,
  ...

In the bf16 contracts K1 and K2 run a kernel of their own: clusters of
blocks share the operator stages and the field tiles (multicast copies), a
persistent ring runs on across output tiles, and the epilogue goes through
a shared-memory tile by the tensor maps (csrc/burgers.cu, the note above
burgers_col_bf16; ``column_schedule`` here is its launch).

The operator's split is a constant of the plan: ``pack_operator`` makes it
once for each operator tensor and contract, already in the tile layout that
all three kernels copy into shared memory.  The TPU kernel's point, the
fusion, is kept for the bytes: the combine runs in the epilogue from two
accumulators (D1 rows and D2 rows), so the 2F-field product that the plain
version writes and reads back (~6F+1 field passes per axis) never reaches
device memory (2F+1 passes).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.

The plain derivative products (``deriv1``, ``deriv12``): the same column
and row kernels with a plain store for an epilogue, D1 @ X (deriv1_x/y/z)
or D1 @ X and D2 @ X into two outputs (deriv12_x/y/z), in the "highest"
contract alone, from the same packed [D1; D2] (deriv1 reads its D1 tiles).
They replace no Pallas kernel: they stand for tlab_tpu's compressible
einsums, HIGHEST whatever TLAB_TPU_MATMUL_PRECISION says, which the port
ran as cuBLAS fp32 products on the FMA units (~48 TFLOP/s at 512x256x256
on an H100, whose fp32 peak is 67).  A d1 block runs D1 of two operator
row tiles in its two accumulators, so it does as many products on each
field tile it reads as a K1-K3 block.  The compressible set calls them (dycore/compressible.py);
their launches are the span registry's counter ops.derivative.k.
"""
from __future__ import annotations

import ctypes

import torch

from tlab_tpu_torch import device as _device
from tlab_tpu_torch.ops import _build
from tlab_tpu_torch.ops.derivative import der1, der12
from tlab_tpu_torch.utils import nantrap
from tlab_tpu_torch.utils import trace as _trace

# the arithmetic contracts of tlab_tpu's _dot by their prec_name
# (ops/derivative.py::op_precision): (operand type, passes)
CONTRACTS = {"highest": ("tf32", 3), "high": ("bf16", 3),
             "default": ("bf16", 1)}
# kernel launches per axis (K1, K2, K3) of each contract's entry points;
# counted where a launch is made
contract_launches = {name: [0, 0, 0] for name in CONTRACTS}

ENTRY_POINTS = ("burgers_x", "burgers_y", "burgers_z")
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# operator tensor -> its packed split, for the last few operators seen; an
# entry keeps its operator alive, so a key's address cannot be reused
_PACKS_KEPT = 8
_packs: dict = {}


def entry_points(prec_name: str = "highest") -> tuple:
    """The entry points (K1, K2, K3) of a contract: burgers_x/y/z for
    "highest", with the suffix _high or _default for the others."""
    _contract(prec_name)
    suffix = "" if prec_name == "highest" else f"_{prec_name}"
    return tuple(name + suffix for name in ENTRY_POINTS)


def reset_launches() -> None:
    """Every contract's launch counts set to 0."""
    for counts in contract_launches.values():
        counts[:] = [0, 0, 0]


# the span registry's counter ops.burgers.k, set to 0 by its reset()
_trace.source("ops.burgers.k",
              lambda: sum(map(sum, contract_launches.values())),
              reset_launches)

# launches per axis of the plain derivative products' entry points
# (deriv1_x/y/z, deriv12_x/y/z); counted where a launch is made
deriv_launches = {"deriv1": [0, 0, 0], "deriv12": [0, 0, 0]}


def reset_deriv_launches() -> None:
    for counts in deriv_launches.values():
        counts[:] = [0, 0, 0]


# the span registry's counter ops.derivative.k (the derivative products
# that the kernels compute), set to 0 by its reset()
_trace.source("ops.derivative.k",
              lambda: sum(map(sum, deriv_launches.values())),
              reset_deriv_launches)


def _contract(prec_name: str) -> tuple:
    try:
        return CONTRACTS[prec_name]
    except KeyError:
        raise ValueError(f"prec_name must be one of {tuple(CONTRACTS)}, "
                         f"got {prec_name!r}") from None


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


def bf16_round(v):
    """float32 `v` rounded to bf16 (7 explicit mantissa bits, 8
    significant), nearest even, on the bit pattern; the result is a float32
    whose 16 low bits are zero."""
    bits = v.contiguous().view(torch.int32)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & ~0xFFFF
    return bits.view(torch.float32)


def bf16_split(v):
    """(hi, lo) with hi = bf16(v) and lo = bf16(v - hi), as tlab_tpu's _dot
    splits its operands (v - hi is exact in float32)."""
    hi = bf16_round(v)
    return hi, bf16_round(v - hi)


_SPLITS = {"tf32": tf32_split, "bf16": bf16_split}


def der12_split_plain(d12, x, axis: int, passes: int = 3,
                      unit: str = "tf32"):
    """(d1 x, d2 x) in the arithmetic of the tensor-core kernels, in plain
    PyTorch on any device, `axis` valid for x itself (as der12): operands
    split into hi + lo of the `unit`'s type (TF32 or bf16), the products
    x_lo.d_hi, x_hi.d_lo and x_hi.d_hi summed in float32 (small terms
    first).  `passes=1` keeps x_hi.d_hi alone, a single pass.  Each product
    is one of operands that float32 holds exactly, accumulated in float32.
    ("tf32", 3) is the "highest" contract, ("bf16", 3) "high" and
    ("bf16", 1) "default" (CONTRACTS).  The tests and chip_smoke.py hold
    the kernels with it; the main path never calls it."""
    _device.full_fp32_matmul()
    if unit not in _SPLITS:
        raise ValueError(f"unit must be 'tf32' or 'bf16', got {unit!r}")
    d_hi, d_lo = _SPLITS[unit](d12)
    x_hi, x_lo = _SPLITS[unit](x)
    if passes == 3:
        terms = ((d_hi, x_lo), (d_lo, x_hi), (d_hi, x_hi))
    elif passes == 1:
        terms = ((d_hi, x_hi),)
    else:
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    d1x = d2x = 0.0
    for d, xx in terms:
        a, b = der12(d, xx, axis)
        d1x, d2x = d1x + a, d2x + b
    return d1x, d2x


def fused_burgers_split_plain(d12, x, conv, nu, axis: int, passes: int = 3,
                              unit: str = "tf32"):
    """The Burgers term in the arithmetic of the tensor-core kernels
    (der12_split_plain along spatial axis `axis`), then the combine."""
    d1x, d2x = der12_split_plain(d12, x, axis + 1, passes, unit)
    return nu.reshape(-1, 1, 1, 1) * d2x - conv[None] * d1x


def pack_operator(d12, rows: int, depth: int, prec_name: str = "highest"):
    """The split operator in the layout K1-K3 copy into shared memory.

    d12 (2n, n) = [D1; D2] is split as the contract `prec_name` splits it
    (TF32 or bf16 hi + lo; the hi part alone for one pass), zero-padded to
    multiples of the tile (rows x depth), and written tile by tile as
    (row tile, K tile, {D1 hi, D1 lo, D2 hi, D2 lo} or {D1, D2}, rows,
    chunks, chunk), each tile K-major, 64 bytes a row (depth 16 in float32,
    32 in bfloat16), with its 16-byte chunks in the 64-byte swizzle of the
    wgmma descriptor: chunk c of row r sits at chunk c ^ ((r >> 1) & 3).
    float32 for "highest", bfloat16 (the parts are bf16 values) otherwise.
    """
    unit, passes = _contract(prec_name)
    size = 4 if unit == "tf32" else 2
    if depth * size != 64:
        raise ValueError(f"the 64-byte swizzle needs a K-tile of "
                         f"{64 // size} {unit} elements, got {depth}")
    n = d12.shape[1]
    hi, lo = _SPLITS[unit](d12.reshape(2, n, n))
    q = torch.stack((hi[0], lo[0], hi[1], lo[1]) if passes == 3
                    else (hi[0], hi[1]))
    chunk = 16 // size
    at, kt = -(-n // rows), -(-n // depth)
    q = torch.nn.functional.pad(q, (0, kt * depth - n, 0, at * rows - n))
    q = q.reshape(len(q), at, rows, kt, depth // chunk, chunk)
    r = torch.arange(rows, device=d12.device)
    c = torch.arange(depth // chunk, device=d12.device)
    src = c[None, :] ^ ((r[:, None] >> 1) & 3)            # (rows, chunks)
    q = q.gather(4, src[None, None, :, None, :, None].expand_as(q))
    q = q.permute(1, 3, 0, 2, 4, 5).contiguous()
    return q if unit == "tf32" else q.to(torch.bfloat16)


# The bf16 column kernel's launch (csrc/burgers.cu: col_cluster, ColTile),
# written out for the CPU tests and for the card test that holds the C code
# to it: a block owns TILE field lines x TILE operator rows; a cluster of
# cc x ca blocks shares the operator stages (cc line tiles) and the field
# tiles (ca row tiles); a persistent grid of clusters walks the cluster
# tiles.
TILE = 128


def column_schedule(n: int, ncol: int, G: int, F: int, bulk: bool) -> dict:
    """The bf16 column kernel's launch for F * G slabs of (n, ncol): `at`
    operator row tiles, `ct` line tiles a slab, `lines` = F G ct line tiles
    in all; the cluster's extents `cc` (line tiles that share the operator
    stages) and `ca` (row tiles that share a field tile: a power of 2 up to
    4 and up to at, 1 off the bulk-copy path), 8 blocks in all and no more
    line tiles than there are; `tiles`, the cluster tiles the grid walks.
    `bulk`: the field rows start on 16 bytes (ncol % 4 == 0, x aligned)."""
    at, ct = -(-n // TILE), -(-ncol // TILE)
    lines = F * G * ct
    ca = 1
    while bulk and ca * 2 <= min(at, 4):
        ca *= 2
    cc = 8 // ca
    while cc > 1 and cc // 2 >= lines:
        cc //= 2
    return {"at": at, "ct": ct, "lines": lines, "cc": cc, "ca": ca,
            "tiles": -(-lines // cc) * -(-at // ca)}


def column_tile(sched: dict, T: int, rank: int) -> tuple:
    """(line tile, operator row tile) of the block at `rank` of its cluster
    in cluster tile T (row tiles of a line group fastest); a line tile past
    `lines` or a row tile past `at` is a padded slot."""
    groups = -(-sched["at"] // sched["ca"])
    lg, ag = divmod(T, groups)
    return (lg * sched["cc"] + rank % sched["cc"],
            ag * sched["ca"] + rank // sched["cc"])


def column_line(sched: dict, L: int, F: int) -> tuple:
    """(f, g, c0) of line tile L: fields fastest (the F tiles that share a
    conv tile sit side by side), then a slab's column tiles, then slabs."""
    f, rest = L % F, L // F
    return f, rest // sched["ct"], (rest % sched["ct"]) * TILE


def _packed(d12, lib, prec_name: str):
    """pack_operator(d12, prec_name) at the kernel's tile sizes, made once
    for each operator tensor and contract."""
    key = (d12.data_ptr(), tuple(d12.shape), d12.device, d12._version,
           prec_name)
    hit = _packs.get(key)
    if hit is None:
        rows, depth = ctypes.c_int(), ctypes.c_int()
        tiles = lib.burgers_pack_tiles if CONTRACTS[prec_name][0] == "tf32" \
            else lib.burgers_pack_tiles_bf16
        tiles.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        tiles.restype = None
        tiles(ctypes.byref(rows), ctypes.byref(depth))
        while len(_packs) >= _PACKS_KEPT:
            _packs.pop(next(iter(_packs)))
        hit = _packs[key] = (d12, pack_operator(d12, rows.value,
                                                depth.value, prec_name))
    return hit[1]


def _check(d12, x, conv, nu, axis: int) -> None:
    if axis not in (0, 1, 2):
        raise ValueError(f"axis must be 0, 1 or 2, got {axis}")
    if x.ndim != 4:
        raise ValueError(f"x must be (F, nx, ny, nz), got {tuple(x.shape)}")
    F, nx, ny, nz = x.shape
    n = x.shape[axis + 1]
    _check_tensors(x, (("d12", d12, (2 * n, n)), ("x", x, x.shape),
                       ("conv", conv, (nx, ny, nz)), ("nu", nu, (F,))))


def _check_tensors(x, tensors) -> None:
    """Each (name, tensor, shape) on x's device, float32, of that shape and
    contiguous; x with fewer than 2**31 elements (32-bit sizes)."""
    for name, t, shape in tensors:
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


def fused_burgers(d12, x, conv, nu, axis: int,
                  prec_name: str = "highest"):
    """res = nu * D2(x) - conv * D1(x) along spatial axis `axis` (0..2) of
    the stacked fields x (F, nx, ny, nz), as tlab_tpu's fused_burgers.

    d12: (2n, n) stacked [D1; D2]; conv: (nx, ny, nz); nu: (F,).
    Returns (F, nx, ny, nz).  prec_name is the arithmetic contract
    ("highest", "high" or "default", CONTRACTS; tlab_tpu's default is
    "high", the port's "highest": ROADMAP C).  On a CPU tensor every
    contract gives the full-fp32 plain version, as tlab_tpu computes full
    fp32 off a TPU whatever the name; on a CUDA tensor the contract's
    kernel runs.

    Under the NaN trap's per-op check (utils/nantrap.py) the call is one
    op: a launch through ctypes is seen by no dispatcher, so its output is
    checked here and a NaN is named after the contract's entry point
    (burgers_x, burgers_y_high, ...), on the CPU's plain version too."""
    name = entry_points(prec_name)[axis]
    if nantrap.checking():
        with nantrap.suspended():
            out = fused_burgers(d12, x, conv, nu, axis, prec_name)
        nantrap.check(out, name, (x, conv))
        return out
    if x.device.type == "cpu":
        return fused_burgers_plain(d12, x, conv, nu, axis)
    _check(d12, x, conv, nu, axis)
    out = torch.empty_like(x)
    lib = _build.library("burgers")
    fn = getattr(lib, name)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    F, nx, ny, nz = x.shape
    with torch.cuda.device(x.device):
        pack = _packed(d12, lib, prec_name)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(pack.data_ptr(), x.data_ptr(), conv.data_ptr(),
                 nu.data_ptr(), out.data_ptr(), F, nx, ny, nz, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    contract_launches[prec_name][axis] += 1
    return out


DERIV_KINDS = ("deriv1", "deriv12")
_DERIV_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]


def _deriv(kind: str, d12, x, axis: int):
    """The entry point `kind` along `axis` (valid for x itself) of a 3-D
    field or a 4-D stack: d1 x, or (d1 x, d2 x) for "deriv12"."""
    if x.ndim not in (3, 4) or not x.ndim - 3 <= axis < x.ndim:
        raise ValueError(f"axis {axis} is not a spatial axis of a field or "
                         f"a stack of shape {tuple(x.shape)}")
    spatial = axis - (x.ndim - 3)
    name = f"{kind}_{'xyz'[spatial]}"
    if nantrap.checking():
        with nantrap.suspended():
            out = _deriv(kind, d12, x, axis)
        nantrap.check(out, name, (x,))
        return out
    if x.device.type == "cpu":
        if kind == "deriv1":
            return der1(d12[:x.shape[axis]], x, axis)
        return der12(d12, x, axis)
    n = x.shape[axis]
    _check_tensors(x, (("d12", d12, (2 * n, n)), ("x", x, x.shape)))
    d1 = torch.empty_like(x)
    d2 = torch.empty_like(x) if kind == "deriv12" else None
    lib = _build.library("burgers")
    fn = getattr(lib, name)
    fn.argtypes = _DERIV_ARGTYPES
    fn.restype = ctypes.c_int
    F, nx, ny, nz = (1,) * (4 - x.ndim) + tuple(x.shape)
    with torch.cuda.device(x.device):
        pack = _packed(d12, lib, "highest")
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(pack.data_ptr(), x.data_ptr(), d1.data_ptr(),
                 None if d2 is None else d2.data_ptr(), F, nx, ny, nz,
                 stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    deriv_launches[kind][spatial] += 1
    return d1 if d2 is None else (d1, d2)


def deriv1(d12, x, axis: int):
    """D1 x along `axis` of a field (nx, ny, nz) or a stack (F, nx, ny, nz),
    axis valid for x itself (as ops.derivative.der1), from the plan's
    stacked d12 = [D1; D2] (2n, n).  On a CUDA tensor the 3xTF32 kernel
    deriv1_x/y/z (float32, contiguous, or it raises); on a CPU tensor the
    plain product der1(d12[:n], x, axis).  Under the NaN trap's per-op
    check the call is one op, named after its entry point."""
    return _deriv("deriv1", d12, x, axis)


def deriv12(d12, x, axis: int):
    """(D1 x, D2 x) along `axis` as deriv1, two separate contiguous
    tensors: on a CUDA tensor the kernel deriv12_x/y/z, on a CPU tensor
    der12(d12, x, axis)."""
    return _deriv("deriv12", d12, x, axis)
