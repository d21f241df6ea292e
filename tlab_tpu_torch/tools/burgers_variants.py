"""Time variants of the column Burgers kernel (K1, K2) on one CUDA card.

    python3 -m tlab_tpu_torch.tools.burgers_variants [variant ...]

Each variant is a set of text replacements on ``csrc/burgers.cu``; a
replacement whose old text is no longer in the source is an error, so the
table below has to follow the kernel.  All variants are built at once (one
nvcc each, into a temporary directory), then each is run through its C
entry points at the main path's shape (F = 4, 512x256x256, fp32) on the
same inputs, compared with the plain version and timed with CUDA events
(median and minimum of 7).  Variants that drop work ("noload", "nomma")
give wrong results on purpose: they show what the remaining work costs.

With no arguments every variant runs, "base" first and last.
"""
from __future__ import annotations

import ctypes
import pathlib
import statistics
import subprocess
import sys
import tempfile

import torch

from tlab_tpu_torch import device as _device
from tlab_tpu_torch.ops import _build, burgers

VARIANTS = {
    "base": [],
    # the K loop without its copies from L2 (tiles 0..kStages-3 only)
    "noload": [("    if (t + kStages - 2 < kt)\n        load_stage(",
                "    if (false)\n        load_stage(")],
    # the copies and the epilogue without the products
    "nomma": [("    tile_products(ring, t, frag0, acc1, acc2, hi, lo);\n",
               "    if (n < 0) tile_products(ring, t, frag0, acc1, acc2, "
               "hi, lo);\n")],
    "stages4": [("constexpr int kStages = 5;", "constexpr int kStages = 4;")],
    # fields slowest, as a (tiles, batch) grid orders them
    "fslowest": [("const int f = rest % F;\n    rest /= F;",
                  "const int f = rest / (c_tiles * G);\n"
                  "    rest %= (c_tiles * G);")],
    "noprefetch": [("if (a < n && c < C) prefetch_l2(",
                    "if (a < 0) prefetch_l2(")],
}
SHAPE = (512, 256, 256)
FIELDS = 4
REPS = 7
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def build_all(names, workdir: pathlib.Path) -> dict:
    """name -> (library path or None, nvcc's stderr); all nvcc runs started
    together."""
    source = (_build.CSRC / "burgers.cu").read_text()
    procs = {}
    for name in names:
        text = source
        for old, new in VARIANTS[name]:
            if old not in text:
                raise ValueError(f"variant {name!r}: the source no longer "
                                 f"holds {old!r}")
            text = text.replace(old, new)
        cu = workdir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(workdir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        ok = proc.returncode == 0
        out[name] = (workdir / f"{name}.so" if ok else None, err)
    return out


def time_variant(lib, x, conv, nu, d12, ref) -> str:
    rows, depth = ctypes.c_int(), ctypes.c_int()
    lib.burgers_col_tiles.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.burgers_col_tiles.restype = None
    lib.burgers_col_tiles(ctypes.byref(rows), ctypes.byref(depth))
    parts = []
    for axis, fn in enumerate((lib.burgers_x, lib.burgers_y)):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        pack = burgers.pack_operator(d12[axis], rows.value, depth.value)
        out = torch.empty_like(x)
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            err = fn(pack.data_ptr(), x.data_ptr(), conv.data_ptr(),
                     nu.data_ptr(), out.data_ptr(), FIELDS, *SHAPE, stream)
            if err != 0:
                raise RuntimeError(f"launch failed: cudaError {err}")

        run()
        torch.cuda.synchronize()
        rel = ((out - ref[axis]).abs().max() / ref[axis].abs().max()).item()
        ms = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        parts.append(f"K{axis + 1} {statistics.median(ms):.3f} ms "
                     f"(min {min(ms):.3f}), rel err {rel:.2e}")
    return "; ".join(parts)


def main(argv=None) -> int:
    names = list(sys.argv[1:] if argv is None else argv) \
        or [*VARIANTS, "base"]
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"unknown variants {unknown}; known: {list(VARIANTS)}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("burgers_variants: no CUDA card; kernel times come only from "
              "one", file=sys.stderr)
        return 1
    _device.full_fp32_matmul()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"[variants] {smi}; F={FIELDS} {SHAPE} fp32, median of {REPS}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((FIELDS, *SHAPE), generator=gen, device="cuda")
    conv = torch.randn(SHAPE, generator=gen, device="cuda")
    nu = torch.rand(FIELDS, generator=gen, device="cuda")
    d12 = [torch.randn((2 * SHAPE[a], SHAPE[a]), generator=gen,
                       device="cuda") for a in (0, 1)]
    ref = [burgers.fused_burgers_plain(d12[a], x, conv, nu, a)
           for a in (0, 1)]
    with tempfile.TemporaryDirectory() as tmp:
        built = build_all(dict.fromkeys(names), pathlib.Path(tmp))
        for name in names:
            so, log = built[name]
            if so is None:
                print(f"[variants] {name}: BUILD FAILED\n{log[-2000:]}")
                return 1
            regs = [ln.split(":")[-1].strip() for ln in log.splitlines()
                    if "Used" in ln][0]
            print(f"[variants] {name}: {regs}; "
                  + time_variant(ctypes.CDLL(str(so)), x, conv, nu, d12, ref),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
