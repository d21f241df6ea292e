"""Time variants of the Burgers kernels (K1-K3) on one CUDA card.

    python3 -m tlab_tpu_torch.tools.burgers_variants [--prec P[,P]] [variant ...]

Each variant is a set of text replacements on ``csrc/burgers.cu``; a
replacement whose old text is no longer in the source is an error, so the
table below has to follow the kernel.  All variants are built at once (one
nvcc each, into a temporary directory), then each is run through its C
entry points at the main path's shape (F = 4, 512x256x256, fp32) on the
same inputs, compared with the plain version and timed with CUDA events
(median and minimum of 7).  ``--prec`` names the contracts whose entry
points are timed ("highest" when it is not given; "high" and "default", the
bf16 ones, are each held to the plain version of their own split).
Variants that drop work ("noload", "nomma", "bfnomma", ...) give wrong
results on purpose: they show what the remaining work costs.  The ring, the
products and the operator's layout of the 3xTF32 column kernel (K1, K2) and
of the row kernel (K3, every contract) are shared, so "noload", "nomma",
"stages4" and "noprefetch" change both; "fslowest", "nofieldcopy" and
"noopcopy" change the 3xTF32 column kernel alone; "xk16", "xk64", "noahead",
"stagedepi" and "stcs" the row kernel alone; the "bf..." and "cl..."
variants the bf16 column kernel alone (time them with --prec high,default).

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

# copies of a row-kernel item's first tiles only after the epilogue before
# it: the count of copies stops at the item's end, and the prologue is made
# again for each item
_NOAHEAD_COUNT = ("        if (++tk == kt) { tk = 0; ++item; }\n",
                  "        if (tk < kt) ++tk;\n")
_PROLOGUE_AGAIN = """        tl.tk = 0;
        ++tl.item;
        for (int i = 0; i < L::kStages - 2; ++i) {
            tl.load(ring, t + i);
            cp_async_commit();
        }
"""
# the row kernel's combine (the Burgers epilogue), and the end of each
# item's epilogue with the clear after it
_EPILOGUE = """            row_epilogue(acc1, acc2, cv + a0, ob + a0, nu_f, n, tl.rows,
                         n - a0, m, q, vec);
"""
_CLEAR = "        }\n        clear(acc1, acc2);\n"
# the row kernel's epilogue through the ring's memory, as the column
# kernel's: (r, a) tiles, then 16-byte rows of out and conv
_STAGED_EPILOGUE = """        cp_async_wait<0>();
        __syncthreads();
        {
            float* s1 = ring;
            float* s2 = ring + kTC * kOS;
#pragma unroll
            for (int j = 0; j < 16; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int o = (m + 8 * h) * kOS + 8 * j + 2 * q;
                    *reinterpret_cast<float2*>(s1 + o) = make_float2(
                        acc1[4 * j + 2 * h], acc1[4 * j + 2 * h + 1]);
                    *reinterpret_cast<float2*>(s2 + o) = make_float2(
                        acc2[4 * j + 2 * h], acc2[4 * j + 2 * h + 1]);
                }
            __syncthreads();
            const bool vec4 = (n % 4) == 0 && aligned16(cv, ob);
            for (int i = tid; i < kTC * (kTA / 4); i += kThreads) {
                const int rr = i / (kTA / 4), aa = (i % (kTA / 4)) * 4;
                if (rr >= tl.rows || a0 + aa >= n) continue;
                float d1[kTN], d2[kTN];
                load4(d1, &s1[rr * kOS + aa]);
                load4(d2, &s2[rr * kOS + aa]);
                const size_t o = (size_t)rr * n + a0 + aa;
                combine_store(ob + o, cv + o, d1, d2, nu_f, n - a0 - aa,
                              vec4);
            }
            __syncthreads();
        }
"""

# the "highest" contract's (3xTF32) ring depth and row-form chunk depth;
# every variant times that contract's entry points
_TF32_STAGES = ("    static constexpr int kStages = 5;\n",
                "    static constexpr int kStages = 4;\n")
_TF32_RK = "    static constexpr int kRK = 32;   // 128-byte pieces"
# the bf16 column kernel's choice of cluster extents
_CLUSTER = ("    while (bulk && a * 2 <= at && a * 2 <= 4) a *= 2;\n"
            "    int c = 8 / a;\n")
# the column kernel's copy of a K tile's operator stage
_COL_OP_COPY = ("        load_operator<C, kPair>(\n"
                "            ring, pack_tiles + (size_t)t * L::kOpStage,\n"
                "            kPair && second ? second + (size_t)t * "
                "L::kOpStage : nullptr, s,\n"
                "            tid);\n")
VARIANTS = {
    "base": [],
    # the K loop without its copies from L2 (the prologue's tiles only)
    "noload": [("    tl.load(ring, t + L::kStages - 2);\n",
                "    if (t < 0) tl.load(ring, t + L::kStages - 2);\n")],
    # the copies and the epilogue without the products
    "nomma": [("    if (live)\n        tile_products<",
               "    if (t < 0)\n        tile_products<")],
    "stages4": [_TF32_STAGES],
    # column kernel: the K loop without the field tiles' copies, or without
    # the operator's (what each stream from L2 costs)
    "nofieldcopy": [(_COL_OP_COPY, _COL_OP_COPY + "        return;\n")],
    "noopcopy": [(_COL_OP_COPY, "")],
    # bf16 column kernel: without its products; without the combine and
    # store of its epilogue
    "bfnomma": [("if (live)\n                col_bf16_products<C>(",
                 "if (kt < 0)\n                col_bf16_products<C>(")],
    "bfnoepi": [("if (live) {\n                const float nu_f",
                 "if (kt < 0) {\n                const float nu_f"),
                ("if (tl.op_live && tl.x_live)\n"
                 "                    store_boxes(",
                 "if (kt < 0)\n                    store_boxes(")],
    # bf16 column kernel: no field boxes asked into L2 ahead of their
    # copies; 4 stages in "default"
    "bfnopf": [("if (R::kAhead > 0 && (u < kt || more)) {", "if (u < 0) {")],
    "bfst4": [("kStages = C::kPasses == 3 ? 3 : 5;",
               "kStages = C::kPasses == 3 ? 3 : 4;")],
    # bf16 column kernel: the cluster's extents cc x ca (ca up to the row
    # tiles), in place of 8 / ca x up to 4
    **{f"cl{cc}{ca}": [(_CLUSTER, _CLUSTER.replace("a * 2 <= 4",
                                                   f"a * 2 <= {ca}")
                        .replace("8 / a", str(cc)))]
       for cc, ca in ((8, 1), (2, 2), (4, 2))},
    # column kernel: fields slowest, as a (tiles, batch) grid orders them
    "fslowest": [("const int f = rest % F;\n    rest /= F;",
                  "const int f = rest / (c_tiles * G);\n"
                  "    rest %= (c_tiles * G);")],
    "noprefetch": [("if (r < rows && c < cols) prefetch_l2(",
                    "if (r < 0) prefetch_l2(")],
    # row kernel: depth of a field chunk (64-, 128-, 256-byte pieces of a
    # field row); 64 deep leaves room for 4 operator stages
    "xk16": [(_TF32_RK, _TF32_RK.replace("32", "16"))],
    "xk64": [(_TF32_RK, _TF32_RK.replace("32", "64")), _TF32_STAGES],
    "noahead": [_NOAHEAD_COUNT, (_CLEAR, _CLEAR + _PROLOGUE_AGAIN)],
    # the staged epilogue needs the ring, so it cannot have the next item's
    # copies on their way: compare it with "noahead"
    "stagedepi": [_NOAHEAD_COUNT, (_EPILOGUE, _STAGED_EPILOGUE),
                  (_CLEAR, _CLEAR + _PROLOGUE_AGAIN)],
    # row kernel: streaming stores of out
    "stcs": [("                        *reinterpret_cast<float2*>"
              "(orow + 8 * (jb + j)) = v;",
              "                        __stcs(reinterpret_cast<float2*>"
              "(orow + 8 * (jb + j)), v);")],
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


def registers(log: str) -> str:
    """'row 232 registers, col 232 registers' from ptxas's report."""
    found, kernel = [], "?"
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            kernel = "row" if "burgers_row" in ln else \
                "colbf16" if "col_bf16" in ln else \
                "deriv" if "deriv_" in ln else "col"
        elif "Used" in ln:
            found.append(f"{kernel} "
                         + ln.split(":")[-1].split(",")[0].strip()[5:])
        elif "spill" in ln and "0 bytes spill stores, 0 bytes spill" not in ln:
            found.append(f"{kernel} SPILLS: {ln.strip()}")
        elif "Performance" in ln or "serialized" in ln or "warning" in ln:
            found.append(f"{kernel} {ln.split(':', 1)[-1].strip()}")
    return ", ".join(found)


def time_variant(lib, x, conv, nu, d12, ref, prec: str) -> str:
    rows, depth = ctypes.c_int(), ctypes.c_int()
    tiles = lib.burgers_pack_tiles if prec == "highest" \
        else lib.burgers_pack_tiles_bf16
    tiles.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    tiles.restype = None
    tiles(ctypes.byref(rows), ctypes.byref(depth))
    parts = []
    for axis, name in enumerate(burgers.entry_points(prec)):
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        pack = burgers.pack_operator(d12[axis], rows.value, depth.value,
                                     prec)
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
    args = list(sys.argv[1:] if argv is None else argv)
    precs = ["highest"]
    if "--prec" in args:
        i = args.index("--prec")
        precs = args[i + 1].split(",")
        del args[i:i + 2]
    for prec in precs:
        burgers.entry_points(prec)          # raises on an unknown name
    names = args or [*VARIANTS, "base"]
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
    d12 = [torch.randn((2 * n, n), generator=gen, device="cuda")
           for n in SHAPE]

    def reference(prec):
        unit, passes = burgers.CONTRACTS[prec]
        return [burgers.fused_burgers_plain(d12[a], x, conv, nu, a)
                if prec == "highest" else burgers.fused_burgers_split_plain(
                    d12[a], x, conv, nu, a, passes, unit)
                for a in range(3)]

    with tempfile.TemporaryDirectory() as tmp:
        built = build_all(dict.fromkeys(names), pathlib.Path(tmp))
        for name in names:
            so, log = built[name]
            if so is None:
                print(f"[variants] {name}: BUILD FAILED\n{log[-2000:]}")
                return 1
            lib = ctypes.CDLL(str(so))
            for prec in precs:
                ref = reference(prec)
                print(f"[variants] {name} {prec}: {registers(log)}; "
                      + time_variant(lib, x, conv, nu, d12, ref, prec),
                      flush=True)
                del ref
    return 0


if __name__ == "__main__":
    sys.exit(main())
