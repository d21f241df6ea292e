#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tlab_tpu_torch) on one CUDA card and check it.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card,
nvcc and PyTorch built for CUDA (no JAX needed):

    python3 chip_smoke.py

Phases, each printing one line of its own numbers; any failure exits
non-zero:
  1. device   the card's name and power limit (nvidia-smi)
  2. build    the Burgers kernels K1-K3 from tlab_tpu_torch/csrc/ with nvcc
  3. kernels  K1-K3 against their plain PyTorch version on the card, fp32,
              at four ragged shapes and at the main path's 512x256x256
              shape, each there also against a float64 product and timed
              beside its plain version, the plain version's one matmul
              (library_ms) and its bound
  4. main     the shear layer at 512x256x256 fp32: one warm-up RK4 step,
              then 3 timed steps through rk_loop_stacked; every Burgers
              term must go through the kernels
  5. fp64     fp32 (kernels) against fp64 (dense path) on the card,
              5 RK4 steps at 128x64x64
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Without a CUDA card the script exits 1 and
prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from tlab_tpu_torch import device as tdevice
from tlab_tpu_torch import entry
from tlab_tpu_torch.dycore import incompressible as dyn
from tlab_tpu_torch.ops import _build, burgers
from tlab_tpu_torch.ops.derivative import apply_along

MAIN_SHAPE = (512, 256, 256)
# ragged edges in every tile dimension; the odd widths take the kernels'
# scalar loads and epilogue, the multiples of 4 their 16-byte ones; the
# third is smaller than one tile in every dimension; in the last nz spans
# two operator tiles and ends in a ragged K tile
RAGGED = ((5, (24, 20, 36)), (5, (23, 19, 37)), (3, (7, 5, 6)),
          (3, (6, 10, 200)))
STEPS = 3
REPS = 7
KERNEL_TOL = 1e-5        # max|kernel - plain| / max|plain|: sums of <= 512
                         # products in another order, from the 3xTF32 split
                         # (K1-K3: ~22 bits an operand)
# published peaks of one H100 SXM (NVIDIA's data sheet, dense)
PEAK_BYTES = 3.35e12     # device memory, B/s
PEAK_OPS = {"tf32": 495e12, "fp32": 67e12}      # FLOP/s by unit
# the unit each kernel's product runs on, and its passes over the product
UNIT = (("tf32", 3), ("tf32", 3), ("tf32", 3))
FP64_TOL = 3e-4          # 5 RK4 steps at tlab_tpu's production 5.9e-5/step
SOURCE = "tlab_tpu_torch/csrc/burgers.cu"
REPLACES = ("tlab_tpu/ops/pallas_burgers.py:62",    # _kern_x
            "tlab_tpu/ops/pallas_burgers.py:71",    # _kern_y
            "tlab_tpu/ops/pallas_burgers.py:80")    # _kern_z


class PhaseFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailure(what)


def event_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}")
    print(f"[device] nvidia-smi: {smi}")
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.library("burgers")
    seconds = time.perf_counter() - t0
    info = _build.builds.get("burgers")
    regs = [ln.split("ptxas info    : ")[-1].strip() for ln in
            (info["log"].splitlines() if info else [])
            if "registers" in ln or "spill" in ln or "warning" in ln.lower()]
    how = "built" if info else "loaded"
    print(f"[build] libburgers {how} in {seconds:.2f} s; ptxas: "
          + " | ".join(regs))


def bound(axis, d12, x, conv, nu) -> dict:
    """The least time the card could take for one fused Burgers term: each
    input read once and the output written once at the memory rate, or
    2 * 2n multiply-adds per output point (times the passes of the split)
    at the peak of the unit the kernel's product runs on."""
    n = x.shape[axis + 1]
    unit, passes = UNIT[axis]
    nbytes = sum(t.numel() * t.element_size() for t in (d12, x, conv, nu, x))
    ops = passes * 4 * n * x.numel()
    by_bytes, by_ops = nbytes / PEAK_BYTES, ops / PEAK_OPS[unit]
    return {"bound_ms": 1e3 * max(by_bytes, by_ops),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "bytes_ms": 1e3 * by_bytes, "ops_ms": 1e3 * by_ops, "unit": unit}


def fp64_errors(axis, d12, x, conv, nu, got, ref) -> dict:
    """max|. - fp64| / max|fp64| of the kernel and of the plain version."""
    ref64 = burgers.fused_burgers_plain(d12.double(), x.double(),
                                        conv.double(), nu.double(), axis)
    scale = ref64.abs().max().item()
    return {"kernel_vs_fp64": (got - ref64).abs().max().item() / scale,
            "plain_vs_fp64": (ref - ref64).abs().max().item() / scale}


def check_kernel(axis, d12, x, conv, nu, timed: bool) -> dict:
    got = burgers.fused_burgers(d12, x, conv, nu, axis)
    ref = burgers.fused_burgers_plain(d12, x, conv, nu, axis)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    require(err <= KERNEL_TOL * scale,
            f"{burgers.ENTRY_POINTS[axis]} at {tuple(x.shape)}: "
            f"max|err| {err} > {KERNEL_TOL} * {scale}")
    res = {"max_abs_err": err, "rel_err": err / scale}
    if timed:
        res.update(fp64_errors(axis, d12, x, conv, nu, got, ref))
        del got, ref
        calls = {
            "ms": lambda: burgers.fused_burgers(d12, x, conv, nu, axis),
            "plain_ms":
                lambda: burgers.fused_burgers_plain(d12, x, conv, nu, axis),
            # the plain version's one full-fp32 matmul, without the combine
            "library_ms": lambda: apply_along(d12, x, axis + 1)}
        times = {key: [] for key in calls}
        for _ in range(REPS):
            for key, fn in calls.items():
                times[key].append(event_ms(fn))
        res.update({key: statistics.median(v) for key, v in times.items()})
        res.update(bound(axis, d12, x, conv, nu))
    return res


def phase_kernels(P) -> list:
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    for F, shape in RAGGED:
        for axis in range(3):
            n = shape[axis]
            r = check_kernel(axis, randn(2 * n, n), randn(F, *shape),
                             randn(*shape), torch.rand(F, generator=gen,
                                                       device="cuda"), False)
            print(f"[kernels] {burgers.ENTRY_POINTS[axis]} F={F} {shape}: "
                  f"rel err {r['rel_err']:.3e}")
    records, errs = [], []
    nu = torch.tensor((P["visc"],) * 3 + P["diff"], dtype=torch.float32,
                      device="cuda")
    x = randn(len(nu), *MAIN_SHAPE)
    conv = randn(*MAIN_SHAPE)
    for axis in range(3):
        r = check_kernel(axis, P["d12" + "xyz"[axis]], x, conv, nu, True)
        print(f"[kernels] {burgers.ENTRY_POINTS[axis]} F={len(nu)} "
              f"{MAIN_SHAPE}: max|err| {r['max_abs_err']:.3e} "
              f"(rel {r['rel_err']:.3e}); kernel {r['ms']:.3f} ms, "
              f"plain {r['plain_ms']:.3f} ms, its matmul alone "
              f"{r['library_ms']:.3f} ms (median of {REPS}); bound "
              f"{r['bound_ms']:.3f} ms by {r['bound_by']} ({r['unit']}: "
              f"{r['ops_ms']:.3f} ms, bytes: {r['bytes_ms']:.3f} ms)")
        errs.append(f"{burgers.ENTRY_POINTS[axis]} ({r['unit']}) "
                    f"{r['kernel_vs_fp64']:.3e}, plain (cuBLAS fp32) "
                    f"{r['plain_vs_fp64']:.3e}")
        records.append({"name": burgers.ENTRY_POINTS[axis], "route": "cuda",
                        "source": SOURCE, "replaces": REPLACES[axis],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(f"[kernels] max|. - fp64| / max|fp64| at {MAIN_SHAPE}: "
          + "; ".join(errs))
    return records


def phase_main(P, state) -> list:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = dyn.rk_loop_stacked(P, state, entry.DT, 1)       # warm-up
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    burgers.launches[:] = [0, 0, 0]
    t0 = time.perf_counter()
    state, p = dyn.rk_loop_stacked(P, state, entry.DT, STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = list(burgers.launches)
    substeps = STEPS * len(P["rk"]["kdt"])
    require(launches == [substeps] * 3,
            f"kernel launches {launches}, expected {substeps} per axis")
    for name, a in zip("uvws", (state.u, state.v, state.w, state.s)):
        require(bool(torch.isfinite(a).all()), f"non-finite {name}")
    require(tuple(state.u.shape) == MAIN_SHAPE
            and tuple(state.s.shape) == (1,) + MAIN_SHAPE, "state shape")
    points = MAIN_SHAPE[0] * MAIN_SHAPE[1] * MAIN_SHAPE[2]
    cfl = entry.DT * float(dyn.cfl_advective_max(P, state))
    dmin, dmax = (float(d) for d in dyn.dilatation_minmax(P, state))
    peak = torch.cuda.max_memory_allocated()
    print(f"[main] {MAIN_SHAPE} fp32 RK4: {STEPS} steps in {seconds:.4f} s "
          f"(warm-up step {warm:.3f} s): "
          f"{1e3 * seconds / substeps:.3f} ms/substep, "
          f"{points * substeps / seconds:.6e} points/s/substep; "
          f"peak memory {peak} B; CFL {cfl:.4f}; "
          f"dilatation [{dmin:.4e}, {dmax:.4e}]; launches {launches}")
    return launches


def phase_fp64() -> None:
    out = {}
    for dtype in (torch.float32, torch.float64):
        _, P, state = entry.build(128, 64, 64, dtype, "cuda", seed=0)
        state, _ = dyn.rk_loop_stacked(P, state, entry.DT, 5)
        out[dtype] = state.u.double()
    ref = out[torch.float64]
    rel = ((out[torch.float32] - ref).abs().max() / ref.abs().max()).item()
    print(f"[fp64] 128x64x64, 5 RK4 steps: max|u32 - u64| / max|u64| = "
          f"{rel:.3e} (limit {FP64_TOL})")
    require(rel <= FP64_TOL, f"fp32 vs fp64: {rel} > {FP64_TOL}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this script runs only on one",
              file=sys.stderr)
        return 1
    tdevice.full_fp32_matmul()
    name = phase_device()
    phase_build()
    _, P, state = entry.build(*MAIN_SHAPE, torch.float32, "cuda", seed=0)
    records = phase_kernels(P)
    launches = phase_main(P, state)
    for rec, n in zip(records, launches):
        rec["launches"] = n
    del P, state
    phase_fp64()
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
