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
              at ten ragged shapes and at the main path's 512x256x256
              shape, each there also against a float64 product and timed
              beside its plain version, the plain version's one matmul
              (library_ms) and its bound; (b) the plain derivative
              products deriv1_x/y/z and deriv12_x/y/z against their
              full-fp32 product at the ragged shapes and a 96-point line,
              and at 512x256x256 with case02's operators (F = 1 and 4)
              against fp64 (no further off than 2x the cuBLAS product),
              timed beside the plain version and the cuBLAS fp32 product;
              (c) the fused compressible kernels comp_flux_<d>,
              comp_assemble_<d>, comp_final against their plain versions
              at 512x256x256, timed against their byte bound, and one
              internal-energy RHS fused and on the PyTorch algebra against
              fp64, timed in turns, with the memory a call adds
  4. main     the shear layer at 512x256x256 fp32: one warm-up RK4 step,
              then 3 timed steps through rk_loop_stacked; every Burgers
              term must go through the kernels
  5. fp64     fp32 (kernels) against fp64 (dense path) on the card,
              5 RK4 steps at 128x64x64
  6. dns      the port's command line (inigrid, ini, dns) on the card:
              (a) examples/shear3d/tlab.ini at its full 512x256x256 for 10
              adaptive-dt steps with a restart and the avg tables at step
              10; (b) the same case at 128x64x64, 8 steps straight against
              4 + 4 through a restart file, bit for bit
  7. options  `dns` of edited copies of that case from 6a's initial fields,
              512x256x256 fp32, 5 adaptive-dt steps each: (a) stratified and
              rotating (buoyancy, Coriolis; K1-K3 launch every substep, the
              avg table's buoyancy columns are filled); (b) skew-symmetric
              advection, staggered pressure, compact pressure filter and
              [Filter] cadence (dense products: no kernel launch, by
              design; the staggered projection alone held on a smooth
              field, in fp64 and in fp32); (c) direct eigen Poisson,
              Helmholtz pressure filter, dealiasing (no launch either; the
              filter held in fp64 against the operator it inverts); (d)
              each of a-c at
              128x64x64, fp32 against fp64; (e) the direct Poisson and
              Helmholtz solves at 512x256x256, fp32 against fp64, timed
              beside the factorized solve, and the unstaggered projection
              of a smooth field in fp32; (f) `dns` of the case with one
              option of a-c at a time (VARIANTS): what each costs a substep
  8. moist    (a) examples/cloudtop_anelastic/tlab.ini at its own
              256x192x128: K1-K3 against their plain version at the shapes
              its dns gives them (5 fields, its operators), then inigrid,
              ini and dns, 10 adaptive steps (moist thermodynamics with the
              Boussinesq set: K1-K3 launch, NewtonRs logged, 0 <= ql <= qt,
              the source hook against its fp64 evaluation, and on the fp32
              run's background); (b) that case with Equations=anelastic, gray
              radiation and sedimentation, 5 steps (dense products: no
              launch; the background's buoyancy, a background state's
              stillness and the rho-weighted projection of a smooth field
              in fp64; the radiation's two y-loops timed); (c) the shear
              layer with a wavemaker and a chemistry source, 5 steps at
              512x256x256, one RK step per dns window; (d) each of a-c at a
              reduced grid, fp32 against fp64 (the velocity's fluctuations
              and plane means and the scalars, each held)
  9. boundary (a) tests/data/case93_small3d.ini (channel over two mirrored
              bars) at 512x256x256, the bars 40x64 points: inigrid, ini,
              dns, 5 RK4 steps (K1-K3 launch after the spline fill; every
              solid point exactly 0 after every step; the fill on the card
              against the CPU's in fp64; its tables' bytes and its time a
              substep); (b) examples/ekman_mesh/tlab.ini at its 128x96x128
              without its mesh and towers, with its Jmax sponge and an
              interactive bottom surface, 10 RK3 steps (tau 0 below the
              strip; the wall scalar moves, its plane mean stays); (c)
              tests/test_cases.py's spatial jet as a 3-D case at
              512x256x128 with an inflow box and the filter sponge through
              dns.run, 5 steps (the Imin strip's v, the jet core, the
              sponge's amplitude, st5.npz and avg_zt5); (d) each of a-c at a
              reduced grid, fp32 against fp64
 10. smr91    the semi-implicit diffusion (TimeOrder=RungeKuttaDiffusion3):
              (a) examples/ekman_mesh/tlab.ini at its 128x96x128 without its
              mesh and towers, 10 adaptive steps through the CLI (K1-K3
              against their plain version with nu = 0 at its shapes, then
              launches 3 a step; the CFL column at TimeCFL while D# passes
              the explicit limit; v 0 on the walls; the Dirichlet pencil
              keeps u's and w's no-slip rows); (b) the shear layer at
              512x256x256 from 6a's fields, 5 steps: ms a stage and a step,
              peak memory; (c) both at a small grid, fp32 against fp64
 11. long     lines of 2304 points or more (ops/thomas.py): (a) the shear
              layer at 4096x128x64 (x periodic: the substructured d1 and d2,
              no K1 launch) and (b) at 128x2304x64 (y between walls: the
              substructured d1, no K2 launch; the direct eigen Poisson
              solve), inigrid, ini, dns, 5 steps, the banded operators
              against the dense ones in fp64 and fp32, the plans' host
              set-up; (c) one banded d1 against the dense product at 2304
              and 4096 points, periodic and not: the crossover on this card
 12. comp     the ideal-gas compressible set: (a) tests/data/
              case02_small3d.ini (internal energy) at
              512x256x256, inigrid, ini, dns, 5 adaptive RK4 steps (rho and p
              positive within the FlowLimit bounds, the CFL column at
              TimeCFL, the integral of rho conserved, the Favre avg columns
              finite, no kernel launch: the reference's einsums); (b) its
              fields in total energy with Equations=total and the divergence
              form, 5 steps; (c) at its own 128x64x16, fp32 against fp64,
              held to 2x tlab_tpu's own fp32 drift (tests/test_torch_fp32.py)
 13. comp+    the rest of the compressible set: (a) tests/data/
              case14_small3d.ini's physics (compressible AirWater, NSCBC
              outflow, a relaxation buffer) at 256x192x128, inigrid, ini,
              dns, 5 adaptive RK4 steps (rho and p positive within the
              bounds, 0 <= ql <= qt, NewtonRs against tlab_tpu's and its fp64
              evaluation, the CFL column at TimeCFL, the buffer's wall rows
              at their references); (b1) case02 at 512x256x256 with outflow
              NSCBC and a buffer, (b2) with the unidecomp mixture and a
              buffer, 5 steps each; (c) case14 as it is in fp64, dns.out
              equal to tlab_tpu's float64 rows in every printed digit; (d)
              case14 fp32 against fp64, each field held to 2x tlab_tpu's
              own fp32 drift; (e) case02 Type=spatial at 256x128x128,
              avg_zt5 and avgMA_zt5, the device (z, t) reduction against
              fp64 on the host; K1-K3 launch in none of them
 14. stats    the statistics: K1-K3 against their plain version at the
              diagnostic pressure's shapes (F = 3 at 512x256x256, the
              case's operators, once with conv = 0); `dns` of the shear
              layer from 6a's fields, 4 steps with [Statistics] Pdfs/
              Intermittency/Spectrums/Correlations and [Iteration]
              PhaseAvg=2, then averages, pdfs, spectra, superlayer and
              stats2nc of its restart through the CLI, the launches of each
              (5 a step + 1 a phase accumulation in dns, 1 in averages and
              pdfs: one diagnostic pressure solve each, 0 in the others);
              the offline avg against the in-run one, the pdf files against
              NumPy's tables, a volume row past 2^24 against an int64
              count, Parseval, the phase means, the superlayer heights, the
              NetCDF table; the diagnostic pressure in fp64 against the
              Poisson problem it solves, in fp32 against fp64 (at 128x64x64
              held to 2x tlab_tpu's drift)
 15. io+part  I/O and Lagrangian particles: K1-K3 against their plain
              version at examples/particle_shear's shapes; (a) that case
              (256x128x64, 100,000 tracers, RK4) through inigrid, ini,
              inipart and dns, 10 steps (every particle inside the domain
              after every step, part.10 with 100,000 unique tags, the 32
              tagged trajectories every step, K1-K3 launch 5 a step and
              once a pressure solve of the statistics, the particles' share
              of a step, the scatter-add against fp64), tracers in a
              uniform flow against x0 + u t, fp32 positions against fp64
              (the CPU witness case,
              held to 2x tlab_tpu's drift, and the case at full width);
              (b) Type=Inertia on (a)'s fields and BilinearCloudFour on a
              radiating two-scalar AirWaterLinear case at 256x128x64, 5
              steps each (finite, liquid >= 0, residence clocks never
              decrease); (c) the shear layer at 512x256x256 from 6a's
              fields with [SavePlanes], 5 steps (the planes at the restart's
              step equal to its fields cast to f4, planes2nc equal to the
              files) and examples/ekman_mesh with its [SaveTowers] (the
              tower means against the avg plane means, tower2nc); (d) one
              512x256x256 restart field through the native engine and
              through NumPy (the same bytes, both timed)
 16. tools    K1-K3 against their plain version at the diagnostic
              pressure's shapes of 16a's case; (a) `visuals` of 6a's
              fields at 512x256x256 with 7a's stratified, rotating case and
              a ParamVisuals menu of 13 entries (the Pressure family with
              PressureDecomposition=resolved): the launches against the
              names' pressure solves, Enstrophy = |VorticityVector|^2,
              Strain = 2 S:S of StrainTensor, VelocityMagnitude, Pressure =
              hydrostatic + hydrodynamic, PressureTotal = the sum of its
              four parts (the forcing's parts checked first), VelocityX =
              the restart's u in f4 bit for bit, then a Subdomain call
              against the slice of the whole field; (b) `apriori` modes 1
              and 2 (Ksgs against the tau table's trace, every column
              finite, fp32 against fp64 at 128x64x64); (c) dns.run with
              opr_check (the report before dns.out's header, fp32 within
              limits from the fp64 values of the same grid, fp64 at
              128x64x64 against tlab_tpu's); (d) `transfields` onto
              256x128x128 (against fp64) and onto a y-refined grid (back
              onto the old nodes), a constant and a cubic in y, `transgrid`
              against NumPy's file byte for byte; (e) the cloud-state
              commands on the card against the CPU, the cloud-top pair's
              buoyancy reversal
 17. mesh     the rank mesh (tlab_tpu_torch/parallel/): K1-K3 against their
              plain version at the shapes a 4x2 mesh gives them (K1 on the
              x-gathered stack, K2 on the block, K3 on the z-gathered
              stack); (a) examples/ekman_mesh/tlab.ini as written
              (128x96x128, [Parallel] Mesh=4,2, 20 RK3 steps with its
              buffer, rotation and towers) through the CLI: dns on one
              device, then dns on 8 ranks on the card over gloo (the
              backend rule's line in tlab.log), dns.out and the restarts
              against each other within fp32 limits, each rank's launches
              from tlab.log, s/step of both, transpose_check on 8 ranks;
              (b) the shear layer at 512x256x256 through `dns --mesh 1,1`
              (one rank, NCCL), 3 steps from 6a's fields: its rows against
              6a's, launches >= 15 a kernel, s/step beside 6a's,
              transpose_check there
 18. nantrap  the NaN trap (--debug-nans, [Main] DebugNans): (a) the shear
              layer at 128x64x64 with a fixed TimeStep that makes a NaN at
              a few steps: the untrapped run's NaN row with status 1; dns
              --debug-nans, and the case with [Main] DebugNans=yes, raise
              FloatingPointError naming an op after the untrapped rows
              before it; (b) 6b's case 8 steps with the trap off and on in
              turns, 3 times each: dns.out, the restarts and the avg tables
              bit for bit, the launches equal, the trap's cost a substep,
              and a step from 10 pairs of steps in one process;
              (c) K1-K3 on a finite input whose products overflow: each
              returns its NaN without the trap and raises naming its entry
              point under it; (d) 6a's case at 512x256x256 from 6a's
              fields, 5 steps off, on, on, off: dns.out and the launches
              equal, the cost, and from 10 pairs of steps
 19. precision tlab_tpu's other two contracts of the Burgers kernel
              (TLAB_TPU_MATMUL_PRECISION; every earlier phase runs at the
              unset "highest", 3xTF32): (a) the bf16 variants of K1-K3,
              "high" (3-pass bf16 split) and "default" (one bf16 pass),
              against their plain versions (the same split) at the ragged
              shapes (those that leave the bf16 column kernel's clusters
              partly empty among them) and at 512x256x256, each also
              against fp64 and timed, in turns, beside its plain version,
              one cuBLAS product of the bf16-cast operands (the library
              call of "default"; "high" has none) and the fp32 matmul, with
              its bound; (b)
              the main path at 512x256x256 under each, 3 RK4 steps: only
              that contract's entry points launch, ms/substep beside phase
              4's; (c) phase 5's fp32-against-fp64 run under "high" (held
              to phase 5's limit) and "default" (printed); (d) the
              factorized Poisson solve in fp64 under TLAB_TPU_SING_MODE=
              legacy against the CPU's, and apart from the reference mode
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
Without a CUDA card the script exits 1 and prints no result.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from tlab_tpu_torch import device as tdevice
from tlab_tpu_torch import entry
from tlab_tpu_torch import ibm
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.constants import BC
from tlab_tpu_torch.convert import state_from_numpy, state_to_numpy
from tlab_tpu_torch.dycore import buffer, inflow
from tlab_tpu_torch.dycore import incompressible as dyn
from tlab_tpu_torch.dycore.state import State
from tlab_tpu_torch.fdm.plan import build_fdm_plan
from tlab_tpu_torch.io import fields_io
from tlab_tpu_torch.ops import _build, burgers, comp_rhs, elliptic
from tlab_tpu_torch.ops import elliptic_factorize as fac
from tlab_tpu_torch.ops.derivative import apply_along, der12
from tlab_tpu_torch.physics import radiation, thermo
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.stats import averages, spatial
from tlab_tpu_torch.tools import cli
from tlab_tpu_torch.tools import dns as dns_tool
from tlab_tpu_torch.utils import nantrap
from tlab_tpu_torch.utils import trace as ttrace

MAIN_SHAPE = (512, 256, 256)
# ragged edges in every tile dimension; the odd widths take the kernels'
# scalar loads and epilogue, the multiples of 4 their 16-byte ones; the
# third is smaller than one tile in every dimension; in the fourth nz spans
# two operator tiles and ends in a ragged K tile; the rest leave the bf16
# column kernel's clusters partly empty: n = 300 (3 operator row tiles),
# nz = 300 (3 line tiles a slab), F = 1, n = 513 (a last K tile of one
# row), ncol 23 (cp.async path) beside 24
RAGGED = ((5, (24, 20, 36)), (5, (23, 19, 37)), (3, (7, 5, 6)),
          (3, (6, 10, 200)), (2, (300, 20, 36)), (2, (6, 40, 300)),
          (1, (300, 24, 40)), (3, (513, 8, 12)), (1, (40, 300, 23)),
          (1, (40, 300, 24)))
STEPS = 3
REPS = 7
# ms a substep of the main path by contract (phase 4, 19b)
MAIN_MS: dict = {}
KERNEL_TOL = 1e-5        # max|kernel - plain| / max|plain|: sums of <= 512
                         # products in another order, from the 3xTF32 split
                         # (K1-K3: ~22 bits an operand)
# published peaks of one H100 SXM (NVIDIA's data sheet, dense)
PEAK_BYTES = 3.35e12     # device memory, B/s
PEAK_OPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}   # FLOP/s by unit
FP64_TOL = 3e-4          # 5 RK4 steps at tlab_tpu's production 5.9e-5/step
CASE = pathlib.Path(__file__).resolve().parent / "examples" / "shear3d" \
    / "tlab.ini"
DNS_STEPS = 10
CFL_TARGET, CFL_TOL = 1.2, 0.05      # [Main] TimeCFL of the case
WALL_MEAN, WALL_TOL = 0.5, 1e-3      # |<u>| at the walls: DeltaVelocityX / 2
OPTION_STEPS = 5
INITIAL_FILES = ("flow.0.1", "flow.0.2", "flow.0.3", "scal.0.1")
SAVED_6A = {"dns.out": "dns.6a", "tlab.trace": "trace.6a"}
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


def phase_device() -> tuple:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}")
    print(f"[device] nvidia-smi: {smi}")
    return name, smi


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


def bound(axis, d12, x, conv, nu, prec: str = "highest") -> dict:
    """The least time the card could take for one fused Burgers term: each
    input read once and the output written once at the memory rate, or
    2 * 2n multiply-adds per output point (times the passes of the split)
    at the peak of the unit the contract's product runs on
    (burgers.CONTRACTS: 3 TF32 passes for "highest", 3 or 1 bf16 passes)."""
    n = x.shape[axis + 1]
    unit, passes = burgers.CONTRACTS[prec]
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


def plain_version(prec: str):
    """The plain PyTorch version a contract's kernel is held to: the
    full-fp32 product for "highest" (the 3xTF32 split is within its
    round-off), the same bf16 split for "high" and "default"."""
    if prec == "highest":
        return burgers.fused_burgers_plain
    unit, passes = burgers.CONTRACTS[prec]
    return lambda d12, x, conv, nu, axis: burgers.fused_burgers_split_plain(
        d12, x, conv, nu, axis, passes, unit)


def bf16_library_call(d12, x, axis):
    """(fn, how): one cuBLAS product of the bf16-rounded operator and field
    along `axis`, [D1; D2] X in one call, the yardstick of the bf16
    contracts' kernels (the "default" contract computes that product with
    fp32 accumulation, then the combine).  The operands are cast to bf16
    here, outside what `fn` does; fn returns fp32 where torch's mm/bmm take
    out_dtype=torch.float32, a bf16 result otherwise (`how` says which).
    K1 and K2 are one strided-batched product over the (n, ncol) slabs with
    the operator's batch stride 0, K3 one product of the (rows, n) lines
    with the operator's transpose."""
    n = x.shape[axis + 1]
    d = d12.to(torch.bfloat16)
    xb = x.to(torch.bfloat16)
    if axis == 2:
        a, b, op = xb.reshape(-1, n), d.t(), torch.mm
    else:
        lead = xb.shape[0] * (xb.shape[1] if axis == 1 else 1)
        b = xb.reshape(lead, n, -1)
        a, op = d.expand(lead, 2 * n, n), torch.bmm
    try:
        op(a[..., :1, :], b[..., :1] if axis < 2 else b[:, :1],
           out_dtype=torch.float32)
        kw, how = {"out_dtype": torch.float32}, "bf16 operands, fp32 result"
    except (TypeError, RuntimeError):
        kw, how = {}, "bf16 operands, bf16 result (no out_dtype)"
    return (lambda: op(a, b, **kw)), how


def check_kernel(axis, d12, x, conv, nu, timed: bool,
                 prec: str = "highest") -> dict:
    plain = plain_version(prec)
    got = burgers.fused_burgers(d12, x, conv, nu, axis, prec)
    ref = plain(d12, x, conv, nu, axis)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    require(err <= KERNEL_TOL * scale,
            f"{burgers.entry_points(prec)[axis]} at {tuple(x.shape)}: "
            f"max|err| {err} > {KERNEL_TOL} * {scale}")
    res = {"max_abs_err": err, "rel_err": err / scale}
    if timed:
        res.update(fp64_errors(axis, d12, x, conv, nu, got, ref))
        del got, ref
        calls = {
            "ms": lambda: burgers.fused_burgers(d12, x, conv, nu, axis,
                                                prec),
            "plain_ms": lambda: plain(d12, x, conv, nu, axis),
            # the plain version's one full-fp32 matmul, without the combine
            "library_ms": lambda: apply_along(d12, x, axis + 1)}
        if prec != "highest":
            # the bf16 contracts' yardstick: one bf16 product on operands
            # cast beforehand; the fp32 matmul stays a printed reference
            fp32_matmul = calls.pop("library_ms")
            calls["bf16_call_ms"], res["bf16_call"] = bf16_library_call(
                d12, x, axis)
            calls["fp32_matmul_ms"] = fp32_matmul
        times = {key: [] for key in calls}
        for _ in range(REPS):
            for key, fn in calls.items():
                times[key].append(event_ms(fn))
        res.update({key: statistics.median(v) for key, v in times.items()})
        res.update(bound(axis, d12, x, conv, nu, prec))
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


# max|kernel - plain| / max|plain| of the plain derivative products against
# their full-fp32 product with case02's operators: sums of <= 512 products
# in another order, from the 3xTF32 split (~22 bits an operand).  Random
# operators cancel far more (results ~sqrt(n) of their terms' sum) and are
# held to K1-K3's KERNEL_TOL
DERIV_TOL = 1e-6
# the ragged shapes, and lines of 96 points along every axis
DERIV_SHAPES = RAGGED + ((3, (96, 96, 96)),)
DERIV_BATCH = 10         # calls timed between two events


def deriv_plain(kind: str):
    """The plain version of a derivative entry point: the full-fp32 product
    (der1, or der12 with its halves made two contiguous tensors, as the
    entry point gives them)."""
    if kind == "deriv1":
        return lambda d12, x, axis: (
            apply_along(d12[:x.shape[axis]], x, axis),)
    return lambda d12, x, axis: tuple(h.contiguous()
                                      for h in der12(d12, x, axis))


def deriv_bound(kind: str, d12, x) -> dict:
    """The least time of one derivative entry point: x read once and each
    output written once at the memory rate, or 2n (d1) or 4n ([D1; D2])
    flop a point, three times (the TF32 split's passes), at the TF32
    peak."""
    outs = 1 if kind == "deriv1" else 2
    n = d12.shape[1]
    nbytes = (1 + outs) * x.numel() * 4 + d12.numel() * 4
    ops = 3 * outs * 2 * n * x.numel()
    by_bytes, by_ops = nbytes / PEAK_BYTES, ops / PEAK_OPS["tf32"]
    return {"bound_ms": 1e3 * max(by_bytes, by_ops),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "flop": ops / 3}


def check_deriv(kind: str, axis: int, d12, x, timed: bool,
                tol: float = DERIV_TOL) -> dict:
    """One entry point (kind deriv1 or deriv12, spatial axis `axis` of the
    stack x) against its plain version, within `tol`; timed: against fp64
    too, the kernel's, the plain version's and the cuBLAS product's ms, the
    bound."""
    fn, plain = getattr(burgers, kind), deriv_plain(kind)
    name = f"{kind}_{'xyz'[axis]}"
    got = fn(d12, x, axis + 1)
    got = got if isinstance(got, tuple) else (got,)
    ref = plain(d12, x, axis + 1)
    torch.cuda.synchronize()
    require(all(g.is_contiguous() for g in got)
            and len({g.data_ptr() for g in got}) == len(got),
            f"{name}: outputs not contiguous and separate")
    rel = max((g - r).abs().max().item() / r.abs().max().item()
              for g, r in zip(got, ref))
    require(rel <= tol, f"{name} at {tuple(x.shape)}: rel err {rel} > "
            f"{tol}")
    res = {"rel_err": rel}
    if timed:
        ref64 = plain(d12.double(), x.double(), axis + 1)
        res["kernel_vs_fp64"] = max(
            (g.double() - r).abs().max().item() / r.abs().max().item()
            for g, r in zip(got, ref64))
        res["plain_vs_fp64"] = max(
            (g.double() - r).abs().max().item() / r.abs().max().item()
            for g, r in zip(ref, ref64))
        del got, ref, ref64
        calls = {"ms": lambda: fn(d12, x, axis + 1),
                 "plain_ms": lambda: plain(d12, x, axis + 1),
                 "library_ms": lambda: apply_along(
                     d12 if kind == "deriv12" else d12[:x.shape[axis + 1]],
                     x, axis + 1)}
        # a batch of calls between two events, so that the host's issue of
        # a call (ctypes, the output's allocation: ~0.1 ms against kernels
        # of 0.3 ms) overlaps the card's work as in a step
        times = {key: [] for key in calls}
        for _ in range(REPS):
            for key, call in calls.items():
                times[key].append(event_ms(
                    lambda: [call() for _ in range(DERIV_BATCH)])
                    / DERIV_BATCH)
        res.update({key: statistics.median(v) for key, v in times.items()})
        res.update(deriv_bound(kind, d12, x))
    return res


def phase_deriv_kernels() -> list:
    """3b: the plain derivative products (deriv1_x/y/z, deriv12_x/y/z)
    against their full-fp32 product at the ragged shapes (random operators,
    KERNEL_TOL), then at 512x256x256 with case02's operators for F = 1 and
    F = 4, there against fp64 too and timed beside the plain version and
    today's cuBLAS fp32 product (library_ms), with the bound."""
    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    worst = 0.0
    for F, shape in DERIV_SHAPES:
        for axis in range(3):
            n = shape[axis]
            for kind in burgers.DERIV_KINDS:
                r = check_deriv(kind, axis, randn(2 * n, n),
                                randn(F, *shape), False, KERNEL_TOL)
                worst = max(worst, r["rel_err"])
    print(f"[deriv] deriv1/deriv12 x/y/z at {len(DERIV_SHAPES)} ragged "
          f"shapes, random operators: worst rel err {worst:.3e} (limit "
          f"{KERNEL_TOL})")
    sim = Simulation.from_case(load_case(Ini(text=comp_case(MAIN_SHAPE, 1))),
                               dtype=torch.float32, device="cuda")
    records = []
    for F in (1, 4):
        x = randn(F, *MAIN_SHAPE)
        for axis in range(3):
            d12 = sim.P["d12" + "xyz"[axis]]
            for kind in burgers.DERIV_KINDS:
                name = f"{kind}_{'xyz'[axis]}"
                r = check_deriv(kind, axis, d12, x, True)
                print(f"[deriv] {name} F={F} {MAIN_SHAPE}: rel err "
                      f"{r['rel_err']:.3e}; against fp64 "
                      f"{r['kernel_vs_fp64']:.3e} (cuBLAS fp32 "
                      f"{r['plain_vs_fp64']:.3e}); kernel {r['ms']:.3f} ms "
                      f"({r['flop'] / r['ms'] / 1e9:.1f} TFLOP/s), plain "
                      f"{r['plain_ms']:.3f} ms, cuBLAS fp32 "
                      f"{r['library_ms']:.3f} ms (a call, batches of "
                      f"{DERIV_BATCH}, median of {REPS}); bound "
                      f"{r['bound_ms']:.3f} ms by {r['bound_by']} (tf32 x3)")
                require(r["kernel_vs_fp64"] <= 2 * r["plain_vs_fp64"],
                        f"{name} F={F}: {r['kernel_vs_fp64']} from fp64, "
                        f"over 2x the cuBLAS product's {r['plain_vs_fp64']}")
                records.append({
                    "name": name, "F": F, "route": "cuda", "source": SOURCE,
                    "replaces": "none: tlab_tpu's compressible einsums",
                    "rel_err": r["rel_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"],
                    "kernel_vs_fp64": r["kernel_vs_fp64"],
                    "plain_vs_fp64": r["plain_vs_fp64"]})
        del x
    return records


# max|kernel - plain| / max|plain| of the fused compressible kernels: the
# same fp32 operations, contracted into FMAs and summed in another order
COMP_TOL = 1e-5
COMP_SOURCE = "tlab_tpu_torch/csrc/comp_rhs.cu"
COMP_ENTRIES = tuple(f"comp_{kind}_{d}" for kind in ("flux", "assemble")
                     for d in "xyz") + ("comp_final",)


def comp_fields(kind: str, ns: int, first: bool = True,
                last: bool = False, prim: bool = False) -> int:
    """Fields a fused compressible kernel reads and writes at one point of
    a 3-D box with ns scalars, each once: comp_flux (the state; the fluxes,
    with `prim` the stack and s), comp_assemble (the derivatives, rho and
    the tendencies so far; the tendencies and the gradients, or, `last`,
    the other two directions' gradients and rho e, and div u), comp_final
    (three momentum tendencies and d div u; the tendencies)."""
    if kind == "flux":
        return 5 + ns + 4 + ns + (4 + ns if prim else 0)
    if kind == "final":
        return 9
    reads = 1 + 4 + ns + 3 + 4 + (3 * ns + 1 if ns else 0) \
        + (0 if first else 5 + ns) + (6 + (1 if ns else 2) if last else 0)
    return reads + 5 + ns + (1 if last else 3)


def phase_comp_rhs_kernels(smi: str) -> list:
    """3c: the fused compressible kernels (ops/comp_rhs.py) at 512x256x256
    with one scalar against their plain versions (COMP_TOL), each timed
    alone (batches of DERIV_BATCH calls, median of REPS) beside its plain
    version against its byte bound; then one whole internal-energy RHS of
    case02's plan, fused and on the PyTorch algebra (the gate off here
    alone), each against float64 (the fused no further off than 1.5x),
    timed in turns, and the device memory one call adds at its peak."""
    from tlab_tpu_torch.dycore import compressible as tcomp
    gen = torch.Generator(device="cuda").manual_seed(2)
    ns = 1

    def f(*lead, lo=None):
        a = torch.randn(lead + MAIN_SHAPE, generator=gen, device="cuda")
        return a if lo is None else lo + 0.05 * a

    U = tcomp.CompState(f(lo=1.0), 0.1 * f(), 0.1 * f(), 0.1 * f(),
                        f(lo=17.0), 0.5 + 0.1 * f(ns))
    der = comp_rhs.Derivs(f(), (f(), f(), f(), f(), f(ns)), f(4), f(4),
                          f(ns), f(ns), f())
    grads = {0: f(3), 1: f(3)}
    h0 = f(5 + ns)
    dd = [f(), f(), f()]
    cT, cP, mu, cond, diff = 0.0504, 7.9365, 1e-3, 0.0397, (1e-3,)
    cases = [
        ("comp_flux_x", "flux", dict(prim=True),
         lambda: comp_rhs.flux(0, U, cT, cP, True),
         lambda: comp_rhs.flux_plain(0, U, cT, cP, True)),
        ("comp_flux_y", "flux", dict(prim=False),
         lambda: comp_rhs.flux(1, U, cT, cP, False),
         lambda: comp_rhs.flux_plain(1, U, cT, cP, False)),
        ("comp_flux_z", "flux", dict(prim=False),
         lambda: comp_rhs.flux(2, U, cT, cP, False),
         lambda: comp_rhs.flux_plain(2, U, cT, cP, False))]
    for d, first, last in ((0, True, False), (1, False, False),
                           (2, False, True)):
        args = (grads, first, last, mu, cond, cT, cP, diff)
        cases.append((
            f"comp_assemble_{'xyz'[d]}", "assemble",
            dict(first=first, last=last),
            lambda d=d, args=args: comp_rhs.assemble(d, der, U, h0.clone(),
                                                     *args),
            lambda d=d, args=args: comp_rhs.assemble_plain(
                d, der, U, h0.clone(), *args)))
    cases.append(("comp_final", "final", {},
                  lambda: comp_rhs.final(h0.clone(), dd, mu),
                  lambda: comp_rhs.final_plain(h0.clone(), dd, mu)))
    points = MAIN_SHAPE[0] * MAIN_SHAPE[1] * MAIN_SHAPE[2]
    records = []
    for name, kind, kw, fn, plain in cases:
        got, ref = fn(), plain()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        torch.cuda.synchronize()
        rel = max((g - r).abs().max().item() / r.abs().max().item()
                  for g, r in zip(got, ref) if r is not None)
        require(rel <= COMP_TOL, f"{name}: rel err {rel} > {COMP_TOL}")
        del got, ref
        fields = comp_fields(kind, ns, **kw)
        bound = 1e3 * fields * points * 4 / PEAK_BYTES
        # the clones of h0 the calls take are timed too: the same copy in
        # the kernel's and the plain version's time, read and written once
        clone_ms = statistics.median(
            event_ms(lambda: [h0.clone() for _ in range(DERIV_BATCH)])
            / DERIV_BATCH for _ in range(REPS)) if kind != "flux" else 0.0
        times = {"ms": [], "plain_ms": []}
        for _ in range(REPS):
            for key, call in (("ms", fn), ("plain_ms", plain)):
                times[key].append(event_ms(
                    lambda: [call() for _ in range(DERIV_BATCH)])
                    / DERIV_BATCH - clone_ms)
        ms = statistics.median(times["ms"])
        plain_ms = statistics.median(times["plain_ms"])
        print(f"[comp_rhs] {name} {MAIN_SHAPE} ns={ns} {kw or ''}: rel err "
              f"{rel:.3e}; kernel {ms:.4f} ms ({fields} fields, "
              f"{fields * points * 4 / ms / 1e6:.0f} GB/s), plain "
              f"{plain_ms:.4f} ms; bound {bound:.4f} ms by bytes "
              f"({100 * bound / ms:.1f}%); {smi}")
        records.append({"name": name, "route": "cuda",
                        "source": COMP_SOURCE,
                        "replaces": "none: the PyTorch algebra of "
                                    "rhs_compressible_internal",
                        "rel_err": rel, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": "bytes",
                        "fields": fields})
    del U, der, grads, h0, dd
    sim = Simulation.from_case(load_case(Ini(text=comp_case(MAIN_SHAPE, 1))),
                               dtype=torch.float32, device="cuda")
    c = sim.comp
    rng = np.random.default_rng(3)
    prim = [1.0 + 0.05 * rng.standard_normal(MAIN_SHAPE)] \
        + [0.1 * rng.standard_normal(MAIN_SHAPE) for _ in range(3)] \
        + [1.0 + 0.05 * rng.standard_normal(MAIN_SHAPE)]
    s = rng.random((ns,) + MAIN_SHAPE)

    def state(dtype):
        return tcomp.from_primitive(
            *(torch.from_numpy(a).to("cuda", dtype) for a in prim),
            c["gamma"], c["mach"], s=torch.from_numpy(s).to("cuda", dtype),
            energy="internal")

    def rhs(P, U):
        return tcomp.rhs_compressible_internal(
            P, U, c["gamma"], c["mach"], sim.nsp.visc, c["prandtl"],
            gas=c["gas"])

    U32 = state(torch.float32)
    fused = tcomp._fused
    paths = {"fused": fused, "torch": lambda *a: False}
    out = {}
    for key, gate in paths.items():
        tcomp._fused = gate
        try:
            rhs(sim.P, U32)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            h = rhs(sim.P, U32)
            torch.cuda.synchronize()
            out[key] = {"h": [x.double().cpu() for x in h],
                        "peak": torch.cuda.max_memory_allocated() - base}
            del h
        finally:
            tcomp._fused = fused
    del U32
    P64 = Simulation.from_case(load_case(Ini(text=comp_case(MAIN_SHAPE, 1))),
                               dtype=torch.float64, device="cuda").P
    ref = [x.cpu() for x in rhs(P64, state(torch.float64))]
    del P64
    torch.cuda.empty_cache()
    gaps = {key: [float((a - r).abs().max() / r.abs().max())
                  for a, r in zip(o["h"], ref)] for key, o in out.items()}
    for name, a, b in zip(tcomp.CompState._fields, gaps["fused"],
                          gaps["torch"]):
        require(a <= 1.5 * b, f"fused RHS {name}: {a} from fp64, over 1.5x "
                f"the PyTorch algebra's {b}")
    U32 = state(torch.float32)
    times = {key: [] for key in paths}
    for _ in range(REPS):
        for key, gate in paths.items():
            tcomp._fused = gate
            try:
                times[key].append(event_ms(lambda: rhs(sim.P, U32)))
            finally:
                tcomp._fused = fused
    field_bytes = 4 * points
    print(f"[comp_rhs] RHS {MAIN_SHAPE} ns={ns}: fused "
          f"{statistics.median(times['fused']):.3f} ms, PyTorch algebra "
          f"{statistics.median(times['torch']):.3f} ms (a call, median of "
          f"{REPS}, in turns); device memory a call adds at its peak: fused "
          f"{out['fused']['peak'] / field_bytes:.1f} fields, PyTorch "
          f"{out['torch']['peak'] / field_bytes:.1f} ({out['fused']['peak']} "
          f"and {out['torch']['peak']} B); max|. - fp64| / max|fp64| fused "
          + ", ".join(f"{g:.2e}" for g in gaps["fused"]) + "; PyTorch "
          + ", ".join(f"{g:.2e}" for g in gaps["torch"]) + f"; {smi}")
    return records


def phase_main(P, state) -> list:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = dyn.rk_loop_stacked(P, state, entry.DT, 1)       # warm-up
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    burgers.reset_launches()
    t0 = time.perf_counter()
    state, p = dyn.rk_loop_stacked(P, state, entry.DT, STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = list(burgers.contract_launches["highest"])
    substeps = STEPS * len(P["rk"]["kdt"])
    require(launches == [substeps] * 3,
            f"kernel launches {launches}, expected {substeps} per axis")
    require(all(counts == [0, 0, 0] for name, counts
                in burgers.contract_launches.items() if name != "highest"),
            f"another contract's kernel launched: {burgers.contract_launches}")
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
    MAIN_MS["highest"] = 1e3 * seconds / substeps
    return launches


def fp32_drift() -> float:
    """max|u32 - u64| / max|u64| after 5 RK4 steps at 128x64x64: fp32 through
    the kernels of the contract the environment names, fp64 through the
    dense path."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        _, P, state = entry.build(128, 64, 64, dtype, "cuda", seed=0)
        state, _ = dyn.rk_loop_stacked(P, state, entry.DT, 5)
        out[dtype] = state.u.double()
    ref = out[torch.float64]
    return ((out[torch.float32] - ref).abs().max() / ref.abs().max()).item()


def phase_fp64() -> None:
    rel = fp32_drift()
    print(f"[fp64] 128x64x64, 5 RK4 steps: max|u32 - u64| / max|u64| = "
          f"{rel:.3e} (limit {FP64_TOL})")
    require(rel <= FP64_TOL, f"fp32 vs fp64: {rel} > {FP64_TOL}")


def edit_case(text: str, changes: dict) -> str:
    """The case file's text with {(section, key): value} changed; every key
    must be there already."""
    for (section, key), value in changes.items():
        pat = re.compile(rf"(\[{section}\][^\[]*?^{key}=)[^\n]*", re.M | re.S)
        text, n = pat.subn(rf"\g<1>{value}", text)
        require(n == 1, f"[{section}] {key} not found in the case file")
    return text


def run_cli(command: str, ini: str, outdir: str, *more) -> float:
    """One command of the port's CLI on the card; seconds of wall time."""
    t0 = time.perf_counter()
    rc = cli.main([command, "--ini", ini, "--outdir", outdir, *more])
    torch.cuda.synchronize()
    require(rc == 0, f"cli {command} returned {rc}")
    return time.perf_counter() - t0


def data_rows(path) -> list:
    """dns.out's step rows as lists of fields (text)."""
    with open(path) as fh:
        return [ln.split() for ln in fh if not ln.startswith("#")]


def read_trace(path) -> dict:
    """tlab.trace: message -> (time of the line, seconds of a LEAVING
    line's span or None)."""
    out = {}
    with open(path) as fh:
        for ln in fh:
            stamp, msg = ln.strip().split(None, 1)
            span = re.search(r"^LEAVING  (.*?)  \(([0-9.]+) s\)$", msg)
            if span:
                out[span.group(1)] = (float(stamp), float(span.group(2)))
            else:
                out[msg.split(" (dt=")[0]] = (float(stamp), None)
    return out


def traced_cli(ini: str, out: str, commands, *more) -> dict:
    """The CLI's `commands` in turn with tlab.trace on; `dns` comes last,
    with the kernels' counts set to 0 just before it and read just after
    (K1-K3, the derivative products, the fused compressible kernels).
    Returns the DnsRun, the counts, dns' peak device memory and the seconds
    of each command."""
    os.environ["TLAB_TPU_TRACE"] = "1"         # spans for the timings
    runs = []
    run_fn = dns_tool.run

    def keep_run(*args, **kw):
        runs.append(run_fn(*args, **kw))
        return runs[-1]

    dns_tool.run = keep_run
    seconds = {}
    try:
        for command in commands:
            if command == "dns":
                torch.cuda.reset_peak_memory_stats()
                burgers.reset_launches()
                burgers.reset_deriv_launches()
                comp_rhs.reset_launches()
            seconds[command] = run_cli(command, ini, out, *more)
        launches = list(burgers.contract_launches["highest"])
        deriv = {k: list(v) for k, v in burgers.deriv_launches.items()}
        comp = {k: comp_rhs.launches.get(k, 0) for k in COMP_ENTRIES}
    finally:
        dns_tool.run = run_fn
        del os.environ["TLAB_TPU_TRACE"]
        ttrace.close()
    return {"run": runs[0], "launches": launches, "deriv_launches": deriv,
            "comp_launches": comp, "seconds": seconds,
            "peak": torch.cuda.max_memory_allocated()}


def comp_launches(tag: str, res, each) -> dict:
    """The fused compressible kernels' launches in a traced_cli dns,
    required to be `each` for every entry point (one of them a set)."""
    got = res["comp_launches"]
    allowed = each if isinstance(each, set) else {each}
    print(f"[{tag[:2]}] {tag}: fused compressible kernel launches {got}")
    require(len(set(got.values())) == 1 and got["comp_final"] in allowed,
            f"{tag}: fused compressible kernel launches {got}, each of "
            f"{sorted(allowed)} expected")
    return got


def step_rate(trace: dict, steps: int, n_sub: int) -> dict:
    """Seconds of `steps` logged steps from the trace's stamps, and the
    rates per substep."""
    stamps = [trace["time loop starts"][0]] + [
        trace[f"iteration {k} logged"][0] for k in range(1, steps + 1)]
    each = [b - a for a, b in zip(stamps, stamps[1:])]
    total = stamps[-1] - stamps[0]
    points = MAIN_SHAPE[0] * MAIN_SHAPE[1] * MAIN_SHAPE[2]
    return {"seconds": total, "each": each,
            "ms_substep": 1e3 * total / (steps * n_sub),
            "rate": points * steps * n_sub / total,
            "others_ms_substep": 1e3 * statistics.median(each[1:]) / n_sub}


def phase_dns_case(card: str, keep: str) -> list:
    """6a: inigrid, ini and dns of the full-width case through the CLI.
    The initial fields stay in `keep` for phase 7."""
    changes = {("Iteration", "End"): str(DNS_STEPS),
               ("Iteration", "Restart"): str(DNS_STEPS),
               ("Iteration", "Statistics"): str(DNS_STEPS)}
    text = edit_case(CASE.read_text(), changes)
    print(f"[dns] {CASE.relative_to(CASE.parents[2])} with "
          + ", ".join(f"[{s}] {k}={v}" for (s, k), v in changes.items()))
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as out:
        ini = os.path.join(out, "tlab.ini")
        with open(ini, "w") as fh:
            fh.write(text)
        res = traced_cli(ini, out, ("inigrid", "ini", "dns"))
        ini_s, dns_s = res["seconds"]["ini"], res["seconds"]["dns"]
        launches, peak, run = res["launches"], res["peak"], res["run"]
        for f in INITIAL_FILES:
            shutil.move(os.path.join(out, f), os.path.join(keep, f))
        for f, kept in SAVED_6A.items():          # 17b's reference
            shutil.copy(os.path.join(out, f), os.path.join(keep, kept))
        n_sub = len(run.sim.P["rk"]["kdt"])
        require(launches == [DNS_STEPS * n_sub] * 3,
                f"dns launched {launches}, expected "
                f"{DNS_STEPS * n_sub} per axis")
        for name in ("grid", "tlab.log", "dns.out"):
            require(os.path.exists(os.path.join(out, name)), f"no {name}")

        rows = data_rows(os.path.join(out, "dns.out"))
        require(len(rows) == DNS_STEPS + 1
                and all(r[0] == "0" for r in rows),
                f"dns.out: {len(rows)} rows, status {[r[0] for r in rows]}")
        cfl = [float(r[4]) for r in rows[1:]]
        require(all(abs(c - CFL_TARGET) <= CFL_TOL for c in cfl),
                f"CFL column {cfl} not within {CFL_TOL} of {CFL_TARGET}")
        dil1, dil_n = abs(float(rows[1][8])), abs(float(rows[-1][8]))
        require(dil_n < dil1, f"dilatation max {dil_n} at the last row, "
                              f"{dil1} at row 1")

        got = fields_io.read_state(os.path.join(out, "flow"),
                                   os.path.join(out, "scal"), DNS_STEPS,
                                   run.state.s.shape[0])
        require(tuple(got[0].shape) == MAIN_SHAPE, "restart shape")
        for name, a, b in zip("uvws", got[:4], state_to_numpy(run.state)):
            require(np.isfinite(b).all() and np.array_equal(a, b),
                    f"restart field {name} differs from the final state")
        require(got[4] == run.rtime, "restart time differs from the run's")

        stats = {}
        for name in (f"avg{DNS_STEPS}", f"avg{DNS_STEPS}s1"):
            _, _, cols = averages.read_avg(os.path.join(out, name))
            require(all(np.isfinite(v).all() for v in cols.values()),
                    f"{name}: non-finite column")
            stats[name] = cols
        flow = stats[f"avg{DNS_STEPS}"]
        walls = [abs(flow["rU"][0]), abs(flow["rU"][-1])]
        require(all(abs(m - WALL_MEAN) <= WALL_TOL for m in walls),
                f"|rU| at the walls {walls}, expected {WALL_MEAN}")
        require(flow["Tke"].min() >= 0.0, "negative Tke")
        trace = read_trace(os.path.join(out, "tlab.trace"))

    ic_s, host_s = trace["initial_state"][1], trace["inirand_fields"][1]
    rate = step_rate(trace, DNS_STEPS, n_sub)
    print(f"[dns] {card}: ini {ini_s:.3f} s of which initial_state "
          f"{ic_s:.3f} s = random fields on the host {host_s:.3f} s + "
          f"device part {ic_s - host_s:.3f} s")
    print(f"[dns] {card}: dns {dns_s:.3f} s; {DNS_STEPS} adaptive-dt "
          f"steps with their host syncs {rate['seconds']:.4f} s: "
          f"{rate['ms_substep']:.3f} ms/substep, "
          f"{rate['rate']:.6e} points/s/substep (first step "
          f"{rate['each'][0]:.4f} s, the others' median "
          f"{rate['others_ms_substep']:.3f} ms/substep); "
          f"launches "
          f"{launches}; CFL {min(cfl):.3f}..{max(cfl):.3f}; dilatation max "
          f"{dil1:.4e} -> {dil_n:.4e}; t = {run.rtime:.6e}")
    print(f"[dns] {card}: one write_statistics "
          f"{trace[f'statistics {DNS_STEPS}'][1]:.3f} s; one checkpoint "
          f"(4 fields, <f8) {trace[f'checkpoint {DNS_STEPS}'][1]:.3f} s; "
          f"peak device memory {peak} B; |rU| at the walls {walls[0]:.6f}, "
          f"{walls[1]:.6f}; max Tke {flow['Tke'].max():.4e}")
    return launches


def phase_dns_restart() -> None:
    """6b: 8 steps straight against 4 + 4 through a restart, 128x64x64."""
    small = {("Grid", "Imax"): "128", ("Grid", "Jmax"): "64",
             ("Grid", "Kmax"): "64", ("IniGridOx", "points_1"): "129",
             ("IniGridOy", "points_1"): "64",
             ("IniGridOz", "points_1"): "65",
             ("Iteration", "Restart"): "4"}
    base = CASE.read_text()

    def case(start, end):
        return edit_case(base, {**small,
                                ("Iteration", "Start"): str(start),
                                ("Iteration", "End"): str(end)})

    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as top:
        a, b = os.path.join(top, "a"), os.path.join(top, "b")
        inis = {}
        for name, (start, end) in (("straight", (0, 8)), ("first", (0, 4)),
                                   ("second", (4, 8))):
            inis[name] = os.path.join(top, name + ".ini")
            with open(inis[name], "w") as fh:
                fh.write(case(start, end))
        run_cli("ini", inis["straight"], a)
        os.makedirs(b)
        for f in ("flow.0.1", "flow.0.2", "flow.0.3", "scal.0.1"):
            shutil.copy(os.path.join(a, f), os.path.join(b, f))
        run_cli("dns", inis["straight"], a)
        run_cli("dns", inis["first"], b)
        run_cli("dns", inis["second"], b)
        for f in ("flow.8.1", "flow.8.2", "flow.8.3", "scal.8.1"):
            with open(os.path.join(a, f), "rb") as fa, \
                    open(os.path.join(b, f), "rb") as fb:
                require(fa.read() == fb.read(),
                        f"{f}: 4 + 4 steps differ from 8 straight")
        tail = {d: [r for r in data_rows(os.path.join(d, "dns.out"))
                    if int(r[1]) > 4] for d in (a, b)}
        require(len(tail[a]) == 4 and tail[a] == tail[b],
                f"dns.out rows 5-8 differ: {tail[a]} / {tail[b]}")
    print("[dns] 128x64x64 fp32: 8 steps straight = 4 steps + restart "
          "file + 4 steps, final fields bit for bit, dns.out rows 5-8 equal "
          f"(t = {float(tail[a][-1][2]):.6e})")


def add_keys(text: str, section: str, lines) -> str:
    """The case file's text with `lines` (key=value) put at the head of
    [section], which is appended if the file has none."""
    body = "".join(ln + "\n" for ln in lines)
    if f"[{section}]\n" in text:
        return text.replace(f"[{section}]\n", f"[{section}]\n{body}", 1)
    return f"{text}\n[{section}]\n{body}"


# the Helmholtz pressure filter (1 - w^2/24 Lap) pf = p of 7c and 7e: w is
# four spacings of the case's x and z grids (2 pi / 512)
HELMHOLTZ_WIDTH = 0.05
# phase 7's cases: (changes to keys the file has, sections and keys added)
OPTION_CASES = {
    "7a": ("stratified, rotating",
           {},
           {"Main": ["TermBodyForce=Linear"],
            "Parameters": ["Froude=1.0", "Rossby=1.0"],
            "Gravity": ["Vector=0.0,-1.0,0.0", "Parameters=1.0"],
            "Rotation": ["Type=explicit", "Vector=0.0,1.0,0.0"]}),
    "7b": ("skew-symmetric, staggered, filtered",
           {("Main", "TermAdvection"): "skewsymmetric"},
           {"Staggering": ["StaggerHorizontalPressure=yes"],
            "PressureFilter": ["Type=compact", "Parameters=0.49"],
            "Filter": ["Type=compact", "Parameters=0.49", "Step=2"]}),
    "7c": ("direct eigen Poisson, Helmholtz pressure filter, dealiasing",
           {},
           {"Main": ["EllipticOrder=compactdirect6"],
            "PressureFilter": ["Type=helmholtz",
                               f"Parameters={HELMHOLTZ_WIDTH}"],
            "Dealiasing": ["Type=compact", "Parameters=0.49"]}),
}
# 7f: one option at a time on top of the case (changes, keys added)
VARIANTS = {
    "buoyancy + Coriolis": ({}, OPTION_CASES["7a"][2]),
    "skewsymmetric": ({("Main", "TermAdvection"): "skewsymmetric"}, {}),
    "divergence form": ({("Main", "TermAdvection"): "divergence"}, {}),
    "dealiasing": ({}, {"Dealiasing": ["Type=compact", "Parameters=0.49"]}),
    "direct eigen Poisson": ({}, {"Main": ["EllipticOrder=compactdirect6"]}),
    "Helmholtz pressure filter": (
        {}, {"PressureFilter": OPTION_CASES["7c"][2]["PressureFilter"]}),
    "compact pressure filter": (
        {}, {"PressureFilter": OPTION_CASES["7b"][2]["PressureFilter"]}),
    "staggered": ({}, {"Staggering": ["StaggerHorizontalPressure=yes"]}),
    "[Filter] Step=2": ({}, {"Filter": OPTION_CASES["7b"][2]["Filter"]}),
}
# dilatation max of the last logged step.  7a projects with the factorized
# solver, which removes the divergence it measures (6a: 4e-3 at step 1, 7e-4
# at step 10).  7b's staggered projection is exact only where the
# interpolation's transfer is ~1, as the reference's, and its pressure is
# filtered: the run's dilatation (on the pressure nodes) must fall below the
# initial fields', and the projection alone is held on a smooth field
# (smooth_projection).  7c's direct solver leaves the D1^2-against-D2
# mismatch by construction and its Helmholtz-filtered pressure lets the
# divergence grow from step to step, as the reference's does on this case:
# the run is held to stay bounded, the filter itself against the operator it
# inverts (helmholtz_residual)
OPTION_DIL_TOL = {"7a": 1e-2, "7c": 1e2}
SMOOTH_TOL = 1e-4        # in fp64; tests/test_stagger.py: 2e-3 at 32x49x16
# in fp32 the u/dte forcing's round-off through the Poisson solve stays: about
# three times the 7e-2 (staggered) and 1.1e-1 (unstaggered) read at full width
SMOOTH_TOL_FP32 = 0.3
HELMHOLTZ_TOL = 1e-9     # fp64 round-off of the solve and of three products
BUOYANCY_COLUMNS = ("rB", "Byy", "Buo", "Pot", "Fxx", "Fxz")
SMALL_GRID = {("Grid", "Imax"): "128", ("Grid", "Jmax"): "64",
              ("Grid", "Kmax"): "64", ("IniGridOx", "points_1"): "129",
              ("IniGridOy", "points_1"): "64",
              ("IniGridOz", "points_1"): "65"}


def option_case(tag: str, changes: dict) -> str:
    """The case file with `changes` and phase 7's case `tag`, or, for a
    name of VARIANTS, that one option."""
    edits, added = OPTION_CASES[tag][1:] if tag in OPTION_CASES \
        else VARIANTS[tag]
    text = edit_case(CASE.read_text(), {**changes, **edits})
    for section, lines in added.items():
        text = add_keys(text, section, lines)
    return text


def link_initial_fields(src: str, out: str) -> None:
    os.makedirs(out, exist_ok=True)
    for f in INITIAL_FILES:
        os.symlink(os.path.join(src, f), os.path.join(out, f))


def smooth_projection(grid, P) -> float:
    """max|divergence| after one substep from a smooth divergent field
    (tests/test_stagger.py's, on this grid) over the same before, wall rows
    left out: what the projection removes, for a staggered plan on the
    pressure nodes, where the interpolation's transfer is ~1."""
    kw = {"dtype": P["d1y"].dtype, "device": P["d1y"].device}
    x = torch.as_tensor(grid.x.nodes, **kw)[:, None, None]
    y = torch.as_tensor(grid.y.nodes, **kw)[None, :, None]
    z = torch.as_tensor(grid.z.nodes, **kw)[None, None, :]
    kx, kz = 2 * np.pi / grid.x.scale, 2 * np.pi / grid.z.scale
    ly = float(grid.y.nodes[-1])
    env = torch.sin(np.pi * y / ly)
    one = torch.ones(grid.shape, **kw)
    Q = torch.stack([
        (torch.sin(kx * x) + 0.3 * torch.cos(2 * kx * x + kz * z)) * env,
        0.2 * torch.sin(2 * np.pi * y / ly) * torch.cos(kx * x) * one,
        0.4 * torch.sin(kz * z) * torch.cos(kx * x) * env,
        0.0 * one])
    divergence = dyn.divergence_staggered if P.get("stag") is not None \
        else dyn.divergence
    div0 = divergence(P, Q[0], Q[1], Q[2])
    dte = 0.01
    H, _ = dyn.substep_rhs_stacked(P, Q, torch.zeros_like(Q), dte)
    Q = Q + dte * H
    div = divergence(P, Q[0], Q[1], Q[2])
    return (div[:, 1:-1].abs().max() / div0[:, 1:-1].abs().max()).item()


def helmholtz_residual(P, shape) -> float:
    """max|(1 - w^2/24 Lap) pf - p| / max|p| off the wall rows, for pf the
    plan's [PressureFilter] Type=helmholtz of a random field p and Lap the
    sum of the plan's second-derivative operators: the filter's sign and
    scale as the step applies it."""
    gen = torch.Generator(device=P["d1y"].device).manual_seed(2)
    p = torch.randn(shape, generator=gen, dtype=P["d1y"].dtype,
                    device=P["d1y"].device)
    pf = dyn._pressure_filter(P)(p)
    lap = sum(der12(P[f"d12{name}"], pf, axis)[1]
              for axis, name in enumerate("xyz"))
    back = pf + lap / P["pfilter"]["helmholtz_alpha"]
    return ((back - p)[:, 1:-1].abs().max() / p.abs().max()).item()


def phase_option(tag: str, card: str, initial: str) -> list:
    """7a-7c: `dns` of one edited case at full width from 6a's fields."""
    what = OPTION_CASES[tag][0]
    text = option_case(tag, {("Iteration", "End"): str(OPTION_STEPS),
                             ("Iteration", "Restart"): "1000",
                             ("Iteration", "Statistics"): str(OPTION_STEPS)})
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as out:
        ini = os.path.join(out, "tlab.ini")
        with open(ini, "w") as fh:
            fh.write(text)
        link_initial_fields(initial, out)
        res = traced_cli(ini, out, ("dns",))
        run, launches = res["run"], res["launches"]
        rows = data_rows(os.path.join(out, "dns.out"))
        trace = read_trace(os.path.join(out, "tlab.trace"))
        _, _, flow = averages.read_avg(
            os.path.join(out, f"avg{OPTION_STEPS}"))
    P = run.sim.P
    n_sub = len(P["rk"]["kdt"])
    rate = step_rate(trace, OPTION_STEPS, n_sub)
    cfl = [float(r[4]) for r in rows[1:]]
    dil = [max(abs(float(r[7])), abs(float(r[8]))) for r in rows]
    print(f"[options] {tag} {what} ({card}): {MAIN_SHAPE} fp32, "
          f"{OPTION_STEPS} adaptive-dt steps with their host syncs "
          f"{rate['seconds']:.4f} s: {rate['ms_substep']:.3f} ms/substep, "
          f"{rate['rate']:.6e} points/s/substep (first step "
          f"{rate['each'][0]:.4f} s, the others' median "
          f"{rate['others_ms_substep']:.3f} ms/substep); peak device memory "
          f"{res['peak']} B; launches {launches}")
    print(f"[options] {tag}: CFL {min(cfl):.3f}..{max(cfl):.3f}; dilatation "
          f"max {dil[0]:.4e} at the start, {dil[1]:.4e} -> {dil[-1]:.4e} "
          f"over the steps ("
          + ("pressure nodes" if P.get("stag") is not None else
             "velocity nodes")
          + f"; projection: "
          + ("factorized" if P.get("ell_fac") is not None else "direct eigen")
          + f"); t = {run.rtime:.6e}; statistics "
          f"{trace[f'statistics {OPTION_STEPS}'][1]:.3f} s; "
          + ", ".join(f"max|{n}| {np.abs(flow[n]).max():.3e}"
                      for n in BUOYANCY_COLUMNS[:4]))
    require(len(rows) == OPTION_STEPS + 1 and all(r[0] == "0" for r in rows),
            f"{tag} dns.out: {len(rows)} rows, status "
            f"{[r[0] for r in rows]}")
    for name, a in zip("uvws", state_to_numpy(run.state)):
        require(np.isfinite(a).all(), f"{tag}: non-finite {name}")
    require(tuple(run.state.u.shape) == MAIN_SHAPE, f"{tag}: state shape")
    require(all(abs(c - CFL_TARGET) <= CFL_TOL for c in cfl),
            f"{tag}: CFL column {cfl} not within {CFL_TOL} of {CFL_TARGET}")
    if tag in ("7b", "7c"):
        sim64 = Simulation.from_case(load_case(Ini(text=text)),
                                     dtype=torch.float64, device="cuda")
    if tag == "7c":
        resid = helmholtz_residual(sim64.P, MAIN_SHAPE)
        print(f"[options] 7c: max|(1 - w^2/24 Lap) pf - p| / max|p| off the "
              f"wall rows = {resid:.3e} in fp64 (limit {HELMHOLTZ_TOL}), pf "
              f"the plan's pressure filter of a random p, w = "
              f"{HELMHOLTZ_WIDTH}")
        del sim64
        require(resid <= HELMHOLTZ_TOL,
                f"7c: the Helmholtz pressure filter leaves {resid}")
    if tag == "7b":
        red64 = smooth_projection(sim64.grid, sim64.P)
        red32 = smooth_projection(run.sim.grid, P)
        del sim64
        print(f"[options] 7b: staggered divergence of a smooth field after "
              f"one substep / before = {red64:.3e} in fp64 (limit "
              f"{SMOOTH_TOL}), {red32:.3e} in fp32 (round-off of the u/dte "
              f"forcing; limit {SMOOTH_TOL_FP32})")
        require(red64 <= SMOOTH_TOL,
                f"7b: staggered projection leaves {red64}")
        require(red32 <= SMOOTH_TOL_FP32,
                f"7b: staggered projection leaves {red32} in fp32")
        require(dil[-1] < dil[0], f"7b: dilatation max {dil[-1]} at the last "
                                  f"row, {dil[0]} at the start")
    else:
        require(dil[-1] <= OPTION_DIL_TOL[tag],
                f"{tag}: dilatation max {dil[-1]} > {OPTION_DIL_TOL[tag]}")
    require(all(np.isfinite(v).all() for v in flow.values()),
            f"{tag}: non-finite avg column")
    if tag == "7a":
        # a stratified convective run goes through the kernels every substep
        require(P["bodyforce"] is not None, "7a: no body force in the plan")
        require(launches == [OPTION_STEPS * n_sub] * 3,
                f"7a launched {launches}, expected {OPTION_STEPS * n_sub} "
                f"per axis")
        for n in BUOYANCY_COLUMNS:
            require(np.abs(flow[n]).max() > 0.0, f"7a: avg column {n} is 0")
    else:
        # dense products by design, as in the reference package: the
        # conservative forms (7b) and a dealiased direction (7c) bypass
        # the fused kernel
        require(launches == [0, 0, 0], f"{tag} launched {launches}")
        require(np.abs(flow["rB"]).max() == 0.0, f"{tag}: rB without "
                                                 f"a buoyancy")
    if tag == "7b":
        require(P.get("stag") is not None and P.get("pfilter") is not None
                and P.get("adv_form") == "skewsymmetric"
                and run.sim.filter_matrices() is not None, "7b: plan")
    if tag == "7c":
        require(P.get("ell_fac") is None and P.get("dealias") is not None
                and "helmholtz_alpha" in P["pfilter"], "7c: plan")
    return launches


def phase_options_fp64() -> None:
    """7d: each of 7a-7c at 128x64x64 through the CLI, fp32 against fp64
    from the same initial fields."""
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as top:
        base = os.path.join(top, "base")
        ini0 = os.path.join(top, "base.ini")
        with open(ini0, "w") as fh:
            fh.write(edit_case(CASE.read_text(), SMALL_GRID))
        run_cli("ini", ini0, base, "--x64")
        for tag in OPTION_CASES:
            ini = os.path.join(top, tag + ".ini")
            with open(ini, "w") as fh:
                fh.write(option_case(tag, {
                    **SMALL_GRID, ("Iteration", "End"): str(OPTION_STEPS),
                    ("Iteration", "Restart"): "1000",
                    ("Iteration", "Statistics"): "1000"}))
            out = {}
            for name, more in (("fp32", ()), ("fp64", ("--x64",))):
                outdir = os.path.join(top, f"{tag}_{name}")
                link_initial_fields(base, outdir)
                out[name] = traced_cli(ini, outdir, ("dns",), *more)["run"]
            r32, r64 = out["fp32"], out["fp64"]
            require(r64.state.u.dtype == torch.float64
                    and r32.state.u.dtype == torch.float32, "7d: dtypes")
            rel = max(((a.double() - b).abs().max() / b.abs().max()).item()
                      for a, b in zip(r32.state[:3], r64.state[:3]))
            rel_s = ((r32.state.s.double() - r64.state.s).abs().max()
                     / r64.state.s.abs().max()).item()
            print(f"[options] 7d {tag} 128x64x64, {OPTION_STEPS} adaptive-dt "
                  f"steps: max|q32 - q64| / max|q64| over u, v, w = "
                  f"{rel:.3e}, scalar {rel_s:.3e} (limit {FP64_TOL}); "
                  f"t32 - t64 = {r32.rtime - r64.rtime:.3e}")
            require(max(rel, rel_s) <= FP64_TOL,
                    f"7d {tag}: fp32 vs fp64 {max(rel, rel_s)} > {FP64_TOL}")


def phase_direct_solver(card: str) -> None:
    """7e: the direct eigen Poisson and Helmholtz solves at full width,
    fp32 against fp64 on the same forcing, and their times beside the
    factorized solve's."""
    grid, P, _ = entry.build(*MAIN_SHAPE, torch.float32, "cuda", seed=0)
    ell64 = elliptic.device_elliptic_plan(
        elliptic.build_elliptic_plan(build_fdm_plan(grid)), torch.float64,
        "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    f64 = torch.randn(MAIN_SHAPE, generator=gen, device="cuda",
                      dtype=torch.float64)
    f64 -= f64.mean()
    f32 = f64.float()
    alpha = -24.0 / HELMHOLTZ_WIDTH ** 2          # as 7c's pressure filter
    calls = {
        "direct Poisson": (lambda: elliptic.poisson(P["ell"], f32),
                           lambda: elliptic.poisson(ell64, f64)),
        "Helmholtz": (
            lambda: elliptic.helmholtz(P["ell"], alpha * f32, alpha),
            lambda: elliptic.helmholtz(ell64, alpha * f64, alpha)),
    }
    parts = []
    for name, (fn32, fn64) in calls.items():
        a, b = fn32().double(), fn64()
        require(bool(torch.isfinite(a).all()), f"7e: non-finite {name}")
        rel = ((a - b).abs().max() / b.abs().max()).item()
        del a, b
        ms = statistics.median(event_ms(fn32) for _ in range(REPS))
        parts.append(f"{name} max|p32 - p64| / max|p64| = {rel:.3e}, "
                     f"{ms:.3f} ms")
    ms = statistics.median(
        event_ms(lambda: fac.poisson_factorize(P["ell_fac"], f32))
        for _ in range(REPS))
    print(f"[options] 7e {card}: {MAIN_SHAPE}, random forcing: "
          + "; ".join(parts) + f"; factorized Poisson {ms:.3f} ms "
          f"(fp32, median of {REPS})")
    del f32, f64, ell64
    red32 = smooth_projection(grid, P)
    print(f"[options] 7e: divergence of a smooth field after one substep of "
          f"the case's own plan (unstaggered, factorized) / before = "
          f"{red32:.3e} in fp32 (limit {SMOOTH_TOL_FP32})")
    require(red32 <= SMOOTH_TOL_FP32,
            f"7e: the factorized projection leaves {red32} in fp32")


def phase_variants(card: str, initial: str) -> None:
    """7f: what each option costs: `dns` of the case with one option at a
    time, full width, from 6a's fields."""
    for name in VARIANTS:
        text = option_case(name, {("Iteration", "End"): str(OPTION_STEPS),
                                  ("Iteration", "Restart"): "1000",
                                  ("Iteration", "Statistics"): "1000"})
        with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as out:
            ini = os.path.join(out, "tlab.ini")
            with open(ini, "w") as fh:
                fh.write(text)
            link_initial_fields(initial, out)
            res = traced_cli(ini, out, ("dns",))
            rows = data_rows(os.path.join(out, "dns.out"))
            trace = read_trace(os.path.join(out, "tlab.trace"))
        rate = step_rate(trace, OPTION_STEPS,
                         len(res["run"].sim.P["rk"]["kdt"]))
        dil = [max(abs(float(r[7])), abs(float(r[8]))) for r in rows]
        print(f"[options] 7f {name} ({card}): {rate['ms_substep']:.3f} "
              f"ms/substep (after the first step "
              f"{rate['others_ms_substep']:.3f}); launches "
              f"{res['launches']}; peak device memory {res['peak']} B; "
              f"dilatation max " + " ".join(f"{d:.3e}" for d in dil))


CLOUDTOP = pathlib.Path(__file__).resolve().parent / "examples" \
    / "cloudtop_anelastic" / "tlab.ini"
# the y-shape of the example's VelocityDiscrete perturbation, which its file
# lacks: without it the fields start at rest and stay horizontally uniform
PERTURBATION_SHAPE = ["ProfileIniK=Gaussian", "ThickIniK=0.02",
                      "YMeanRelativeIniK=0.75"]
CLOUD_SHAPE = (256, 192, 128)
MOIST_STEPS = {"8a": 10, "8b": 5, "8c": 5}
# phase 8's cases: (what, case file, changes to keys it has, keys added)
MOIST_CASES = {
    "8a": ("cloudtop: Boussinesq set, moist thermodynamics", CLOUDTOP, {},
           {}),
    "8b": ("cloudtop: anelastic set, gray radiation, sedimentation",
           CLOUDTOP, {("Main", "Equations"): "anelastic"},
           {"IniFields": PERTURBATION_SHAPE,
            "Parameters": ["Settling=0.05"],
            "Infrared": ["Type=gray", "Scalar=1",
                         "BoundaryConditions=0.2, 1.0",
                         "AbsorptionComponent1=5.0",
                         "AbsorptionComponent2=0.1",
                         "AbsorptionComponent3=0.01", "Beta=0.1"],
            "Sedimentation": ["Type=airwater"]}),
    "8c": ("shear layer: wavemaker, chemistry", CASE, {},
           {"SpecialForcing": ["Type=wavemaker", "Parameters=0.5",
                               "Wave1=0.01, 4.0, 30.0, 2.0",
                               "Envelope=3.14159, 0.5, 1.5708, 0.2"],
            "Chemistry": ["Type=quadratic", "Parameters=1.0"]}),
}
CLOUD_SMALL = {("Grid", "Imax"): "128", ("Grid", "Jmax"): "96",
               ("Grid", "Kmax"): "64", ("IniGridOx", "points_1"): "129",
               ("IniGridOy", "points_1"): "96",
               ("IniGridOz", "points_1"): "65"}
# the Newton's last relative step: the saturation adjustment runs in fp64
# whatever the run's dtype, and converges to fp64 round-off (1.9e-12 to
# 4.0e-12 in a CPU fp64 run of a 32x24x16 copy of the case); an fp32
# evaluation of its polynomial reads 2e-3 (tlab_tpu's and the port's alike)
NEWTON_TOL = 1e-10
# the fp32 hook against its fp64 evaluation on the same state, per row of
# max|h32 - h64| / max|h64|: b is the difference of two O(1) densities, and
# the fp32 run's background (rho, p, T, ep cast once to fp32) carries 6e-8
# of them whatever max|b| is: 1.5e-4 and 1.3e-4 of max|b| on the v row of
# 8a and 8b on the card, where the state is near its background, 3.5e-6 on
# the h and qt rows; a wrong sign or a float32 saturation adjustment reads
# O(1).  The witness: the fp64 hook on that fp32-rounded background agrees
# with the fp32 hook to HOOK_ROUNDED_TOL; what is left is the fp32 rounding
# of the result (7.8e-8 and 9.2e-8 on the v row on the card) and the fp32
# work of the radiation and the sedimentation (3.9e-6 and 3.0e-6 on 8b's h
# and qt rows, whether the background is rounded or not)
HOOK_TOL = 1e-3
HOOK_ROUNDED_TOL = 1e-5
# the background's own buoyancy: a difference of two O(1) numbers through
# the saturation adjustment, whose last Newton step is ~4e-12 of T (4.5e-13
# in a CPU run at 32x24x16; a flipped sign of the potential energy ep reads
# ~5e-5); and its velocity after one RK step of dt = 1e-4 (the diffusing
# erf profiles move it by dt^2: 2.9e-10 in a CPU run at 64x96x32)
BACKGROUND_B_TOL = 1e-10
BACKGROUND_DT, BACKGROUND_V_TOL = 1e-4, 1e-8
# 8d's velocity on the cloudtop cases: it is the 1e-3 perturbation and a
# horizontally uniform v (the projection's singular mode), so the fp32
# round-off of a forcing of ~1e-2 (the buoyancy, balanced by the pressure)
# is large beside it.  That drift is the scheme's: tlab_tpu in fp32, its
# thermodynamics in fp64 as the port's, reads the same
# (tests/test_torch_fp32.py, 32x96x16, 5 steps of the start's adaptive dt:
# 5.5e-4 and 8.7e-4 against the port's 7.1e-4 and 7.6e-4, scalars 5.0e-7
# in both).  On the card at 128x96x64 the port read 8.1e-4 and 8.3e-4 on
# the fluctuations about the plane means; the scalars are held to FP64_TOL;
# a wrong sign in the buoyancy reads O(1)
CLOUD_FP64_TOL = 3e-3
STRAT_COLUMNS = ("rR", "rT", "rRref", "rTref", "BuoyFreq_fr",
                 "LapseRate_eq", "PotTemp", "SaturationPressure", "rPref",
                 "RelativeHumidity", "Dewpoint")


def moist_case(tag: str, changes: dict) -> str:
    """Phase 8's case `tag` with `changes` to keys its file has."""
    _, path, edits, added = MOIST_CASES[tag]
    text = edit_case(path.read_text(), {**changes, **edits})
    for section, lines in added.items():
        text = add_keys(text, section, lines)
    return text


def hook_rows(P, state):
    """The source hook's tendency of `state` on zero tendencies, (3+ns, nx,
    ny, nz)."""
    H = torch.zeros((3 + state.s.shape[0],) + tuple(state.u.shape),
                    dtype=state.u.dtype, device=state.u.device)
    rows = (H[0], H[1], H[2], H[3:])
    for row, new in zip(rows, P["bodyforce"](P, state, *rows)):
        if new is not row:
            row.copy_(new)
    return H


def hook_against_fp64(tag, text, run) -> list:
    """max|h32 - h64| / max|h64| of each row of the run's fp32 hook against
    the fp64 hook of the same case on the same state (the rows the hook
    leaves zero read 0)."""
    sim64 = Simulation.from_case(load_case(Ini(text=text)),
                                 dtype=torch.float64, device="cuda")
    st64 = State(*(a.double() for a in run.state[:4]))
    h32 = hook_rows(run.sim.P, run.state).double()
    h64 = hook_rows(sim64.P, st64)
    # the witness: the fp64 hook on the fp32 run's background
    for t in sim64.anelastic["bg"].values():
        t.copy_(t.float().double())
    h64r = hook_rows(sim64.P, st64)

    def errs(ref):
        return [(a - b).abs().max().item() / b.abs().max().item()
                if b.abs().max().item() > 0 else a.abs().max().item()
                for a, b in zip(h32, ref)]

    out, rounded = errs(h64), errs(h64r)
    scales = [b.abs().max().item() for b in h64]
    del sim64, st64, h32, h64, h64r
    print(f"[moist] {tag}: fp32 hook against its fp64 evaluation, rows "
          f"u v w s..: max|h32 - h64| / max|h64| "
          + " ".join(f"{e:.3e}" for e in out) + f" (limit {HOOK_TOL}); on "
          f"the fp32 run's background " + " ".join(f"{e:.3e}" for e in
                                                    rounded)
          + f" (limit {HOOK_ROUNDED_TOL}); max|h64| "
          + " ".join(f"{m:.3e}" for m in scales))
    require(max(out) <= HOOK_TOL, f"{tag}: fp32 hook {out} > {HOOK_TOL}")
    require(max(rounded) <= HOOK_ROUNDED_TOL,
            f"{tag}: fp32 hook on its own background {rounded} > "
            f"{HOOK_ROUNDED_TOL}")
    return out


def background_checks(text) -> None:
    """8b in fp64 on the card: the background's own buoyancy, a state
    equal to its background after one RK step, and the rho-weighted
    projection of a smooth field (div(rho u) after one substep over
    before, off the wall rows, beside div u)."""
    sim = Simulation.from_case(load_case(Ini(text=text)),
                               dtype=torch.float64, device="cuda")
    P = sim.P
    nx, ny, nz = sim.grid.shape
    kw = {"dtype": torch.float64, "device": "cuda"}
    y = sim.grid.y.nodes
    s = torch.stack([torch.as_tensor(p(y), **kw)[None, :, None]
                     .expand(nx, ny, nz) for p in sim.case.scal_profiles])
    zero = torch.zeros((nx, ny, nz), **kw)
    rest = State(u=zero, v=zero, w=zero, s=s)
    ane = sim.anelastic
    b = thermo.buoyancy_explicit(ane["tp"], s, ane["bg"]).abs().max().item()
    state, _ = dyn.rk_step(P, rest, BACKGROUND_DT)
    vmax = state.v.abs().max().item()
    del state
    rho = P["anelastic"]["rho"][None, :, None]
    x = torch.as_tensor(sim.grid.x.nodes, **kw)[:, None, None]
    yy = torch.as_tensor(y, **kw)[None, :, None]
    zz = torch.as_tensor(sim.grid.z.nodes, **kw)[None, None, :]
    kx, kz = 2 * np.pi / sim.grid.x.scale, 2 * np.pi / sim.grid.z.scale
    ly = float(y[-1])
    env = torch.sin(np.pi * yy / ly)
    Q = torch.cat([torch.stack([
        (torch.sin(kx * x) + 0.3 * torch.cos(2 * kx * x + kz * zz)) * env,
        0.2 * torch.sin(2 * np.pi * yy / ly) * torch.cos(kx * x) + zero,
        0.4 * torch.sin(kz * zz) * torch.cos(kx * x) * env]), s])

    def divs(Q):
        return (dyn.divergence(P, Q[0] * rho, Q[1] * rho, Q[2] * rho),
                dyn.divergence(P, Q[0], Q[1], Q[2]))

    before = divs(Q)[0][:, 1:-1].abs().max()
    dte = 0.01
    H, _ = dyn.substep_rhs_stacked(P, Q, torch.zeros_like(Q), dte)
    red_r, red_u = (d[:, 1:-1].abs().max().item() / before.item()
                    for d in divs(Q + dte * H))
    del sim, P, Q, H
    print(f"[moist] 8b fp64: max|b| of the background {b:.3e} (limit "
          f"{BACKGROUND_B_TOL}); max|v| of a state at rest on its "
          f"background after one RK step of dt = {BACKGROUND_DT} {vmax:.3e} "
          f"(limit {BACKGROUND_V_TOL}); smooth field after one substep / "
          f"before: div(rho u) {red_r:.3e} (limit {SMOOTH_TOL}), div u "
          f"{red_u:.3e}")
    require(b <= BACKGROUND_B_TOL, f"8b: the background's buoyancy {b}")
    require(vmax <= BACKGROUND_V_TOL, f"8b: the background moves, {vmax}")
    require(red_r <= SMOOTH_TOL,
            f"8b: the anelastic projection leaves {red_r} of div(rho u)")


def check_case_kernels(text: str, nu_zero: bool = False,
                       fields: int = 0, zero_conv: bool = False) -> list:
    """K1-K3 against their plain version at the shapes a case's `dns` gives
    them: the case's own operators and field count, seeded inputs (with
    `nu_zero`, nu = 0 for every field: the semi-implicit step's advective
    Burgers term; with `fields`, that many fields of viscosity nu: the
    diagnostic pressure's velocity stack; with `zero_conv`, a zero
    convecting velocity: its diffusion-only pass); the max|kernel - plain|
    of each, None for a direction with a banded plan (its kernel does not
    launch there)."""
    sim = Simulation.from_case(load_case(Ini(text=text)),
                               dtype=torch.float32, device="cuda")
    P, shape = sim.P, tuple(sim.grid.shape)
    gen = torch.Generator(device="cuda").manual_seed(1)
    nu = torch.tensor((P["visc"],) * 3 + P["diff"], dtype=torch.float32,
                      device="cuda")
    if fields:
        nu = torch.full((fields,), P["visc"], dtype=torch.float32,
                        device="cuda")
    if nu_zero:
        nu = torch.zeros_like(nu)
    x = torch.randn((len(nu),) + shape, generator=gen, device="cuda")
    conv = torch.randn(shape, generator=gen, device="cuda")
    if zero_conv:
        conv = torch.zeros_like(conv)
    out = []
    for axis in range(3):
        if f"d1{'xyz'[axis]}_banded" in P:
            out.append(None)
            continue
        r = check_kernel(axis, P["d12" + "xyz"[axis]], x, conv, nu, False)
        how = (", nu = 0" if nu_zero else "") + \
            (", conv = 0" if zero_conv else "")
        print(f"[kernels] {burgers.ENTRY_POINTS[axis]} F={len(nu)} {shape} "
              f"(the case's operators{how}): "
              f"max|err| {r['max_abs_err']:.3e} "
              f"(rel {r['rel_err']:.3e}, limit {KERNEL_TOL})")
        out.append(r["max_abs_err"])
    del sim, P, x, conv
    return out


def phase_moist(tag: str, card: str, initial: str) -> list:
    """8a-8c: `dns` of one moist or forced case at full width through the
    CLI; the cloudtop cases from their own `ini`, 8c from phase 6a's initial
    fields in `initial`."""
    what, path = MOIST_CASES[tag][:2]
    steps = MOIST_STEPS[tag]
    shape = CLOUD_SHAPE if path == CLOUDTOP else MAIN_SHAPE
    text = moist_case(tag, {("Iteration", "End"): str(steps),
                            ("Iteration", "Restart"): "1000",
                            ("Iteration", "Statistics"): str(steps)})
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as out:
        ini = os.path.join(out, "tlab.ini")
        with open(ini, "w") as fh:
            fh.write(text)
        if path == CLOUDTOP:
            res = traced_cli(ini, out, ("inigrid", "ini", "dns"))
        else:
            link_initial_fields(initial, out)
            # a dns window of 5 steps, which the time-dependent forcing
            # must cut to one RK step
            res = traced_cli(ini, out, ("dns",), "--inner-steps", str(steps))
        run, launches = res["run"], res["launches"]
        rows = data_rows(os.path.join(out, "dns.out"))
        trace = read_trace(os.path.join(out, "tlab.trace"))
        _, _, flow = averages.read_avg(os.path.join(out, f"avg{steps}"))
    P = run.sim.P
    n_sub = len(P["rk"]["kdt"])
    rate = step_rate(trace, steps, n_sub)
    points = shape[0] * shape[1] * shape[2]
    ms_sub = rate["ms_substep"]
    cfl = [float(r[4]) for r in rows[1:]]
    dil = [max(abs(float(r[7])), abs(float(r[8]))) for r in rows]
    ini_s = res["seconds"].get("ini")
    print(f"[moist] {tag} {what} ({card}): {shape} fp32, {steps} adaptive-dt "
          f"steps with their host syncs {rate['seconds']:.4f} s: "
          f"{ms_sub:.3f} ms/substep, "
          f"{points * steps * n_sub / rate['seconds']:.6e} points/s/substep "
          f"(first step {rate['each'][0]:.4f} s, the others' median "
          f"{rate['others_ms_substep']:.3f} ms/substep); peak device memory "
          f"{res['peak']} B; launches {launches}"
          + (f"; ini {ini_s:.3f} s" if ini_s is not None else ""))
    print(f"[moist] {tag}: CFL {min(cfl):.3f}..{max(cfl):.3f}; dilatation "
          f"max {dil[0]:.4e} at the start, {dil[1]:.4e} -> {dil[-1]:.4e}; "
          f"t = {run.rtime:.6e}; statistics "
          f"{trace[f'statistics {steps}'][1]:.3f} s")
    require(len(rows) == steps + 1 and all(r[0] == "0" for r in rows),
            f"{tag} dns.out: {len(rows)} rows, status {[r[0] for r in rows]}")
    for name, a in zip("uvws", state_to_numpy(run.state)):
        require(np.isfinite(a).all(), f"{tag}: non-finite {name}")
    require(tuple(run.state.u.shape) == shape, f"{tag}: state shape")
    require(all(np.isfinite(v).all() for v in flow.values()),
            f"{tag}: non-finite avg column")
    expect = [steps * n_sub] * 3 if tag in ("8a", "8c") else [0, 0, 0]
    require(launches == expect, f"{tag} launched {launches}, expected "
                                f"{expect}")
    if tag in ("8a", "8b"):
        newton = [float(r[9]) for r in rows]
        print(f"[moist] {tag}: NewtonRs {min(newton):.3e}..{max(newton):.3e}"
              f" (limit {NEWTON_TOL})")
        require(max(newton) <= NEWTON_TOL, f"{tag}: NewtonRs {newton}")
        ane = run.sim.anelastic
        T, ql = thermo.equilibrium_state(ane["tp"], run.state.s, ane["bg"])
        qt = run.state.s[1]
        lo, hi = ql.min().item(), (ql - qt).max().item()
        print(f"[moist] {tag}: final state min ql {lo:.3e}, max(ql - qt) "
              f"{hi:.3e}, max ql {ql.max().item():.4e}, T "
              f"{T.min().item():.5f}..{T.max().item():.5f}")
        require(lo >= 0.0 and hi <= 0.0, f"{tag}: ql outside [0, qt]")
        require(ql.max().item() > 0.0, f"{tag}: no liquid in the cloud")
        hook_against_fp64(tag, text, run)
        # the thermodynamics' part of a substep: the explicit buoyancy, one
        # saturation adjustment in fp64
        ms = statistics.median(event_ms(lambda: thermo.buoyancy_explicit(
            ane["tp"], run.state.s, ane["bg"])) for _ in range(REPS))
        print(f"[moist] {tag}: buoyancy_explicit (saturation adjustment in "
              f"fp64) {ms:.3f} ms a call, {ms:.3f} ms/substep in 8a's hook "
              f"(median of {REPS})")
    if tag == "8b":
        for n in STRAT_COLUMNS:
            require(np.abs(flow[n]).max() > 0.0, f"8b: avg column {n} is 0")
        print("[moist] 8b: avg " + ", ".join(
            f"max|{n}| {np.abs(flow[n]).max():.4e}" for n in STRAT_COLUMNS))
        rad = P["bodyforce"].rad_props
        T, ql = thermo.equilibrium_state(ane["tp"], run.state.s, ane["bg"])
        rho = ane["rho"][None, :, None]
        a = (rad.kappa * ql + rad.kappa_v * (run.state.s[-1] - ql)
             + rad.kappa_g) * rho
        b = rad.beta * radiation.SIGMA * T ** 4
        ms = statistics.median(event_ms(lambda: radiation.infrared_gray_source(
            rad, run.sim.grid.y.nodes, a, b, emissivity=rad.emissivity))
            for _ in range(REPS))
        print(f"[moist] 8b: the gray radiation's two y-loops "
              f"({2 * (shape[1] - 1)} plane steps) {ms:.3f} ms a call = "
              f"ms/substep (median of {REPS})")
        st = run.state
        div_u = dyn.divergence(P, st.u, st.v, st.w).abs().max().item()
        print(f"[moist] 8b: the logged dilatation div(rho u) {dil[-1]:.4e} "
              f"at the last step; div u of the same state {div_u:.4e}")
        del a, b, T, ql
        background_checks(text)
    if tag == "8c":
        bf = P["bodyforce"]
        require(bf.time_dependent, "8c: the hook is not time dependent")
        h0 = hook_rows(P, run.state)
        P1 = dict(P, bodyforce=lambda *a, **k: bf(*a, aux={"rtime": 0.3}))
        h1 = hook_rows(P1, run.state)
        moved = (h1 - h0)[:2].abs().max().item()
        print(f"[moist] 8c: max|hook| u {h0[0].abs().max().item():.3e}, v "
              f"{h0[1].abs().max().item():.3e}, s "
              f"{h0[3].abs().max().item():.3e}; the wavemaker at t = 0.3 "
              f"against t = 0 moves it by {moved:.3e}; dns.out rows "
              f"{[int(r[1]) for r in rows]} (a window of {steps} asked)")
        require(min(h0[i].abs().max().item() for i in (0, 1, 3)) > 0.0,
                "8c: the wavemaker or the chemistry adds nothing")
        require(moved > 0.0, "8c: the wavemaker's phase does not move")
    return launches


def phase_moist_fp64() -> None:
    """8d: each of 8a-8c at a reduced grid through the CLI, fp32 against
    fp64 from the same initial fields."""
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as top:
        for tag in MOIST_CASES:
            small = CLOUD_SMALL if MOIST_CASES[tag][1] == CLOUDTOP \
                else SMALL_GRID
            steps = OPTION_STEPS
            ini = os.path.join(top, tag + ".ini")
            text = moist_case(tag, {
                **small, ("Iteration", "End"): str(steps),
                ("Iteration", "Restart"): "1000",
                ("Iteration", "Statistics"): "1000"})
            if tag == "8a":
                text = add_keys(text, "IniFields", PERTURBATION_SHAPE)
            with open(ini, "w") as fh:
                fh.write(text)
            base = os.path.join(top, tag + "_ini")
            run_cli("ini", ini, base, "--x64")
            out = {}
            for name, more in (("fp32", ()), ("fp64", ("--x64",))):
                outdir = os.path.join(top, f"{tag}_{name}")
                os.makedirs(outdir)
                for f in os.listdir(base):
                    if f.startswith(("flow.0.", "scal.0.")):
                        os.symlink(os.path.join(base, f),
                                   os.path.join(outdir, f))
                out[name] = traced_cli(ini, outdir, ("dns",), *more)["run"]
            r32, r64 = out["fp32"], out["fp64"]
            # the velocity as one vector, and split into its plane means
            # and the fluctuations about them: the cloudtop's horizontally
            # uniform buoyancy grows a uniform v that the projection's
            # singular mode leaves (a difference of O(1) numbers, tlab_tpu's
            # as well)
            vel32 = torch.stack(r32.state[:3]).double()
            vel64 = torch.stack(r64.state[:3])
            scale = vel64.abs().max()
            rel = ((vel32 - vel64).abs().max() / scale).item()
            mean32 = vel32.mean(dim=(1, 3), keepdim=True)
            mean64 = vel64.mean(dim=(1, 3), keepdim=True)
            rel_f = ((vel32 - mean32 - vel64 + mean64).abs().max()
                     / (vel64 - mean64).abs().max()).item()
            rel_m = ((mean32 - mean64).abs().max() / scale).item()
            rel_s = ((r32.state.s.double() - r64.state.s).abs().max()
                     / r64.state.s.abs().max()).item()
            tol = FP64_TOL if small is SMALL_GRID else CLOUD_FP64_TOL
            print(f"[moist] 8d {tag} {tuple(r64.sim.grid.shape)}, {steps} "
                  f"adaptive-dt steps: max|q32 - q64| / max|q64| over u, v, "
                  f"w = {rel:.3e} (limit {tol}; max|u64| {scale:.3e}), "
                  f"scalars {rel_s:.3e} (limit {FP64_TOL}); the velocity "
                  f"less its plane means {rel_f:.3e}, the plane means "
                  f"{rel_m:.3e} of max|u64| (max "
                  f"{mean64.abs().max().item():.3e}); "
                  f"t32 - t64 = {r32.rtime - r64.rtime:.3e}")
            require(rel <= tol, f"8d {tag}: fp32 vs fp64 velocity {rel} > "
                                f"{tol}")
            require(rel_s <= FP64_TOL, f"8d {tag}: fp32 vs fp64 scalars "
                                       f"{rel_s} > {FP64_TOL}")


# ---------------------------------------------------------------------------
# Phase 9: the boundary machinery
# ---------------------------------------------------------------------------

ROOT = pathlib.Path(__file__).resolve().parent
CASE93 = ROOT / "tests" / "data" / "case93_small3d.ini"
EKMAN = ROOT / "examples" / "ekman_mesh" / "tlab.ini"
IBM_STEPS, EKMAN_STEPS, JET_STEPS = 5, 10, 5
EKMAN_SHAPE = (128, 96, 128)
JET_SHAPE = (512, 256, 128)
BOUNDARY_SMALL = {"9a": (128, 64, 64), "9b": (64, 48, 64),
                  "9c": (128, 64, 64)}
# the spline fill on the card (fp32 weights; the same gather and order of
# terms) against the same fill on the CPU in fp64, at each solid point over
# the sum of its terms' sizes, sum_m |w_m u_m|: the fp32 rounding of 4
# weights, 4 products and 4 sums, <= ~6e-7.  Over max|field| the same
# error reads 2.5e-6 at 512x256x256 (NVIDIA H100 80GB HBM3, 700 W): the
# cubic through two fluid points on each side of a 64-point bar has weights
# whose sum of sizes reaches 33, so the sum cancels terms far larger than
# its result; a wrong index or weight reads O(1)
FILL_TOL = 1e-6
# the interactive surface moves the wall scalar by the flux ANOMALY only, so
# its plane mean stays but for the fp32 rounding of the plane means (a
# coupling of the whole flux moves it by dte * cpl * <flux> a substep)
SFC_MEAN_TOL = 1e-5
# 9c: the inflow's v (0.03 g(y) at the sweep's peak) imprinted on the Imin
# strip after 5 steps, and the jet core at mid-x against its inflow value
INFLOW_V_MIN = 1e-4
JET_CORE_MIN = 0.5
# the sweep starts a quarter of the box's length in (lx / 4 Uc), where the
# inflow plane's v = 0.03 g(y) sin(2 pi Uc t / lx) is at its peak
JET_T0 = 0.5
# tests/test_cases.py's SPATIAL_JET (2-D, 64x48) as a 3-D case, its keys
# kept, z periodic, the strips at its fractions of x (8 and 12 of 65
# points), relaxation strips and the filter sponge (Type=both), a log line
# every step
JET_CASE = """[Main]
Type=spatial
Equations=incompressible
SpaceOrder=CompactJacobian6
TimeOrder=RungeKuttaExplicit3
TimeCFL=0.7
[Control]
ScalLimit=no
[Parameters]
Reynolds=500
Schmidt=1.0
[Iteration]
Start=0
End={steps}
Restart={steps}
Statistics={steps}
IteraLog=1
[Flow]
ProfileVelocityX=Bickley
ThickVelocityX=0.08
DeltaVelocityX=1.0
VelocityX=0.05
[Scalar]
ProfileScalar1=Gaussian
ThickScalar1=0.08
DeltaScalar1=1.0
[BoundaryConditions]
VelocityJmin=freeslip
VelocityJmax=freeslip
Scalar1Jmin=neumann
Scalar1Jmax=neumann
[BufferZone]
Type=both
PointsImin={imin}
PointsImax={imax}
ParametersJmin=2.0,2.0
[IniGridOx]
periodic=yes
segments=1
points_1={nx1}
scales_1=4.0
opts_1=uniform
[IniGridOy]
periodic=no
segments=1
points_1={ny}
scales_1=2.0
opts_1=uniform
[IniGridOz]
periodic=yes
segments=1
points_1={nz1}
scales_1=2.0
opts_1=uniform
"""


def grid_keys(shape) -> dict:
    """[Grid] and [IniGrid*] keys of a case at `shape` (x and z periodic:
    one point more in their IniGrid segments)."""
    nx, ny, nz = shape
    return {("Grid", "Imax"): nx, ("Grid", "Jmax"): ny, ("Grid", "Kmax"): nz,
            ("IniGridOx", "points_1"): nx + 1,
            ("IniGridOy", "points_1"): ny, ("IniGridOz", "points_1"): nz + 1}


def ibm_case(shape, steps: int) -> str:
    """tests/data/case93_small3d.ini (channel over two mirrored bars,
    32x32x16) at `shape`, the bars scaled with the grid: Height 5 of 32
    points, Width 4 of 16."""
    return edit_case(CASE93.read_text(), {
        **grid_keys(shape),
        ("IBMGeometry", "Height"): shape[1] * 5 // 32,
        ("IBMGeometry", "Width"): shape[2] * 4 // 16,
        ("Iteration", "End"): steps, ("Iteration", "Restart"): 1000,
        ("Iteration", "Statistics"): steps})


def ekman_case(shape, steps: int) -> str:
    """examples/ekman_mesh/tlab.ini at `shape`, without its [Parallel] device
    mesh (ROADMAP A17: multi-GPU) and its [SaveTowers] (A15), with scalar 1
    on Dirichlet walls, a linear profile (0.75 at the bottom to 0.25 at the
    top) and an interactive bottom surface (SfcType=linear, coupling 0.5);
    its Jmax sponge as the example has it.  The scalar starts with broadband
    noise of rms 0.01 in a Gaussian layer of thickness 0.01 on the bottom
    wall: without it the wall flux has no anomaly to couple (the file's
    scalar starts without perturbation), and the surface's ~4e-9 a substep
    is below the wall value's fp32 spacing."""
    text = EKMAN.read_text()
    for section in ("Parallel", "SaveTowers"):
        text, n = re.subn(rf"^\[{section}\]\n[^\[]*", "", text, flags=re.M)
        require(n == 1, f"[{section}] not found in {EKMAN.name}")
    text = edit_case(text, {
        **grid_keys(shape), ("Iteration", "End"): steps,
        ("Iteration", "Restart"): 1000, ("Iteration", "Statistics"): steps,
        ("Scalar", "ProfileScalar1"): "Linear",
        ("Scalar", "MeanScalar1"): "0.5",
        ("BoundaryConditions", "Scalar1Jmin"): "dirichlet",
        ("BoundaryConditions", "Scalar1Jmax"): "dirichlet",
        ("IniFields", "Scalar"): "LayerBroadband"})
    text = add_keys(text, "Scalar", ["DeltaScalar1=0.5", "ThickScalar1=0.2"])
    text = add_keys(text, "IniFields", [
        "ProfileIniS=Gaussian", "ThickIniS=0.01", "YMeanRelativeIniS=0.0",
        "NormalizeS=0.01"])
    return add_keys(text, "BoundaryConditions",
                    ["Scalar1SfcTypeJmin=linear", "Scalar1CouplingJmin=0.5"])


def jet_case(shape, steps: int) -> str:
    nx, ny, nz = shape
    return JET_CASE.format(steps=steps, imin=int(nx * 8 / 65 + 0.5),
                           imax=int(nx * 12 / 65 + 0.5), nx1=nx + 1, ny=ny,
                           nz1=nz + 1)


def jet_start(sim, dtype):
    """The start of tests/test_cases.py's spatial jet: the co-flow + Bickley
    jet and the Gaussian scalar broadcast in x and z, v = w = 0."""
    y = sim.grid.y.nodes
    shape = sim.grid.shape

    def field(prof):
        return torch.as_tensor(prof).to("cuda", dtype)[None, :, None] \
            .expand(shape).contiguous()

    z = torch.zeros(shape, dtype=dtype, device="cuda")
    return State(u=field(sim.case.vel_profiles[0](y)), v=z, w=z.clone(),
                 s=field(sim.case.scal_profiles[0](y))[None])


def jet_box(sim, nbox=32, amp=0.03):
    """tests/test_cases.py:362-375's inflow box: the jet's u and scalar,
    v = amp g(y) sin(2 pi i / nbox) swept past the inlet at Uc = 1 over
    lx = 2."""
    ny = sim.grid.shape[1]
    y = sim.grid.y.nodes
    prof = sim.case.vel_profiles[0](y)
    g = np.exp(-((y - y[ny // 2]) / 0.2) ** 2)
    phases = np.sin(2 * np.pi * np.arange(nbox) / nbox)
    return inflow.InflowBox(fields={
        "u": np.broadcast_to(prof[None, :], (nbox, ny)).copy(),
        "v": amp * phases[:, None] * g[None, :],
        "w": np.zeros((nbox, ny)),
        "s0": np.broadcast_to(sim.case.scal_profiles[0](y)[None, :],
                              (nbox, ny)).copy()}, u_convect=1.0, lx=2.0)


class SolidWatch:
    """Within the block, each dns step also reads max|u|, |v|, |w|, |s| over
    the solid points of its plan's immersed boundary (amax of |q| eps, on
    the card; the host reads them after the run)."""

    def __enter__(self):
        self.real, self.maxima = dyn.rk_step, []

        def step(P, state, dtime, aux=None):
            state, p = self.real(P, state, dtime, aux=aux)
            eps = P["ibm"]["eps"]
            self.maxima.append(torch.stack(
                [torch.amax(a.abs() * eps) for a in state[:3]]
                + [torch.amax(state.s.abs() * eps)]))
            return state, p

        dyn.rk_step = step
        return self

    def __exit__(self, *exc):
        dyn.rk_step = self.real

    def read(self):
        return torch.stack(self.maxima).tolist()


def rate_line(tag: str, card: str, shape, steps: int, n_sub: int, trace,
              res, phase: str = "boundary") -> str:
    rate = step_rate(trace, steps, n_sub)
    points = shape[0] * shape[1] * shape[2]
    return (f"[{phase}] {tag} ({card}): {shape} fp32, {steps} adaptive-dt "
            f"steps with their host syncs {rate['seconds']:.4f} s: "
            f"{rate['ms_substep']:.3f} ms/substep, "
            f"{points * steps * n_sub / rate['seconds']:.6e} "
            f"points/s/substep (first step {rate['each'][0]:.4f} s, the "
            f"others' median {rate['others_ms_substep']:.3f} ms/substep); "
            f"peak device memory {res['peak']} B; launches {res['launches']}")


def dilatation_text(rows) -> str:
    dil = [max(abs(float(r[7])), abs(float(r[8]))) for r in rows]
    return (f"dilatation max {dil[0]:.4e} at the start, {dil[-1]:.4e} at "
            f"the last step")


def step_parts(tag: str, P, state, calls: dict, dt: float = 1e-4) -> None:
    """Where a phase's step goes, on its final state (CUDA events, median of
    REPS): one RK step with the plan as it is, and with each of `calls`'
    plan keys taken out (what that part costs), beside `calls`' other
    parts alone."""
    def step(key=None):
        plan = P if key is None else dict(P, **{key: None})
        return lambda: dyn.rk_step(plan, state, dt, aux=calls.get("aux"))

    timed = {"one RK step": step()}
    for key in calls.get("without", ()):
        timed[f"the step without {key}"] = step(key)
    timed.update(calls.get("parts", {}))
    ms = {name: statistics.median(event_ms(fn) for _ in range(REPS))
          for name, fn in timed.items()}
    n_sub = len(P["rk"]["kdt"])
    print(f"[boundary] {tag}: " + "; ".join(
        f"{name} {v:.3f} ms" for name, v in ms.items())
        + f" ({n_sub} substeps a step; median of {REPS})")


def phase_ibm(card: str) -> list:
    """9a: inigrid, ini and dns of the channel over mirrored bars at
    512x256x256 through the CLI; the solids after every step, the fill on
    the card against the CPU's in fp64, its tables' bytes and its time."""
    shape = MAIN_SHAPE
    text = ibm_case(shape, IBM_STEPS)
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as out:
        ini = os.path.join(out, "tlab.ini")
        with open(ini, "w") as fh:
            fh.write(text)
        with SolidWatch() as watch:
            res = traced_cli(ini, out, ("inigrid", "ini", "dns"))
        rows = data_rows(os.path.join(out, "dns.out"))
        trace = read_trace(os.path.join(out, "tlab.trace"))
        _, _, flow = averages.read_avg(os.path.join(out, f"avg{IBM_STEPS}"))
    run, launches = res["run"], res["launches"]
    P = run.sim.P
    n_sub = len(P["rk"]["kdt"])
    solid = watch.read()
    print(rate_line("9a channel over mirrored bars", card, shape, IBM_STEPS,
                    n_sub, trace, res))
    print(f"[boundary] 9a: ini {res['seconds']['ini']:.3f} s (random fields "
          f"on the host {trace['inirand_fields'][1]:.3f} s); the fills' "
          f"set-up (host tables + copy to the card) "
          f"{trace['immersed boundary fills'][1]:.3f} s in dns; "
          + dilatation_text(rows))
    require(len(rows) == IBM_STEPS + 1 and all(r[0] == "0" for r in rows),
            f"9a dns.out: {len(rows)} rows, status {[r[0] for r in rows]}")
    require(launches == [IBM_STEPS * n_sub] * 3,
            f"9a launched {launches}, expected {IBM_STEPS * n_sub} per axis")
    require(len(solid) == IBM_STEPS
            and all(m == 0.0 for step in solid for m in step),
            f"9a: max |u|, |v|, |w|, |s| in the solids after each step "
            f"{solid}, expected 0")
    for name, a in zip("uvws", run.state[:4]):
        require(bool(torch.isfinite(a).all()), f"9a: non-finite {name}")
    require(all(np.isfinite(v).all() for v in flow.values()),
            "9a: non-finite avg column")
    fills = P["ibm"]["fills"]
    nsolid = int((P["ibm"]["eps"] > 0.5).sum())
    print(f"[boundary] 9a: {nsolid} solid points of {np.prod(shape)}; "
          f"directions with weights: "
          f"{[n for n, f in fills.items() if 'src' in f]}, "
          f"the others zero tables (tlab_tpu's: its x lines are all solid in "
          f"the bars, its y tables are lost to a reshape, ROADMAP C); fill "
          f"tables {ibm.fill_bytes(fills)} B, mask and its complement "
          f"{2 * P['ibm']['eps'].numel() * P['ibm']['eps'].element_size()} B")
    # the fill on the card against the same tables' fill on the CPU in fp64
    eps = (P["ibm"]["eps"] > 0.5).cpu().numpy().astype(np.float64)
    t0 = time.perf_counter()
    tables = ibm.spline_tables(eps, run.sim.grid)
    host_s = time.perf_counter() - t0
    cpu64 = ibm.device_fills(tables, torch.float64, "cpu")
    Q = torch.cat([run.state.u[None], run.state.v[None], run.state.w[None],
                   run.state.s])
    Q64 = Q.double().cpu()
    errs, field_errs, wsum = [], [], 0.0
    for name, fill in fills.items():
        got = ibm.apply_spline_fill(Q, fill).double().cpu()
        want = ibm.apply_spline_fill(Q64, cpu64[name])
        diff = (got - want).reshape(len(Q), -1)
        field_errs.append((diff.abs().max() / want.abs().max()).item())
        f64 = cpu64[name]
        if "src" in f64:      # the size of each solid point's sum of terms
            terms = Q64.reshape(len(Q), -1).index_select(-1, f64["src"]) \
                .reshape(len(Q), 4, -1).abs() * f64["w"].abs()
            size = terms.sum(dim=1) + f64["const"].abs()
            errs.append((diff[:, f64["index"]].abs()
                         / size.clamp_min(1e-300)).max().item())
            wsum = f64["w"].abs().sum(dim=0).max().item()
            del terms, size
        else:                 # zero tables: the solids are set to 0
            errs.append(diff.abs().max().item())
        del got, want, diff
    del Q64, cpu64

    def fill_substep():
        # a substep's fills: the stack and the advecting velocity, each
        # direction (dycore/incompressible.py _burgers_all)
        for axis, (name, fill) in enumerate(fills.items()):
            ibm.apply_spline_fill(Q, fill)
            ibm.apply_spline_fill(Q[axis], fill)

    ms = statistics.median(event_ms(fill_substep) for _ in range(REPS))
    print(f"[boundary] 9a: the fill on the card against the CPU's in fp64, "
          f"max|. - fp64| over each solid point's sum_m |w_m u_m| "
          + ", ".join(f"{n} {e:.3e}" for n, e in zip(fills, errs))
          + f" (limit {FILL_TOL}; max sum_m |w_m| {wsum:.3f}), over "
          f"max|field| " + ", ".join(f"{n} {e:.3e}" for n, e in
                                     zip(fills, field_errs))
          + f"; the fills of a substep {ms:.3f} ms (median of {REPS}); "
          f"host tables {host_s:.3f} s")
    require(max(errs) <= FILL_TOL, f"9a: fill against fp64 {errs}")
    del Q
    step_parts("9a", P, run.state, {"without": ("ibm",)})
    return launches


def phase_ekman(card: str) -> list:
    """9b: ini and dns of the Ekman layer with its Jmax sponge and an
    interactive bottom surface at its own 128x96x128 through the CLI."""
    text = ekman_case(EKMAN_SHAPE, EKMAN_STEPS)
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as out:
        ini = os.path.join(out, "tlab.ini")
        with open(ini, "w") as fh:
            fh.write(text)
        res = traced_cli(ini, out, ("inigrid", "ini", "dns"))
        rows = data_rows(os.path.join(out, "dns.out"))
        trace = read_trace(os.path.join(out, "tlab.trace"))
        obs = data_rows(os.path.join(out, "dns.obs"))
        wall0 = fields_io.read_field(os.path.join(out, "scal.0.1"))[0][:, 0, :]
    run, launches = res["run"], res["launches"]
    P = run.sim.P
    n_sub = len(P["rk"]["kdt"])
    print(rate_line("9b Ekman layer, Jmax sponge, interactive surface", card,
                    EKMAN_SHAPE, EKMAN_STEPS, n_sub, trace, res))
    tau = P["buffer"]["tau"].ravel().cpu().numpy()
    points = run.sim.case.buffer.points_jmax
    wall = run.state.s[0, :, 0, :].double().cpu().numpy()
    moved = np.abs(wall - wall0).max()
    mean_shift = abs(wall.mean() - wall0.mean())
    print(f"[boundary] 9b: ini {res['seconds']['ini']:.3f} s; attach_buffer "
          f"{trace['attach_buffer'][1]:.4f} s; tau 0 below the top "
          f"{points} points, {tau[-1]:.3f} at the wall; the bottom wall "
          f"scalar moved by up to {moved:.3e}, its plane mean by "
          f"{mean_shift:.3e} (limit {SFC_MEAN_TOL} of "
          f"{np.abs(wall0).max():.3f}); max|sfc| "
          f"{run.state.sfc.abs().max().item():.3e}; dns.obs {len(obs)} rows; "
          + dilatation_text(rows))
    require(len(rows) == EKMAN_STEPS + 1 and all(r[0] == "0" for r in rows),
            f"9b dns.out: {len(rows)} rows, status {[r[0] for r in rows]}")
    require(launches == [EKMAN_STEPS * n_sub] * 3,
            f"9b launched {launches}, expected {EKMAN_STEPS * n_sub} per axis")
    require(tau[:-points].max() == 0.0 and tau[-1] > 0.0,
            "9b: the buffer's tau outside its strip")
    require(mean_shift <= SFC_MEAN_TOL * np.abs(wall0).max(),
            f"9b: the wall scalar's plane mean moved by {mean_shift}")
    require(moved > 0.0, "9b: the interactive surface moves nothing")
    require(len(obs) == EKMAN_STEPS, f"9b: dns.obs has {len(obs)} rows")
    for name, a in zip("uvws", run.state[:4]):
        require(bool(torch.isfinite(a).all()), f"9b: non-finite {name}")
    step_parts("9b", P, run.state, {"without": ("buffer", "surface_bc")})
    return launches


def run_jet(shape, dtype, outdir: str, steps: int):
    """dns.run of the 3-D spatial jet from its start with the inflow box;
    returns (run, the kernels' counts over it, peak device memory)."""
    sim = Simulation.from_case(load_case(Ini(text=jet_case(shape, steps))),
                               dtype=dtype, device="cuda")
    state = jet_start(sim, dtype)
    box = jet_box(sim)
    torch.cuda.reset_peak_memory_stats()
    burgers.reset_launches()
    run = dns_tool.run(sim, state, outdir=outdir, rtime=JET_T0,
                       n_steps=steps, inflow=box,
                       log_path=os.path.join(outdir, "dns.out"))
    torch.cuda.synchronize()
    return (run, list(burgers.contract_launches["highest"]),
            torch.cuda.max_memory_allocated())


def phase_jet(card: str) -> list:
    """9c: the spatial jet at 512x256x128 with the inflow box through
    dns_tool.run: the strips, the sponge, the station statistics."""
    os.environ["TLAB_TPU_TRACE"] = "1"
    try:
        with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as out:
            run, launches, peak = run_jet(JET_SHAPE, torch.float32, out,
                                          JET_STEPS)
            ttrace.close()
            rows = data_rows(os.path.join(out, "dns.out"))
            trace = read_trace(os.path.join(out, "tlab.trace"))
            st = spatial.SpatialStats.load(
                os.path.join(out, f"st{JET_STEPS}.npz"))
            with open(os.path.join(out, f"avg_zt{JET_STEPS}")) as fh:
                zt = [ln.split() for ln in fh.read().splitlines()[3:]]
    finally:
        del os.environ["TLAB_TPU_TRACE"]
        ttrace.close()
    sim = run.sim
    nx, ny, _ = JET_SHAPE
    n_sub = len(sim.P["rk"]["kdt"])
    print(rate_line("9c spatial jet, inflow box, Type=both", card, JET_SHAPE,
                    JET_STEPS, n_sub, trace,
                    {"peak": peak, "launches": launches}))
    prof = sim.case.vel_profiles[0](sim.grid.y.nodes)
    jc = ny // 2
    core = run.state.u[nx // 2, jc].mean().item()
    v_in = run.state.v[:sim.case.buffer.points_imin].abs().max().item()
    amp = sim.filter_sponge[0].ravel().cpu().numpy()
    zt_vals = np.array([[float(x) for x in r] for r in zt])
    print(f"[boundary] 9c: max|v| in the Imin strip {v_in:.3e} (limit "
          f"{INFLOW_V_MIN}); the jet core at mid-x {core:.4f} against "
          f"{prof[jc]:.4f} at the inflow (limit {JET_CORE_MIN} of it); the "
          f"sponge's amp {amp[nx // 2]:.3f} mid-domain, {amp[-1]:.4f} at the "
          f"outflow; st{JET_STEPS}.npz n_samples {st.n_samples}; "
          f"avg_zt{JET_STEPS} {zt_vals.shape[0]} rows x "
          f"{zt_vals.shape[1]} columns; attach_buffer "
          f"{trace['attach_buffer'][1]:.4f} s; t = {run.rtime:.6e}; "
          + dilatation_text(rows))
    require(len(rows) == JET_STEPS + 1 and all(r[0] == "0" for r in rows),
            f"9c dns.out: {len(rows)} rows, status {[r[0] for r in rows]}")
    require(launches == [JET_STEPS * n_sub] * 3,
            f"9c launched {launches}, expected {JET_STEPS * n_sub} per axis")
    require(v_in > INFLOW_V_MIN, f"9c: max|v| in the Imin strip {v_in}")
    require(core > JET_CORE_MIN * prof[jc], f"9c: jet core {core}")
    require(amp[nx // 2] == 0.0 and amp[-1] > 0.9, "9c: the sponge's amp")
    require(st.n_samples == JET_STEPS,
            f"9c: st{JET_STEPS}.npz holds {st.n_samples} samples")
    require(zt_vals.size > 0 and np.isfinite(zt_vals).all(),
            f"9c: avg_zt{JET_STEPS} empty or not finite")
    for name, a in zip("uvws", run.state[:4]):
        require(bool(torch.isfinite(a).all()), f"9c: non-finite {name}")
    st = run.state
    box = jet_box(sim)
    aux = {"refs_x": box.refs_at(run.rtime, st.u.dtype, ny, "cuda")}
    stats = spatial.SpatialStats.create(nx, ny,
                                        list(spatial.state_fields(st)))
    step_parts("9c", sim.P, st, {
        "aux": aux, "without": ("buffer",),
        "parts": {
            "the filter sponge": lambda: buffer.apply_filter_sponge(
                *sim.filter_sponge, st),
            "the spatial sums (9 gradients, the reduction, its copy)":
                lambda: stats.accumulate_device(
                    spatial.state_fields(st),
                    grads=dns_tool.velocity_gradients(sim.P, st), p=st.u),
            "the inflow planes (host, copy)": lambda: box.refs_at(
                run.rtime, st.u.dtype, ny, "cuda")}})
    return launches


def phase_boundary_fp64() -> None:
    """9d: each of 9a-9c at a reduced grid, 5 steps, fp32 against fp64 from
    the same start (9a, 9b through the CLI from one fp64 ini)."""
    steps = OPTION_STEPS
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as top:
        for tag, shape in BOUNDARY_SMALL.items():
            t0 = time.perf_counter()
            out = {}
            if tag == "9c":
                for name, dtype in (("fp32", torch.float32),
                                    ("fp64", torch.float64)):
                    outdir = os.path.join(top, f"{tag}_{name}")
                    os.makedirs(outdir)
                    out[name] = run_jet(shape, dtype, outdir, steps)[0]
            else:
                make = ibm_case if tag == "9a" else ekman_case
                ini = os.path.join(top, tag + ".ini")
                with open(ini, "w") as fh:
                    fh.write(make(shape, steps))
                base = os.path.join(top, tag + "_ini")
                run_cli("ini", ini, base, "--x64")
                for name, more in (("fp32", ()), ("fp64", ("--x64",))):
                    outdir = os.path.join(top, f"{tag}_{name}")
                    os.makedirs(outdir)
                    for f in os.listdir(base):
                        if f.startswith(("flow.0.", "scal.0.")):
                            os.symlink(os.path.join(base, f),
                                       os.path.join(outdir, f))
                    out[name] = traced_cli(ini, outdir, ("dns",),
                                           *more)["run"]
            r32, r64 = out["fp32"], out["fp64"]
            # the velocity as one vector (9c's w is round-off of a flow
            # uniform in z), the scalar
            vel32 = torch.stack(r32.state[:3]).double()
            vel64 = torch.stack(r64.state[:3])
            rel = ((vel32 - vel64).abs().max() / vel64.abs().max()).item()
            rel_s = ((r32.state.s.double() - r64.state.s).abs().max()
                     / r64.state.s.abs().max()).item()
            print(f"[boundary] 9d {tag} {shape}, {steps} adaptive-dt steps: "
                  f"max|q32 - q64| / max|q64| over u, v, w = {rel:.3e}, "
                  f"scalar {rel_s:.3e} (limit {FP64_TOL}); t32 - t64 = "
                  f"{r32.rtime - r64.rtime:.3e}; "
                  f"{time.perf_counter() - t0:.1f} s")
            require(max(rel, rel_s) <= FP64_TOL,
                    f"9d {tag}: fp32 vs fp64 {max(rel, rel_s)} > {FP64_TOL}")


# ---------------------------------------------------------------------------
# Phases 10-12: semi-implicit diffusion, long lines, the compressible set
# ---------------------------------------------------------------------------

CASE02 = ROOT / "tests" / "data" / "case02_small3d.ini"
SMR91_STEPS, SMR91_SHEAR_STEPS = 10, 5
LONG_X_SHAPE, LONG_Y_SHAPE, LONG_STEPS = (4096, 128, 64), (128, 2304, 64), 5
COMP_SHAPE, COMP_SMALL, COMP_STEPS = (512, 256, 256), (128, 64, 16), 5
# the substructured operators are an exact block LU of the dense ones:
# round-off in fp64, fp32's own round-off in fp32 (of max|dense|)
BANDED_TOL = {torch.float64: 1e-10, torch.float32: 1e-5}
# integral of rho over the box after 5 RK4 steps, relative: what
# tests/test_compressible.py:92-110 holds tlab_tpu to over 50 steps
MASS_TOL = 1e-6
# 12c: the fp32 run's drift of that integral beside the fp64 run's, the
# rounding of 20 updates of rho (1.9e-9 apart on an H100 in 12c; a
# step that loses or gains mass in fp32 only reads more)
MASS_FP32_TOL = 1e-7
# 12c's witness: tlab_tpu in fp32 on the same inputs on the CPU, 5 RK4 steps
# of COMP_DT from case02's initial state, max over the conservative fields
# of max|q32 - q64| / max|q64| (tests/test_torch_fp32.py::
# test_compressible_steps_in_float32_drift_as_tlab_tpus: 3.760e-06, the port
# 3.439e-06); the card's run is held to 2x it
COMP_WITNESS, COMP_DT = 3.760e-6, 2.2e-3
COMP_FP32_TOL = 2.0 * COMP_WITNESS
# 10a's witness: tlab_tpu in float64 on the CPU, inigrid, ini and dns of
# the case 10a runs (ekman_smr91_case(EKMAN_SHAPE, SMR91_STEPS)); max over
# u and w of |q - ref| on the no-slip wall after the last step.  Its SMR91
# step pins only v there: the start's noise (1.063e-2) and the pressure
# gradient's corrections stay (PYTHONPATH=. python
# tests/test_torch_implicit.py prints it); the card's fp32 run is held to it
# within FP64_TOL of max|u, w|, the fp32-against-fp64 limit of 10c
EKMAN_WALL_WITNESS = 1.5344067419802165e-2
# 11c's lines: F = 4 fields of a 128 x 64 cross-section, as 11a and 11b;
# 1024 and 2048 bracket the crossover below tlab_tpu's default of 2304
CROSSOVER_LINES = tuple((n, periodic) for n in (1024, 2048, 2304, 4096)
                        for periodic in (False, True))


def smr91_case(text: str, changes: dict) -> str:
    """A case file with TimeOrder=RungeKuttaDiffusion3 and `changes`."""
    return edit_case(text, {("Main", "TimeOrder"): "RungeKuttaDiffusion3",
                            **changes})


def ekman_smr91_case(shape, steps: int) -> str:
    """examples/ekman_mesh/tlab.ini at `shape` with the SMR91 scheme, as the
    reference's Ekman cases 85-87 run, without its [Parallel] mesh (A17) and
    [SaveTowers] (A15); its Jmax sponge as the example has it (tlab_tpu's
    SMR91 step applies no buffer: the port's neither)."""
    text = EKMAN.read_text()
    for section in ("Parallel", "SaveTowers"):
        text, n = re.subn(rf"^\[{section}\]\n[^\[]*", "", text, flags=re.M)
        require(n == 1, f"[{section}] not found in {EKMAN.name}")
    return smr91_case(text, {**grid_keys(shape),
                             ("Iteration", "End"): steps,
                             ("Iteration", "Restart"): 1000,
                             ("Iteration", "Statistics"): steps})


def shear_case(shape, steps: int, changes=None) -> str:
    """examples/shear3d/tlab.ini at `shape`, `steps` steps, statistics at
    the last, no restart file."""
    return edit_case(CASE.read_text(), {
        **grid_keys(shape), ("Iteration", "End"): steps,
        ("Iteration", "Restart"): 1000, ("Iteration", "Statistics"): steps,
        **(changes or {})})


def comp_case(shape, steps: int, changes=None) -> str:
    """tests/data/case02_small3d.ini (the reference's Case02 compressible
    shear layer, reduced) at `shape`: its box and profiles, [Grid] and the
    [IniGrid*] points together."""
    return edit_case(CASE02.read_text(), {
        **grid_keys(shape), ("Iteration", "End"): steps,
        ("Iteration", "Restart"): 1000, ("Iteration", "Statistics"): steps,
        **(changes or {})})


def write_case(out: str, text: str) -> str:
    ini = os.path.join(out, "tlab.ini")
    with open(ini, "w") as fh:
        fh.write(text)
    return ini


def slice_line(tag: str, card: str, shape, steps: int, n_sub: int, res,
               trace) -> str:
    """rate_line for phases 10-12, with ms a step."""
    rate = step_rate(trace, steps, n_sub)
    return (rate_line(tag, card, shape, steps, n_sub, trace, res, tag[:2])
            + f"; {1e3 * rate['seconds'] / steps:.3f} ms/step")


def wall_check(P, state) -> tuple:
    """The SMR91 Helmholtz update of u and w on `state` with their wall
    pencil (Dirichlet for a no-slip wall) keeps the wall rows it is given
    (aug q_wall is the solve's boundary value): max over u and w of
    |x_wall - q_wall| / max|q|; and v's wall rows (exactly 0 after a step)."""
    from tlab_tpu_torch.dycore import implicit
    kdt, kim, kex = implicit.KDT[0], implicit.KIM[0], implicit.KEX[0]
    kef = kex / kim
    aug = 1.0 + kef
    dte = 1e-3 * kdt
    err = 0.0
    for name, q in (("u", state.u), ("w", state.w)):
        pair = P["wall_bc_types"][name]
        x = implicit._helmholtz_update(
            P, pair, q, aug * q, (aug * q[:, 0, :], aug * q[:, -1, :]),
            dte * kim * P["visc"], kef)
        for side, j in zip(pair, (0, -1)):
            if side == "dirichlet":
                err = max(err, ((x[:, j] - q[:, j]).abs().max()
                                / q.abs().max()).item())
    return err, state.v[:, (0, -1), :].abs().max().item()


def phase_smr91_ekman(card: str) -> list:
    """10a: inigrid, ini and dns of the Ekman layer at its own 128x96x128
    with the SMR91 scheme: the CFL column at TimeCFL on every step after the
    first while D# passes the explicit diffusive limit; v's walls 0; u and w
    keep their no-slip values through the Dirichlet pencil."""
    text = ekman_smr91_case(EKMAN_SHAPE, SMR91_STEPS)
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as out:
        res = traced_cli(write_case(out, text), out,
                         ("inigrid", "ini", "dns"))
        rows = data_rows(os.path.join(out, "dns.out"))
        trace = read_trace(os.path.join(out, "tlab.trace"))
    run, launches = res["run"], res["launches"]
    case, P = run.sim.case, run.sim.P
    cfl = [float(r[4]) for r in rows]
    dnum = [float(r[5]) for r in rows]
    wall_err, v_wall = wall_check(P, run.state)
    # what the limit would read with the Neumann pencil in the Dirichlet
    # one's place (tlab_tpu's fallback where a plan lacks ell_dd)
    wrong_err, _ = wall_check(dict(P, ell_dd=P["ell"]), run.state)
    yw = np.array([run.sim.grid.y.nodes[0], run.sim.grid.y.nodes[-1]])
    refs = (case.vel_profiles[0](yw), case.vel_profiles[2](yw))
    dev = [max(abs(run.state.u[:, j].double() - refs[0][j]).max().item(),
               abs(run.state.w[:, j].double() - refs[1][j]).max().item())
           for j in (0, -1)]
    qmax = max(run.state.u.abs().max().item(), run.state.w.abs().max().item())
    dev_tol = FP64_TOL * qmax
    print(slice_line("10a Ekman layer, SMR91", card, EKMAN_SHAPE,
                     SMR91_STEPS, 3, res, trace))
    print(f"[10] 10a: CFL column {min(cfl[1:]):.3f}..{max(cfl[1:]):.3f} "
          f"(TimeCFL {case.time_cfl}); D# {min(dnum):.3f}..{max(dnum):.3f} "
          f"(the explicit scheme's limit TimeDiffusiveCFL "
          f"{case.time_cfl_diffusive}); the Dirichlet pencil keeps the wall "
          f"rows to {wall_err:.3e} of max|q| (the Neumann pencil in its place "
          f"moves them by {wrong_err:.3e}); max|v| on the walls {v_wall}; "
          f"|u, w - ref| on the no-slip wall {dev[0]:.6e} (tlab_tpu's fp64 "
          f"{EKMAN_WALL_WITNESS:.6e}, limit +-{dev_tol:.3e}: its SMR91 step "
          f"pins only v); t = {run.rtime:.6e}; " + dilatation_text(rows))
    require(len(rows) == SMR91_STEPS + 1 and all(r[0] == "0" for r in rows),
            f"10a dns.out: {len(rows)} rows, status {[r[0] for r in rows]}")
    require(all(abs(c - case.time_cfl) <= 1e-3 for c in cfl[1:]),
            f"10a: CFL column {cfl} not at {case.time_cfl}")
    require(max(dnum) > case.time_cfl_diffusive,
            f"10a: D# {max(dnum)} within the explicit limit: dt diffusive?")
    require(launches == [SMR91_STEPS * 3] * 3,
            f"10a launched {launches}, expected {SMR91_STEPS * 3} per axis")
    require(v_wall == 0.0, f"10a: v on the walls {v_wall}")
    require(abs(dev[0] - EKMAN_WALL_WITNESS) <= dev_tol,
            f"10a: u, w on the no-slip wall {dev[0]} from their values, "
            f"tlab_tpu's {EKMAN_WALL_WITNESS}")
    require(wall_err <= 1e-6 < wrong_err,
            f"10a: the wall rows move by {wall_err} ({wrong_err} with the "
            "Neumann pencil)")
    require(P["wall_bc_types"]["u"][0] == "dirichlet"
            and P["wall_bc_types"]["u"][1] == "neumann", "10a: wall kinds")
    for name, a in zip("uvws", run.state[:4]):
        require(bool(torch.isfinite(a).all()), f"10a: non-finite {name}")
    return launches


def phase_smr91_shear(card: str, initial: str) -> list:
    """10b: dns of the shear layer at 512x256x256 with the SMR91 scheme
    from 6a's initial fields, 5 steps: ms a stage and a step, peak memory."""
    text = smr91_case(shear_case(MAIN_SHAPE, SMR91_SHEAR_STEPS), {})
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as out:
        link_initial_fields(initial, out)
        res = traced_cli(write_case(out, text), out, ("dns",))
        rows = data_rows(os.path.join(out, "dns.out"))
        trace = read_trace(os.path.join(out, "tlab.trace"))
        _, _, flow = averages.read_avg(
            os.path.join(out, f"avg{SMR91_SHEAR_STEPS}"))
    run, launches = res["run"], res["launches"]
    rate = step_rate(trace, SMR91_SHEAR_STEPS, 3)
    cfl = [float(r[4]) for r in rows[1:]]
    print(slice_line("10b shear layer, SMR91", card, MAIN_SHAPE,
                     SMR91_SHEAR_STEPS, 3, res, trace)
          .replace("ms/substep", "ms/stage"))
    print(f"[10] 10b: {rate['ms_substep']:.3f} ms a stage (the others' "
          f"median {rate['others_ms_substep']:.3f}), "
          f"{1e3 * rate['seconds'] / SMR91_SHEAR_STEPS:.3f} ms a step; CFL "
          f"{min(cfl):.3f}..{max(cfl):.3f}; D# {rows[-1][5]}; "
          + dilatation_text(rows))
    require(len(rows) == SMR91_SHEAR_STEPS + 1
            and all(r[0] == "0" for r in rows), "10b dns.out status")
    require(launches == [SMR91_SHEAR_STEPS * 3] * 3,
            f"10b launched {launches}")
    require(all(abs(c - CFL_TARGET) <= CFL_TOL for c in cfl),
            f"10b: CFL column {cfl}")
    require(all(np.isfinite(v).all() for v in flow.values()),
            "10b: avg columns not finite")
    for name, a in zip("uvws", run.state[:4]):
        require(bool(torch.isfinite(a).all()), f"10b: non-finite {name}")
    return launches


def cli_fp32_fp64(top: str, tag: str, text: str) -> tuple:
    """ini once in fp64, then dns in fp32 and in fp64 from those files:
    (fp32 run, fp64 run)."""
    ini = os.path.join(top, tag + ".ini")
    with open(ini, "w") as fh:
        fh.write(text)
    base = os.path.join(top, tag + "_ini")
    run_cli("ini", ini, base, "--x64")
    out = {}
    for name, more in (("fp32", ()), ("fp64", ("--x64",))):
        outdir = os.path.join(top, f"{tag}_{name}")
        os.makedirs(outdir)
        for f in os.listdir(base):
            if f.startswith(("flow.0.", "scal.0.")):
                os.symlink(os.path.join(base, f), os.path.join(outdir, f))
        out[name] = traced_cli(ini, outdir, ("dns",), *more)["run"]
    return out["fp32"], out["fp64"]


def phase_smr91_fp64() -> None:
    """10c: fp32 against fp64 on the card, 5 SMR91 steps, the shear layer at
    128x64x64 and the Ekman copy at its 128x96x128."""
    cases = {"shear layer 128x64x64": smr91_case(
                 shear_case((128, 64, 64), OPTION_STEPS), {}),
             "Ekman at 128x96x128": ekman_smr91_case(EKMAN_SHAPE,
                                                  OPTION_STEPS)}
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as top:
        for i, (what, text) in enumerate(cases.items()):
            r32, r64 = cli_fp32_fp64(top, f"10c{i}", text)
            vel32 = torch.stack(r32.state[:3]).double()
            vel64 = torch.stack(r64.state[:3])
            rel = ((vel32 - vel64).abs().max() / vel64.abs().max()).item()
            print(f"[10] 10c {what}, {OPTION_STEPS} SMR91 steps: "
                  f"max|q32 - q64| / max|q64| over u, v, w = {rel:.3e} "
                  f"(limit {FP64_TOL}); t32 - t64 = "
                  f"{r32.rtime - r64.rtime:.3e}")
            require(rel <= FP64_TOL, f"10c {what}: {rel} > {FP64_TOL}")


def banded_against_dense(plan, shape, name: str, axis: int,
                         keys) -> dict:
    """A long line's substructured d1 (and d2 where the plan has it) on the
    card against the dense products of the same operators, on 3 seeded
    normal fields of the run's shape, in fp32 and in fp64 (plans built
    anew in each): max error over max|dense|.  (On a smooth field the
    derivative is small beside the field, and fp32's rounding of the field
    reads larger over max|derivative| than a normal field's.)"""
    from tlab_tpu_torch.ops import thomas
    gen = torch.Generator(device="cuda").manual_seed(4)
    q64 = torch.randn((3,) + tuple(shape), generator=gen, device="cuda",
                      dtype=torch.float64)
    out = {}
    for dtype in (torch.float32, torch.float64):
        nt = np.float32 if dtype == torch.float32 else np.float64
        q = q64.to(dtype)
        for key, (A, B) in (("d1", (plan.A1, plan.B1)),
                            ("d2", (plan.A2, plan.B2))):
            if f"{key}{name}_banded" not in keys:
                continue
            bp = thomas.device_plan(thomas.banded_plan(
                A, B, nt, periodic=plan.periodic), dtype, "cuda")
            got = thomas.banded_der1(bp, q, axis + 1)
            dense = der12(torch.as_tensor(plan.d12[BC.DD]).to("cuda", dtype),
                          q, axis + 1)[0 if key == "d1" else 1]
            err = ((got - dense).abs().max() / dense.abs().max()).item()
            out[f"{key}{name} {str(dtype)[6:]}"] = err
            require(err <= BANDED_TOL[dtype],
                    f"banded {key}{name} {dtype}: {err}")
            del got, dense
        del q
    del q64
    return out


def long_line_case(shape) -> str:
    """The shear layer at `shape`, LONG_STEPS steps.  A long y takes the
    direct eigen Poisson solve (EllipticOrder=compactdirect6): the
    factorized plan's eigenbases have cond(V) ~3e9 at ny = 2304, beyond
    what its complex64 sweeps carry, and its float32 plan is refused."""
    text = shear_case(shape, LONG_STEPS)
    if shape[1] >= 2304:
        text = add_keys(text, "Main", ["EllipticOrder=compactdirect6"])
    return text


def phase_long_line(tag: str, card: str, shape, expect: list) -> list:
    """11a/11b: inigrid, ini and dns of the shear layer with one line of
    2304 points or more, 5 steps: the launches of K1-K3 (none along the
    banded direction), the banded operators against the dense ones, the
    host set-up of the plans; at ny = 2304, the float32 factorized plan
    refused (cond(V) printed)."""
    text = long_line_case(shape)
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as out:
        res = traced_cli(write_case(out, text), out,
                         ("inigrid", "ini", "dns"))
        rows = data_rows(os.path.join(out, "dns.out"))
        trace = read_trace(os.path.join(out, "tlab.trace"))
    run, launches = res["run"], res["launches"]
    sim = run.sim
    banded = sorted(k for k in sim.P if k.endswith("_banded"))
    name = "x" if shape[0] >= 2304 else "y"
    axis = "xyz".index(name)
    errs = banded_against_dense((sim.fdm.x, sim.fdm.y)[axis], shape,
                                name, axis, banded)
    t0 = time.perf_counter()
    fac_plan = fac.build_factorize_plan(sim.fdm)
    fac_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ell_plan = elliptic.build_elliptic_plan(sim.fdm)
    ell_s = time.perf_counter() - t0
    conds = (max(fac_plan.emin["cond"], fac_plan.emax["cond"]),
             ell_plan.eig_condition)
    refused = ""
    if "ell_fac" not in sim.P:
        # the long y's factorized plan in float32 is refused: its solve
        # would be noise
        try:
            fac.device_factorize_plan(fac_plan, torch.float32, "cuda")
        except ValueError:
            refused = "; the float32 factorized plan refused"
        require(bool(refused), f"{tag}: the float32 factorized plan at "
                f"cond(V) {conds[0]:.3e} was not refused")
    print(slice_line(f"{tag} shear layer {shape}", card, shape, LONG_STEPS,
                     5, res, trace))
    print(f"[11] {tag}: plan keys {banded}; banded against dense "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (limits {BANDED_TOL[torch.float64]} fp64, "
          f"{BANDED_TOL[torch.float32]} fp32); host set-up (ny = "
          f"{shape[1]}): the factorized plan {fac_s:.3f} s (cond(V) "
          f"{conds[0]:.3e}), the direct eigen plan {ell_s:.3f} s (cond "
          f"{conds[1]:.3e}); the run's Poisson solve "
          f"{'factorized' if 'ell_fac' in sim.P else 'direct eigen'}"
          f"{refused}; ini {res['seconds']['ini']:.3f} s; "
          + dilatation_text(rows))
    require(len(rows) == LONG_STEPS + 1 and all(r[0] == "0" for r in rows),
            f"{tag} dns.out status")
    require(launches == expect, f"{tag} launched {launches}, not {expect}")
    require(bool(banded), f"{tag}: no banded plan")
    for n, a in zip("uvws", run.state[:4]):
        require(bool(torch.isfinite(a).all()), f"{tag}: non-finite {n}")
    return launches


def phase_crossover(card: str) -> None:
    """11c: one banded_der1 against the dense d1 product, fp32, F = 4 lines
    of a 128 x 64 cross-section, N = 1024, 2048, 2304 and 4096, periodic
    and not (CUDA events, median of REPS, in turns)."""
    from tlab_tpu_torch import grid as tgrid
    from tlab_tpu_torch.fdm.plan import build_deriv_plan
    from tlab_tpu_torch.ops import thomas
    gen = torch.Generator(device="cuda").manual_seed(3)
    for n, periodic in CROSSOVER_LINES:
        nodes = np.arange(n) * (2 * np.pi / n) if periodic \
            else np.linspace(0.0, 1.0, n)
        plan = build_deriv_plan(tgrid.make_axis(nodes, periodic))
        bp = thomas.device_plan(thomas.banded_plan(
            plan.A1, plan.B1, np.float32, periodic=periodic),
            torch.float32, "cuda")
        d1 = torch.as_tensor(plan.d1[0]).to("cuda", torch.float32)
        u = torch.randn((4, n, 128, 64), generator=gen, device="cuda")
        calls = {"dense": lambda: apply_along(d1, u, 1),
                 "banded": lambda: thomas.banded_der1(bp, u, 1)}
        times = {k: [] for k in calls}
        for _ in range(REPS):
            for k, fn in calls.items():
                times[k].append(event_ms(fn))
        ms = {k: statistics.median(v) for k, v in times.items()}
        err = ((calls["banded"]() - calls["dense"]()).abs().max()
               / calls["dense"]().abs().max()).item()
        S = bp["part"]["S"]
        kind = "periodic" if periodic else "walls"
        print(f"[11] 11c ({card}) N = {n} {kind}: dense d1 "
              f"{ms['dense']:.3f} ms, banded "
              f"{ms['banded']:.3f} ms ({S} segments of {n // S}; "
              f"dense/banded {ms['dense'] / ms['banded']:.2f}); max|banded - "
              f"dense| / max {err:.3e}")
        require(err <= BANDED_TOL[torch.float32], f"11c N={n}: {err}")
        del u


def comp_checks(tag: str, run, rows, steps: int, mass0: float) -> dict:
    """The compressible run's limits: rho and p finite, positive and within
    the FlowLimit bounds; the CFL column at TimeCFL; the integral of rho
    conserved."""
    sim, U = run.sim, run.state
    p = dns_tool._primitive(sim, U)[4]
    bounds = sim.comp["bounds"]
    rmin, rmax = U.rho.min().item(), U.rho.max().item()
    pmin, pmax = p.min().item(), p.max().item()
    mass = U.rho.double().sum().item()
    drift = abs(mass - mass0) / mass0
    cfl = [float(r[4]) for r in rows[1:]]
    require(len(rows) == steps + 1 and all(r[0] == "0" for r in rows),
            f"{tag} dns.out status {[r[0] for r in rows]}")
    require(all(np.isfinite(x) and x > 0 for x in (rmin, pmin, rmax, pmax)),
            f"{tag}: rho {rmin}..{rmax}, p {pmin}..{pmax}")
    require(bounds["r"][0] <= rmin and rmax <= bounds["r"][1]
            and bounds["p"][0] <= pmin and pmax <= bounds["p"][1],
            f"{tag}: out of the FlowLimit bounds {bounds}")
    require(all(abs(c - sim.case.time_cfl) <= 1e-3 for c in cfl),
            f"{tag}: CFL column {cfl}")
    require(drift <= MASS_TOL, f"{tag}: mass drift {drift}")
    for name, a in zip(("rho", "rhou", "rhov", "rhow", "rhoE"), U[:5]):
        require(bool(torch.isfinite(a).all()), f"{tag}: non-finite {name}")
    return {"rho": (rmin, rmax), "p": (pmin, pmax), "mass_drift": drift}


def phase_compressible(card: str) -> list:
    """12a: inigrid, ini and dns of case02_small3d.ini (Equations=internal:
    the divergence form whatever TermAdvection says, as tlab_tpu's) at
    512x256x256, 5 adaptive RK4 steps; 12b: its initial
    state in total energy (rhoE + rho |u|^2 / 2 of the same fields) with
    Equations=total and TermAdvection=divergence, 5 steps.  Returns each
    run's K1-K3 launches and its fused compressible kernels' launches:
    each entry point once a substep in 12a, none in 12b."""
    launches, fused = [], []
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as out:
        res = traced_cli(write_case(out, comp_case(COMP_SHAPE, COMP_STEPS)),
                         out, ("inigrid", "ini", "dns"))
        rows = data_rows(os.path.join(out, "dns.out"))
        trace = read_trace(os.path.join(out, "tlab.trace"))
        _, _, flow = averages.read_avg(os.path.join(out,
                                                    f"avg{COMP_STEPS}"))
        U0, _, _ = fields_io.read_comp_state(os.path.join(out, "flow"), 0)
        mass0 = float(U0.rho.sum())
        run = res["run"]
        got = comp_checks("12a", run, rows, COMP_STEPS, mass0)
        favre = ("fU", "fV", "fW", "fT", "fe", "fh", "fs", "Rxx", "C2",
                 "Rho_ac", "RhoDil1", "Gyy", "Dyy")
        require(all(np.isfinite(flow[n]).all() for n in favre)
                and np.abs(flow["rR"] - 1.0).max() > 0.0,
                "12a: the avg file's Favre columns")
        print(slice_line("12a case02 (internal energy)",
                         card, COMP_SHAPE, COMP_STEPS, 5, res, trace))
        print(f"[12] 12a: rho {got['rho'][0]:.6f}..{got['rho'][1]:.6f}, p "
              f"{got['p'][0]:.6f}..{got['p'][1]:.6f} (FlowLimit "
              f"{run.sim.comp['bounds']}); integral of rho drifts "
              f"{got['mass_drift']:.3e} (limit {MASS_TOL}); ini "
              f"{res['seconds']['ini']:.3f} s of which initial_state "
              f"{trace['initial_state'][1]:.3f} s; one "
              f"write_statistics_compressible "
              f"{trace[f'statistics {COMP_STEPS}'][1]:.3f} s; the avg "
              f"file's Favre columns finite, rR "
              f"{flow['rR'].min():.6f}..{flow['rR'].max():.6f}")
        require(res["launches"] == [0, 0, 0],
                f"12a launched {res['launches']}")
        # 24 d1 and 6 [D1;D2] products a substep through the kernels
        d = res["deriv_launches"]
        print(f"[12] 12a: derivative kernel launches {d}")
        require(min(d["deriv1"] + d["deriv12"]) > 0,
                f"12a: derivative kernel launches {d}")
        substeps = COMP_STEPS * len(run.sim.P["rk"]["kdt"])
        fused.append(comp_launches("12a", res, substeps))
        launches.append(res["launches"])
        # 12b: the same fields in total energy
        ke = 0.5 * (U0.rhou ** 2 + U0.rhov ** 2 + U0.rhow ** 2) / U0.rho
        params = fields_io.read_field(os.path.join(out, "flow.0.5"))[1]
        out_b = os.path.join(out, "12b")
        os.makedirs(out_b)
        for f in os.listdir(out):
            if f.startswith("flow.0.") and f != "flow.0.5":
                os.symlink(os.path.join(out, f), os.path.join(out_b, f))
        fields_io.write_field(os.path.join(out_b, "flow.0.5"),
                              U0.rhoE + ke, 0, params)
        text = comp_case(COMP_SHAPE, COMP_STEPS, {
            ("Main", "Equations"): "total",
            ("Main", "TermAdvection"): "divergence"})
        del run, res, U0, ke
        res = traced_cli(write_case(out_b, text), out_b, ("dns",))
        rows = data_rows(os.path.join(out_b, "dns.out"))
        trace = read_trace(os.path.join(out_b, "tlab.trace"))
        got = comp_checks("12b", res["run"], rows, COMP_STEPS, mass0)
        print(slice_line("12b case02 (total energy, divergence form)", card,
                         COMP_SHAPE, COMP_STEPS, 5, res, trace))
        print(f"[12] 12b: rho {got['rho'][0]:.6f}..{got['rho'][1]:.6f}, p "
              f"{got['p'][0]:.6f}..{got['p'][1]:.6f}; integral of rho "
              f"drifts {got['mass_drift']:.3e}; the last row's PMin PMax "
              f"RMin RMax {' '.join(rows[-1][7:11])}")
        require(res["launches"] == [0, 0, 0],
                f"12b launched {res['launches']}")
        fused.append(comp_launches("12b", res, 0))
        launches.append(res["launches"])
    return launches, fused


def phase_compressible_fp64() -> None:
    """12c: case02 at its own 128x64x16, 5 RK4 steps of COMP_DT from its
    initial state, fp32 against fp64 on the card; held to 2x tlab_tpu's
    fp32 drift on the same inputs (COMP_WITNESS)."""
    from tlab_tpu_torch.dycore import compressible as comp
    from tlab_tpu_torch.tools.initialize import compressible_initial_state
    text = comp_case(COMP_SMALL, COMP_STEPS)
    start = None
    out, drift = {}, {}
    for dtype in (torch.float64, torch.float32):
        sim = Simulation.from_case(load_case(Ini(text=text)), dtype=dtype,
                                   device="cuda")
        if start is None:
            start = compressible_initial_state(sim, seed=0)
        c = sim.comp
        U = comp.CompState(*(a.to(dtype) for a in start))
        mass0 = U.rho.double().sum().item()
        for _ in range(COMP_STEPS):
            U = comp.rk_step_compressible(
                sim.P, U, COMP_DT, c["gamma"], c["mach"], sim.nsp.visc,
                c["prandtl"], form=c["form"], energy=c["energy"],
                gvec=c["gvec"])
        out[dtype] = [a.double() for a in U]
        drift[dtype] = (U.rho.double().sum().item() - mass0) / mass0
    rel = max(((a - b).abs().max() / b.abs().max()).item() for a, b in
              zip(out[torch.float32], out[torch.float64]))
    ddrift = abs(drift[torch.float32] - drift[torch.float64])
    print(f"[12] 12c case02 {COMP_SMALL}, {COMP_STEPS} RK4 steps of "
          f"dt {COMP_DT}: max over the conservative fields of max|q32 - q64| "
          f"/ max|q64| = {rel:.3e} (limit {COMP_FP32_TOL:.3e}: 2x tlab_tpu's "
          f"{COMP_WITNESS:.3e} on the CPU); the integral of rho drifts "
          f"{drift[torch.float64]:.3e} in fp64 (the wall rows' Neumann "
          f"tendency is not a flux), "
          f"{drift[torch.float32]:.3e} in fp32 (limit on the difference "
          f"{MASS_FP32_TOL})")
    require(rel <= COMP_FP32_TOL, f"12c: {rel} > {COMP_FP32_TOL}")
    require(ddrift <= MASS_FP32_TOL, f"12c: fp32 mass drift {ddrift}")


# ---------------------------------------------------------------------------
# Phase 13: the rest of the compressible set (NSCBC, mixtures, AirWater, the
# compressible buffer, the compressible spatial statistics)
# ---------------------------------------------------------------------------

CASE14 = ROOT / "tests" / "data" / "case14_small3d.ini"
# 13a: the width of the repo's cloud-top example (examples/cloudtop_anelastic)
AW_SHAPE, AW_STEPS = (256, 192, 128), 5
# 13e: the compressible spatial mode, and 13c/13d: case14 as the file has it
SPATIAL_COMP_SHAPE, SPATIAL_COMP_STEPS = (256, 128, 128), 5
C14_SHAPE, C14_STEPS = (32, 48, 8), 10
# 13c's witness: tlab_tpu in float64 on the CPU, inigrid, ini and dns of
# tests/data/case14_small3d.ini as it is (tests/test_torch_airwater.py
# reruns it and holds these rows to its dns.out): every data row of dns.out
C14_ROWS = (
    "0 0 0.000000E+00 0.128E-04 0.120E+01 0.510E-05 0.100E-04 0.820E+05 "
    "0.821E+05 0.957E+00 0.985E+00 0.000E+00",
) + tuple(
    f"0 {k} {t} 0.128E-04 0.120E+01 0.510E-05 0.100E-04 0.820E+05 "
    "0.821E+05 0.957E+00 0.985E+00 0.917E-04"
    for k, t in enumerate(("0.128074E-04", "0.256149E-04", "0.384223E-04",
                           "0.512297E-04", "0.640372E-04", "0.768446E-04",
                           "0.896520E-04", "0.102459E-03", "0.115267E-03",
                           "0.128074E-03"), start=1))
# and its final state in more digits than the log prints: max over y of
# the plane means |<rho v>|, <rho>, <rho e>, <rho qt>, and max|rho u|.  The
# x momentum is the imbalance of p ~ 8.2e4 at M = 0.0029 (its plane mean
# ~1e-14): the packages agree on it to the problem's round-off floor, which
# tlab_tpu shows against itself (ROADMAP C)
C14_MEANS = {"rhov_mean": 0.0244773256337293,
             "rho_mean": 0.9831605363667723,
             "rhoE_mean": 0.6727332575107033,
             "rhos_mean": 0.010814765900034495,
             "rhou_max": 0.00015518166507574272}
C14_MEANS_TOL = {"rhov_mean": 1e-8, "rho_mean": 1e-12, "rhoE_mean": 1e-12,
                 "rhos_mean": 1e-12, "rhou_max": 1e-4}
# 13d's witness: tlab_tpu in fp32 against fp64 on the same inputs on the CPU
# (tests/test_torch_fp32.py::test_airwater_steps_in_float32_drift_as_tlab_
# tpus), its saturation Newton in fp64 as the port's; the card's fp32 run is
# held to 2x it, field by field
C14_DT = 1.28e-5
C14_WITNESS = {"rho": 2.9071130335412818e-05, "rhou": 0.6680860740519406,
               "rhov": 1.0325934031140778, "rhoE": 0.0002015440611103037,
               "rhos": 2.930627309384125e-05}
# 13a's NewtonRs: the saturation Newton's last step over T (three steps from
# the unsaturated guess, as the reference: not converged to round-off);
# tlab_tpu's float64 run of case14 reads 0.917E-04 (C14_ROWS); an fp32
# polynomial reads ~1e-3.  The card's fp32 run's column may not pass 2x it,
# and the final state's NewtonRs in fp64 on the card agrees with the fp32
# state's to NEWTON_FP32_TOL of it (the state's fp32 rounding)
NEWTON_WITNESS = 9.174444447565667e-05
NEWTON_FP32_TOL = 1e-2
# 13a: the buffer's wall rows' plane means against their references
# (relative; the relaxation holds them where the 5 steps leave them)
BUFFER_WALL_TOL = 1e-5
# 13b: the ideal gas with characteristic boundaries, and a mixture
MIX_NAME = "unidecomp"
# 13e: the device reduction against an fp64 host evaluation of the same sums
# on the same state, per row: max|dev - host| over the size of the terms the
# row sums, every sum taken in magnitudes (|D1| and |fields|, the z-mean of
# |products|), so that a derivative's own terms count: a derivative of
# T ~ 1 or p ~ 7.9 cancels ~1e3 of its terms, and fp32 keeps ~1e-7 of them
SPATIAL_SUMS_TOL = 1e-5


def aw_case(shape, steps: int) -> str:
    """tests/data/case14_small3d.ini at `shape`: its box, profiles, NSCBC
    and [BufferZone] kept, [Grid] and [IniGrid*] points together."""
    return edit_case(CASE14.read_text(), {
        **grid_keys(shape), ("Iteration", "End"): steps,
        ("Iteration", "Restart"): 1000, ("Iteration", "Statistics"): steps})


def open_case(shape, steps: int) -> str:
    """case02_small3d.ini at `shape` with outflow (NSCBC) y boundaries and
    a relaxation buffer of 16 points a side (13b1)."""
    text = comp_case(shape, steps, {
        ("BoundaryConditions", "VelocityJmin"): "outflow",
        ("BoundaryConditions", "VelocityJmax"): "outflow",
        ("BufferZone", "Type"): "relaxation"})
    return add_keys(text, "BufferZone", ["PointsJmin=16", "PointsJmax=16",
                                         "Parameters=1.0,2.0"])


def mix_case(shape, steps: int, nscbc: bool = False) -> str:
    """case02_small3d.ini at `shape` with the relaxation buffer and the
    unidecomp combustion mixture (2 species: its one scalar is Y_1), its
    free-slip walls (13b2), or with the outflow boundaries of open_case
    too: tlab_tpu's characteristic corrections leave the balance species'
    formation enthalpy out of the energy (ROADMAP C), and that run turns
    its pressure negative at the first step in both packages."""
    text = open_case(shape, steps)
    if not nscbc:
        text = edit_case(text, {
            ("BoundaryConditions", "VelocityJmin"): "freeslip",
            ("BoundaryConditions", "VelocityJmax"): "freeslip"})
    return add_keys(text, "Thermodynamics", [f"Mixture={MIX_NAME}"])


def comp_bounds(sim) -> dict:
    """The case's [Control] FlowLimit bounds, or the ones the reference
    takes by default (the mean pressure and density 1e-6 and 1e6 times)
    where the case sets FlowLimit=no."""
    if sim.comp["bounds"] is not None:
        return sim.comp["bounds"]
    ini = sim.case.ini
    gamma, mach = sim.comp["gamma"], sim.comp["mach"]
    p = ini.get_float("Flow", "Pressure", 1.0 / (gamma * mach ** 2))
    r = ini.get_float("Flow", "Density", 1.0)
    return {"p": (p * 1e-6, p * 1e6), "r": (r * 1e-6, r * 1e6)}


def comp_open_checks(tag: str, run, rows, steps: int) -> dict:
    """comp_checks without the integral of rho (open boundaries let mass
    out): rho and p finite, positive, inside the bounds; the CFL column at
    TimeCFL after the first step."""
    sim, U = run.sim, run.state
    p = dns_tool._primitive(sim, U)[4]
    bounds = comp_bounds(sim)
    rmin, rmax = U.rho.min().item(), U.rho.max().item()
    pmin, pmax = p.min().item(), p.max().item()
    cfl = [float(r[4]) for r in rows[1:]]
    require(len(rows) == steps + 1 and all(r[0] == "0" for r in rows),
            f"{tag} dns.out status {[r[0] for r in rows]}")
    require(all(np.isfinite(x) and x > 0 for x in (rmin, pmin, rmax, pmax)),
            f"{tag}: rho {rmin}..{rmax}, p {pmin}..{pmax}")
    require(bounds["r"][0] <= rmin and rmax <= bounds["r"][1]
            and bounds["p"][0] <= pmin and pmax <= bounds["p"][1],
            f"{tag}: out of the FlowLimit bounds {bounds}")
    require(all(abs(c - sim.case.time_cfl) <= 1e-3 for c in cfl),
            f"{tag}: CFL column {cfl}")
    for name, a in zip(("rho", "rhou", "rhov", "rhow", "rhoE"), U[:5]):
        require(bool(torch.isfinite(a).all()), f"{tag}: non-finite {name}")
    if U.rhos is not None:
        require(bool(torch.isfinite(U.rhos).all()), f"{tag}: non-finite rhos")
    return {"rho": (rmin, rmax), "p": (pmin, pmax), "bounds": bounds}


def phase_airwater(card: str) -> list:
    """13a: inigrid, ini and dns of case14_small3d.ini's physics (the
    moist cloud top in the compressible internal-energy set, NSCBC outflow,
    a relaxation buffer) at 256x192x128 fp32, 5 adaptive RK4 steps."""
    from tlab_tpu_torch.dycore import compressible as comp
    text = aw_case(AW_SHAPE, AW_STEPS)
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as out:
        res = traced_cli(write_case(out, text), out,
                         ("inigrid", "ini", "dns"))
        rows = data_rows(os.path.join(out, "dns.out"))
        trace = read_trace(os.path.join(out, "tlab.trace"))
        _, _, flow = averages.read_avg(os.path.join(out, f"avg{AW_STEPS}"))
    run = res["run"]
    sim, U = run.sim, run.state
    got = comp_open_checks("13a", run, rows, AW_STEPS)
    aw = sim.comp["aw"]
    u, v, w, T, p, ql, newton_end = comp.primitive_airwater(U, aw)
    qt = U.rhos[0] / U.rho
    ql_min = ql.min().item()
    ql_over = (ql - qt).max().item()
    newton = [float(r[11]) for r in rows[1:]]
    U64 = comp.CompState(*(a.double() for a in U))
    newton64 = comp.primitive_airwater(U64, aw)[6].item()
    newton_rel = abs(newton_end.item() - newton64) / newton64
    # the buffer's wall rows against their references
    buf = sim.comp["buffer"]
    wall = 0.0
    for name in ("rho", "rhoE"):
        ref = buf["refs"][name][0, :, 0].double()
        mean = getattr(U, name).double().mean(dim=(0, 2))
        wall = max(wall, ((mean - ref)[[0, -1]].abs().max()
                          / ref.abs().max()).item())
    ref = buf["refs"]["rs0"][0, :, 0].double()
    mean = U.rhos[0].double().mean(dim=(0, 2))
    wall = max(wall, ((mean - ref)[[0, -1]].abs().max()
                      / ref.abs().max()).item())
    spec = sim.comp["nscbc"]
    print(slice_line("13a case14 AirWater, NSCBC, buffer", card, AW_SHAPE,
                     AW_STEPS, 5, res, trace))
    print(f"[13] 13a: rho {got['rho'][0]:.6f}..{got['rho'][1]:.6f}, p "
          f"{got['p'][0]:.6e}..{got['p'][1]:.6e} (bounds {got['bounds']}); "
          f"ql {ql_min:.3e}..{ql.max().item():.3e}, max(ql - qt) "
          f"{ql_over:.3e}; NewtonRs column {newton} (tlab_tpu's fp64 on "
          f"case14 {NEWTON_WITNESS:.6e}); the final state's NewtonRs "
          f"{newton_end.item():.6e} (fp32 state), {newton64:.6e} (fp64), "
          f"{newton_rel:.3e} apart; NSCBC {spec.ymin}/{spec.ymax} sigma "
          f"{spec.sigma} cinf {spec.cinf} ctan {spec.ctan}, p_ref "
          f"{spec.refs_ymin[4]:.6e} / {spec.refs_ymax[4]:.6e}; the buffer's "
          f"wall rows {wall:.3e} from their references (limit "
          f"{BUFFER_WALL_TOL}); ini {res['seconds']['ini']:.3f} s of which "
          f"the pointwise (p, h) inversion "
          f"{trace['airwater pointwise (p, h) inversion'][1]:.3f} s; one "
          f"write_statistics_compressible "
          f"{trace[f'statistics {AW_STEPS}'][1]:.3f} s")
    require(res["launches"] == [0, 0, 0], f"13a launched {res['launches']}")
    require(ql_min >= 0.0 and ql_over <= 0.0,
            f"13a: ql {ql_min}, ql - qt {ql_over}")
    require(all(0.0 < n <= 2.0 * NEWTON_WITNESS for n in newton),
            f"13a: NewtonRs {newton} against {NEWTON_WITNESS}")
    require(newton_rel <= NEWTON_FP32_TOL,
            f"13a: NewtonRs fp32 state {newton_end.item()} fp64 {newton64}")
    require(wall <= BUFFER_WALL_TOL, f"13a: buffer wall rows {wall}")
    require(all(np.isfinite(v).all() for v in flow.values()),
            "13a: avg columns not finite")
    return res["launches"]


def phase_open(tag: str, card: str, text: str) -> list:
    """13b1/13b2: inigrid, ini and dns of an edited case02 at 512x256x256,
    5 adaptive RK4 steps: 13b1 outflow NSCBC and the buffer (the ideal gas),
    13b2 the unidecomp mixture and the buffer between free-slip walls.
    Returns the K1-K3 launches and the fused compressible kernels': none
    with the mixture, each entry point once a substep or none in 13b1."""
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as out:
        res = traced_cli(write_case(out, text), out,
                         ("inigrid", "ini", "dns"))
        rows = data_rows(os.path.join(out, "dns.out"))
        trace = read_trace(os.path.join(out, "tlab.trace"))
        _, _, flow = averages.read_avg(os.path.join(out, f"avg{COMP_STEPS}"))
    run = res["run"]
    got = comp_open_checks(tag, run, rows, COMP_STEPS)
    c = run.sim.comp
    s = run.state.rhos[0] / run.state.rho
    what = (f"NSCBC {c['nscbc'].ymin}/{c['nscbc'].ymax}" if c["nscbc"]
            else f"mixture {c['mixture'].name} (gama0 "
            f"{c['mixture'].gama0:.6f})")
    print(slice_line(f"{tag} case02 {what}, buffer", card, COMP_SHAPE,
                     COMP_STEPS, 5, res, trace))
    print(f"[13] {tag}: rho {got['rho'][0]:.6f}..{got['rho'][1]:.6f}, p "
          f"{got['p'][0]:.6f}..{got['p'][1]:.6f} (FlowLimit "
          f"{got['bounds']}); s {s.min().item():.6f}..{s.max().item():.6f}; "
          f"ini {res['seconds']['ini']:.3f} s; the last row's PMin PMax "
          f"RMin RMax {' '.join(rows[-1][7:11])}")
    require(res["launches"] == [0, 0, 0],
            f"{tag} launched {res['launches']}")
    require("buffer" in c and (c["nscbc"] is not None) == (tag == "13b1")
            and (c["mixture"] is not None) == (tag == "13b2"),
            f"{tag}: the case's parts")
    require(all(np.isfinite(v).all() for v in flow.values()),
            f"{tag}: avg columns not finite")
    substeps = COMP_STEPS * len(run.sim.P["rk"]["kdt"])
    fused = comp_launches(tag, res, 0 if tag == "13b2" else {0, substeps})
    return res["launches"], fused


def plane_means(U) -> dict:
    """13c's numbers of a final state (the keys of C14_MEANS)."""
    def mean(a):
        return a.double().mean(dim=(0, 2)).abs().max().item()
    return {"rhov_mean": mean(U.rhov), "rho_mean": mean(U.rho),
            "rhoE_mean": mean(U.rhoE), "rhos_mean": mean(U.rhos[0]),
            "rhou_max": U.rhou.abs().max().item()}


def phase_case14_fp64(card: str) -> None:
    """13c: tests/data/case14_small3d.ini as it is (32x48x8), inigrid, ini
    and dns in float64 on the card, 10 steps: dns.out equal to tlab_tpu's
    float64 rows in every printed digit, and the final plane means to
    C14_MEANS_TOL of tlab_tpu's."""
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as out:
        res = traced_cli(write_case(out, CASE14.read_text()), out,
                         ("inigrid", "ini", "dns"), "--x64")
        rows = data_rows(os.path.join(out, "dns.out"))
    got = [" ".join(r) for r in rows]
    means = plane_means(res["run"].state)
    dev = {k: abs(means[k] - C14_MEANS[k]) / abs(C14_MEANS[k])
           for k in C14_MEANS}
    print(f"[13] 13c case14 {C14_SHAPE} fp64 on the card ({card}), "
          f"{C14_STEPS} steps: dns.out rows equal to tlab_tpu's fp64 "
          f"{sum(a == b for a, b in zip(got, C14_ROWS))} of {len(C14_ROWS)}; "
          f"last row {got[-1]}; the final plane means against tlab_tpu's: "
          + ", ".join(f"{k} {means[k]:.12e} ({dev[k]:.1e}, limit "
                      f"{C14_MEANS_TOL[k]})" for k in C14_MEANS))
    require(tuple(got) == C14_ROWS, f"13c: dns.out {got}")
    require(all(dev[k] <= C14_MEANS_TOL[k] for k in dev), f"13c: {dev}")
    require(res["launches"] == [0, 0, 0], f"13c launched {res['launches']}")


def phase_case14_fp32() -> None:
    """13d: case14 as it is, 5 RK4 steps of C14_DT from its initial state
    (ini in fp64), fp32 against fp64 on the card, each field held to 2x
    tlab_tpu's own fp32 drift on the same inputs (C14_WITNESS)."""
    from tlab_tpu_torch.dycore import compressible as comp
    from tlab_tpu_torch.tools.initialize import compressible_initial_state
    text = CASE14.read_text()
    start, out = None, {}
    for dtype in (torch.float64, torch.float32):
        sim = Simulation.from_case(load_case(Ini(text=text)), dtype=dtype,
                                   device="cuda")
        if start is None:
            start = compressible_initial_state(sim)
        U = comp.CompState(*(a.to(dtype) for a in start))
        sim.attach_buffer_compressible(U)
        c = sim.comp
        for _ in range(5):
            U, _ = comp.rk_step_airwater(
                sim.P, U, C14_DT, c["aw"], sim.nsp.visc, c["prandtl"],
                c["schmidt"], nscbc=c["nscbc"], ly=c["ly"], gvec=c["gvec"],
                buffer=c["buffer"])
        out[dtype] = {"rho": U.rho, "rhou": U.rhou, "rhov": U.rhov,
                      "rhoE": U.rhoE, "rhos": U.rhos[0]}
    drift = {k: ((out[torch.float32][k].double() - out[torch.float64][k])
                 .abs().max() / out[torch.float64][k].abs().max()).item()
             for k in C14_WITNESS}
    print("[13] 13d case14 fp32 against fp64 on the card, 5 RK4 steps of dt "
          f"{C14_DT}: " + ", ".join(
              f"{k} {drift[k]:.3e} (limit 2 x tlab_tpu's "
              f"{C14_WITNESS[k]:.3e})" for k in drift))
    require(all(drift[k] <= 2.0 * C14_WITNESS[k] for k in drift),
            f"13d: {drift}")


def spatial_row_names(stats) -> list:
    """The names of make_comp_spatial_reducer's rows, in its order."""
    from tlab_tpu_torch.stats import spatial_registers
    names = [f"{n}^{k}" for n in stats.names for k in range(1, 5)]
    names += [f"{a}{b}" for a, b in stats.pairs]
    names += [f"{g}^{k}" for g in stats.GRAD_NAMES for k in (1, 2)]
    names += [f"{stats.GRAD_NAMES[a]}*{stats.GRAD_NAMES[b]}"
              for a, b in stats.GRADX_PAIRS]
    names += ["p", "p^2", "pu", "pv", "pw"] + [f"p*{g}"
                                               for g in stats.GRAD_NAMES]
    names += ["".join(t) for t in stats.TRIPLES]
    names += [f"comp {n}" for n in stats.COMP_NAMES]
    return names + list(spatial_registers.NAMES)


def phase_spatial_comp(card: str) -> list:
    """13e: case02_small3d.ini with Type=spatial at 256x128x128, inigrid,
    ini and dns, 5 steps: avg_zt5 and avgMA_zt5 written and finite; the
    device reduction of the final state against an fp64 host evaluation of
    the same sums on the same state."""
    text = comp_case(SPATIAL_COMP_SHAPE, SPATIAL_COMP_STEPS,
                     {("Main", "Type"): "spatial"})
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as out:
        res = traced_cli(write_case(out, text), out,
                         ("inigrid", "ini", "dns"))
        rows = data_rows(os.path.join(out, "dns.out"))
        trace = read_trace(os.path.join(out, "tlab.trace"))
        tabs = {}
        for name in (f"avg_zt{SPATIAL_COMP_STEPS}",
                     f"avgMA_zt{SPATIAL_COMP_STEPS}"):
            path = os.path.join(out, name)
            require(os.path.exists(path), f"13e: no {name}")
            tabs[name] = np.loadtxt(path, skiprows=3)
    run = res["run"]
    got = comp_open_checks("13e", run, rows, SPATIAL_COMP_STEPS)
    sim, U = run.sim, run.state
    stats = spatial.SpatialStats.create(
        sim.grid.x.size, sim.grid.y.size,
        ["u", "v", "w"] + [f"s{i + 1}" for i in range(sim.nsp.n_scalars)])
    t0 = time.perf_counter()
    dev = spatial.make_comp_spatial_reducer(sim, stats)(U)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    sim64 = Simulation.from_case(load_case(Ini(text=text)),
                                 dtype=torch.float64, device="cpu")
    U64 = type(U)(*(a.to("cpu", torch.float64) for a in U))
    t0 = time.perf_counter()
    host = spatial.make_comp_spatial_reducer(sim64, stats)(U64)
    host_s = time.perf_counter() - t0
    # the term sizes: the same sums of |fields| with |D1| and |[D1;D2]|
    P_abs = {k: v.abs() if k.startswith("d1") and torch.is_tensor(v) else v
             for k, v in sim64.P.items()}
    scale = spatial.make_comp_spatial_reducer(
        dataclasses.replace(sim64, P=P_abs), stats)(
        type(U)(*(a.abs() for a in U64))).flatten(1).max(dim=1).values
    dev = dev.to("cpu", torch.float64)
    err = ((dev - host).abs().flatten(1).max(dim=1).values
           / torch.where(scale > 0, scale, torch.ones_like(scale)))
    row_names = spatial_row_names(stats)
    require(len(row_names) == dev.shape[0], "13e: the reducer's rows")
    worst = row_names[int(err.argmax())]
    print(rate_line("13e case02 Type=spatial", card, SPATIAL_COMP_SHAPE,
                    SPATIAL_COMP_STEPS, 5, trace, res, "13"))
    print(f"[13] 13e: rho {got['rho'][0]:.6f}..{got['rho'][1]:.6f}; "
          + "; ".join(f"{k} {v.shape[0]} rows x {v.shape[1]} columns, "
                      f"finite {bool(np.isfinite(v).all())}"
                      for k, v in tabs.items())
          + f"; the device reduction ({dev.shape[0]} rows, {dev_s:.3f} s) "
          f"against fp64 on the host ({host_s:.3f} s), over each row's "
          f"term size: max {err.max().item():.3e} (limit "
          f"{SPATIAL_SUMS_TOL}; the largest "
          + ", ".join(f"{row_names[i]} {err[i].item():.2e}"
                      for i in err.argsort(descending=True)[:4].tolist())
          + "); "
          f"the spatial sums a step "
          f"{trace[f'spatial sums {SPATIAL_COMP_STEPS}'][1]:.3f} s")
    require(all(np.isfinite(v).all() and v.size for v in tabs.values()),
            "13e: station tables empty or not finite")
    require(err.max().item() <= SPATIAL_SUMS_TOL,
            f"13e: device sums {err.max().item()} from fp64 (row {worst})")
    require(res["launches"] == [0, 0, 0], f"13e launched {res['launches']}")
    return res["launches"]


# ---------------------------------------------------------------------------
# phase 14: the statistics (A14) -- the diagnostic pressure through K1-K3,
# the in-run pdfs, spectra and phase averages, the post-processing commands
# ---------------------------------------------------------------------------

STATS_STEPS = 4          # dns steps; the restart and the statistics at 4
PHASE_STRIDE = 2         # [Iteration] PhaseAvg: accumulations at 2 and 4
STATS_KEYS = ["Pdfs=yes", "Intermittency=yes", "Spectrums=yes",
              "Correlations=yes"]
# (command, its arguments, diagnostic pressure solves): one solve a snapshot
# in `averages` (shared by the flow and the scalar tables; tlab_tpu solves
# it again for each scalar table) and in `pdfs`; `dns` solves one a PhaseAvg
# accumulation.  Each solve launches each of K1-K3 once on the velocity
# stack (F = 3), twice with PressureDecomposition=advection|diffusion
POST_COMMANDS = (("averages", ["--gate-scalar", "1"], 1), ("pdfs", [], 1),
                 ("spectra", [], 0), ("superlayer", [], 0),
                 ("stats2nc", [], 0))
POISSON_TOL = 1e-9       # fp64 round-off; a wrong sign or boundary value O(1)
# the fp32 diagnostic pressure against fp64 on one seeded state of the
# shear layer at 128x64x64 (pressure_witness_fields), per decomposition:
# tlab_tpu's own fp32 drift there (tests/test_torch_fp32.py::
# test_diagnostic_pressure_in_float32_drifts_as_tlab_tpus); the card's run
# is held to 2x it
PRESSURE_SMALL = (128, 64, 64)
PRESSURE_WITNESS = {"total": 1.363e-6, "advection": 1.065e-6}
COLUMN_TOL = 1e-6        # offline avg against the in-run avg of one state
PARSEVAL_TOL = 1e-5      # a plane's spectrum sums against its variance, fp32
SPECTRUM_FILE_TOL = 1e-6  # a spectrum file against its fp32 evaluation
PHASE_TOL = 1e-6         # a phavg slot mean against the field's z-mean


def pressure_witness_fields(shape, y, seed: int = 14):
    """u, v, w, s1 (float64 NumPy) of a perturbed shear layer: tanh
    profiles of the case's thickness and seeded noise under a Gaussian
    envelope."""
    rng = np.random.default_rng(seed)
    yc = (y - 0.5 * (y[0] + y[-1]))[None, :, None]
    env = np.exp(-(yc / 0.1) ** 2)
    prof = np.tanh(yc / 0.0234375) * np.ones(shape)

    def noise(a):
        return a * env * rng.standard_normal(shape)

    return (0.5 * prof + noise(0.05), noise(0.05), noise(0.05),
            (0.5 - 0.5 * prof + noise(0.02))[None])


def stats_case() -> str:
    """The shear layer at full width with the in-run statistics and the
    phase averages: STATS_STEPS steps, the restart and the statistics at
    the last."""
    text = edit_case(CASE.read_text(), {
        ("Iteration", "End"): str(STATS_STEPS),
        ("Iteration", "Restart"): str(STATS_STEPS),
        ("Iteration", "Statistics"): str(STATS_STEPS)})
    text = add_keys(text, "Iteration", [f"PhaseAvg={PHASE_STRIDE}"])
    return add_keys(text, "Statistics", STATS_KEYS)


def pressure_columns(sim, state, p) -> set:
    """The columns of the avg tables that read the pressure: those that
    move when it does (the scalar table's as "s:<name>")."""
    ex = averages.build_extras(sim, state)
    tabs = []
    for q in (p, 2.0 * p + 1.0):
        flow = averages.flow_statistics(sim.P, state, sim.nsp.visc, p=q,
                                        extras=ex)
        scal = averages.scalar_statistics(
            sim.P, state, sim.nsp.diffusivity(0), 0, p=q,
            visc=sim.nsp.visc, extras=ex)
        tabs.append(averages.to_host(flow, [scal]))
    (fa, (sa,)), (fb, (sb,)) = tabs
    return {k for k in fa if not np.array_equal(fa[k], fb[k])} | \
        {f"s:{k}" for k in sa if not np.array_equal(sa[k], sb[k])}


def volume_bins(vol: np.ndarray, nbins: int) -> np.ndarray:
    """The bin of each counted sample of the whole-volume row: the
    reference's two-pass range (reference_formats.pdf1v2d + pdf_analize),
    the truncated bin indices, the outliers dropped."""
    from tlab_tpu_torch.io import reference_formats as rf
    lo, hi = rf.pdf_analize(nbins, rf.pdf1v2d(vol, nbins, ilim=1))
    step = (hi - lo) / nbins
    up = ((vol - lo) / (step if step != 0.0 else 1.0)).astype(np.int64)
    return up[(up >= 0) & (up <= nbins - 1)]


def check_pdf_file(path: str, field, y, nbins: int = 32) -> np.ndarray:
    """A pdf file of `field` (on the card) against NumPy's host table of
    the same float32 field, byte for byte after the time stamp; the
    device table against it bin for bin; the counts' sums.  Returns the
    device table."""
    from tlab_tpu_torch.io import reference_formats as rf
    from tlab_tpu_torch.stats.pdfs import pdf1v_plane_table_device
    nx, ny, nz = field.shape
    host = rf.pdf1v_plane_table(field.cpu().numpy(), nbins)
    dev = pdf1v_plane_table_device(field, nbins).cpu().numpy()
    moved = int(np.abs(dev[:, :nbins] - host[:, :nbins]).sum())
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as hdir:
        ref = open(rf.write_pdf_file(hdir, "ref", 0.0, y, host, nbins),
                   "rb").read()
    with open(path, "rb") as fh:
        body = fh.read()
    require(body[4:] == ref[4:] and moved == 0,
            f"14 {os.path.basename(path)}: the file or the device table "
            f"differs from NumPy's ({moved} samples moved)")
    require(np.all(dev[:-1, :nbins].sum(1) <= nx * nz)
            and dev[-1, :nbins].sum() <= nx * ny * nz,
            f"14 {os.path.basename(path)}: counts beyond the samples")
    return dev


def count_beyond_fp32(sim, st) -> dict:
    """The whole-volume row of |grad s1|^2 (pdfs mode 2's GiGi): the free
    streams put most of the 33.5 M samples in its first bin, past 2^24.
    The device table against an int64 count of the same range, and what a
    float32 counter of the field's dtype (tlab_tpu's) holds there."""
    from tlab_tpu_torch import mappings
    from tlab_tpu_torch.stats.pdfs import pdf1v_plane_table_device
    g = mappings.gradient_magnitude2(sim.P, st.s[0])
    dev = pdf1v_plane_table_device(g, 32)[-1, :32].cpu().numpy()
    vol = g.reshape(-1).cpu().numpy()
    bins = volume_bins(vol, 32)
    ref64 = np.bincount(bins, minlength=32)
    require(np.array_equal(dev.astype(np.int64), ref64),
            "14 GiGi: the volume row against an int64 count")
    top = int(np.argmax(ref64))
    require(ref64[top] > 2 ** 24, f"14 GiGi: the largest bin {ref64[top]} "
            f"<= 2^24")
    # a float32 counter, one atomic addition of 1 a sample as tlab_tpu's
    # scatter-add in the field's dtype: its largest bin stops at 2^24
    idx = torch.as_tensor(bins, device="cuda")
    fp32 = torch.zeros(32, dtype=torch.float32, device="cuda").index_add_(
        0, idx, torch.ones(idx.shape, dtype=torch.float32, device="cuda"))
    return {"top": int(ref64[top]), "top_fp32": float(fp32[top].item()),
            "counted": (int(ref64.sum()), vol.size)}


def diagnostic_pressure_checks(text: str, fields) -> dict:
    """The diagnostic pressure of the restart's `fields` in fp64 on the
    card against the discrete Poisson problem it solves, in fp32 (K1-K3)
    against fp64 at full width; and at PRESSURE_SMALL on seeded fields, fp32
    against fp64 for two decompositions, held to 2x tlab_tpu's drift."""
    from tlab_tpu_torch.dycore.pressure import (pressure_boussinesq,
                                                pressure_forcing)
    res = {}
    p = {}
    for dtype in (torch.float64, torch.float32):
        sim = Simulation.from_case(load_case(Ini(text=text)), dtype=dtype,
                                   device="cuda")
        st = state_from_numpy(*fields, "cuda", dtype)
        burgers.reset_launches()
        if dtype == torch.float64:
            div, bcs_b, bcs_t = pressure_forcing(sim.P, st)
            p[dtype] = elliptic.poisson(sim.P["ell"], div, bcs_b=bcs_b,
                                        bcs_t=bcs_t)
            res["residual"] = elliptic.poisson_residual(
                sim.fdm, p[dtype], div, bcs_b, bcs_t)
            res["residual_flipped"] = elliptic.poisson_residual(
                sim.fdm, -p[dtype], div, bcs_b, bcs_t)
            del div, bcs_b, bcs_t
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p[dtype] = pressure_boussinesq(sim.P, st)
            torch.cuda.synchronize()
            res["ms"] = 1e3 * (time.perf_counter() - t0)
        res[f"launches_{dtype}"] = list(burgers.contract_launches["highest"])
        del sim, st
    p64 = p[torch.float64]
    res["full"] = ((p[torch.float32].double() - p64).abs().max()
                   / p64.abs().max()).item()
    del p, p64
    small = shear_case(PRESSURE_SMALL, 1)
    for dcmp in PRESSURE_WITNESS:
        ps = {}
        for dtype in (torch.float64, torch.float32):
            sim = Simulation.from_case(load_case(Ini(text=small)),
                                       dtype=dtype, device="cuda")
            st = state_from_numpy(*pressure_witness_fields(
                PRESSURE_SMALL, sim.grid.y.nodes), "cuda", dtype)
            burgers.reset_launches()
            ps[dtype] = pressure_boussinesq(sim.P, st, dcmp).double()
            ps[f"launches_{dtype}"] = list(
                burgers.contract_launches["highest"])
        res[f"small_{dcmp}"] = ((ps[torch.float32] - ps[torch.float64])
                                .abs().max()
                                / ps[torch.float64].abs().max()).item()
        res[f"small_launches_{dcmp}"] = ps[f"launches_{torch.float32}"]
    return res


def phase_stats(card: str, initial: str) -> dict:
    """14: `dns` of the shear layer at 512x256x256 fp32 from 6a's fields
    with [Statistics] Pdfs/Intermittency/Spectrums/Correlations and
    [Iteration] PhaseAvg, then averages, pdfs, spectra, superlayer and
    stats2nc of its restart through the CLI, the kernels' counts set to 0
    before each command and read after; each output held."""
    from tlab_tpu_torch.dycore.pressure import pressure_boussinesq
    from tlab_tpu_torch.stats import spectra
    text = stats_case()
    it = STATS_STEPS
    launches, seconds, peaks = {}, {}, {}
    out_info = {}
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as out:
        ini = write_case(out, text)
        link_initial_fields(initial, out)
        res = traced_cli(ini, out, ("dns",))
        trace = read_trace(os.path.join(out, "tlab.trace"))
        sim = res["run"].sim
        del res["run"]
        launches["dns"], peaks["dns"] = res["launches"], res["peak"]
        seconds["dns"] = res["seconds"]["dns"]
        n_sub = len(sim.P["rk"]["kdt"])
        n_phase = STATS_STEPS // PHASE_STRIDE
        want = [STATS_STEPS * n_sub + n_phase] * 3
        require(launches["dns"] == want,
                f"14 dns launched {launches['dns']}, expected {want}")
        # the in-run tables of step `it`, before `averages` and `pdfs`
        # rewrite them
        inrun = {n: averages.read_avg(os.path.join(out, n))[2]
                 for n in (f"avg{it}", f"avg{it}s1")}
        inrun_pdf = {t: open(os.path.join(out, f"pdf{it}.{t}"), "rb").read()
                     for t in ("u", "v", "w", "s1")}
        for command, extra, solves in POST_COMMANDS:
            burgers.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            seconds[command] = run_cli(command, ini, out, "--files", str(it),
                                       *extra)
            launches[command] = list(burgers.contract_launches["highest"])
            peaks[command] = torch.cuda.max_memory_allocated()
            require(launches[command] == [solves] * 3,
                    f"14 {command} launched {launches[command]}, expected "
                    f"{[solves] * 3}")
        names = set(os.listdir(out))
        need = {f"phavg{it}.npz", f"int{it}", f"cavg{it}", f"sl{it}.npz",
                f"avg{it}.nc"} | {f"pdf{it}.{t}" for t in
                                  ("u", "v", "w", "p", "s1")} | {
            f"{k}{it}.{e}{t}" for k, e in (("xsp", "E"), ("zsp", "E"),
                                           ("xcr", "C"), ("zcr", "C"),
                                           ("rsp", "E"))
            for t in ("uu", "vv", "ww", "11") if k != "rsp" or e == "E"}
        require(need <= names, f"14: missing {sorted(need - names)}")

        # the restart's fields on the card, as the commands read them
        fields = [np.ascontiguousarray(a) for a in fields_io.read_state(
            os.path.join(out, "flow"), os.path.join(out, "scal"), it, 1)[:4]]
        st = state_from_numpy(*fields, "cuda", torch.float32)
        nx, ny, nz = MAIN_SHAPE
        y = sim.grid.y.nodes
        p = pressure_boussinesq(sim.P, st)

        # the offline avg against the in-run one of the same state: the
        # columns that read no pressure; the pressure columns finite
        pcols = pressure_columns(sim, st, p)
        col_err, worst = 0.0, ""
        for name, table in inrun.items():
            _, _, off = averages.read_avg(os.path.join(out, name))
            tag = "s:" if name.endswith("s1") else ""
            for k, ref in table.items():
                require(np.isfinite(off[k]).all(), f"14 {name} {k} finite")
                if k == "Y" or tag + k in pcols:
                    continue
                e = float(np.abs(off[k] - ref).max()
                          / max(np.abs(ref).max(), 1e-300))
                if e > col_err:
                    col_err, worst = e, f"{name} {k}"
        require(col_err <= COLUMN_TOL,
                f"14 offline avg against in-run: {worst} {col_err}")

        # pdfs: the offline (pdfs) files against NumPy's host tables of the
        # same fields, the in-run (dns) ones of the same step equal to them
        for tag, field in (("s1", st.s[0]), ("u", st.u), ("p", p)):
            dev = check_pdf_file(os.path.join(out, f"pdf{it}.{tag}"), field,
                                 y)
            out_info[f"top_{tag}"] = int(dev[-1, :32].max())
        for tag, body in inrun_pdf.items():
            require(open(os.path.join(out, f"pdf{it}.{tag}"), "rb").read()
                    == body, f"14 pdf{it}.{tag}: in-run and offline differ")
        out_info.update(count_beyond_fp32(sim, st))

        # spectra: Parseval on the card; the files their fp32 evaluation
        spec_err, file_err = 0.0, 0.0
        for tag, field in (("uu", st.u), ("11", st.s[0])):
            a = field - field.mean(dim=(0, 2), keepdim=True)
            var = (a * a).mean(dim=(0, 2))
            for e in (spectra.spectrum_x(a), spectra.spectrum_z(a)):
                spec_err = max(spec_err, ((e.sum(0) - var).abs().max()
                                          / var.max()).item())
            want_x = (0.5 * spectra.spectrum_x(field)[: nx // 2]).cpu()
            have = np.fromfile(os.path.join(out, f"xsp{it}.E{tag}"), "<f4")
            file_err = max(file_err, float(
                np.abs(have - want_x.numpy().T.ravel()).max()
                / want_x.abs().max()))
        require(spec_err <= PARSEVAL_TOL, f"14 Parseval {spec_err}")
        require(file_err <= SPECTRUM_FILE_TOL, f"14 xsp file {file_err}")

        # the phase averages: one accumulation in each of the 2 slots;
        # slot 0 holds step `it`, its means the fields' z-means
        ph = np.load(os.path.join(out, f"phavg{it}.npz"))
        require(list(ph["counts"]) == [1] * n_phase,
                f"14 phavg counts {list(ph['counts'])}")
        names_ph = [str(n) for n in ph["names"]]
        ph_err = 0.0
        for k, f in (("u", st.u), ("v", st.v), ("w", st.w), ("s1", st.s[0]),
                     ("p", p)):
            zm = f.double().mean(dim=2).cpu().numpy()
            ph_err = max(ph_err, float(
                np.abs(ph["sums"][0, names_ph.index(k)] - zm).max()
                / max(np.abs(zm).max(), 1e-30)))
        require(ph_err <= PHASE_TOL, f"14 phavg slot means {ph_err}")

        # superlayer: heights inside the grid, each height pdf all points
        sl = np.load(os.path.join(out, f"sl{it}.npz"))
        for k in ("y_upper", "y_lower"):
            require(sl[k].min() >= y[0] and sl[k].max() <= y[-1],
                    f"14 {k} outside the grid")
        for k in ("up_pdf", "lo_pdf"):
            require(round(float(sl[k].sum()) * nx * nz) == nx * nz,
                    f"14 {k} sums to {sl[k].sum()}")
        require(sl["up_mean"] > sl["lo_mean"], "14 the interfaces' order")
        out_info["sl"] = (float(sl["lo_mean"]), float(sl["up_mean"]))

        # stats2nc: the NetCDF table is the ASCII one to float32 rounding
        _, g_nc, c_nc = averages.read_avg_nc(os.path.join(out,
                                                          f"avg{it}.nc"))
        _, g_a, c_a = averages.read_avg(os.path.join(out, f"avg{it}"))
        require(g_nc == g_a and all(np.array_equal(
            c_nc[k], np.float32(c_a[k]).astype(float)) for k in c_a),
            "14 avg.nc differs from avg")
        del st, p, sim
    diag = diagnostic_pressure_checks(text, fields)
    return {"launches": launches, "seconds": seconds, "peaks": peaks,
            "trace": trace, "n_sub": n_sub, "col_err": col_err,
            "pcols": len(pcols), "spec_err": spec_err,
            "file_err": file_err, "ph_err": ph_err, "diag": diag,
            **out_info}


def report_stats(card: str, r: dict) -> None:
    """Phase 14's lines, and its limits on the diagnostic pressure."""
    rate = step_rate(r["trace"], STATS_STEPS, r["n_sub"])
    d = r["diag"]
    print(f"[14] dns with [Statistics] Pdfs/Intermittency/Spectrums/"
          f"Correlations and PhaseAvg={PHASE_STRIDE} ({card}): "
          f"{MAIN_SHAPE} fp32, {STATS_STEPS} adaptive-dt steps with their "
          f"host syncs {rate['seconds']:.4f} s: {rate['ms_substep']:.3f} "
          f"ms/substep, {rate['rate']:.6e} points/s/substep (first step "
          f"{rate['each'][0]:.4f} s, the others' median "
          f"{rate['others_ms_substep']:.3f} ms/substep); one statistics "
          f"(tables, pdfs, spectra) "
          f"{r['trace'][f'statistics {STATS_STEPS}'][1]:.3f} s")
    for cmd in ["dns"] + [c for c, _, _ in POST_COMMANDS]:
        print(f"[14] {cmd}: {r['seconds'][cmd]:.3f} s, peak device memory "
              f"{r['peaks'][cmd]} B, launches {r['launches'][cmd]}")
    print(f"[14] offline avg{STATS_STEPS} against the in-run one: "
          f"{r['col_err']:.3e} of each column's max (limit {COLUMN_TOL}; "
          f"{r['pcols']} pressure columns finite); pdf files of s1, u, p "
          f"equal to NumPy's tables of the fields byte for byte; the "
          f"volume row of |grad s1|^2: largest bin {r['top']} > 2^24 = "
          f"{2 ** 24} ({r['counted'][0]} of {r['counted'][1]} samples), "
          f"equal to an int64 count (a float32 counter: "
          f"{r['top_fp32']:.0f}; the largest volume bin of s1 "
          f"{r['top_s1']}, u {r['top_u']}, p {r['top_p']}); Parseval {r['spec_err']:.3e} (limit "
          f"{PARSEVAL_TOL}); xsp files {r['file_err']:.3e} (limit "
          f"{SPECTRUM_FILE_TOL}); phavg slot means {r['ph_err']:.3e} "
          f"(limit {PHASE_TOL}); interfaces at y = {r['sl'][0]:.4f} and "
          f"{r['sl'][1]:.4f}")
    print(f"[14] the diagnostic pressure of the restart: fp64 against the "
          f"Poisson problem it solves {d['residual']:.3e} (limit "
          f"{POISSON_TOL}; -p reads {d['residual_flipped']:.3e}); fp32 "
          f"{d['ms']:.3f} ms with launches "
          f"{d['launches_torch.float32']}, against fp64 "
          f"{d['full']:.3e}; at {PRESSURE_SMALL}: "
          + "; ".join(f"{k} {d[f'small_{k}']:.3e} (limit "
                      f"{2.0 * w:.3e}: 2x tlab_tpu's {w:.3e}), launches "
                      f"{d[f'small_launches_{k}']}"
                      for k, w in PRESSURE_WITNESS.items()))
    require(d["residual"] <= POISSON_TOL,
            f"14 Poisson residual {d['residual']}")
    require(d["launches_torch.float64"] == [0, 0, 0]
            and d["launches_torch.float32"] == [1, 1, 1],
            f"14 pressure launches {d['launches_torch.float32']}")
    for k, w in PRESSURE_WITNESS.items():
        require(d[f"small_{k}"] <= 2.0 * w,
                f"14 fp32 pressure ({k}) {d[f'small_{k}']} > 2x {w}")
        want = [2, 2, 2] if k == "advection" else [1, 1, 1]
        require(d[f"small_launches_{k}"] == want,
                f"14 {k} launches {d[f'small_launches_{k}']}")


# ---------------------------------------------------------------------------
# phase 15: I/O and Lagrangian particles (A15) -- the particle step through
# K1-K3 from inipart's file, the part/trajectory/pdf files, [SavePlanes] and
# [SaveTowers] with their NetCDF converters, the restart engine
# ---------------------------------------------------------------------------

PARTICLE_CASE = ROOT / "examples" / "particle_shear" / "tlab.ini"
PARTICLE_SHAPE = (256, 128, 64)
PARTICLE_STEPS = 10          # 15a; the case's End=40 cut
OTHER_PARTICLE_STEPS = 5     # 15b
N_TRAJ = 32                  # the case's [Particles] TrajNumber
# tests/test_torch_particles.py's witness: its 32x24x16 copy of
# tests/data/case01_small3d.ini, 300 tracers, 5 steps of dt 0.01, fp32
# against fp64: tlab_tpu's own drift there (x64 off, as its CLI runs), the
# port's is held to 2x it (both read 2.583e-07 on the CPU)
PARTICLE_WITNESS = 2.583e-07
WITNESS_STEPS, WITNESS_DT, WITNESS_N = 5, 0.01, 300
# tracers in a uniform u = 0.7 for 20 steps of dt 0.01 (tests/
# test_particles.py::test_tracer_uniform_advection) against x0 + u t: fp32
# rounding of ~2.0 over 100 substeps; a sign error reads 0.28
UNIFORM_TOL = 1e-5
# the full-width fp32 positions against fp64 from the same files, 10 steps
# of the same fixed dt: a wrong sign or index reads O(1)
FULL_POS_TOL = 1e-3
# the scatter-add (index_put_ with accumulate: atomics in any order on the
# card) of a seeded value a particle at 15a's final positions, fp32 against
# the fp64 scatter of the same values and positions, and the field's total
# against the values' sum, each over the size of its terms: fp32 rounding of
# the weights and of a few sums (~1e-7); a dropped corner reads ~0.1
SCATTER_TOL = 1e-5
PLANES_STEPS = 5             # 15c shear layer: planes and restart at 5
PLANES = {"j": (1, 128, 255), "k": (0, 100)}     # 0-based node indices
TOWER_STEPS = 4              # 15c Ekman layer: statistics and restart at 4
TOWER_TOL = 1e-6             # tower means against the avg plane means


def particle_case(changes=None, keys=()) -> str:
    """examples/particle_shear/tlab.ini (256x128x64, 100,000 tracers), its
    End cut to PARTICLE_STEPS, restart and statistics there."""
    text = edit_case(PARTICLE_CASE.read_text(), {
        ("Iteration", "End"): PARTICLE_STEPS,
        ("Iteration", "Restart"): PARTICLE_STEPS,
        ("Iteration", "Statistics"): PARTICLE_STEPS, **(changes or {})})
    return add_keys(text, "Particles", list(keys)) if keys else text


def cloud_particle_case(shape, steps: int) -> str:
    """tests/test_particles.py::test_bil_cloud_radiation_coupling's case
    (tests/data/case01_small.ini with two Tanh scalars and [Infrared]
    grayliquid on scalar 1) at `shape` (z periodic), with the AirWaterLinear
    mixture
    whose liquid the droplets start from (l = 0.1 softplus((1 - 2 s1 +
    0.5 s2) / 0.1): ~0 in the upper stream, ~1 in the lower) and 100,000
    BilinearCloudFour particles (droplet constants (-2, 0.5, 0.1))."""
    text = (ROOT / "tests" / "data" / "case01_small.ini").read_text()
    text = text.replace("Schmidt=1.0", "Schmidt=1.0,1.0").replace(
        "[Scalar]\nProfileScalar1=Tanh", "[Scalar]\nProfileScalar2=Tanh\n"
        "ThickScalar2=0.05\nDeltaScalar2=-1.0\nMeanScalar2=0.5\n"
        "Scalar2Jmin=neumann\nScalar2Jmax=neumann\nProfileScalar1=Tanh")
    require("ProfileScalar2" in text, "15b: the two-scalar case")
    text = edit_case(text, {**grid_keys(shape), ("Grid", "ZPeriodic"): "yes",
                            ("IniGridOz", "periodic"): "yes",
                            ("Iteration", "End"): steps,
                            ("Iteration", "Restart"): steps,
                            ("Iteration", "Statistics"): steps})
    return text + (
        "\n[Infrared]\nType=grayliquid\nScalar=1\n"
        "BoundaryConditions=1.0, 0.0\nAbsorptionComponent1=10.0\n"
        "\n[Thermodynamics]\nType=anelastic\nMixture=AirWaterLinear\n"
        "Parameters=-2.0,0.5,0.1\n"
        "\n[Particles]\nType=BilinearCloudFour\nNumber=100000\n"
        "DiamIniP=0.3\nYMeanRelativeIniP=0.5\n")


def recording_particle_step(store: list):
    """dns' particle step wrapped: after each step the positions' per-axis
    min and max and the props, kept on the card (no sync)."""
    inner = dns_tool.rk_step_with_particles

    def step(*args):
        state, ps = inner(*args)
        store.append((torch.stack([ps.x.amin(0), ps.x.amax(0)]),
                      ps.props.clone()))
        return state, ps
    return inner, step


def particle_cli(text: str, out: str, initial=None) -> dict:
    """inigrid, ini (or the given initial fields), inipart and dns of `text`
    through the CLI with the particle step recorded; the traced_cli result
    with the records and the trace."""
    ini = write_case(out, text)
    commands = ("inigrid", "ini", "inipart", "dns")
    if initial is not None:
        link_initial_fields(initial, out)
        commands = ("inipart", "dns")
    store = []
    inner, dns_tool.rk_step_with_particles = recording_particle_step(store)
    try:
        res = traced_cli(ini, out, commands)
    finally:
        dns_tool.rk_step_with_particles = inner
    res["records"] = store
    res["trace"] = read_trace(os.path.join(out, "tlab.trace"))
    return res


def particle_launches(sim, steps: int) -> list:
    """K1-K3 launches of `dns` with particles over `steps` steps with the
    statistics at the last: one a substep, and one diagnostic pressure
    solve for the flow table and one for each scalar table (the particle
    step returns no projection pressure, as tlab_tpu's, so the tables
    solve for it as tlab_tpu's do)."""
    return [steps * len(sim.P["rk"]["kdt"]) + 1 + sim.nsp.n_scalars] * 3


def check_inside(tag: str, grid, records) -> None:
    """x and z in [x0, x0 + L], y in [y0, y1] after every step (the fp32
    wrap of a position a rounding below x0 lands on x0 + L, the same point
    of the periodic axis)."""
    lo = [grid.x.nodes[0], grid.y.nodes[0], grid.z.nodes[0]]
    hi = [grid.x.nodes[0] + grid.x.scale, grid.y.nodes[-1],
          grid.z.nodes[0] + grid.z.scale]
    for n, (ext, _) in enumerate(records):
        mn, mx = ext.double().cpu().numpy()
        require(all(mn[d] >= lo[d] for d in range(3))
                and all(mx[d] <= hi[d] for d in range(3)),
                f"{tag}: a particle outside the domain after step {n + 1}: "
                f"{mn} {mx}")


def particle_share(sim, run, pprops) -> dict:
    """ms of one RK step with the particles (rk_step_with_particles) on the
    run's final state and of its particle work alone (per substep: the
    gather of u, v, w, the update and the wrap), CUDA events, median of
    REPS."""
    from tlab_tpu_torch.particles import core as pcore
    locate = pcore.make_locator(sim.grid)
    state, ps = run.state, run.pstate
    kdt = sim.P["rk"]["kdt"]
    dt = 1e-3

    def full():
        dns_tool.rk_step_with_particles(sim.P, sim.grid, locate, pprops,
                                        state, ps, dt)

    def particles():
        x = ps
        for k in kdt:
            dx, dv = pcore.particle_rhs(pprops, x, locate, state.u, state.v,
                                        state.w)
            x = x._replace(x=pcore.wrap_positions(sim.grid, x.x + dt * k * dx),
                           v=x.v + dt * k * dv)

    out = {}
    for key, fn in (("step", full), ("particles", particles)):
        fn()
        out[key] = statistics.median(event_ms(fn) for _ in range(REPS))
    return out


def scatter_check(sim, pstate) -> dict:
    """particles_to_field on the card at `pstate`'s positions (SCATTER_TOL):
    max|f32 - f64| / max|f64| and |sum f32 - sum values| / sum |values|."""
    from tlab_tpu_torch.particles import core as pcore
    locate = pcore.make_locator(sim.grid)
    gen = torch.Generator(device=pstate.x.device).manual_seed(3)
    vals = torch.randn(pstate.x.shape[0], generator=gen,
                       device=pstate.x.device)
    f32 = pcore.particles_to_field(vals, locate(pstate.x), sim.grid.shape)
    f64 = pcore.particles_to_field(vals.double(), locate(pstate.x.double()),
                                   sim.grid.shape)
    v64 = vals.double()
    return {"field": ((f32.double() - f64).abs().max()
                      / f64.abs().max()).item(),
            "total": ((f32.double().sum() - v64.sum()).abs()
                      / v64.abs().sum()).item()}


def uniform_advection() -> float:
    """tests/test_particles.py::test_tracer_uniform_advection on the card in
    fp32: 100 tracers in u = 0.7, 20 steps of dt 0.01 through
    rk_step_with_particles (K1-K3 at 32x33x16); max over the tracers of
    |x - (x0 + u t)| modulo the box, and of the y drift."""
    from tlab_tpu_torch.fdm.plan import build_fdm_plan as fdm_plan
    from tlab_tpu_torch.grid import uniform_grid
    from tlab_tpu_torch.particles import core as pcore
    from tlab_tpu_torch.physics.params import NSParams
    grid = uniform_grid(32, 33, 16, 2.0, 1.0, 1.5)
    dev = tdevice.resolve("cuda")
    P = dyn.build_device_plans(
        fdm_plan(grid), NSParams(reynolds=1e6, schmidt=()),
        dyn.WallBCs.from_velocity_kind("freeslip", "freeslip", scalar_bcs=()),
        dtype=torch.float32, device=dev)
    u0, dt, n = 0.7, 0.01, 20
    z = torch.zeros(grid.shape, device=dev)
    state = State(u=torch.full(grid.shape, u0, device=dev), v=z, w=z,
                  s=z.new_zeros((0,) + grid.shape))
    ps = pcore.init_particles(grid, 100, seed=3, dtype=torch.float32)
    x0 = ps.x.double().cpu().numpy()
    locate = pcore.make_locator(grid)
    for _ in range(n):
        state, ps = dns_tool.rk_step_with_particles(
            P, grid, locate, pcore.ParticleProps(), state, ps, dt)
    x = ps.x.double().cpu().numpy()
    d = np.abs(np.mod(x[:, 0], grid.x.scale)
               - np.mod(x0[:, 0] + u0 * dt * n, grid.x.scale))
    return max(float(np.minimum(d, grid.x.scale - d).max()),
               float(np.abs(x[:, 1] - x0[:, 1]).max()))


def witness_case() -> str:
    """tests/test_torch_particles.py's SMALL: tests/data/case01_small3d.ini
    at 32x24x16."""
    text = (ROOT / "tests" / "data" / "case01_small3d.ini").read_text()
    return edit_case(text, grid_keys((32, 24, 16)))


def positions_fp32_fp64(text: str, steps: int, dt: float, n_part: int,
                        seed: int, ymean_rel: float, diam: float) -> float:
    """`steps` particle steps of fixed dt from the case's initial state
    (tools/initialize.initial_state, seed 7) and the same init_particles
    draw (the slab at ymean_rel of the y scale, `diam` wide), in fp32 and in
    fp64 on the card: max|x32 - x64| / max|x64|."""
    from tlab_tpu_torch.particles import core as pcore
    from tlab_tpu_torch.tools.initialize import initial_state
    x = {}
    fields = None
    for dtype in (torch.float64, torch.float32):
        sim = Simulation.from_case(load_case(Ini(text=text)), dtype=dtype,
                                   device="cuda")
        if fields is None:
            fields = state_to_numpy(initial_state(sim, seed=7))
        st = state_from_numpy(*fields, "cuda", dtype)
        ymean = float(sim.grid.y.nodes[0]) + ymean_rel * float(
            sim.grid.y.scale)
        ps = pcore.init_particles(sim.grid, n_part, seed=seed, ymean=ymean,
                                  diam=diam, dtype=dtype)
        locate = pcore.make_locator(sim.grid)
        for _ in range(steps):
            st, ps = dns_tool.rk_step_with_particles(
                sim.P, sim.grid, locate, pcore.ParticleProps(), st, ps, dt)
        x[dtype] = ps.x.double()
        del sim, st
    ref = x[torch.float64]
    return ((x[torch.float32] - ref).abs().max() / ref.abs().max()).item()


def phase_particles(card: str) -> dict:
    """15a: examples/particle_shear/tlab.ini at 256x128x64 through the CLI
    (inigrid, ini, inipart, dns of PARTICLE_STEPS steps); 15b: Type=Inertia
    on the same case from 15a's fields, and BilinearCloudFour on the
    radiating two-scalar case, OTHER_PARTICLE_STEPS steps each."""
    from tlab_tpu_torch.particles import io as pio
    from tlab_tpu_torch.particles.core import props_from_ini
    res = {}
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as out:
        r = particle_cli(particle_case(), out)
        run, n_sub = r["run"], len(r["run"].sim.P["rk"]["kdt"])
        sim = run.sim
        check_inside("15a", sim.grid, r["records"])
        require(len(r["records"]) == PARTICLE_STEPS,
                f"15a: {len(r['records'])} particle steps")
        ps, it = pio.read_particles(os.path.join(out,
                                                 f"part.{PARTICLE_STEPS}"),
                                    dtype=torch.float32)
        tags = ps.tags.cpu().numpy()
        require(it == PARTICLE_STEPS and ps.x.shape == (100000, 3)
                and np.unique(tags).size == 100000,
                f"15a part.{PARTICLE_STEPS}: {tuple(ps.x.shape)}, "
                f"{np.unique(tags).size} unique tags")
        require(torch.equal(ps.x, run.pstate.x),
                "15a: part file and the run's positions differ")
        traj = np.load(os.path.join(out, f"trajectories.1-{PARTICLE_STEPS}"
                                    ".npz"))
        require(traj["x"].shape == (PARTICLE_STEPS, N_TRAJ, 3)
                and list(traj["itimes"]) == list(range(1, PARTICLE_STEPS + 1))
                and list(traj["tags"]) == list(range(N_TRAJ)),
                f"15a trajectories: {traj['x'].shape}")
        require(np.array_equal(traj["x"][-1],
                                run.pstate.x[:N_TRAJ].cpu().numpy()),
                "15a: the trajectories' last row against the run")
        want = particle_launches(sim, PARTICLE_STEPS)
        require(r["launches"] == want,
                f"15a launched {r['launches']}, expected {want}")
        share = particle_share(sim, run, props_from_ini(sim.case.ini))
        res["scatter"] = scatter_check(sim, run.pstate)
        print(rate_line("15a particle_shear, 100,000 tracers", card,
                        PARTICLE_SHAPE, PARTICLE_STEPS, n_sub, r["trace"], r,
                        "particles")
              + f"; ini {r['seconds']['ini']:.3f} s, inipart "
              f"{r['seconds']['inipart']:.3f} s; one RK step on the final "
              f"state {share['step']:.3f} ms, its particle work alone "
              f"{share['particles']:.3f} ms "
              f"({100 * share['particles'] / share['step']:.1f}%)")
        res["15a"] = r["launches"]
        # 15b: inertial particles on the same fields
        initial = out
        with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as out2:
            text = particle_case(
                {("Particles", "Type"): "Inertia",
                 ("Iteration", "End"): OTHER_PARTICLE_STEPS,
                 ("Iteration", "Restart"): OTHER_PARTICLE_STEPS,
                 ("Iteration", "Statistics"): OTHER_PARTICLE_STEPS},
                ["Parameters=0.05,0.5"])
            r2 = particle_cli(text, out2, initial=initial)
            check_inside("15b inertia", r2["run"].sim.grid, r2["records"])
            v = r2["run"].pstate.v
            require(bool(torch.isfinite(r2["run"].pstate.x).all()
                         and torch.isfinite(v).all())
                    and v.abs().max().item() > 0.0,
                    "15b inertia: velocities non-finite or at rest")
            want = particle_launches(r2["run"].sim, OTHER_PARTICLE_STEPS)
            require(r2["launches"] == want,
                    f"15b inertia launched {r2['launches']}, expected {want}")
            print(rate_line("15b Type=Inertia (Stokes 0.05, settling 0.5)",
                            card, PARTICLE_SHAPE, OTHER_PARTICLE_STEPS, n_sub,
                            r2["trace"], r2, "particles")
                  + f"; max|v_p| {v.abs().max().item():.4f}")
            res["15b_inertia"] = r2["launches"]
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as out:
        r3 = particle_cli(cloud_particle_case(PARTICLE_SHAPE,
                                              OTHER_PARTICLE_STEPS), out)
        sim3 = r3["run"].sim
        n3 = len(sim3.P["rk"]["kdt"])
        check_inside("15b bil_cloud", sim3.grid, r3["records"])
        liq_min = min(p[:, :2].min().item() for _, p in r3["records"])
        prev = r3["records"][0][1][:, 2:4]
        clocks_ok = True
        for _, p in r3["records"][1:]:
            clocks_ok &= bool((p[:, 2:4] >= prev).all())
            prev = p[:, 2:4]
        final = r3["run"].pstate.props
        require(bool(torch.isfinite(final).all())
                and bool(torch.isfinite(r3["run"].state.s).all()),
                "15b bil_cloud: non-finite props or scalars")
        require(liq_min >= 0.0, f"15b bil_cloud: liquid {liq_min} < 0")
        require(clocks_ok, "15b bil_cloud: a residence clock decreased")
        require(final[:, :2].abs().max().item() > 0.0,
                "15b bil_cloud: no liquid on the droplets")
        want = particle_launches(sim3, OTHER_PARTICLE_STEPS)
        require(r3["launches"] == want,
                f"15b bil_cloud launched {r3['launches']}, expected {want}")
        print(rate_line("15b BilinearCloudFour, [Infrared] grayliquid", card,
                        PARTICLE_SHAPE, OTHER_PARTICLE_STEPS, n3, r3["trace"],
                        r3, "particles")
              + f"; liquid min {liq_min:.3e}, max "
              f"{final[:, :2].max().item():.4f}; residence clocks up to "
              f"{final[:, 2:4].max().item():.4e}, never decreasing")
        res["15b_bil_cloud"] = r3["launches"]
    del r, r2, r3, run, sim, sim3
    res["uniform"] = uniform_advection()
    res["witness"] = positions_fp32_fp64(witness_case(), WITNESS_STEPS,
                                         WITNESS_DT, WITNESS_N, 1, 0.5, 0.3)
    res["full"] = positions_fp32_fp64(particle_case(), PARTICLE_STEPS, 1e-3,
                                      100000, 7, 0.5, 0.3)
    print(f"[particles] 15a tracers in a uniform flow (32x33x16 fp32, 20 "
          f"steps) against x0 + u t: {res['uniform']:.3e} (limit "
          f"{UNIFORM_TOL}); fp32 positions against fp64 on the card: the "
          f"witness case {res['witness']:.3e} (limit "
          f"{2.0 * PARTICLE_WITNESS:.3e}: 2x tlab_tpu's "
          f"{PARTICLE_WITNESS:.3e}), particle_shear at {PARTICLE_SHAPE} "
          f"{PARTICLE_STEPS} steps of dt 1e-3 {res['full']:.3e} (limit "
          f"{FULL_POS_TOL}); the scatter-add of 100,000 values at 15a's "
          f"final positions, fp32 against fp64 {res['scatter']['field']:.3e}"
          f", its total against the values' sum "
          f"{res['scatter']['total']:.3e} (limit {SCATTER_TOL} each)")
    require(res["uniform"] <= UNIFORM_TOL,
            f"15a uniform advection {res['uniform']}")
    require(0.0 < res["witness"] <= 2.0 * PARTICLE_WITNESS,
            f"15a fp32 positions {res['witness']} > 2x {PARTICLE_WITNESS}")
    require(res["full"] <= FULL_POS_TOL, f"15a fp32 positions {res['full']}")
    require(max(res["scatter"].values()) <= SCATTER_TOL,
            f"15a scatter-add {res['scatter']}")
    return res


def planes_case() -> str:
    """The shear layer at 512x256x256 with [SavePlanes] (three j planes, two
    k planes) every PLANES_STEPS steps, the restart at PLANES_STEPS."""
    text = edit_case(CASE.read_text(), {
        ("Iteration", "End"): PLANES_STEPS,
        ("Iteration", "Restart"): PLANES_STEPS,
        ("Iteration", "Statistics"): 1000})
    text = add_keys(text, "Iteration", [f"SavePlanes={PLANES_STEPS}"])
    return text + "\n[SavePlanes]\n" + planes_keys() + "\n"


def planes_keys() -> str:
    return "\n".join(f"Planes{ax.upper()}=" + ",".join(map(str, idx))
                     for ax, idx in PLANES.items())


def towers_case() -> str:
    """examples/ekman_mesh/tlab.ini at its 128x96x128 with its [SaveTowers]
    Stride=16,1,16, without its [Parallel] mesh (ROADMAP A17); statistics
    and restart (the towers' flush) at TOWER_STEPS."""
    text = EKMAN.read_text()
    text, n = re.subn(r"^\[Parallel\]\n[^\[]*", "", text, flags=re.M)
    require(n == 1 and "[SaveTowers]\nStride=16,1,16" in text,
            "15c: the Ekman case's sections")
    return edit_case(text, {("Iteration", "End"): TOWER_STEPS,
                            ("Iteration", "Restart"): TOWER_STEPS,
                            ("Iteration", "Statistics"): TOWER_STEPS})


def nc_variables(path: str) -> dict:
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as f:
        return {k: np.array(v[:]) for k, v in f.variables.items()}


def phase_planes_towers(card: str, initial: str) -> dict:
    """15c: the shear layer's planes from 6a's fields and the Ekman layer's
    towers through the CLI, each held to the restart and the avg tables
    of its own run, and read back through planes2nc and tower2nc; 15d: one
    512x256x256 restart field through the engine and through NumPy."""
    from tlab_tpu_torch.io import reference_formats as rf
    res = {}
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as out:
        ini = write_case(out, planes_case())
        link_initial_fields(initial, out)
        r = traced_cli(ini, out, ("dns",))
        trace = read_trace(os.path.join(out, "tlab.trace"))
        n_sub = len(r["run"].sim.P["rk"]["kdt"])
        res["launches_planes"] = r["launches"]
        want = [PLANES_STEPS * n_sub] * 3
        require(r["launches"] == want,
                f"15c planes launched {r['launches']}, expected {want}")
        it = PLANES_STEPS
        fields = fields_io.read_state(os.path.join(out, "flow"),
                                      os.path.join(out, "scal"), it, 1)[:4]
        vars_ = list(fields[:3]) + [fields[3][0]]
        names = ["VelocityX", "VelocityY", "VelocityZ", "Scalar1"]
        nc_t = time.perf_counter()
        run_cli("planes2nc", ini, out, "--files", str(it))
        nc_t = time.perf_counter() - nc_t
        for axis, idx in PLANES.items():
            path = os.path.join(out, f"planes{axis.upper()}.{it}")
            data = rf.read_planes_file(path, axis, MAIN_SHAPE, 5, len(idx))
            ax = "ijk".index(axis)
            for iv, f in enumerate(vars_):
                want32 = np.take(f, idx, axis=ax).astype("<f4")
                got = np.moveaxis(data[iv], 0, ax)
                require(np.array_equal(got, want32),
                        f"15c planes{axis.upper()}.{it} variable {iv}: not "
                        "the restart's field cast to f4")
            require(np.isfinite(data[4]).all() and np.abs(data[4]).max() > 0,
                    f"15c planes{axis.upper()}.{it}: the pressure")
            nc = nc_variables(path + ".nc")
            for iv, nm in enumerate(names + ["Pressure"]):
                require(np.array_equal(nc[nm], data[iv]),
                        f"15c planes2nc {axis} {nm}")
        res["checkpoint_s"] = trace[f"checkpoint {it}"][1]
        print(rate_line("15c shear layer with [SavePlanes] "
                        + planes_keys().replace("\n", " "), card, MAIN_SHAPE,
                        PLANES_STEPS, n_sub, trace, r, "planes")
              + f"; planesJ/planesK at {it} equal to the restart's fields "
              f"cast to f4 bit for bit, planes2nc {nc_t:.3f} s equal to the "
              f"files; the checkpoint of 4 fields through the engine "
              f"{res['checkpoint_s']:.3f} s")
        # 15d: one restart field through the engine and through NumPy
        a = np.ascontiguousarray(fields[0])
        paths = {k: os.path.join(out, k) for k in ("engine", "numpy")}
        t = {}
        for key, fn in (("engine_write", lambda: fields_io.write_field(
                            paths["engine"], a, it, (0.0, 1e-3))),
                        ("numpy_write", lambda: fields_io.write_field_plain(
                            paths["numpy"], a, it, (0.0, 1e-3))),
                        ("engine_read", lambda: fields_io.read_field(
                            paths["numpy"])),
                        ("numpy_read", lambda: fields_io.read_field_plain(
                            paths["engine"]))):
            t0 = time.perf_counter()
            got = fn()
            t[key] = time.perf_counter() - t0
            if got is not None:
                require(np.array_equal(got[0], a), f"15d {key}: the field")
        with open(paths["engine"], "rb") as fa, open(paths["numpy"],
                                                     "rb") as fb:
            same = fa.read() == fb.read()
        require(same, "15d: the engine's file differs from NumPy's")
        res["io"] = t
        print(f"[io] 15d one {MAIN_SHAPE} float64 restart field "
              f"({a.nbytes} B; {os.cpu_count()} host cores): engine write "
              f"{t['engine_write']:.3f} s, NumPy {t['numpy_write']:.3f} s "
              f"(files equal byte for byte); read engine "
              f"{t['engine_read']:.3f} s, NumPy {t['numpy_read']:.3f} s")
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as out:
        ini = write_case(out, towers_case())
        r = traced_cli(ini, out, ("ini", "dns"))
        trace = read_trace(os.path.join(out, "tlab.trace"))
        n_sub = len(r["run"].sim.P["rk"]["kdt"])
        res["launches_towers"] = r["launches"]
        want = [TOWER_STEPS * n_sub] * 3
        require(r["launches"] == want,
                f"15c towers launched {r['launches']}, expected {want}")
        ny = EKMAN_SHAPE[1]
        means = sorted(n for n in os.listdir(out)
                       if n.startswith("tower.mean."))
        require(len(means) == 4, f"15c: tower mean files {means}")
        span = means[0].split(".")[2]
        _, _, flow = averages.read_avg(os.path.join(out,
                                                    f"avg{TOWER_STEPS}"))
        _, _, scal = averages.read_avg(os.path.join(out,
                                                    f"avg{TOWER_STEPS}s1"))
        err = 0.0
        for iv, col in ((1, flow["rU"]), (2, flow["rV"]), (3, flow["rW"]),
                        (5, scal["rS"])):
            t_, its, d = rf.read_tower_file(
                os.path.join(out, f"tower.mean.{span}.{iv}"), ny)
            require(list(its) == list(range(1, TOWER_STEPS + 1)),
                    f"15c tower.mean {iv}: iterations {list(its)}")
            err = max(err, float(np.abs(d[-1] - col).max()
                                 / max(np.abs(col).max(), 1e-30)))
        cols = sorted(n for n in os.listdir(out) if n.startswith("tower.0"))
        n_cols = (EKMAN_SHAPE[0] // 16) * (EKMAN_SHAPE[2] // 16)
        require(len(cols) == 4 * n_cols,
                f"15c: {len(cols)} tower column files, expected "
                f"{4 * n_cols}")
        run_cli("tower2nc", ini, out)
        nc = nc_variables(os.path.join(out, "towers.nc"))
        first = cols[0]
        i_pos, k_pos = int(first[6:12]), int(first[13:19])
        ci = [(int(c[6:12]), int(c[13:19])) for c in cols
              if c.endswith(".1")].index((i_pos, k_pos))
        _, _, d = rf.read_tower_file(os.path.join(out, first), ny)
        require(np.array_equal(nc["VelocityX"][:, :, ci],
                               d.astype(np.float32)),
                "15c tower2nc: VelocityX of the first tower")
        print(rate_line("15c Ekman layer with [SaveTowers] Stride=16,1,16",
                        card, EKMAN_SHAPE, TOWER_STEPS, n_sub, trace, r,
                        "planes")
              + f"; {len(cols)} tower files, the means at step "
              f"{TOWER_STEPS} against avg{TOWER_STEPS}'s rU rV rW rS "
              f"{err:.3e} of each column's max (limit {TOWER_TOL}); "
              f"towers.nc {tuple(nc['VelocityX'].shape)} equal to the files")
        require(err <= TOWER_TOL, f"15c tower means {err}")
    return res


# ---------------------------------------------------------------------------
# phase 16: the tools (A16) -- visuals with the ParamVisuals menu, apriori,
# opr_check, transfields/transgrid and the cloud-state commands
# ---------------------------------------------------------------------------

# 16a's menu numbers (iscal_offset 9 without a mixture): the velocity files,
# vector and magnitude, the Pressure family (PressureDecomposition=resolved),
# the scalar, VorticityVector, the Enstrophy block, StrainTensor, the Strain
# block, the invariants, Tke and the Reynolds tensor
VISUAL_MENU = (1, 2, 3, 4, 5, 8, 9, 13, 15, 16, 18, 19, 24)
# the diagnostic pressure solves of each name that needs one: each solve
# launches K1-K3 once on the velocity stack (F = 3); PressureHydrodynamic
# solves the hydrostatic part and the whole, PressureAdvection the whole and
# the diffusion-only pass; Coriolis and Buoyancy solve with no Burgers term
PRESSURE_SOLVES = {
    "Pressure": 1, "PressureGradientPower": 1, "PressureStrainX": 1,
    "PressureStrainY": 1, "PressureStrainZ": 1, "PressureHydrostatic": 1,
    "PressureHydrodynamic": 2, "PressureCoriolis": 0, "PressureBuoyancy": 0,
    "PressureDiffusion": 1, "PressureAdvection": 2, "PressureAdvDiff": 1,
    "PressureTotal": 1, "StressTensor": 1, "StrainPressure": 1,
    "PressureGradientY": 1}
# 16a's second call: [PostProcessing] Subdomain (1-based, inclusive) and the
# names it writes
SUBDOMAIN = (129, 384, 33, 224, 65, 192)
SUB_FIELDS = ("VelocityX", "Enstrophy", "Pressure")
IDENTITY_TOL = 1e-5      # two sides of an identity between f4 files, over
                         # the largest max|file| of its terms: fp32 rounding
FORCING_TOL = 1e-5       # the total forcing against its four parts, fp32
# 16a's pressure files against references: 7a's case at SMALL_GRID on the
# seeded fields of pressure_witness_fields; `visuals` of PRESSURE_VISUALS in
# fp32 on the card against the port's fp64 solve of the same fields on the
# card, over max|fp64|: within 2x tlab_tpu's own fp32 drift there plus the
# file's f4 rounding; that fp64 solve's pressure_stats within
# PRESSURE_VISUAL_TOL of max|p| of tlab_tpu's float64 ones (both printed by
# PYTHONPATH=. python tests/test_torch_visuals.py)
PRESSURE_VISUALS = ("Pressure", "PressureHydrostatic")
PRESSURE_POINT = (31, 21, 13)
PRESSURE_VISUAL_FP64 = {
    "Pressure": (-0.4824929108579948, 0.0006543499584690017,
                 0.27983389288428206, -0.33103250586231614),
    "PressureHydrostatic": (-0.4569838207165978, 5.059371363069911e-05,
                            0.27981801077807295, -0.3315505143752997)}
PRESSURE_VISUAL_WITNESS = {"Pressure": 1.612e-06,
                           "PressureHydrostatic": 1.611e-06}
PRESSURE_VISUAL_TOL = 1e-9   # fp64 round-off; a wrong solve reads O(1)
# 16b: Ksgs against the tau table's trace, both written in 9 digits from
# fp32 plane means; the fp32 tables against fp64 at SMALL_GRID, over each
# column's max (the plane mean of an x or z derivative vanishes: over the
# max rms of that derivative, sqrt of its "2" column): tau = G(uu) - G(u)G(u)
# of the weak compact filter cancels; a CPU run of this check read 4.8e-5
# (Tauxx)
KSGS_TOL = 1e-6
APRIORI_FP32_TOL = 1e-4
# 16c: tlab_tpu's float64 values of opr_check's deterministic keys on the
# shear layer at 128x64x64 (PYTHONPATH=. python tests/test_torch_check.py)
OPR_CHECK_SMALL = (128, 64, 64)
OPR_CHECK_FP64 = {"d1x_mode1_error": 6.673328556416891e-12,
                  "poisson_error": 2.1934229987863318e-07}
# within 1e-8 of tlab_tpu's value and 1e-15 for round-off
OPR_CHECK_REL_TOL, OPR_CHECK_ROUND_OFF = 1e-8, 1e-15
FFT_TOL = 1e-5           # the fp32 round trip over max|u|: ~2e-7 on the CPU
# the fp32 errors over their fp64 values at full width: the derivative's
# rounding is 2^-24 a term of a row of |D1| (8x its row sum: 6.5e-6 at 128
# and 1.0e-5 at 256 points on the CPU, against 1.4e-5 and 2.9e-5 allowed);
# the solve's rounding on a field of max 1 (4.2e-7 and 6.6e-7 at 128x64x64
# and 256x128x128 on the CPU)
D1_ROUNDING = 8 * 2.0 ** -24
POISSON_ROUNDING = 1e-5
# 16d: transfields onto a coarser grid and a y-refined one (every old node
# among the new ones); cubic Lagrange is exact on cubics and constants
REMESH_COARSE = (256, 128, 128)
REMESH_FINE = (512, 511, 256)
REMESH_TOL = 1e-6        # fp32 against fp64, over max|field|
# 16e: the cloud tools on the card (fp64) against the CPU's
CLOUD_TOL = 1e-12
CLOUD_COMMANDS = (
    ("state", ["--h", "0.97", "--qt", "0.02"], "state.dat"),
    ("smooth", ["--h", "0.97", "--range", "0.0,0.05,51"], "vapor.dat"),
    ("saturation", ["--p", "0.9"], "sat.dat"),
    # tests/test_thermo.py:90-103's cloud-top pair
    ("reversal", ["--h", "0.95", "--qt", "0.02", "--h2", "1.01", "--qt2",
                  "0.004"], "reversal.dat"))


def visuals_case() -> str:
    """7a's stratified, rotating shear layer with 16a's ParamVisuals menu
    and the resolved pressure decomposition."""
    menu = ",".join(map(str, VISUAL_MENU))
    return option_case("7a", {}) + (
        "\n[PostProcessing]\nFiles=0\nPressureDecomposition=resolved\n"
        f"ParamVisuals={menu}\n")


def read_vis(out: str, name: str) -> np.ndarray:
    """vis0.<name> (raw f4, z slowest) as float64 (nz, ny, nx)."""
    nx, ny, nz = MAIN_SHAPE
    return np.fromfile(os.path.join(out, f"vis0.{name}"),
                       "<f4").astype(np.float64).reshape(nz, ny, nx)


def identity_error(lhs, terms) -> float:
    """max|lhs - sum(terms)| over the largest max|.| among lhs and terms."""
    scale = max(float(np.abs(t).max()) for t in (lhs, *terms))
    return float(np.abs(lhs - sum(terms)).max()) / scale


def forcing_parts(sim) -> float:
    """The diagnostic pressure's total forcing (and its Neumann data)
    against the sum of its advection, diffusion, Coriolis and buoyancy
    parts on seeded fields, fp32 on the card: the case's body force has
    those two terms only, so PressureTotal is the sum of the four solves."""
    from tlab_tpu_torch.dycore.pressure import pressure_forcing
    st = state_from_numpy(*pressure_witness_fields(
        tuple(sim.grid.shape), sim.grid.y.nodes), "cuda", torch.float32)
    total = pressure_forcing(sim.P, st, "total")
    parts = [pressure_forcing(sim.P, st, d) for d in
             ("advection", "diffusion", "coriolis", "buoyancy")]
    err = 0.0
    for i in range(3):
        scale = max(p[i].abs().max().item() for p in parts)
        err = max(err, (total[i] - sum(p[i] for p in parts)).abs().max()
                  .item() / scale)
    return err


def pressure_stats(p) -> tuple:
    """(min, max, rms, value at PRESSURE_POINT) of a float64 tensor."""
    return (p.min().item(), p.max().item(),
            p.square().mean().sqrt().item(), p[PRESSURE_POINT].item())


def pressure_reference() -> dict:
    """16a's pressure files against references (PRESSURE_VISUALS): the
    seeded fields at SMALL_GRID written as a float64 restart, `visuals` of
    those names through the CLI in fp32 on the card, each file against the
    port's fp64 solve on the card; that solve's stats against tlab_tpu's."""
    from tlab_tpu_torch.dycore.pressure import pressure_boussinesq
    text = edit_case(visuals_case(), SMALL_GRID)
    sim = Simulation.from_case(load_case(Ini(text=text)),
                               dtype=torch.float64, device="cuda")
    fields = pressure_witness_fields(tuple(sim.grid.shape),
                                     sim.grid.y.nodes)
    st = state_from_numpy(*fields, "cuda", torch.float64)
    zero = torch.zeros_like(st.u)
    ref = {"Pressure": pressure_boussinesq(sim.P, st, "resolved"),
           "PressureHydrostatic": pressure_boussinesq(
               sim.P, st._replace(u=zero, v=zero, w=zero))}
    nx, ny, nz = sim.grid.shape
    res = {}
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as out:
        ini = write_case(out, text)
        fields_io.write_state(os.path.join(out, "flow"),
                              os.path.join(out, "scal"), 0,
                              state_from_numpy(*fields, "cpu",
                                               torch.float64),
                              0.0, sim.nsp.visc)
        burgers.reset_launches()
        run_cli("visuals", ini, out, "--fields", ",".join(PRESSURE_VISUALS))
        res["launches"] = list(burgers.contract_launches["highest"])
        for name, p64 in ref.items():
            f4 = np.fromfile(os.path.join(out, f"vis0.{name}"), "<f4")
            got = torch.from_numpy(f4.reshape(nz, ny, nx).transpose(
                2, 1, 0).astype(np.float64)).to("cuda")
            scale = p64.abs().max().item()
            stats = pressure_stats(p64)
            res[name] = {
                "fp32": (got - p64).abs().max().item() / scale,
                "fp32_limit": 2.0 * PRESSURE_VISUAL_WITNESS[name]
                + 2.0 ** -24,
                "fp64": max(abs(a - b) for a, b in zip(
                    stats, PRESSURE_VISUAL_FP64[name])) / scale,
                "stats": stats}
    require(res["launches"] == [sum(PRESSURE_SOLVES[n]
                                    for n in PRESSURE_VISUALS)] * 3,
            f"16a pressure reference launched {res['launches']}")
    for name in PRESSURE_VISUALS:
        r = res[name]
        require(r["fp32"] <= r["fp32_limit"],
                f"16a {name}: the fp32 file against fp64 {r['fp32']} > "
                f"{r['fp32_limit']}")
        require(r["fp64"] <= PRESSURE_VISUAL_TOL,
                f"16a {name}: fp64 {r['stats']} against tlab_tpu's "
                f"{PRESSURE_VISUAL_FP64[name]}")
    return res


def phase_visuals(card: str, initial: str) -> dict:
    """16a: `visuals` of 6a's initial fields at 512x256x256 fp32 through the
    CLI with 7a's case and VISUAL_MENU, then with a Subdomain; the files'
    identities, the launches against the names' solves."""
    text = visuals_case()
    res = {}
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as out:
        ini = write_case(out, text)
        link_initial_fields(initial, out)
        u = fields_io.read_field(os.path.join(out, "flow.0.1"))[0]
        small = Simulation.from_case(load_case(Ini(text=edit_case(
            text, SMALL_GRID))), dtype=torch.float32, device="cuda")
        res["forcing"] = forcing_parts(small)
        require(res["forcing"] <= FORCING_TOL,
                f"16a: the total forcing against its parts {res['forcing']}")
        names = cli.visual_menu(small.case, small)
        del small
        want = sum(PRESSURE_SOLVES.get(n, 0) for n in names)
        burgers.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        res["seconds"] = run_cli("visuals", ini, out)
        res["launches"] = list(burgers.contract_launches["highest"])
        res["peak"] = torch.cuda.max_memory_allocated()
        require(res["launches"] == [want] * 3,
                f"16a visuals launched {res['launches']}, expected "
                f"{[want] * 3} ({len(names)} names)")
        files = sorted(n for n in os.listdir(out) if n.startswith("vis0."))
        res["files"] = len(files)
        res["bytes"] = sum(os.path.getsize(os.path.join(out, n))
                           for n in files)
        nx, ny, nz = MAIN_SHAPE
        require(all(os.path.getsize(os.path.join(out, n)) == 4 * nx * ny * nz
                    for n in files), "16a: a visual file's size")
        u32 = u.transpose(2, 1, 0).astype("<f4")
        with open(os.path.join(out, "vis0.VelocityX"), "rb") as fh:
            require(fh.read() == u32.tobytes(),
                    "16a: VelocityX is not the restart's u cast to f4")
        del u, u32

        def vec(stem, n):
            return [read_vis(out, f"{stem}{i}") for i in range(1, n + 1)]

        ident = {}
        om = vec("VorticityVector", 3)
        ident["Enstrophy"] = identity_error(read_vis(out, "Enstrophy"),
                                            [c * c for c in om])
        del om
        s = vec("StrainTensor", 6)
        ident["Strain"] = identity_error(
            read_vis(out, "Strain"),
            [2 * c * c for c in s[:3]] + [4 * c * c for c in s[3:]])
        del s
        vv = vec("VelocityVector", 3)
        ident["VelocityMagnitude"] = identity_error(
            read_vis(out, "VelocityMagnitude"), [c * c for c in vv])
        del vv
        ident["PressureTotal"] = identity_error(
            read_vis(out, "PressureTotal"),
            [read_vis(out, "Pressure" + n) for n in
             ("Advection", "Diffusion", "Coriolis", "Buoyancy")])
        res["identities"] = ident
        for k, v in ident.items():
            require(v <= IDENTITY_TOL, f"16a: the {k} identity {v}")
        full = {n: read_vis(out, n).astype("<f4") for n in SUB_FIELDS}
        for n in files:
            os.remove(os.path.join(out, n))

        # the second call: a Subdomain, the names of SUB_FIELDS
        sub_text = text + "Subdomain=" + ",".join(map(str, SUBDOMAIN)) + "\n"
        ini = write_case(out, sub_text)
        burgers.reset_launches()
        res["sub_seconds"] = run_cli("visuals", ini, out, "--fields",
                                     ",".join(SUB_FIELDS))
        res["sub_launches"] = list(burgers.contract_launches["highest"])
        require(res["sub_launches"] == [1, 1, 1],
                f"16a Subdomain launched {res['sub_launches']}")
        i0, i1, j0, j1, k0, k1 = SUBDOMAIN
        for n in SUB_FIELDS:
            got = np.fromfile(os.path.join(out, f"vis0.{n}"), "<f4")
            want_ = np.ascontiguousarray(
                full[n][k0 - 1:k1, j0 - 1:j1, i0 - 1:i1])
            require(np.array_equal(got, want_.ravel()),
                    f"16a Subdomain {n}: not the slice of the whole field")
    res["reference"] = pressure_reference()
    return res


def apriori_case(mode: int, changes=None) -> str:
    return edit_case(CASE.read_text(), changes or {}) + (
        f"\n[PostProcessing]\nFiles=0\nParamStructure={mode}\n")


def apriori_tables(out: str, mode: int) -> dict:
    names = ("tau0", "sgs0") if mode == 1 else ("gradU0",)
    return {n: averages.read_table(os.path.join(out, n)) for n in names}


def apriori_scale(table: dict, k: str) -> float:
    """The size of column k's terms: its max, or for a plane mean of a
    derivative (gradU's Ux..Wz) the max rms of that derivative."""
    if k + "2" in table:
        return max(float(np.sqrt(np.abs(table[k + "2"]).max())),
                   float(np.abs(table[k]).max()))
    return float(np.abs(table[k]).max())


def phase_apriori(card: str, initial: str) -> dict:
    """16b: `apriori` modes 1 and 2 of 6a's initial fields at full width
    (the fallback compact test filter); at SMALL_GRID, fp32 against
    --x64."""
    res = {"seconds": {}, "launches": {}}
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as out:
        link_initial_fields(initial, out)
        for mode in (1, 2):
            ini = write_case(out, apriori_case(mode))
            burgers.reset_launches()
            res["seconds"][mode] = run_cli("apriori", ini, out)
            res["launches"][mode] = list(burgers.contract_launches["highest"])
            require(res["launches"][mode] == [0, 0, 0],
                    f"16b apriori launched {res['launches'][mode]}")
            for n, table in apriori_tables(out, mode).items():
                for k, col in table.items():
                    require(len(col) == MAIN_SHAPE[1]
                            and np.isfinite(col).all(), f"16b {n} {k}")
        tab = apriori_tables(out, 1)
        tau, sgs = tab["tau0"], tab["sgs0"]
        trace = 0.5 * (tau["Tauxx"] + tau["Tauyy"] + tau["Tauzz"])
        res["ksgs"] = float(np.abs(sgs["Ksgs"] - trace).max()
                            / np.abs(trace).max())
        require(res["ksgs"] <= KSGS_TOL, f"16b Ksgs {res['ksgs']}")
    err = {}
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as top:
        dirs = {}
        for mode in (1, 2):
            for tag, more in (("fp64", ["--x64"]), ("fp32", [])):
                d = os.path.join(top, f"{mode}{tag}")
                os.makedirs(d)
                ini = write_case(d, apriori_case(mode, SMALL_GRID))
                if mode == 1 and tag == "fp64":
                    run_cli("ini", ini, d, "--x64")
                    src = d
                else:
                    for f in INITIAL_FILES:
                        shutil.copy(os.path.join(src, f), d)
                run_cli("apriori", ini, d, *more)
                dirs[mode, tag] = d
            t64 = apriori_tables(dirs[mode, "fp64"], mode)
            t32 = apriori_tables(dirs[mode, "fp32"], mode)
            for n, table in t64.items():
                for k, col in table.items():
                    if k != "Y":
                        err[f"{n}:{k}"] = float(
                            np.abs(t32[n][k] - col).max()
                            / apriori_scale(table, k))
    worst = max(err, key=err.get)
    res["fp32"], res["fp32_worst"] = err[worst], worst
    require(err[worst] <= APRIORI_FP32_TOL,
            f"16b fp32 against fp64: {worst} {err[worst]}")
    return res


def phase_opr_check(card: str, initial: str) -> dict:
    """16c: dns.run(opr_check=True) of the shear layer at 512x256x256 fp32
    from 6a's fields, one step: the report in dns.out before its header,
    its fp32 errors within their fp64 values (the same grid in fp64 on the
    card) and the rounding allowances; fp64 at OPR_CHECK_SMALL against
    tlab_tpu's."""
    from tlab_tpu_torch.ops.check import opr_check
    res = {}
    text = shear_case(MAIN_SHAPE, 1)
    sim = Simulation.from_case(load_case(Ini(text=text)),
                               dtype=torch.float32, device="cuda")
    u, v, w, s = fields_io.read_state(os.path.join(initial, "flow"),
                                      os.path.join(initial, "scal"), 0,
                                      1)[:4]
    state = state_from_numpy(*(np.ascontiguousarray(a) for a in (u, v, w,
                                                                 s)),
                             "cuda", torch.float32)
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as out:
        log = os.path.join(out, "dns.out")
        t0 = time.perf_counter()
        dns_tool.run(sim, state, outdir=out, n_steps=1, checkpoint=False,
                     opr_check=True, log_path=log)
        torch.cuda.synchronize()
        res["seconds"] = time.perf_counter() - t0
        with open(log) as fh:
            lines = fh.read().splitlines()
    require(lines[0] == "# OPR_CHECK startup self-test",
            f"16c: dns.out starts with {lines[0]!r}")
    head = min(i for i, ln in enumerate(lines) if ln.startswith("#####"))
    rep = dict(ln[4:].split(": ") for ln in lines[1:head])
    got = {k: float(v) for k, v in rep.items()}
    require(list(got) == ["fft_roundtrip_residual", "fft_time_s",
                          "d1x_mode1_error", "poisson_time_s",
                          "poisson_error"], f"16c: the report's keys {got}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    umax = torch.randn(MAIN_SHAPE, generator=gen, device="cuda").abs() \
        .max().item()
    d1_rows = sim.P["d1x"].double().abs().sum(1).max().item()
    del sim, state
    sim64 = Simulation.from_case(load_case(Ini(text=text)),
                                 dtype=torch.float64, device="cuda")
    full64 = opr_check(sim64)
    del sim64
    limits = {"fft_roundtrip_residual": FFT_TOL * umax,
              "d1x_mode1_error": full64["d1x_mode1_error"]
              + D1_ROUNDING * d1_rows,
              "poisson_error": full64["poisson_error"] + POISSON_ROUNDING}
    for k, lim in limits.items():
        require(got[k] <= lim, f"16c fp32 {k} {got[k]} > {lim}")
    small = Simulation.from_case(load_case(Ini(text=shear_case(
        OPR_CHECK_SMALL, 1))), dtype=torch.float64, device="cuda")
    small64 = opr_check(small)
    del small
    for k, ref in OPR_CHECK_FP64.items():
        require(abs(small64[k] - ref) <= OPR_CHECK_REL_TOL * abs(ref)
                + OPR_CHECK_ROUND_OFF,
                f"16c fp64 {k} {small64[k]} against tlab_tpu's {ref}")
    res.update(fp32=got, limits=limits, full64=full64, small64=small64,
               head=head)
    return res


def remesh_checks(grid, grid2) -> dict:
    """A constant and a cubic in y through remesh_field on the card, fp32,
    grid -> grid2."""
    from tlab_tpu_torch.ops.interpolate import remesh_field
    kw = {"dtype": torch.float32, "device": "cuda"}
    one = torch.ones(grid.shape, **kw)
    out = {"constant": (remesh_field(one, grid, grid2) - 1.0).abs().max()
           .item()}

    def cubic(y):
        y = torch.as_tensor(y, dtype=torch.float64)
        return (1.0 - 2.0 * y + 0.5 * y ** 2 - 3.0 * y ** 3)[None, :, None]

    got = remesh_field(cubic(grid.y.nodes).to(**kw) * one, grid, grid2)
    want = cubic(grid2.y.nodes).to("cuda")
    out["cubic"] = ((got.double() - want).abs().max()
                    / want.abs().max()).item()
    return out


def grid_bytes(path: str, refine: int) -> bytes:
    """transgrid's file as NumPy writes it: each axis's nodes resampled
    linearly in the arc parameter, the Fortran records of sizes, scales and
    nodes (periodic scales with the wrap-around spacing)."""
    import struct
    from tlab_tpu_torch.grid import read_reference_grid
    g = read_reference_grid(path)
    sizes, scales, nodes = [], [], []
    for ax in (g.x, g.y, g.z):
        n = ax.size * refine
        x = np.interp(np.linspace(0.0, 1.0, n), np.linspace(0.0, 1.0,
                                                            ax.size),
                      ax.nodes)
        span = float(x[-1] - x[0])
        sizes.append(n)
        scales.append(span * (1.0 + 1.0 / (n - 1)) if ax.periodic else span)
        nodes.append(x)

    def rec(payload: bytes) -> bytes:
        return struct.pack("<i", len(payload)) + payload + \
            struct.pack("<i", len(payload))

    return (rec(np.asarray(sizes, "<i4").tobytes())
            + rec(np.asarray(scales, "<f8").tobytes())
            + b"".join(rec(x.astype("<f8").tobytes()) for x in nodes))


def phase_remesh(card: str, initial: str) -> dict:
    """16d: `transfields` of 6a's initial fields onto REMESH_COARSE and
    REMESH_FINE through the CLI, `transgrid` of its grid file."""
    from tlab_tpu_torch.ops.interpolate import remesh_field
    from tlab_tpu_torch.runtime import grid_from_case
    res = {"seconds": {}}
    base = shear_case(MAIN_SHAPE, 1)
    grid = grid_from_case(load_case(Ini(text=base)))
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as out:
        ini = write_case(out, base)
        link_initial_fields(initial, out)
        fields = [np.ascontiguousarray(a) for a in fields_io.read_state(
            os.path.join(out, "flow"), os.path.join(out, "scal"), 0, 1)[:4]]
        names = ("flow_rm.0.1", "flow_rm.0.2", "flow_rm.0.3", "scal_rm.0.1")
        for tag, shape in (("coarse", REMESH_COARSE), ("fine", REMESH_FINE)):
            ini2 = os.path.join(out, f"{tag}.ini")
            with open(ini2, "w") as fh:
                fh.write(shear_case(shape, 1))
            grid2 = grid_from_case(load_case(ini2))
            res[tag] = remesh_checks(grid, grid2)
            require(max(res[tag].values()) <= REMESH_TOL,
                    f"16d {tag}: {res[tag]}")
            burgers.reset_launches()
            res["seconds"][tag] = run_cli("transfields", ini, out, "--ini2",
                                          ini2, "--files", "0")
            require(burgers.contract_launches["highest"] == [0, 0, 0],
                    "16d: a kernel launched")
            err = 0.0
            for name, f in zip(names, (*fields[:3], fields[3][0])):
                got = fields_io.read_field(os.path.join(out, name))[0]
                require(got.shape == shape and np.isfinite(got).all(),
                        f"16d {tag} {name}: {got.shape}")
                f_dev = torch.as_tensor(f, device="cuda")
                if tag == "coarse":
                    ref = remesh_field(f_dev, grid, grid2)
                else:
                    # back onto the original nodes, in fp32 as the files'
                    ref = f_dev.float()
                    got = remesh_field(torch.as_tensor(
                        got, dtype=torch.float32, device="cuda"), grid2,
                        grid).cpu().numpy()
                err = max(err, float(np.abs(got - ref.cpu().numpy()).max()
                                     / ref.abs().max().item()))
                del f_dev, ref, got
                os.remove(os.path.join(out, name))
            res[f"{tag}_fields"] = err
            require(err <= REMESH_TOL, f"16d {tag}: the fields {err}")
        run_cli("inigrid", ini, out)
        t0 = time.perf_counter()
        rc = cli.main(["transgrid", "--outdir", out, "--refine", "2"])
        res["seconds"]["transgrid"] = time.perf_counter() - t0
        require(rc == 0, "16d transgrid")
        with open(os.path.join(out, "grid.ref"), "rb") as fh:
            require(fh.read() == grid_bytes(os.path.join(out, "grid"), 2),
                    "16d transgrid: grid.ref differs from NumPy's")
    return res


def phase_cloud(card: str) -> dict:
    """16e: the cloud-state commands with --device cuda (fp64 on the card)
    against --device cpu; the cloud-top pair's reversal."""
    res = {}
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as top:
        for command, flags, name in CLOUD_COMMANDS:
            tabs = {}
            for dev in ("cuda", "cpu"):
                d = os.path.join(top, dev)
                t0 = time.perf_counter()
                rc = cli.main([command, "--ini", os.path.join(top, "none"),
                               "--outdir", d, "--device", dev, *flags])
                require(rc == 0, f"16e {command} on {dev}")
                res[f"{command}_{dev}_s"] = time.perf_counter() - t0
                tabs[dev] = np.atleast_2d(np.loadtxt(os.path.join(d, name)))
            a, b = tabs["cuda"], tabs["cpu"]
            require(a.shape == b.shape and np.isfinite(a).all(),
                    f"16e {name}: {a.shape}")
            res[command] = float((np.abs(a - b) / np.maximum(
                np.abs(b).max(0), 1e-300)).max())
            require(res[command] <= CLOUD_TOL,
                    f"16e {name}: cuda against cpu {res[command]}")
        with open(os.path.join(top, "cuda", "reversal.dat")) as fh:
            head = dict(kv.split("=") for kv in fh.readline().split()
                        if "=" in kv)
    res["chi_star"], res["b_star"] = float(head["chi_star"]), \
        float(head["b_star"])
    require(0.0 <= res["chi_star"] <= 1.0 and res["b_star"] <= 0.0,
            f"16e reversal: chi_star {res['chi_star']}, b_star "
            f"{res['b_star']}")
    return res


def phase_tools(card: str, initial: str) -> dict:
    """Phase 16, each part's line."""
    t16 = time.perf_counter()
    vis = phase_visuals(card, initial)
    print(f"[16] 16a visuals of 7a's case ({card}): {MAIN_SHAPE} fp32, "
          f"menu {','.join(map(str, VISUAL_MENU))}: {vis['files']} files "
          f"({vis['bytes']} B) in {vis['seconds']:.3f} s, peak device "
          f"memory {vis['peak']} B, launches {vis['launches']}; the "
          f"forcing's parts {vis['forcing']:.3e}; identities "
          + ", ".join(f"{k} {v:.3e}" for k, v in vis["identities"].items())
          + f" (limit {IDENTITY_TOL}); VelocityX = the restart's u in f4; "
          f"Subdomain {SUBDOMAIN} {vis['sub_seconds']:.3f} s, launches "
          f"{vis['sub_launches']}, the slice of the whole field")
    ref = vis["reference"]
    print(f"[16] 16a pressure files at 128x64x64 ({card}): launches "
          f"{ref['launches']}; "
          + "; ".join(f"{n} fp32 file against fp64 {ref[n]['fp32']:.3e} "
                      f"(limit {ref[n]['fp32_limit']:.3e}), fp64 stats "
                      f"{ref[n]['stats']} against tlab_tpu's "
                      f"{ref[n]['fp64']:.3e} (limit {PRESSURE_VISUAL_TOL})"
                      for n in PRESSURE_VISUALS))
    ap = phase_apriori(card, initial)
    print(f"[16] 16b apriori ({card}): mode 1 {ap['seconds'][1]:.3f} s, "
          f"mode 2 {ap['seconds'][2]:.3f} s, launches "
          f"{ap['launches'][1]}; Ksgs against the tau trace {ap['ksgs']:.3e} "
          f"(limit {KSGS_TOL}); fp32 against fp64 at 128x64x64 "
          f"{ap['fp32']:.3e} ({ap['fp32_worst']}; limit {APRIORI_FP32_TOL})")
    oc = phase_opr_check(card, initial)
    print(f"[16] 16c opr_check ({card}): dns.run of one step "
          f"{oc['seconds']:.3f} s, the report's {oc['head'] - 1} lines "
          f"before the header; fp32 at {MAIN_SHAPE}: "
          + ", ".join(f"{k} {oc['fp32'][k]:.6e} (limit {v:.3e})"
                      for k, v in oc["limits"].items())
          + f"; fft {oc['fp32']['fft_time_s']:.6f} s, Poisson "
          f"{oc['fp32']['poisson_time_s']:.6f} s; fp64 there "
          + ", ".join(f"{k} {oc['full64'][k]:.6e}" for k in OPR_CHECK_FP64)
          + f"; fp64 at {OPR_CHECK_SMALL} "
          + ", ".join(f"{k} {oc['small64'][k]:.16e}"
                      for k in OPR_CHECK_FP64)
          + f" (tlab_tpu's within {OPR_CHECK_REL_TOL} and "
          f"{OPR_CHECK_ROUND_OFF})")
    rm = phase_remesh(card, initial)
    print(f"[16] 16d transfields ({card}): onto {REMESH_COARSE} "
          f"{rm['seconds']['coarse']:.3f} s (fields against fp64 "
          f"{rm['coarse_fields']:.3e}), onto {REMESH_FINE} "
          f"{rm['seconds']['fine']:.3f} s (back onto the old nodes "
          f"{rm['fine_fields']:.3e}); a constant and a cubic in y "
          f"{rm['coarse']}, {rm['fine']} (limit {REMESH_TOL}); transgrid "
          f"{rm['seconds']['transgrid']:.3f} s, equal to NumPy's file")
    cl = phase_cloud(card)
    print(f"[16] 16e cloud tools ({card}): cuda against cpu "
          + ", ".join(f"{c} {cl[c]:.3e}" for c, _, _ in CLOUD_COMMANDS)
          + f" (limit {CLOUD_TOL}); reversal chi_star {cl['chi_star']:.6e},"
          f" b_star {cl['b_star']:.6e}")
    t16 = time.perf_counter() - t16
    print(f"[16] phase 16 took {t16:.1f} s")
    return {"launches_16a": vis["launches"], "seconds": t16}


# ---------------------------------------------------------------------------
# Phase 17: the rank mesh (parallel/, dns --mesh)
# ---------------------------------------------------------------------------

MESH = (4, 2)                # examples/ekman_mesh's [Parallel] Mesh
MESH_STEPS = 20              # the case's End
NCCL_MESH = (1, 1)
NCCL_STEPS = 3               # 17b: dns of 6a's case from 6a's fields
# 17a, the 4x2 mesh against one device on the card, fp32, 20 RK3 steps
# (measured: PR 13's first chip run): dns.out's time, dt, CFL#, D#, visc
# relative, 0 read, limit one digit of a 3-digit column; DilMin/DilMax over
# the column's largest magnitude, 3.52e-5 read, limit 10x; the restarts
# over their max, 3.14e-5 read, limit 10x.  A transpose with its peers'
# blocks swapped (a scratch copy) went to NaN at step 5.
MESH_ROW_TOL = 1e-2
MESH_DIL_TOL = 4e-4
MESH_FIELD_TOL = 3e-4
# 17b, NCCL in a world of one against 6a's first rows: 0 and 2.26e-3 read
NCCL_ROW_TOL = 1e-2
NCCL_DIL_TOL = 2e-2
LAUNCH_LINE = re.compile(r"(\d+) \[(\d+), (\d+), (\d+)\]")


def substeps(text: str) -> int:
    """The RK substeps a step of the case's TimeOrder."""
    from tlab_tpu_torch.dycore import timemarch
    return len(timemarch.get_scheme(
        load_case(Ini(text=text)).time_order).kdt)


def rank_launches(log: str) -> list:
    """[K1, K2, K3] of each rank from tlab.log's launch line of a mesh
    run (the kernels run in the ranks' processes)."""
    with open(log) as fh:
        line = [ln for ln in fh if ln.startswith("Burgers kernel launches")]
    require(len(line) == 1, f"{log}: {len(line)} launch lines")
    return [[int(g) for g in m.groups()[1:]]
            for m in LAUNCH_LINE.finditer(line[0])]


def row_errors(rows, ref) -> tuple:
    """(max relative deviation of the time, dt, CFL#, D#, visc columns,
    max deviation of DilMin/DilMax over the column's largest magnitude)."""
    a = np.array([[float(v) for v in r[2:7]] for r in rows])
    b = np.array([[float(v) for v in r[2:7]] for r in ref])
    cols = np.abs(a - b) / np.maximum(np.abs(b), 1e-300)
    da = np.array([[float(v) for v in r[7:9]] for r in rows])
    db = np.array([[float(v) for v in r[7:9]] for r in ref])
    dil = np.abs(da - db).max(0) / np.maximum(np.abs(db).max(0), 1e-300)
    return float(cols.max()), float(dil.max())


def check_mesh_kernels(text: str, mesh) -> list:
    """K1-K3 against their plain version, timed, at the shapes a (px, pz)
    mesh gives them in the case's dns: K1 on the x-gathered stack, K2 on
    the block, K3 on the z-gathered stack, with the case's operators."""
    from tlab_tpu_torch.parallel.pencil import block_shapes
    sim = Simulation.from_case(load_case(Ini(text=text)),
                               dtype=torch.float32, device="cuda")
    P = sim.P
    shapes = block_shapes(*mesh, sim.grid.shape)
    gen = torch.Generator(device="cuda").manual_seed(17)
    nu = torch.tensor((P["visc"],) * 3 + P["diff"], dtype=torch.float32,
                      device="cuda")
    out = []
    for axis, key in ((0, "x"), (1, "local"), (2, "z")):
        shape = shapes[key]
        x = torch.randn((len(nu),) + shape, generator=gen, device="cuda")
        conv = torch.randn(shape, generator=gen, device="cuda")
        r = check_kernel(axis, P["d12" + "xyz"[axis]], x, conv, nu, True)
        r["shape"] = [len(nu), *shape]
        print(f"[mesh] {burgers.ENTRY_POINTS[axis]} F={len(nu)} {shape} "
              f"({key} of the {mesh[0]}x{mesh[1]} mesh): max|err| "
              f"{r['max_abs_err']:.3e} (rel {r['rel_err']:.3e}, limit "
              f"{KERNEL_TOL}); kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, matmul {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}")
        out.append(r)
    del sim, P
    return out


def mesh_transposes(mesh, shape) -> dict:
    """transpose_check on px pz spawned ranks on the card (the backend
    rule's), rank 0's report."""
    from tlab_tpu_torch.ops import check
    from tlab_tpu_torch.parallel import mesh as pmesh
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as td:
        reports = pmesh.spawn(check.transpose_check, *mesh, "cuda", shape,
                              torch.float32, 5, store_dir=td)
    rep = reports[0]
    require(all(r == rep for r in reports), "transpose_check: the ranks "
            "disagree")
    require(rep["transpose_roundtrip_residual"] == 0.0,
            f"transpose_check residual {rep}")
    return rep


def traced_dns(ini: str, out: str, *more) -> dict:
    """`dns` through the CLI with tlab.trace on (the mesh run's rank 0
    writes it), the parent's kernel counts set to 0 just before it and
    read just after: (seconds, parent's counts, trace)."""
    os.environ["TLAB_TPU_TRACE"] = "1"
    try:
        burgers.reset_launches()
        seconds = run_cli("dns", ini, out, *more)
        launches = list(burgers.contract_launches["highest"])
    finally:
        del os.environ["TLAB_TPU_TRACE"]
        ttrace.close()
    return {"seconds": seconds, "launches": launches,
            "trace": read_trace(os.path.join(out, "tlab.trace"))}


def phase_mesh_ekman(card: str) -> dict:
    """17a: examples/ekman_mesh/tlab.ini as written (128x96x128, [Parallel]
    Mesh=4,2, 20 RK3 steps with its buffer, rotation and towers) through
    the CLI: inigrid, ini, then dns on one device and dns on 8 ranks on
    the card over gloo; dns.out and the restarts against each other."""
    text = EKMAN.read_text()
    require("[Parallel]\nMesh=4,2\n" in text and f"End={MESH_STEPS}" in text,
            "17a: examples/ekman_mesh/tlab.ini is not the 4x2 case")
    res = {"kernels": check_mesh_kernels(text, MESH)}
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as top:
        one, many = os.path.join(top, "one"), os.path.join(top, "mesh")
        os.makedirs(one)
        ini_one = os.path.join(one, "tlab.ini")
        with open(ini_one, "w") as fh:
            fh.write(text.replace("[Parallel]\nMesh=4,2\n", ""))
        run_cli("inigrid", ini_one, one)
        res["ini_s"] = run_cli("ini", ini_one, one)
        shutil.copytree(one, many)
        ini_many = os.path.join(many, "tlab.ini")
        with open(ini_many, "w") as fh:
            fh.write(text)
        single = traced_dns(ini_one, one)
        mesh = traced_dns(ini_many, many)
        require(mesh["launches"] == [0, 0, 0], "17a: a kernel launched in "
                "the launching process")
        res["by_rank"] = rank_launches(os.path.join(many, "tlab.log"))
        with open(os.path.join(many, "tlab.log")) as fh:
            res["describe"] = [ln.split(":", 1)[1].strip() for ln in fh
                               if ln.startswith("Mesh ")][0]
        rows_one = data_rows(os.path.join(one, "dns.out"))
        rows_many = data_rows(os.path.join(many, "dns.out"))
        require(len(rows_many) == len(rows_one) == MESH_STEPS + 1,
                f"17a: dns.out rows {len(rows_many)}, {len(rows_one)}")
        res["rows"], res["dil"] = row_errors(rows_many, rows_one)
        res["fields"] = {}
        for name in ("flow.20.1", "flow.20.2", "flow.20.3", "scal.20.1"):
            a = fields_io.read_field(os.path.join(one, name))[0]
            b = fields_io.read_field(os.path.join(many, name))[0]
            require(np.isfinite(b).all(), f"17a: non-finite {name}")
            res["fields"][name] = float(np.abs(a - b).max()
                                        / max(np.abs(a).max(), 1e-30))
        res["towers"] = sorted(f for f in os.listdir(many)
                               if f.startswith("tower"))
        n_sub = substeps(text)
        res["single"], res["mesh"] = single, mesh
        res["single_rate"] = step_rate(single["trace"], MESH_STEPS, n_sub)
        res["mesh_rate"] = step_rate(mesh["trace"], MESH_STEPS, n_sub)
        res["single_launches"] = single["launches"]
        res["transposes"] = mesh_transposes(MESH, EKMAN_SHAPE)
    want = [MESH_STEPS * n_sub] * 3
    require(res["single_launches"] == want,
            f"17a: one device launched {res['single_launches']}")
    require(len(res["by_rank"]) == MESH[0] * MESH[1]
            and all(r == want for r in res["by_rank"]),
            f"17a: launches by rank {res['by_rank']}, expected {want} each")
    require(res["towers"], "17a: the mesh run wrote no tower files")
    return res


def phase_mesh_nccl(card: str, initial: str) -> dict:
    """17b: dns of the shear layer at 512x256x256 through `dns --mesh 1,1`
    (one rank, NCCL) from 6a's initial fields, 3 steps: its rows against
    6a's, its launches and its time beside 6a's."""
    changes = {("Iteration", "End"): str(NCCL_STEPS),
               ("Iteration", "Restart"): str(NCCL_STEPS),
               ("Iteration", "Statistics"): str(NCCL_STEPS)}
    text = edit_case(CASE.read_text(), changes)
    res = {}
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as out:
        ini = write_case(out, text)
        link_initial_fields(initial, out)
        run = traced_dns(ini, out, "--mesh", ",".join(map(str, NCCL_MESH)))
        require(run["launches"] == [0, 0, 0], "17b: a kernel launched in "
                "the launching process")
        res["by_rank"] = rank_launches(os.path.join(out, "tlab.log"))
        with open(os.path.join(out, "tlab.log")) as fh:
            res["describe"] = [ln.split(":", 1)[1].strip() for ln in fh
                               if ln.startswith("Mesh ")][0]
        rows = data_rows(os.path.join(out, "dns.out"))
        got = fields_io.read_field(os.path.join(out, f"flow.{NCCL_STEPS}.1"))
        require(np.isfinite(got[0]).all() and got[0].shape == MAIN_SHAPE,
                "17b: the restart")
        res["seconds"], res["trace"] = run["seconds"], run["trace"]
    ref = data_rows(os.path.join(initial, SAVED_6A["dns.out"]))
    require(len(rows) == NCCL_STEPS + 1, f"17b: dns.out rows {len(rows)}")
    res["rows"], res["dil"] = row_errors(rows, ref[:NCCL_STEPS + 1])
    n_sub = substeps(text)
    res["rate"] = step_rate(res["trace"], NCCL_STEPS, n_sub)
    res["rate_6a"] = step_rate(
        read_trace(os.path.join(initial, SAVED_6A["tlab.trace"])),
        NCCL_STEPS, n_sub)
    res["transposes"] = mesh_transposes(NCCL_MESH, MAIN_SHAPE)
    require("backend nccl" in res["describe"], f"17b: {res['describe']}")
    require(len(res["by_rank"]) == 1
            and all(n >= NCCL_STEPS * n_sub for n in res["by_rank"][0]),
            f"17b: launches {res['by_rank']}")
    return res


def phase_mesh(card: str, initial: str) -> dict:
    """Phase 17, each part's line."""
    t17 = time.perf_counter()
    a = phase_mesh_ekman(card)
    tr = a["transposes"]
    print(f"[mesh] 17a examples/ekman_mesh {EKMAN_SHAPE} fp32, "
          f"{MESH_STEPS} RK3 steps ({card}): {a['describe']}; one device "
          f"{a['single_rate']['seconds'] / MESH_STEPS:.4f} s/step "
          f"({a['single_rate']['ms_substep']:.3f} ms/substep), the mesh "
          f"{a['mesh_rate']['seconds'] / MESH_STEPS:.4f} s/step "
          f"({a['mesh_rate']['ms_substep']:.3f} ms/substep; its other "
          f"steps' median {a['mesh_rate']['others_ms_substep']:.3f}); dns "
          f"{a['single']['seconds']:.1f} s and {a['mesh']['seconds']:.1f} "
          f"s; launches one device {a['single_launches']}, by rank "
          f"{a['by_rank']}; dns.out against one device: columns "
          f"{a['rows']:.3e} (limit {MESH_ROW_TOL}), DilMin/DilMax "
          f"{a['dil']:.3e} (limit {MESH_DIL_TOL}); restarts "
          + ", ".join(f"{k} {v:.3e}" for k, v in a["fields"].items())
          + f" (limit {MESH_FIELD_TOL}); towers {len(a['towers'])} files; "
          f"transpose round trip ({tr['backend']}, {tr['mesh']}, "
          f"{tr['shape']}) {1e3 * tr['transpose_roundtrip_time_s']:.3f} ms, "
          f"{tr['transpose_bandwidth_GBps']:.3f} GB/s")
    require(a["rows"] <= MESH_ROW_TOL and a["dil"] <= MESH_DIL_TOL,
            f"17a dns.out: {a['rows']}, {a['dil']}")
    require(max(a["fields"].values()) <= MESH_FIELD_TOL,
            f"17a restarts: {a['fields']}")
    b = phase_mesh_nccl(card, initial)
    tr = b["transposes"]
    print(f"[mesh] 17b shear layer {MAIN_SHAPE} fp32 dns --mesh 1,1, "
          f"{NCCL_STEPS} steps from 6a's fields ({card}): {b['describe']}; "
          f"{b['rate']['seconds'] / NCCL_STEPS:.4f} s/step "
          f"({b['rate']['ms_substep']:.3f} ms/substep, its other steps' "
          f"median {b['rate']['others_ms_substep']:.3f}) beside 6a's "
          f"{b['rate_6a']['seconds'] / NCCL_STEPS:.4f} s/step "
          f"({b['rate_6a']['ms_substep']:.3f}, median "
          f"{b['rate_6a']['others_ms_substep']:.3f}); dns {b['seconds']:.1f}"
          f" s; launches {b['by_rank'][0]}; rows against 6a's: columns "
          f"{b['rows']:.3e} (limit {NCCL_ROW_TOL}), DilMin/DilMax "
          f"{b['dil']:.3e} (limit {NCCL_DIL_TOL}); transpose round trip "
          f"({tr['backend']}, {tr['mesh']}, {tr['shape']}) "
          f"{1e3 * tr['transpose_roundtrip_time_s']:.3f} ms")
    require(b["rows"] <= NCCL_ROW_TOL and b["dil"] <= NCCL_DIL_TOL,
            f"17b rows: {b['rows']}, {b['dil']}")
    t17 = time.perf_counter() - t17
    print(f"[mesh] phase 17 took {t17:.1f} s")
    return {"a": a, "b": b, "seconds": t17}


# ---------------------------------------------------------------------------
# Phase 18: the NaN trap (--debug-nans, [Main] DebugNans)
# ---------------------------------------------------------------------------

# 6b's grid of the shear layer
TRAP_GRID = {("Grid", "Imax"): "128", ("Grid", "Jmax"): "64",
             ("Grid", "Kmax"): "64", ("IniGridOx", "points_1"): "129",
             ("IniGridOy", "points_1"): "64",
             ("IniGridOz", "points_1"): "65"}
# 18a: a fixed dt 7x the CFL's first one at 128x64x64; a CPU fp32 run of
# the case makes its NaN at the 4th step (CFL 4.6e25 at the 3rd)
BLOWUP_DT = "0.1"
BLOWUP_STEPS = 8
TRAP_STEPS = 8               # 18b: 6b's case, restarts at 4 and 8
TRAP_COST_STEPS = 5          # 18d: 6a's case from 6a's fields
TRAP_PAIRS = 10              # steps off and on in turns, in one process
NAN_OP = re.compile(r"invalid value \(nan\) encountered in "
                    r"(aten\.[a-z0-9_]+\.[A-Za-z0-9_]+|burgers_[xyz])$")
# 18c: |x| ~ 1e38, finite in fp32; the [D1; D2] products overflow, and the
# combine (or the product's sum) meets inf - inf
OVERFLOW = 3e38


def trapped_dns(ini: str, out: str, *more) -> str:
    """`dns` through the CLI that must stop with the NaN trap's
    FloatingPointError: its message."""
    try:
        run_cli("dns", ini, out, *more)
    except FloatingPointError as e:
        return str(e)
    require(False, f"{out}: dns ran to its end under the NaN trap")


def trap_blow_up() -> dict:
    """18a: the shear layer at 128x64x64 with dt fixed at BLOWUP_DT: the
    untrapped run ends with its NaN row and status 1; with --debug-nans,
    and with [Main] DebugNans=yes, dns raises naming an op, after the
    untrapped run's rows before its NaN row."""
    text = edit_case(CASE.read_text(), {
        **TRAP_GRID, ("Main", "TimeStep"): BLOWUP_DT,
        ("Iteration", "End"): str(BLOWUP_STEPS),
        ("Iteration", "Restart"): str(BLOWUP_STEPS),
        ("Iteration", "Statistics"): str(BLOWUP_STEPS)})
    res = {}
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as top:
        start = os.path.join(top, "start")
        os.makedirs(start)
        ini = write_case(start, text)
        run_cli("inigrid", ini, start)
        run_cli("ini", ini, start)
        plain = os.path.join(top, "plain")
        shutil.copytree(start, plain)
        run_cli("dns", write_case(plain, text), plain)
        rows = data_rows(os.path.join(plain, "dns.out"))
        require(rows[-1][0] == "1" and "NaN" in rows[-1]
                and all(r[0] == "0" for r in rows[:-1])
                and len(rows) < BLOWUP_STEPS + 1,
                f"18a: the untrapped run's rows {rows}")
        res["nan_step"] = int(rows[-1][1])
        for how, more, case in (
                ("flag", ("--debug-nans",), text),
                ("key", (), add_keys(text, "Main", ["DebugNans=yes"]))):
            out = os.path.join(top, how)
            shutil.copytree(start, out)
            msg = trapped_dns(write_case(out, case), out, *more)
            require(NAN_OP.match(msg), f"18a ({how}): {msg}")
            got = data_rows(os.path.join(out, "dns.out"))
            require(got == rows[:-1], f"18a ({how}): rows {got}, the "
                    f"untrapped run's before its NaN row {rows[:-1]}")
            res[how] = msg
    return res


def trap_runs(text: str, steps: int, start: str, order) -> dict:
    """dns of `text` from the initial fields in `start` (linked) with the
    trap off and on in `order`: each run's traced_dns, the SHA-256 of its
    files but the log, trace and case, and its ms/substep."""
    n_sub = substeps(text)
    runs = {}
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as top:
        for i, trap in enumerate(order):
            out = os.path.join(top, f"run{i}")
            link_initial_fields(start, out)
            r = traced_dns(write_case(out, text), out,
                           *(("--debug-nans",) if trap else ()))
            r["rate"] = step_rate(r["trace"], steps, n_sub)
            r["files"] = {f: hashlib.sha256(pathlib.Path(out, f)
                                            .read_bytes()).hexdigest()
                          for f in sorted(os.listdir(out))
                          if f not in INITIAL_FILES + ("tlab.log",
                                                       "tlab.trace",
                                                       "tlab.ini")}
            runs.setdefault(trap, []).append(r)
    off, on = runs[False], runs[True]
    for r in off[1:] + on:
        require(r["files"] == off[0]["files"], "the run with the trap on "
                "wrote other files than without it: " + ", ".join(
                    f for f in off[0]["files"]
                    if r["files"].get(f) != off[0]["files"][f]))
        require(r["launches"] == off[0]["launches"],
                f"launches {r['launches']} against {off[0]['launches']}")
    ms = {k: statistics.mean(r["rate"]["ms_substep"] for r in v)
          for k, v in runs.items()}
    med = {k: statistics.mean(r["rate"]["others_ms_substep"] for r in v)
           for k, v in runs.items()}
    return {"off": off, "on": on, "ms": ms, "others": med,
            "files": sorted(off[0]["files"]),
            "launches": off[0]["launches"],
            "cost": (ms[True] - ms[False]) / ms[False],
            "cost_others": (med[True] - med[False]) / med[False]}


def trap_same_numbers() -> dict:
    """18b: 6b's case (128x64x64), TRAP_STEPS steps with the trap off and
    on in turns, three times each: dns.out, the restarts and the avg tables
    bit for bit, the launches equal; ms/substep of both."""
    text = edit_case(CASE.read_text(), {
        **TRAP_GRID, ("Iteration", "End"): str(TRAP_STEPS),
        ("Iteration", "Restart"): str(TRAP_STEPS // 2),
        ("Iteration", "Statistics"): str(TRAP_STEPS)})
    with tempfile.TemporaryDirectory(prefix="tlab_smoke_") as start:
        run_cli("ini", write_case(start, text), start)
        res = trap_runs(text, TRAP_STEPS, start, (False, True) * 3)
        res["pairs"] = trap_step_cost(text, start)
    return res


def trap_step_cost(text: str, start: str) -> dict:
    """The trap's cost a step in one process: dns's step function (a region)
    on the case's initial fields in `start`, TRAP_PAIRS pairs of steps with
    the trap off and on in turns (the first of a pair alternating), each
    timed on the host clock to its synchronize, as the loop's host read
    ends a step: the medians, and the quartiles of the pairs'
    differences."""
    sim = Simulation.from_case(load_case(Ini(text=text)),
                               dtype=torch.float32, device="cuda")
    u, v, w, s, _, _ = fields_io.read_state(
        os.path.join(start, "flow"), os.path.join(start, "scal"), 0,
        sim.nsp.n_scalars)
    state = state_from_numpy(u, v, w, s, "cuda", torch.float32)
    raw, diagnostics = dns_tool.make_step_functions(sim)
    step, _ = dns_tool._trapped(raw, diagnostics)
    dt = dyn.next_dt(sim.P, float(diagnostics(state)[0]),
                     sim.case.time_cfl, sim.case.time_cfl_diffusive)

    def timed(trap: bool) -> float:
        with nantrap.trap(trap):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, dt)[2].tolist()
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0)

    timed(False), timed(True)                       # warm-up
    times = {False: [], True: []}
    for i in range(TRAP_PAIRS):
        for trap in ((False, True) if i % 2 == 0 else (True, False)):
            times[trap].append(timed(trap))
    diffs = [b - a for a, b in zip(times[False], times[True])]
    q1, _, q3 = statistics.quantiles(diffs, n=4)
    off = statistics.median(times[False])
    return {"off_ms": off, "on_ms": statistics.median(times[True]),
            "diff_ms": statistics.median(diffs), "q1": q1, "q3": q3,
            "share": statistics.median(diffs) / off}


def trap_kernels() -> list:
    """18c: K1-K3 on a finite input whose products overflow: without the
    trap each returns its NaN; under the trap each raises naming its own
    entry point."""
    sim = Simulation.from_case(load_case(Ini(text=edit_case(
        CASE.read_text(), TRAP_GRID))), dtype=torch.float32, device="cuda")
    shape = sim.grid.shape
    gen = torch.Generator(device="cuda").manual_seed(18)
    x = OVERFLOW * (2.0 * torch.rand((2,) + shape, generator=gen,
                                     device="cuda") - 1.0)
    conv = torch.rand(shape, generator=gen, device="cuda") + 0.5
    nu = torch.tensor((sim.P["visc"],) * 2, dtype=torch.float32,
                      device="cuda")
    require(bool(torch.isfinite(x).all()), "18c: the input is not finite")
    msgs = []
    for axis in range(3):
        d12 = sim.P["d12" + "xyz"[axis]]
        out = burgers.fused_burgers(d12, x, conv, nu, axis)
        n_nan = int(torch.isnan(out).sum())
        require(n_nan > 0, f"18c: {burgers.ENTRY_POINTS[axis]} made no NaN")
        try:
            with nantrap.trap():
                burgers.fused_burgers(d12, x, conv, nu, axis)
        except FloatingPointError as e:
            msgs.append((str(e), n_nan))
        else:
            require(False, f"18c: {burgers.ENTRY_POINTS[axis]} under the "
                    "trap returned")
        require(msgs[-1][0] == "invalid value (nan) encountered in "
                + burgers.ENTRY_POINTS[axis], f"18c: {msgs[-1][0]}")
    return msgs


def trap_cost(initial: str) -> dict:
    """18d: 6a's case (512x256x256) from 6a's fields, TRAP_COST_STEPS steps
    with the trap off, on, on, off (no restart or statistics step: 18b
    holds those): dns.out and the launches the same, the trap's cost a
    substep; then its cost a step from TRAP_PAIRS pairs in one process."""
    steps = TRAP_COST_STEPS
    text = edit_case(CASE.read_text(), {
        ("Iteration", "End"): str(steps),
        ("Iteration", "Restart"): str(10 * steps),
        ("Iteration", "Statistics"): str(10 * steps)})
    res = trap_runs(text, steps, initial, (False, True, True, False))
    res["pairs"] = trap_step_cost(text, initial)
    return res


def pairs_text(r: dict) -> str:
    return (f"{TRAP_PAIRS} pairs of steps in one process: off {r['off_ms']:.3f}"
            f" ms, on {r['on_ms']:.3f} ms (medians), the trap "
            f"{r['diff_ms']:.3f} ms a step (quartiles {r['q1']:.3f}, "
            f"{r['q3']:.3f}): {100 * r['share']:.2f}%")


def each_run(res: dict) -> str:
    """ms/substep of each run, off and on, in run order."""
    return "; ".join(
        f"{'on' if trap else 'off'} " + ", ".join(
            f"{r['rate']['ms_substep']:.4f}" for r in res[
                "on" if trap else "off"]) for trap in (False, True))


def phase_nantrap(card: str, initial: str) -> dict:
    """Phase 18, each part's line."""
    t18 = time.perf_counter()
    a = trap_blow_up()
    print(f"[nantrap] 18a shear layer 128x64x64 fp32, TimeStep={BLOWUP_DT} "
          f"({card}): the untrapped run's NaN row at step {a['nan_step']} "
          f"(status 1); dns --debug-nans: {a['flag']!r}; [Main] "
          f"DebugNans=yes: {a['key']!r}; both after the untrapped rows "
          f"before it")
    b = trap_same_numbers()
    print(f"[nantrap] 18b shear layer 128x64x64 fp32, {TRAP_STEPS} steps "
          f"off/on x 3 ({card}): {len(b['files'])} files bit for bit "
          f"({', '.join(b['files'])}); launches {b['launches']} each run; "
          f"ms/substep off {b['ms'][False]:.4f}, on {b['ms'][True]:.4f} "
          f"(the other steps' median {b['others'][False]:.4f}, "
          f"{b['others'][True]:.4f}): the trap costs "
          f"{100 * b['cost']:.2f}% ({100 * b['cost_others']:.2f}%); each "
          f"run {each_run(b)}; {pairs_text(b['pairs'])}")
    c = trap_kernels()
    print(f"[nantrap] 18c K1-K3 on |x| ~ {OVERFLOW:.0e} fp32 ({card}): "
          + "; ".join(f"{burgers.ENTRY_POINTS[i]} {n} NaN without the trap, "
                      f"under it {m!r}" for i, (m, n) in enumerate(c)))
    d = trap_cost(initial)
    print(f"[nantrap] 18d shear layer {MAIN_SHAPE} fp32, {TRAP_COST_STEPS} "
          f"steps off/on/on/off from 6a's fields ({card}): "
          f"{len(d['files'])} files bit for bit; launches {d['launches']} "
          f"each run; ms/substep off {d['ms'][False]:.4f}, on "
          f"{d['ms'][True]:.4f} (the other steps' median "
          f"{d['others'][False]:.4f}, {d['others'][True]:.4f}): the trap "
          f"costs {100 * d['cost']:.2f}% ({100 * d['cost_others']:.2f}%); "
          f"each run {each_run(d)}; {pairs_text(d['pairs'])}")
    t18 = time.perf_counter() - t18
    print(f"[nantrap] phase 18 took {t18:.1f} s")
    return {"a": a, "b": b, "c": c, "d": d, "seconds": t18}

# ---------------------------------------------------------------------------
# Phase 19: tlab_tpu's other two arithmetic contracts of the Burgers kernel
# (TLAB_TPU_MATMUL_PRECISION=high, default) and TLAB_TPU_SING_MODE=legacy
# ---------------------------------------------------------------------------

# the bf16 contracts, the branches of tlab_tpu's _dot they port
BF16_CONTRACTS = ("high", "default")
# 19c: tlab_tpu's documented fp32 drift a step at "default" (its
# ops/derivative.py:op_precision): the default contract's drift is printed
# beside 5 steps of it, not held
DEFAULT_DRIFT_A_STEP = 2.5e-2
# 19d: the factorized solve in fp64 on the card against the CPU's fp64
# solve (round-off of the same tables), and legacy apart from the
# reference mode (0.674 of max|p| at 16x33x8 on the CPU)
LEGACY_TOL = 1e-10
LEGACY_APART = 1e-3
LEGACY_SHAPE = (64, 65, 32)


def phase_contract_kernels(P) -> list:
    """19a: the bf16 variants of K1-K3 against their plain versions (the
    same split) at the ragged shapes and at the main path's, timed there."""
    gen = torch.Generator(device="cuda").manual_seed(19)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    records = []
    nu = torch.tensor((P["visc"],) * 3 + P["diff"], dtype=torch.float32,
                      device="cuda")
    x = randn(len(nu), *MAIN_SHAPE)
    conv = randn(*MAIN_SHAPE)
    for prec in BF16_CONTRACTS:
        names = burgers.entry_points(prec)
        for F, shape in RAGGED:
            errs = []
            for axis in range(3):
                n = shape[axis]
                r = check_kernel(axis, randn(2 * n, n), randn(F, *shape),
                                 randn(*shape),
                                 torch.rand(F, generator=gen, device="cuda"),
                                 False, prec)
                errs.append(f"{names[axis]} {r['rel_err']:.3e}")
            print(f"[precision] 19a {prec} F={F} {shape}: rel err "
                  + ", ".join(errs))
        for axis in range(3):
            r = check_kernel(axis, P["d12" + "xyz"[axis]], x, conv, nu, True,
                             prec)
            # "default" is the one bf16 product (and the combine): the bf16
            # call is its library time; no one call computes "high"'s
            # 3-pass split, so there it is printed beside the kernel only
            library = r["bf16_call_ms"] if prec == "default" else None
            print(f"[precision] 19a {names[axis]} F={len(nu)} {MAIN_SHAPE}: "
                  f"max|err| {r['max_abs_err']:.3e} (rel {r['rel_err']:.3e}) "
                  f"against its plain version (the same bf16 split); "
                  f"max|. - fp64| / max|fp64| {r['kernel_vs_fp64']:.3e} "
                  f"(plain {r['plain_vs_fp64']:.3e}); kernel {r['ms']:.3f} "
                  f"ms, plain {r['plain_ms']:.3f} ms, the bf16 call "
                  f"{r['bf16_call_ms']:.3f} ms ({r['bf16_call']}, cast "
                  f"outside the timing; library_ms "
                  + ("this call" if library is not None else
                     "none: no one call computes the 3-pass split")
                  + f"), the fp32 matmul {r['fp32_matmul_ms']:.3f} ms "
                  f"(reference; median of {REPS}, in turns); bound "
                  f"{r['bound_ms']:.3f} ms by {r['bound_by']} ({r['unit']} x"
                  f"{burgers.CONTRACTS[prec][1]}: {r['ops_ms']:.3f} ms, "
                  f"bytes: {r['bytes_ms']:.3f} ms)")
            records.append({
                "name": names[axis], "route": "cuda", "source": SOURCE,
                "replaces": f"{REPLACES[axis]} prec_name={prec} "
                            "(_dot, tlab_tpu/ops/pallas_burgers.py:38)",
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": library,
                "bf16_call_ms": r["bf16_call_ms"],
                "fp32_matmul_ms": r["fp32_matmul_ms"],
                "kernel_vs_fp64": r["kernel_vs_fp64"]})
    return records


def phase_contract_main(prec: str, P, state) -> list:
    """19b: the main path at 512x256x256 under TLAB_TPU_MATMUL_PRECISION=
    prec from phase 4's initial state, 3 timed RK4 steps after a warm-up:
    the contract's entry points launch 5 a step each and no other
    contract's."""
    with mock.patch.dict(os.environ, {"TLAB_TPU_MATMUL_PRECISION": prec}):
        state, _ = dyn.rk_loop_stacked(P, state, entry.DT, 1)     # warm-up
        torch.cuda.synchronize()
        burgers.reset_launches()
        t0 = time.perf_counter()
        state, _ = dyn.rk_loop_stacked(P, state, entry.DT, STEPS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: list(v) for k, v in burgers.contract_launches.items()}
    substeps = STEPS * len(P["rk"]["kdt"])
    want = {k: [substeps] * 3 if k == prec else [0, 0, 0] for k in counts}
    require(counts == want, f"19b {prec}: launches {counts}, expected "
                            f"{want}")
    for name, a in zip("uvws", (state.u, state.v, state.w, state.s)):
        require(bool(torch.isfinite(a).all()), f"19b {prec}: non-finite "
                                               f"{name}")
    MAIN_MS[prec] = 1e3 * seconds / substeps
    dmin, dmax = (float(d) for d in dyn.dilatation_minmax(P, state))
    print(f"[precision] 19b {MAIN_SHAPE} fp32 RK4 under "
          f"TLAB_TPU_MATMUL_PRECISION={prec}: {STEPS} steps, "
          f"{MAIN_MS[prec]:.3f} ms/substep (phase 4, highest: "
          f"{MAIN_MS['highest']:.3f}); dilatation [{dmin:.4e}, {dmax:.4e}]; "
          f"launches {counts}")
    return counts[prec]


def phase_contract_drift() -> None:
    """19c: phase 5's fp32-against-fp64 run under each bf16 contract."""
    for prec in BF16_CONTRACTS:
        with mock.patch.dict(os.environ, {"TLAB_TPU_MATMUL_PRECISION": prec}):
            rel = fp32_drift()
        if prec == "high":
            print(f"[precision] 19c high: 128x64x64, 5 RK4 steps: max|u32 - "
                  f"u64| / max|u64| = {rel:.3e} (limit {FP64_TOL}: "
                  f"tlab_tpu's 5.9e-5 a step at high, x5)")
            require(rel <= FP64_TOL, f"19c high: {rel} > {FP64_TOL}")
        else:
            print(f"[precision] 19c default: 128x64x64, 5 RK4 steps: max|u32"
                  f" - u64| / max|u64| = {rel:.3e} (not held; tlab_tpu "
                  f"documents {DEFAULT_DRIFT_A_STEP} a step at default, "
                  f"{5 * DEFAULT_DRIFT_A_STEP:.3g} over 5)")


def phase_legacy() -> None:
    """19d: the factorized Poisson solve in fp64 on the card under
    TLAB_TPU_SING_MODE=legacy against the CPU's, and apart from the
    reference mode's."""
    from tlab_tpu_torch.grid import uniform_grid
    nx, ny, nz = LEGACY_SHAPE
    grid = uniform_grid(nx, ny, nz, 2.0 * np.pi, 1.0, np.pi)
    plan = fac.build_factorize_plan(build_fdm_plan(grid))
    y = np.asarray(grid.y.nodes)
    f = np.random.default_rng(19).standard_normal((nx, ny, nz)) \
        + 3.0 * np.cos(np.pi * y)[None, :, None]
    out = {}
    for dev in ("cuda", "cpu"):
        fd = torch.from_numpy(f).to(dev)
        dplan = fac.device_factorize_plan(plan, torch.float64, dev)
        with mock.patch.dict(os.environ, {"TLAB_TPU_SING_MODE": "legacy"}):
            out[dev] = [a.cpu() for a in fac.poisson_factorize(dplan, fd)]
        if dev == "cuda":
            with mock.patch.dict(os.environ,
                                 {"TLAB_TPU_SING_MODE": "reference"}):
                out["reference"] = [a.cpu() for a in
                                    fac.poisson_factorize(dplan, fd)]
    parts = []
    for i, name in enumerate(("p", "dp/dy")):
        scale = out["cpu"][i].abs().max().item()
        err = (out["cuda"][i] - out["cpu"][i]).abs().max().item() / scale
        apart = (out["cuda"][i] - out["reference"][i]).abs().max().item() \
            / scale
        require(err <= LEGACY_TOL, f"19d {name}: card vs CPU {err} > "
                                   f"{LEGACY_TOL}")
        require(apart > LEGACY_APART, f"19d {name}: legacy vs reference "
                                      f"{apart} <= {LEGACY_APART}")
        parts.append(f"{name} card vs CPU {err:.3e} (limit {LEGACY_TOL}), "
                     f"legacy vs reference {apart:.3e} (> {LEGACY_APART})")
    print(f"[precision] 19d factorized solve {LEGACY_SHAPE} fp64 under "
          f"TLAB_TPU_SING_MODE=legacy, of max|.|: " + "; ".join(parts))


def phase_precision() -> dict:
    """Phase 19: 19a-19d; the records of the bf16 variants with their
    launches on 19b's runs."""
    t0 = time.perf_counter()
    _, P, state = entry.build(*MAIN_SHAPE, torch.float32, "cuda", seed=0)
    records = phase_contract_kernels(P)
    launches = {prec: phase_contract_main(prec, P, state)
                for prec in BF16_CONTRACTS}
    del P, state
    for rec in records:
        prec = rec["name"].rsplit("_", 1)[1]
        rec["launches"] = launches[prec]["xyz".index(rec["name"][8])]
    phase_contract_drift()
    phase_legacy()
    seconds = time.perf_counter() - t0
    print(f"[precision] phase 19 took {seconds:.1f} s")
    return {"records": records, "seconds": seconds}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this script runs only on one",
              file=sys.stderr)
        return 1
    tdevice.full_fp32_matmul()
    name, smi = phase_device()
    phase_build()
    _, P, state = entry.build(*MAIN_SHAPE, torch.float32, "cuda", seed=0)
    records = phase_kernels(P)
    launches = phase_main(P, state)
    for rec, n in zip(records, launches):
        rec["launches"] = n
    del P, state
    deriv_records = phase_deriv_kernels() + phase_comp_rhs_kernels(smi)
    phase_fp64()
    # 6a's initial fields at 512x256x256, for phases 7, 8c and 10b
    keep = tempfile.TemporaryDirectory(prefix="tlab_smoke_")
    initial = keep.name
    for rec, n in zip(records, phase_dns_case(smi, initial)):
        rec["dns_launches"] = n
    phase_dns_restart()
    for tag in OPTION_CASES:
        for rec, n in zip(records, phase_option(tag, smi, initial)):
            rec[f"launches_{tag}"] = n
    phase_variants(smi, initial)
    t8 = time.perf_counter()
    for rec, err in zip(records, check_case_kernels(moist_case("8a", {}))):
        rec["max_abs_err_8a"] = err
    for tag in MOIST_CASES:
        for rec, n in zip(records, phase_moist(tag, smi, initial)):
            rec[f"launches_{tag}"] = n
    t8 = time.perf_counter() - t8
    phase_options_fp64()
    phase_direct_solver(smi)
    t8d = time.perf_counter()
    phase_moist_fp64()
    t8d = time.perf_counter() - t8d
    print(f"[moist] phase 8 took {t8:.1f} s (8a-8c) + {t8d:.1f} s (8d)")
    t9 = time.perf_counter()
    for tag, text in (("9b", ekman_case(EKMAN_SHAPE, EKMAN_STEPS)),
                      ("9c", jet_case(JET_SHAPE, JET_STEPS))):
        for rec, err in zip(records, check_case_kernels(text)):
            rec[f"max_abs_err_{tag}"] = err
    for tag, phase in (("9a", phase_ibm), ("9b", phase_ekman),
                       ("9c", phase_jet)):
        for rec, n in zip(records, phase(smi)):
            rec[f"launches_{tag}"] = n
    t9 = time.perf_counter() - t9
    t9d = time.perf_counter()
    phase_boundary_fp64()
    t9d = time.perf_counter() - t9d
    print(f"[boundary] phase 9 took {t9:.1f} s (9a-9c) + {t9d:.1f} s (9d)")
    t10 = time.perf_counter()
    text = ekman_smr91_case(EKMAN_SHAPE, SMR91_STEPS)
    for rec, err in zip(records, check_case_kernels(text, nu_zero=True)):
        rec["max_abs_err_10a"] = err
    for rec, n in zip(records, phase_smr91_ekman(smi)):
        rec["launches_10a"] = n
    for rec, n in zip(records, phase_smr91_shear(smi, initial)):
        rec["launches_10b"] = n
    phase_smr91_fp64()
    t10 = time.perf_counter() - t10
    t11 = time.perf_counter()
    for tag, shape, expect in (("11a", LONG_X_SHAPE, [0, 25, 25]),
                               ("11b", LONG_Y_SHAPE, [25, 0, 25])):
        errs = check_case_kernels(long_line_case(shape))
        require([e is not None for e in errs] == [n > 0 for n in expect],
                f"{tag}: kernels checked {errs}, launches expected {expect}")
        for rec, err in zip(records, errs):
            if err is not None:
                rec[f"max_abs_err_{tag}"] = err
        for rec, n in zip(records, phase_long_line(tag, smi, shape, expect)):
            rec[f"launches_{tag}"] = n
    phase_crossover(smi)
    t11 = time.perf_counter() - t11
    t12 = time.perf_counter()
    comp_records = [r for r in deriv_records if r["source"] == COMP_SOURCE]

    def comp_counts(tag, fused):
        for rec in comp_records:
            rec[f"launches_{tag}"] = fused[rec["name"]]
    for tag, got, fused in zip(("12a", "12b"), *phase_compressible(smi)):
        for rec, n in zip(records, got):
            rec[f"launches_{tag}"] = n
        comp_counts(tag, fused)
    phase_compressible_fp64()
    t12 = time.perf_counter() - t12
    t13 = time.perf_counter()
    for rec, n in zip(records, phase_airwater(smi)):
        rec["launches_13a"] = n
    for tag, text in (("13b1", open_case(COMP_SHAPE, COMP_STEPS)),
                      ("13b2", mix_case(COMP_SHAPE, COMP_STEPS))):
        got, fused = phase_open(tag, smi, text)
        for rec, n in zip(records, got):
            rec[f"launches_{tag}"] = n
        comp_counts(tag, fused)
    phase_case14_fp64(smi)
    phase_case14_fp32()
    for rec, n in zip(records, phase_spatial_comp(smi)):
        rec["launches_13e"] = n
    t13 = time.perf_counter() - t13
    t14 = time.perf_counter()
    errs = [max(a, b) for a, b in zip(
        check_case_kernels(stats_case(), fields=3),
        check_case_kernels(stats_case(), fields=3, zero_conv=True))]
    for rec, err in zip(records, errs):
        rec["max_abs_err_14"] = err
    stats = phase_stats(smi, initial)
    report_stats(smi, stats)
    for cmd, got in stats["launches"].items():
        for rec, n in zip(records, got):
            rec[f"launches_14{cmd}"] = n
    t14 = time.perf_counter() - t14
    t15 = time.perf_counter()
    for rec, err in zip(records, check_case_kernels(particle_case())):
        rec["max_abs_err_15a"] = err
    parts = phase_particles(smi)
    planes = phase_planes_towers(smi, initial)
    t15 = time.perf_counter() - t15
    errs = [max(a, b) for a, b in zip(
        check_case_kernels(visuals_case(), fields=3),
        check_case_kernels(visuals_case(), fields=3, zero_conv=True))]
    for rec, err in zip(records, errs):
        rec["max_abs_err_16a"] = err
    tools = phase_tools(smi, initial)
    for key, got in (("15a", parts["15a"]),
                     ("15b_inertia", parts["15b_inertia"]),
                     ("15b_bil_cloud", parts["15b_bil_cloud"]),
                     ("15c", planes["launches_planes"]),
                     ("15c_towers", planes["launches_towers"])):
        for rec, n in zip(records, got):
            rec[f"launches_{key}"] = n
    for rec, n in zip(records, tools["launches_16a"]):
        rec["launches_16a"] = n
    mesh = phase_mesh(smi, initial)
    trap = phase_nantrap(smi, initial)
    keep.cleanup()
    precision = phase_precision()
    for axis, rec in enumerate(records):
        k = mesh["a"]["kernels"][axis]
        rec["mesh_17a"] = {key: k[key] for key in (
            "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}
        rec["max_abs_err_17a"] = k["max_abs_err"]
        by_rank = [r[axis] for r in mesh["a"]["by_rank"]]
        rec["launches_17a_by_rank"] = by_rank
        rec["launches_17a"] = sum(by_rank)
        rec["launches_17b"] = mesh["b"]["by_rank"][0][axis]
        rec["launches_18b"] = trap["b"]["launches"][axis]
        rec["launches_18d"] = trap["d"]["launches"][axis]
    print(f"[slice] phase 10 took {t10:.1f} s, 11 {t11:.1f} s, 12 "
          f"{t12:.1f} s, 13 {t13:.1f} s, 14 {t14:.1f} s, 15 {t15:.1f} s, "
          f"16 {tools['seconds']:.1f} s, 17 {mesh['seconds']:.1f} s, 18 "
          f"{trap['seconds']:.1f} s, 19 {precision['seconds']:.1f} s")
    print(json.dumps({"kernels": records + deriv_records
                      + precision["records"]}))
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
