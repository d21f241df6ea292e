"""Startup self-test + micro-benchmark (reference OPR_CHECK,
src/operators/opr_check.f90:6-136; port of tlab_tpu/ops/check.py).

Validates the runtime's operator round-trips on the run's device and
reports timings: the FFT round-trip residual, the first derivative of the
first Fourier mode along x, the Poisson error on a manufactured field.
Called by dns.run(opr_check=True) at startup; the report goes to the run
log before its header.

tlab_tpu also reports the round trip of its matmul DFT (ops/rdft.py, the
TPU's f32 transform); the port transforms with torch.fft and has no such
module, so it has no rdft_* keys.  The random field is drawn from a
torch.Generator: its values are not jax.random's.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from tlab_tpu_torch.dycore import incompressible as dyn
from tlab_tpu_torch.ops import elliptic


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def opr_check(sim, generator: torch.Generator = None) -> dict:
    """{key: value} of the self-test on sim's device and dtype; the random
    field from `generator` (default: seed 0 on that device)."""
    nx, ny, nz = sim.grid.shape
    dev, dtype = sim.device, sim.dtype
    gen = generator if generator is not None \
        else torch.Generator(device=dev).manual_seed(0)
    u = torch.randn((nx, ny, nz), generator=gen, dtype=dtype, device=dev)

    out = {}

    # FFT round trip (the reference checks forward+backward transpose/FFT)
    _sync(dev)
    t0 = time.perf_counter()
    u_back = torch.fft.irfft(torch.fft.rfft(u, dim=0), n=nx, dim=0)
    _sync(dev)
    out["fft_roundtrip_residual"] = float((u_back - u).abs().max())
    out["fft_time_s"] = time.perf_counter() - t0

    kw = {"dtype": dtype, "device": dev}
    X = torch.as_tensor(sim.grid.x.nodes, **kw)[:, None, None]
    ones = torch.ones((nx, ny, nz), **kw)
    if sim.grid.x.periodic:
        # the first derivative of the first Fourier mode
        k0 = 2 * np.pi / sim.grid.x.scale
        df = dyn._d1(sim.P, "x", 0, torch.sin(k0 * X) * ones)
        out["d1x_mode1_error"] = float((df - k0 * torch.cos(k0 * X))
                                       .abs().max())

    # Poisson residual on a smooth manufactured field
    _sync(dev)
    t0 = time.perf_counter()
    Y = torch.as_tensor(sim.grid.y.nodes, **kw)[None, :, None]
    ly = sim.grid.y.scale
    p_exact = torch.cos(2 * np.pi * X / sim.grid.x.scale) \
        * torch.cos(np.pi * Y / ly)
    lap = (-(2 * np.pi / sim.grid.x.scale) ** 2 - (np.pi / ly) ** 2) \
        * p_exact
    p = elliptic.poisson(sim.P["ell"], lap * ones)
    _sync(dev)
    out["poisson_time_s"] = time.perf_counter() - t0
    pm = p - p.mean()
    pe = p_exact - p_exact.mean()
    out["poisson_error"] = float((pm - pe).abs().max())
    return out


def format_report(results: dict) -> str:
    lines = ["# OPR_CHECK startup self-test"]
    for k, v in results.items():
        lines.append(f"#   {k}: {v:.6e}" if isinstance(v, float)
                     else f"#   {k}: {v}")
    return "\n".join(lines)
