"""The benchmark's initial fields, made on the device from --seed.

Each configuration names a recipe ("initial": {"kind": ...}), a file of
its own, initial/<kind>.py, whose make(case, params, seed, device, dtype)
returns the stack of the case's equation set (harness/sets.py: u, v, w,
s1.., or rho, rho u, rho v, rho w, rho e, rho s1..) in the
configuration's dtype, made in a few large calls of a generator on the
device: the same seed gives the same fields.  The recipes are the
benchmark's own copies of the tlab cases' initial conditions; the
helpers they share are here.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from reference.case import Case
from reference.step import profile


def axes(case: Case):
    """(nodes, length) of x, y, z: uniform, a periodic axis without its
    wrap node."""
    out = []
    for d in "xyz":
        nodes = np.linspace(0.0, case.float(f"IniGridO{d}", "scales_1", 1.0),
                            case.int(f"IniGridO{d}", "points_1", 1))
        periodic = case.bool("Grid", f"{d.upper()}Periodic", False)
        out.append((nodes[:-1] if periodic else nodes, nodes[-1]))
    return out


def scalar_profiles(case: Case, y, shape, device):
    """The case's scalar mean profiles as a (ns, nx, ny, nz) stack."""
    ns = len(case.floats("Parameters", "Schmidt", (1.0,)))
    return torch.stack([torch.as_tensor(
        profile(case, "Scalar", f"Scalar{i + 1}", y),
        device=device)[None, :, None].expand(shape) for i in range(ns)])


def curl_noise(gen, shape, lengths, f0, env, device):
    """A random velocity field (3, nx, ny, nz) free of divergence: the
    spectral curl of env(y) times a filtered random vector potential, y
    taken as periodic (env vanishes at the walls), float64."""
    nx, ny, nz = shape
    a = torch.randn((3, nx, ny, nz), generator=gen, device=device,
                    dtype=torch.float32).to(torch.float64)
    k = [2.0 * math.pi * torch.fft.fftfreq(n, d=L / n, device=device,
                                           dtype=torch.float64)
         for n, L in zip(shape, lengths)]
    k[2] = 2.0 * math.pi * torch.fft.rfftfreq(nz, d=lengths[2] / nz,
                                              device=device,
                                              dtype=torch.float64)
    kx, ky, kz = (k[0][:, None, None], k[1][None, :, None],
                  k[2][None, None, :])
    f = torch.sqrt(kx ** 2 + ky ** 2 + kz ** 2) / (2.0 * math.pi)
    ah = torch.fft.rfftn(a, dim=(1, 2, 3)) * torch.exp(-0.5 * (f / f0) ** 2)
    a = torch.fft.irfftn(ah, s=shape, dim=(1, 2, 3)) * env
    ah = torch.fft.rfftn(a, dim=(1, 2, 3))
    ax, ay, az = ah[0], ah[1], ah[2]
    u = 1j * (ky * az - kz * ay)
    v = 1j * (kz * ax - kx * az)
    w = 1j * (kx * ay - ky * ax)
    return torch.fft.irfftn(torch.stack([u, v, w]), s=shape, dim=(1, 2, 3))


def initial_stack(config: dict, ini: dict, seed: int, device, dtype,
                  bench_dir=None) -> torch.Tensor:
    """The configuration's initial stack (F, nx, ny, nz), F the number
    of the equation set's fields."""
    from harness.spec import BENCH_DIR, load_module
    params = config["initial"]
    mod = load_module((bench_dir or BENCH_DIR) / "initial"
                      / f"{params['kind']}.py", "initial")
    return mod.make(Case(ini), params, seed % (1 << 63), device, dtype)
