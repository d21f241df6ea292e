"""The cloud top's initial fields: the case's erf scalar profiles at
rest, plus the [Discrete] mode (ModeX, ModeZ, 2DAmpl) with phases drawn
from the seed, shaped in y by a Gaussian (the configuration's `thick` at
`ycoor`) and free of divergence, and a broadband perturbation of `noise`
times the mode's amplitude under the same Gaussian."""
from __future__ import annotations

import math

import torch

from harness.fields import axes, curl_noise, scalar_profiles


def make(case, params, seed, device, dtype):
    (x, lx), (y, ly), (z, lz) = axes(case)
    shape = (x.size, y.size, z.size)
    gen = torch.Generator(device=device).manual_seed(seed)
    amp = case.float("Discrete", "2DAmpl", 0.001)
    kx = 2.0 * math.pi * case.float("Discrete", "ModeX", 1.0) / lx
    kz = 2.0 * math.pi * case.float("Discrete", "ModeZ", 1.0) / lz
    phx, phz = (2.0 * math.pi * torch.rand(2, generator=gen, device=device,
                                           dtype=torch.float64)).tolist()
    ycoor = y[0] + (y[-1] - y[0]) * params["ycoor"]
    th = params["thick"]
    yd = torch.as_tensor(y, device=device)[None, :, None]
    g = torch.exp(-0.5 * ((yd - ycoor) / th) ** 2)
    dg = -(yd - ycoor) / th ** 2 * g
    xd = torch.as_tensor(x, device=device)[:, None, None]
    zd = torch.as_tensor(z, device=device)[None, None, :]
    cx, sx = torch.cos(kx * xd + phx), torch.sin(kx * xd + phx)
    cz, sz = torch.cos(kz * zd + phz), torch.sin(kz * zd + phz)
    k2 = kx ** 2 + kz ** 2
    vel = torch.stack([-amp * dg * sx * cz * kx / k2,
                       amp * g * cx * cz,
                       -amp * dg * cx * sz * kz / k2])
    noise = curl_noise(gen, shape, (lx, ly + (y[1] - y[0]), lz),
                       case.float("Broadband", "f0", 6.0), g, device)
    vel += noise * (params["noise"] * amp / float(noise.abs().max()))
    s = scalar_profiles(case, y, shape, device)
    return torch.cat([vel, s]).to(dtype)
