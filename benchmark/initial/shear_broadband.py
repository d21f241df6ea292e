"""The shear layer's initial fields: the case's tanh mean profiles of u
and the scalars, plus a broadband velocity perturbation, the curl of a
random vector potential shaped by the case's [IniFields] ThickIniK
Gaussian in y (at YMeanRelativeIniK) and filtered to a spectrum
E(f) ~ f^2 exp(-(f/f0)^2) of the case's [Broadband] f0, so that it is free
of divergence, scaled so that the largest plane-mean kinetic energy is
[IniFields] NormalizeK."""
from __future__ import annotations

import math

import torch

from harness.fields import axes, curl_noise, scalar_profiles
from reference.step import profile


def make(case, params, seed, device, dtype):
    (x, lx), (y, ly), (z, lz) = axes(case)
    shape = (x.size, y.size, z.size)
    gen = torch.Generator(device=device).manual_seed(seed)
    ycoor = y[0] + (y[-1] - y[0]) * case.float("IniFields",
                                                "YMeanRelativeIniK", 0.5)
    thick = case.float("IniFields", "ThickIniK", 0.05)
    yd = torch.as_tensor(y, device=device)
    env = torch.exp(-0.5 * ((yd - ycoor) / thick) ** 2)[None, :, None]
    # the y period is the wall distance plus one spacing
    pert = curl_noise(gen, shape, (lx, ly + (y[1] - y[0]), lz),
                      case.float("Broadband", "f0", 6.0), env, device)
    tke = 0.5 * torch.mean(torch.sum(pert ** 2, dim=0), dim=(0, 2))
    pert *= math.sqrt(case.float("IniFields", "NormalizeK", 0.02)
                      / float(tke.max()))
    pert[0] += torch.as_tensor(profile(case, "Flow", "VelocityX", y),
                               device=device)[None, :, None]
    s = scalar_profiles(case, y, shape, device)
    return torch.cat([pert, s]).to(dtype)
