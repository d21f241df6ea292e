"""1-D auto/cross spectra and correlations (reference tools/statistics/
spectra.f90 equivalents, xsp/zsp outputs; port of tlab_tpu/stats/
spectra.py on torch.fft).

Power spectral densities along the periodic directions, averaged over the
other horizontal direction, as functions of y.
"""
from __future__ import annotations

import numpy as np
import torch


def _fold(e, axis: int):
    """Double the interior wavenumbers (the negative ones folded in)."""
    e = e.clone()
    e.narrow(axis, 1, max(e.shape[axis] - 2, 0)).mul_(2.0)
    return e


def spectrum_x(a, b=None):
    """Cross-PSD along x averaged over z: (nkx, ny)."""
    ah = torch.fft.rfft(a, dim=0)
    bh = ah if b is None else torch.fft.rfft(b, dim=0)
    nx = a.shape[0]
    e = _fold(torch.real(ah * torch.conj(bh)) / nx ** 2, 0)
    return torch.mean(e, dim=2)


def spectrum_z(a, b=None):
    """Cross-PSD along z averaged over x: (nkz, ny)."""
    ah = torch.fft.rfft(a, dim=2)
    bh = ah if b is None else torch.fft.rfft(b, dim=2)
    nz = a.shape[2]
    e = _fold(torch.real(ah * torch.conj(bh)) / nz ** 2, 2)
    return torch.mean(e, dim=0).T


def correlation_x(a, b=None):
    """Two-point correlation along x from the PSD (Wiener-Khinchin)."""
    ah = torch.fft.rfft(a, dim=0)
    bh = ah if b is None else torch.fft.rfft(b, dim=0)
    nx = a.shape[0]
    c = torch.fft.irfft(ah * torch.conj(bh), n=nx, dim=0) / nx
    return torch.mean(c, dim=2)


def radial_spectrum(a, lx, lz):
    """Radial (shell-integrated) 2-D spectrum per y: (nk, ny)."""
    nx, ny, nz = a.shape
    ah = torch.fft.fft(torch.fft.rfft(a, dim=0), dim=2)
    e = _fold(torch.abs(ah) ** 2 / (nx * nz) ** 2, 0)
    kx = np.arange(nx // 2 + 1) * (2 * np.pi / lx)
    kz = np.fft.fftfreq(nz, d=1.0) * nz * (2 * np.pi / lz) if nz > 1 \
        else np.zeros(1)
    kmag = np.sqrt(kx[:, None] ** 2 + kz[None, :] ** 2)
    dk = 2 * np.pi / max(lx, lz)
    nshell = int(np.max(kmag) / dk) + 1
    shell = np.minimum((kmag / dk).astype(int), nshell - 1)
    out = np.zeros((nshell, ny))
    e_np = e.cpu().numpy()
    for i in range(kx.shape[0]):
        for k in range(kz.shape[0]):
            out[shell[i, k]] += e_np[i, :, k]
    return out


def write_spectra(path: str, spec: np.ndarray, itime: int) -> None:
    np.savetxt(path, np.asarray(spec), header=f"it={itime} rows=k cols=y")


def correlation_z(a, b=None):
    """Two-point correlation along z from the PSD (Wiener-Khinchin)."""
    ah = torch.fft.rfft(a, dim=2)
    bh = ah if b is None else torch.fft.rfft(b, dim=2)
    nz = a.shape[2]
    c = torch.fft.irfft(ah * torch.conj(bh), n=nz, dim=2) / nz
    return torch.mean(c, dim=0).T


def cross_phase_x(a, b):
    """Cross-spectrum power and phase along x (reference spectra.f90
    pow/pha outputs, opt_main=2): (nkx, ny) each."""
    ah = torch.fft.rfft(a, dim=0)
    bh = torch.fft.rfft(b, dim=0)
    nx = a.shape[0]
    cross = torch.mean(ah * torch.conj(bh), dim=2) / nx ** 2
    return torch.abs(cross), torch.angle(cross)


def spectrum_2d(a, b=None, y_blocks: int = 1):
    """Full 2-D cross-PSD E(kx, kz) averaged inside y blocks:
    (nkx, nkz, y_blocks) (reference spectra.f90 opt_block y-averaging of the
    2-D spectral density before the radial reduction)."""
    nx, ny, nz = a.shape
    ah = torch.fft.fft(torch.fft.rfft(a, dim=0), dim=2)
    bh = ah if b is None else torch.fft.fft(torch.fft.rfft(b, dim=0), dim=2)
    e = _fold(torch.real(ah * torch.conj(bh)) / (nx * nz) ** 2, 0)
    nb = max(1, min(y_blocks, ny))
    edges = np.linspace(0, ny, nb + 1).astype(int)
    blocks = [torch.mean(e[:, j0:j1, :], dim=1) for j0, j1 in
              zip(edges[:-1], edges[1:])]
    return torch.stack(blocks, dim=-1)
