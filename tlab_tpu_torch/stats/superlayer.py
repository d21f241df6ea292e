"""Turbulent/non-turbulent interface ("superlayer") analysis (port of
tlab_tpu/stats/superlayer.py).

Equivalents of the reference superlayer tools
(src/tools/superlayer/sl_boundary.f90, sl_normal_analysis.f90,
sl_boundary_vorticity_pdf.f90; surface extraction in
src/utils/boundary.f90:SL_UPPER_BOUNDARY/SL_LOWER_BOUNDARY): the interface
height y_sl(x,z) is the outermost crossing of an indicator field (enstrophy
or scalar-gradient magnitude) above a threshold, linearly interpolated in y.
Instead of per-(i,k) loops over transposed pencils, everything here is a
vectorized reduction over the y axis of the (nx, ny, nz) block on its
device; the histograms are host NumPy.
"""
from __future__ import annotations

import numpy as np
import torch


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _at(a, j):
    """a[i, j[i, k], k] -> (nx, nz)."""
    return torch.take_along_dim(a, j[:, None, :], dim=1)[:, 0, :]


def _first_true(mask):
    """Index of the first True along y (0 where none)."""
    return torch.argmax(mask.to(torch.uint8), dim=1)


def upper_boundary(y, a, amin):
    """y_sl(x,z): height of the LAST (from the top) downward crossing of
    a > amin, scanning down from jmax; y[0] where never exceeded."""
    y = torch.as_tensor(y).to(a.device, a.dtype)
    ny = y.shape[0]
    mask = a > amin                           # (nx, ny, nz)
    # last j (largest) with mask true
    jlast = ny - 1 - _first_true(torch.flip(mask, [1]))
    any_mask = torch.any(mask, dim=1)
    j = torch.clamp(jlast, 0, ny - 2)
    a_j, a_j1 = _at(a, j), _at(a, j + 1)
    # linear interpolation between y[j] (inside) and y[j+1] (outside)
    denom = a_j - a_j1
    w = torch.where(torch.abs(denom) > 0, (amin - a_j1) / denom, 0.0)
    ysl = y[j + 1] + (y[j] - y[j + 1]) * w
    ysl = torch.where(jlast >= ny - 1, y[-1], ysl)   # saturated at the top
    return torch.where(any_mask, ysl, y[0])


def lower_boundary(y, a, amin):
    """y_sl(x,z): height of the FIRST (from the bottom) crossing, mirrored
    logic of upper_boundary (reference SL_LOWER_BOUNDARY)."""
    y = torch.as_tensor(y).to(a.device, a.dtype)
    ny = y.shape[0]
    mask = a > amin
    jfirst = _first_true(mask)
    any_mask = torch.any(mask, dim=1)
    j = torch.clamp(jfirst, 1, ny - 1)
    a_j, a_j1 = _at(a, j), _at(a, j - 1)
    denom = a_j - a_j1
    w = torch.where(torch.abs(denom) > 0, (amin - a_j1) / denom, 0.0)
    ysl = y[j - 1] + (y[j] - y[j - 1]) * w
    ysl = torch.where(jfirst <= 0, y[0], ysl)
    return torch.where(any_mask, ysl, y[-1])


def surface_statistics(ysl):
    """Mean/min/max/rms of the interface height over the (x,z) plane."""
    m = torch.mean(ysl)
    return {"mean": m, "min": torch.amin(ysl), "max": torch.amax(ysl),
            "rms": torch.sqrt(torch.mean((ysl - m) ** 2))}


def sample_at_surface(field, y, ysl, offsets=(0.0,)):
    """Sample a 3-D field at y = ysl(x,z) + offset for each offset, by
    linear interpolation along y (reference sl_normal_sample.f90 role,
    vertical-line sampling variant): returns (n_offsets, nx, nz)."""
    y = torch.as_tensor(y).to(field.device, field.dtype)
    ny = y.shape[0]
    out = []
    for off in offsets:
        yt = torch.clamp(ysl + off, y[0], y[-1])
        j = torch.clamp(torch.searchsorted(y, yt.contiguous(), right=True)
                        - 1, 0, ny - 2)
        y0, y1 = y[j], y[j + 1]
        w = torch.where(y1 > y0, (yt - y0) / (y1 - y0), 0.0)
        out.append((1.0 - w) * _at(field, j) + w * _at(field, j + 1))
    return torch.stack(out)


def height_pdf(ysl, nbins: int = 64):
    """PDF of the interface height (reference sl_boundary.f90 iopt=4)."""
    ys = _np(ysl).ravel()
    counts, edges = np.histogram(ys, bins=nbins)
    return counts / max(ys.size, 1), edges


def surface_jpdf(vals_a, vals_b, nbins: int = 32, ranges=None):
    """Joint PDF of two quantities sampled on the interface (reference
    sl_boundary_vorticity_jpdf.f90): returns (nbins, nbins) counts plus
    the two edge arrays."""
    a = _np(vals_a).ravel()
    b = _np(vals_b).ravel()
    if ranges is None:
        ranges = [[a.min(), a.max()], [b.min(), b.max()]]
    counts, ea, eb = np.histogram2d(a, b, bins=nbins, range=ranges)
    return counts / max(a.size, 1), ea, eb


def surface_normals(grid, ysl):
    """Unit normals of the interface surface y = ysl(x, z), pointing to
    the irrotational (outer) side (reference SL_NORMAL_SAMPLE: the normal
    is the gradient direction of the conditioning field; for a
    height-function surface n ~ (-dh/dx, 1, -dh/dz)/|.|)."""
    nx, nz = ysl.shape
    dx = grid.x.nodes[1] - grid.x.nodes[0] if grid.x.size > 1 else 1.0
    dz = grid.z.nodes[1] - grid.z.nodes[0] if grid.z.size > 1 else 1.0
    hx = (torch.roll(ysl, -1, 0) - torch.roll(ysl, 1, 0)) / (2.0 * dx) \
        if nx > 1 else torch.zeros_like(ysl)
    hz = (torch.roll(ysl, -1, 1) - torch.roll(ysl, 1, 1)) / (2.0 * dz) \
        if nz > 1 else torch.zeros_like(ysl)
    mag = torch.sqrt(hx * hx + 1.0 + hz * hz)
    return torch.stack([-hx / mag, 1.0 / mag, -hz / mag], dim=-1)


def sample_along_normals(grid, field, ysl, distances, side="upper"):
    """Fields sampled along the LOCAL interface normal at the given
    signed distances (reference sl_normal_sample.f90:55-96; replaces the
    vertical-ray sampling of sample_at_surface): returns
    (ndist, nx, nz). side='lower' flips the normal."""
    from tlab_tpu_torch.particles.core import (interpolate_to_particles,
                                               make_locator)
    nx, nz = ysl.shape
    n = surface_normals(grid, ysl)
    if side == "lower":
        n = -n
    ones = torch.ones((nx, nz), dtype=ysl.dtype, device=ysl.device)
    X = torch.as_tensor(grid.x.nodes).to(ysl.device, ysl.dtype)[:, None] \
        * ones
    Z = ones * (torch.as_tensor(grid.z.nodes).to(ysl.device, ysl.dtype)
                [None, :] if grid.z.size > 1 else 0.0)
    locate = make_locator(grid)
    out = []
    for d in distances:
        px = (X + d * n[..., 0]).reshape(-1)
        py = (ysl + d * n[..., 1]).reshape(-1)
        pz = (Z + d * n[..., 2]).reshape(-1)
        pos = torch.stack([px, py, pz], dim=1)
        vals = interpolate_to_particles(field, locate(pos))
        out.append(vals.reshape(nx, nz))
    return torch.stack(out)
