"""Grid -> point interpolation (port of make_locator and
interpolate_to_particles of tlab_tpu/particles/core.py, the reference's
FIELD_TO_PARTICLE trilinear gather, particle_interpolate.f90).

Only these two (and their cell searches) are ported: stats/superlayer.py
samples fields along the interface normals with them.  The particles
themselves are ROADMAP A15: the other public names of tlab_tpu's module
raise NotImplementedError naming it.
"""
from __future__ import annotations

import torch


def _locate_uniform(x, x0, dx, n, periodic):
    xi = (x - x0) / dx
    if periodic:
        xi = torch.remainder(xi, n)
        i0 = torch.floor(xi).to(torch.int64)
        frac = xi - i0
        i1 = torch.remainder(i0 + 1, n)
        i0 = torch.remainder(i0, n)
    else:
        xi = torch.clamp(xi, 0.0, n - 1.000001)
        i0 = torch.clamp(torch.floor(xi).to(torch.int64), 0, n - 2)
        frac = xi - i0
        i1 = i0 + 1
    return i0, i1, frac


def _locate_nonuniform(xp, nodes):
    """Bisection cell search on a nonuniform axis (reference LOCATE_Y)."""
    n = nodes.shape[0]
    i0 = torch.clamp(torch.searchsorted(nodes, xp, right=True) - 1, 0, n - 2)
    frac = (xp - nodes[i0]) / (nodes[i0 + 1] - nodes[i0])
    return i0, i0 + 1, torch.clamp(frac, 0.0, 1.0)


def make_locator(grid):
    """Returns locate(positions (np,3)) -> indices + weights, closed over
    static grid data."""
    gx, gy, gz = grid.x, grid.y, grid.z

    def locate(pos):
        npart = pos.shape[0]

        def none():
            zero = torch.zeros(npart, dtype=torch.int64, device=pos.device)
            return zero, zero, torch.zeros(npart, dtype=pos.dtype,
                                           device=pos.device)

        if gx.size > 1:
            dx = gx.nodes[1] - gx.nodes[0]
            ix = _locate_uniform(pos[:, 0], gx.nodes[0], dx, gx.size,
                                 gx.periodic)
        else:
            ix = none()
        if gy.uniform and gy.size > 1:
            dy = gy.nodes[1] - gy.nodes[0]
            iy = _locate_uniform(pos[:, 1], gy.nodes[0], dy, gy.size, False)
        elif gy.size > 1:
            nodes = torch.as_tensor(gy.nodes).to(pos.device, pos.dtype)
            iy = _locate_nonuniform(pos[:, 1].contiguous(), nodes)
        else:
            iy = none()
        if gz.size > 1:
            dz = gz.nodes[1] - gz.nodes[0]
            iz = _locate_uniform(pos[:, 2], gz.nodes[0], dz, gz.size,
                                 gz.periodic)
        else:
            iz = none()
        return ix, iy, iz

    locate.y_bounds = (float(gy.nodes[0]), float(gy.nodes[-1]))
    return locate


def interpolate_to_particles(field, loc):
    """Trilinear gather of one (nx, ny, nz) field at located particles."""
    (i0, i1, fx), (j0, j1, fy), (k0, k1, fz) = loc
    f = field
    c00 = f[i0, j0, k0] * (1 - fx) + f[i1, j0, k0] * fx
    c10 = f[i0, j1, k0] * (1 - fx) + f[i1, j1, k0] * fx
    c01 = f[i0, j0, k1] * (1 - fx) + f[i1, j0, k1] * fx
    c11 = f[i0, j1, k1] * (1 - fx) + f[i1, j1, k1] * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


_A15 = ("ParticleState", "ParticleProps", "particles_to_field",
        "particle_rhs", "wrap_positions", "init_particles", "props_from_ini",
        "n_props")


def __getattr__(name):
    if name not in _A15:
        raise AttributeError(name)
    raise NotImplementedError(
        f"particles.core.{name}: Lagrangian particles are not ported yet "
        "(ROADMAP A15)")
