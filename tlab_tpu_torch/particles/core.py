"""Lagrangian point particles (port of tlab_tpu/particles/core.py;
reference src/particles/*).

Fixed-size SoA tensors (n_part, ...) advanced with the same low-storage RK
scheme as the flow; grid->particle interpolation is a vectorized trilinear
gather (reference FIELD_TO_PARTICLE, particle_interpolate.f90), and
particle->grid is a scatter-add over the 8 corners (reference
PARTICLE_TO_FIELD; index_put_ with accumulate, whose sums on the card depend
on the order of the atomics).  No migration/sorting on one device; the
rank mesh's owner-sharded slots and their migration are particles/
parallel.py.

Particle types (reference particle_vars.f90:8-15):
  tracer:  dx/dt = u(x)
  inertia: dx/dt = v_p;  dv_p/dt = (u(x) - v_p)/St - settling e_y
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from tlab_tpu_torch import device as _device


class ParticleState(NamedTuple):
    x: torch.Tensor       # (np, 3) positions
    v: torch.Tensor       # (np, 3) particle velocities (inertia type)
    props: torch.Tensor   # (np, n_props) extra properties
    tags: torch.Tensor    # (np,) int64 ids


@dataclasses.dataclass(frozen=True)
class ParticleProps:
    # tracer | inertia | bil_cloud_3 | bil_cloud_4 | tinia
    type: str = "tracer"
    stokes: float = 0.0
    settling: float = 0.0
    bil_cloud: object = None      # BilCloudParams for the bil_cloud types
    # wall behavior: 'none' (clip) | 'stick' (freeze at the wall) --
    # reference part_bcs, PART_BCS_STICK forced for TINIA_1
    # (particle_procs.f90:67)
    bcs: str = "none"


# ---------------------------------------------------------------------------
# Interpolation grid -> particles (trilinear)
# ---------------------------------------------------------------------------

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


def particles_to_field(values, loc, shape):
    """Trilinear scatter-add of per-particle values onto the grid
    (reference PARTICLE_TO_FIELD, particle_to_field.f90)."""
    (i0, i1, fx), (j0, j1, fy), (k0, k1, fz) = loc
    out = values.new_zeros(shape)
    for ii, wx in ((i0, 1 - fx), (i1, fx)):
        for jj, wy in ((j0, 1 - fy), (j1, fy)):
            for kk, wz in ((k0, 1 - fz), (k1, fz)):
                out.index_put_((ii, jj, kk), values * wx * wy * wz,
                               accumulate=True)
    return out


# ---------------------------------------------------------------------------
# Dynamics
# ---------------------------------------------------------------------------

def particle_rhs(props: ParticleProps, pstate: ParticleState, locate,
                 u, v, w):
    """(dx/dt, dv/dt) for the particle ensemble."""
    loc = locate(pstate.x)
    uf = torch.stack([interpolate_to_particles(u, loc),
                      interpolate_to_particles(v, loc),
                      interpolate_to_particles(w, loc)], dim=1)
    if props.type == "tinia":
        # PART_TYPE_TINIA_1: the reference parses the type and forces
        # stick wall BCs, but its RHS is commented out
        # (rhs_part_1.f90:143-144) -- particles carry zero tendency.
        return torch.zeros_like(pstate.x), torch.zeros_like(pstate.v)
    if props.type == "tracer" or props.type.startswith("bil_cloud"):
        # bil_cloud droplets advect as tracers; their droplet scalars are
        # integrated separately (bil_cloud.droplet_rhs)
        dx, dv = uf, torch.zeros_like(pstate.v)
    else:
        # inertia: Stokes drag + settling
        acc = (uf - pstate.v) / max(props.stokes, 1e-30)
        acc[:, 1] += -props.settling
        dx, dv = pstate.v, acc
    if props.bcs == "stick":
        # stick BC (reference PART_BCS_STICK): particles that reached a
        # y wall stay there permanently; wrap_positions clips them to
        # [y0, y1], so equality marks "at the wall"
        y = pstate.x[:, 1]
        at_wall = ((y <= locate.y_bounds[0])
                   | (y >= locate.y_bounds[1]))[:, None]
        dx = dx.masked_fill(at_wall, 0.0)
        dv = dv.masked_fill(at_wall, 0.0)
    return dx, dv


def wrap_positions(grid, x):
    """Periodic wrap in x/z, clip in y (reference TIME_SUBSTEP_PARTICLE
    edge handling, time.f90:938-1011)."""
    out = x.clone()
    if grid.x.periodic and grid.x.size > 1:
        x0 = float(grid.x.nodes[0])
        out[:, 0] = torch.remainder(out[:, 0] - x0, float(grid.x.scale)) + x0
    if grid.z.periodic and grid.z.size > 1:
        z0 = float(grid.z.nodes[0])
        out[:, 2] = torch.remainder(out[:, 2] - z0, float(grid.z.scale)) + z0
    out[:, 1] = torch.clamp(out[:, 1], float(grid.y.nodes[0]),
                            float(grid.y.nodes[-1]))
    return out


def init_particles(grid, n_part: int, seed: int = 7,
                   y_profile=None, ymean=None, diam=None,
                   mode: str = "default", scal=None, scal_mean=0.0,
                   scal_delta=1.0, dtype=torch.float64,
                   device="cuda") -> ParticleState:
    """Particle position ICs (reference inipart, particle_main.f90:198-254):
    default = uniform in x/z, uniform y slab [ymean - diam/2, ymean + diam/2];
    mode='hardcoded' pins all particles to the first node column;
    mode='scalar' rejection-samples the y slab weighted by
    |(s - mean)/delta + 0.5| of the reference scalar field (a host array);
    y_profile (tlab_tpu's extension) draws y from an arbitrary density.
    The draws are NumPy's default_rng(seed) in tlab_tpu's order, so the
    positions equal tlab_tpu's bit for bit in float64."""
    rng = np.random.default_rng(seed)
    lx = grid.x.scale if grid.x.size > 1 else 1.0
    lz = grid.z.scale if grid.z.size > 1 else 1.0
    x0 = grid.x.nodes[0]
    z0 = grid.z.nodes[0] if grid.z.size > 1 else 0.0
    if grid.z.size == 1:
        lz = 0.0                                  # 2-D (particle_main.f90:193)
    ya, yb = grid.y.nodes[0], grid.y.nodes[-1]
    if ymean is None:
        ymean = 0.5 * (ya + yb)
    if diam is None:
        diam = yb - ya
    if mode == "hardcoded":                       # PART_INITYPE_HARDCODED
        x = np.full(n_part, x0)
        z = np.full(n_part, z0)
        y = np.full(n_part, ymean)
    elif mode == "scalar" and scal is not None:   # PART_INITYPE_SCALAR
        s = np.asarray(scal)
        nx, ny, nz = s.shape
        ylo, yhi = ymean - 0.5 * diam, ymean + 0.5 * diam
        jlo = int(np.searchsorted(grid.y.nodes, ylo))
        jhi = max(jlo + 1, int(np.searchsorted(grid.y.nodes, yhi)))
        jhi = min(jhi, ny - 1)
        dy_loc = grid.y.nodes[jhi] - grid.y.nodes[jlo]
        xs, ys, zs = [], [], []
        need = n_part
        while need > 0:
            m = max(2 * need, 1024)
            r = rng.uniform(size=(m, 4))
            i = np.minimum((r[:, 0] * nx).astype(int), nx - 1)
            k = np.minimum((r[:, 2] * nz).astype(int), nz - 1)
            jf = r[:, 1] * (jhi - jlo + 1)
            j = jlo + np.minimum(jf.astype(int), jhi - jlo)
            w = np.abs((s[i, j, k] - scal_mean) / scal_delta + 0.5)
            keep = r[:, 3] <= w
            xs.append(x0 + r[keep, 0] * lx)
            zs.append(z0 + r[keep, 2] * lz)
            ys.append(grid.y.nodes[j[keep]]
                      + (jf[keep] - jf[keep].astype(int)) * dy_loc)
            need = n_part - sum(a.size for a in xs)
        x = np.concatenate(xs)[:n_part]
        y = np.concatenate(ys)[:n_part]
        z = np.concatenate(zs)[:n_part]
    else:
        x = x0 + rng.uniform(0, 1, n_part) * lx
        z = z0 + rng.uniform(0, 1, n_part) * lz
        if y_profile is not None:
            # rejection-free inverse-cdf sampling on the grid
            pdf = np.maximum(y_profile(grid.y.nodes), 0.0)
            cdf = np.cumsum(pdf)
            cdf /= cdf[-1]
            y = np.interp(rng.uniform(0, 1, n_part), cdf, grid.y.nodes)
        else:
            y = ymean + (rng.uniform(0, 1, n_part) - 0.5) * diam
    y = np.clip(y, ya, yb)
    pos = torch.as_tensor(np.stack([x, y, z], axis=1), dtype=dtype,
                          device=_device.resolve(device))
    return ParticleState(
        x=pos, v=torch.zeros_like(pos), props=pos.new_zeros((n_part, 0)),
        tags=torch.arange(n_part, dtype=torch.int64, device=pos.device))


def props_from_ini(ini) -> "ParticleProps | None":
    """[Particles] block (reference Particle_Initialize_Parameters,
    particle_procs.f90:25-157): Type=None/Tracer/Inertia/
    BilinearCloudThree/Four/TiniaOne, Parameters=(Stokes, Settling...).
    Returns None when Type is none."""
    t = ini.get("Particles", "Type", "none").lower()
    mapping = {"none": None, "tracer": "tracer", "inertia": "inertia",
               "bilinearcloudthree": "bil_cloud_3",
               "bilinearcloudfour": "bil_cloud_4",
               "tiniaone": "tinia"}
    if t not in mapping:
        raise ValueError(f"[Particles] Type={t!r} unknown")
    typ = mapping[t]
    if typ is None:
        return None
    pars = ini.get_floats("Particles", "Parameters", ())
    stokes = ini.get_float("Parameters", "Stokes",
                           pars[0] if pars else 0.0)
    settling = ini.get_float("Parameters", "Settling",
                             pars[1] if len(pars) > 1 else 0.0)
    # TINIA forces stick wall BCs (particle_procs.f90:67)
    bcs = "stick" if typ == "tinia" else \
        ini.get("Particles", "Bcs", "none").lower()
    props = ParticleProps(type=typ, stokes=stokes, settling=settling,
                          bcs=bcs)
    if typ.startswith("bil_cloud"):
        from tlab_tpu_torch.particles.bil_cloud import BilCloudParams
        # droplet thermo constants = [Thermodynamics] Parameters(1:3)
        # (rhs_part_1.f90 thermo_param); the residence y-levels are
        # vestigial in the current reference (the l_y_lambda/l_y_base
        # assignments are commented out 'to be rewritten',
        # particle_procs.f90:235-240), so they stay at the default 0
        tp = tuple(ini.get_floats("Thermodynamics", "Parameters", ()))[:3]
        tp = tp + (1.0,) * (3 - len(tp))
        props = dataclasses.replace(props, bil_cloud=BilCloudParams(
            thermo=tp, variant=4 if typ.endswith("4") else 3))
    return props


def n_props(props: "ParticleProps") -> int:
    """Extra per-particle property columns for the type (reference
    inb_part: droplet scalars l_q(:,4:5), + residence clocks l_q(:,6:7)
    for bil_cloud_4)."""
    return {"bil_cloud_3": 2, "bil_cloud_4": 4}.get(props.type, 0)
