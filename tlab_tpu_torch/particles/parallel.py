"""Owner-sharded particle ensembles on the (x, z) rank mesh (port of
tlab_tpu/particles/parallel.py; reference particle_mpi_sort.f90 counting
sort + point-to-point exchange).

Each rank owns a fixed-capacity slot array of the particles inside its
(x, z) block, with a validity mask.  After each substep the particles that
crossed a block edge ride one ring shift a direction and sense (x then z,
so a corner move takes two passes: dist.batch_isend_irecv through
Mesh.shift, tlab_tpu's lax.ppermute), and the receiver compacts them into
its free slots.  At most one block is crossed a step (CFL-limited motion).
Interpolation runs on halo-extended blocks: the neighbour's first plane
along x and z, one ring shift each (reference Create_Halo_K/I_IK).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ShardedParticles(NamedTuple):
    x: torch.Tensor       # (cap, 3) positions (garbage where inactive)
    v: torch.Tensor       # (cap, k) velocities and payload
    tags: torch.Tensor    # (cap,) int32; -1 marks a free slot
    mask: torch.Tensor    # (cap,) bool


def _block_bounds(grid, axis_name: str, n_dev: int) -> np.ndarray:
    ax = {"x": grid.x, "z": grid.z}[axis_name]
    return ax.nodes[0] + ax.scale * np.arange(n_dev + 1) / n_dev


def shard_particles(grid, pstate, px: int, pz: int, capacity: int):
    """Host-side initial distribution (NumPy, as tlab_tpu's): per-rank
    stacked slots (n_dev, cap, ...), rank ix pz + iz holding the particles
    of block (ix, iz).  The extra particle properties (bil_cloud droplet
    scalars and residence clocks) ride as columns 3: of V."""
    xs = np.asarray(pstate.x)
    vs = np.asarray(pstate.v)
    pr = np.asarray(pstate.props)
    if pr.shape[-1]:          # column count: a 0-row bil_cloud state keeps
        vs = np.concatenate([vs, pr], axis=1)       # its property schema
    tags = np.asarray(pstate.tags).astype(np.int32)
    ex = _block_bounds(grid, "x", px)
    ez = _block_bounds(grid, "z", pz) if pz > 1 else None
    n_dev = px * pz
    X = np.zeros((n_dev, capacity, 3))
    V = np.zeros((n_dev, capacity, vs.shape[1]))
    T = np.full((n_dev, capacity), -1, np.int32)
    M = np.zeros((n_dev, capacity), bool)
    ix = np.clip(np.searchsorted(ex, xs[:, 0], side="right") - 1, 0, px - 1)
    if ez is not None:
        iz = np.clip(np.searchsorted(ez, xs[:, 2], side="right") - 1,
                     0, pz - 1)
    else:
        iz = np.zeros_like(ix)
    dev = ix * pz + iz
    for d in range(n_dev):
        sel = np.where(dev == d)[0][:capacity]
        X[d, : sel.size] = xs[sel]
        V[d, : sel.size] = vs[sel]
        T[d, : sel.size] = tags[sel]
        M[d, : sel.size] = True
    return X, V, T, M


def _compact(p: ShardedParticles) -> ShardedParticles:
    """The active slots moved to the front (stable)."""
    order = torch.argsort((~p.mask).to(torch.int32), stable=True)
    return ShardedParticles(x=p.x[order], v=p.v[order], tags=p.tags[order],
                            mask=p.mask[order])


def _exchange_dir(mesh, p: ShardedParticles, send, axis_name: str,
                  shift: int) -> ShardedParticles:
    """Ship the `send`-marked particles one step along the axis's ring."""
    keep = p.mask & ~send
    cols = p.x.shape[1]
    buf = torch.where(send[:, None], torch.cat([p.x, p.v], dim=1), 0.0)
    recv = mesh.shift(buf, axis_name, shift)
    rt = mesh.shift(torch.where(send, p.tags, -1), axis_name, shift)
    rx, rv = recv[:, :cols], recv[:, cols:]
    # compact the kept particles, then fill the tail with received ones
    kept = _compact(ShardedParticles(p.x, p.v, p.tags, keep))
    got = _compact(ShardedParticles(rx, rv, rt, rt >= 0))
    n_keep = kept.mask.sum()
    cap = p.mask.shape[0]
    idx = torch.arange(cap, device=p.mask.device)
    take = torch.clamp(idx - n_keep, 0, cap - 1)
    use = (idx >= n_keep) & (take < got.mask.sum()) & got.mask[take]
    return ShardedParticles(
        torch.where(use[:, None], got.x[take], kept.x),
        torch.where(use[:, None], got.v[take], kept.v),
        torch.where(use, got.tags[take], kept.tags),
        kept.mask | use)


def migrate(mesh, p: ShardedParticles, grid, axis_name: str
            ) -> ShardedParticles:
    """One direction's two ring passes (+1, then -1)."""
    n_dev = mesh.shape[axis_name]
    if n_dev <= 1:
        return p
    ax = {"x": grid.x, "z": grid.z}[axis_name]
    comp = {"x": 0, "z": 2}[axis_name]
    me = mesh.ix if axis_name == "x" else mesh.iz

    def dist(p):
        # the destination block from the (periodic-wrapped) coordinate; the
        # ring distance decides the sense (handles the wrap)
        target = torch.clamp(((p.x[:, comp] - ax.nodes[0]) / ax.scale
                              * n_dev).to(torch.int32), 0, n_dev - 1)
        return torch.remainder(target - me, n_dev)

    # the masks are recomputed between the passes: the first exchange
    # reshuffles the slots
    p = _exchange_dir(mesh, p, p.mask & (dist(p) == 1), axis_name, +1)
    p = _exchange_dir(mesh, p, p.mask & (dist(p) == n_dev - 1), axis_name,
                      -1)
    return p


def to_mesh(mesh, grid, pstate, capacity=None, dtype=None):
    """This rank's slots (X, V, T, M) of a ParticleState that every rank
    holds, on the rank's device.  Raises where the per-rank capacity would
    drop particles (the reference's isize_part overflow abort,
    particle_mpi_send_recv.f90)."""
    n_dev = mesh.size
    n = int(pstate.x.shape[0])
    if not capacity:
        # 4x the balanced load, slot-aligned (particles cluster)
        capacity = max(8, -(-n * 4 // n_dev) // 8 * 8 + 8)
    host = type(pstate)(*(a.detach().cpu().numpy() for a in pstate))
    X, V, T, M = shard_particles(grid, host, mesh.px, mesh.pz, capacity)
    if int(M.sum()) != n:
        raise ValueError(
            f"mesh particle capacity {capacity}/device dropped "
            f"{n - int(M.sum())} of {n} particles; raise [Particles] "
            f"MeshCapacity")
    dt = dtype or pstate.x.dtype
    r = mesh.rank
    return (torch.as_tensor(X[r]).to(mesh.device, dt),
            torch.as_tensor(V[r]).to(mesh.device, dt),
            torch.as_tensor(T[r]).to(mesh.device),
            torch.as_tensor(M[r]).to(mesh.device))


def from_mesh(mesh, parts):
    """The ParticleState of every rank's slots on rank 0 (None elsewhere),
    the active rows sorted by tag (trajectories, PDFs and restarts); V's
    columns 3: are the extra particle properties."""
    from tlab_tpu_torch.particles.core import ParticleState
    got = [mesh.gather_list(a) for a in parts]
    if got[0] is None:
        return None
    X, V, T, M = (torch.cat(g) for g in got)
    x, vall, t = X[M], V[M], T[M]
    order = torch.argsort(t, stable=True)
    return ParticleState(x=x[order], v=vall[order, :3],
                         props=vall[order, 3:],
                         tags=t[order].to(torch.int64))


def halo_exchange(mesh, f):
    """The neighbour's first plane appended along x and z (periodic ring):
    (..., nxl, ny, nzl) -> (..., nxl+1, ny, nzl+1); leading batch axes ride
    the same two shifts."""
    off = f.ndim - 3
    f = torch.cat([f, mesh.shift(f.narrow(off, 0, 1), "x", -1)], dim=off)
    return torch.cat([f, mesh.shift(f.narrow(off + 2, 0, 1), "z", -1)],
                     dim=off + 2)


def make_block_locator(mesh, grid):
    """locate(positions) -> (i0, i1, fx, j0, j1, fy, k0, k1, fz) with
    indices local to the rank's halo-extended block; y as the global
    locator's bisection."""
    from tlab_tpu_torch.particles.core import _locate_nonuniform
    nx_l = grid.x.size // mesh.px
    nz_l = grid.z.size // mesh.pz if grid.z.size > 1 else 1
    dx = grid.x.scale / grid.x.size
    dz = grid.z.scale / max(grid.z.size, 1)
    x0 = grid.x.nodes[0] + mesh.ix * nx_l * dx
    z0 = (grid.z.nodes[0] if grid.z.size > 1 else 0.0) \
        + mesh.iz * nz_l * dz
    y_nodes = np.asarray(grid.y.nodes)

    def locate(pos):
        xi = torch.clamp((pos[:, 0] - x0) / dx, 0.0, nx_l - 1e-6)
        i0 = torch.floor(xi).to(torch.int64)
        fx = xi - i0
        nodes = torch.as_tensor(y_nodes).to(pos.device, pos.dtype)
        j0, j1, fy = _locate_nonuniform(pos[:, 1].contiguous(), nodes)
        if grid.z.size > 1:
            zi = torch.clamp((pos[:, 2] - z0) / dz, 0.0, nz_l - 1e-6)
            k0 = torch.floor(zi).to(torch.int64)
            fz = zi - k0
        else:
            k0 = torch.zeros_like(i0)
            fz = torch.zeros_like(fx)
        return (i0, i0 + 1, fx, j0, j1, fy, k0, k0 + 1, fz)

    return locate


def interpolate_block(f_halo, loc):
    """Trilinear gather on the halo-extended block (tlab_tpu's weights
    layout)."""
    i0, i1, fx, j0, j1, fy, k0, k1, fz = loc

    def g(ii, jj, kk):
        return f_halo[ii, jj, kk]

    return ((1 - fx) * ((1 - fy) * ((1 - fz) * g(i0, j0, k0)
                                    + fz * g(i0, j0, k1))
                        + fy * ((1 - fz) * g(i0, j1, k0)
                                + fz * g(i0, j1, k1)))
            + fx * ((1 - fy) * ((1 - fz) * g(i1, j0, k0)
                                + fz * g(i1, j0, k1))
                    + fy * ((1 - fz) * g(i1, j1, k0)
                            + fz * g(i1, j1, k1))))
