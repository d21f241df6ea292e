"""Owner-sharded particles of the port (tlab_tpu_torch/particles/
parallel.py) on four CPU ranks against tlab_tpu's on its virtual mesh at
2x2, from the same seeded particles (tlab_tpu's tests/
test_particles_parallel.py scenarios): a uniform drift across the blocks
and the periodic wrap with migration, and forward Euler through the
halo-extended block interpolation of a sheared field.  Each rank holds the
same tags in the same slots as tlab_tpu's device, at the same positions
(1e-12), and from_mesh gives every particle once, sorted by tag."""
import functools

import numpy as np
import pytest

import test_torch_mesh_workers as W
from tlab_tpu_torch.parallel import mesh as pmesh

PX, PZ = 2, 2
SHAPE, SCALES = (32, 17, 16), (2.0, 1.0, 1.6)
N_PART, CAP = 96, 64
TOL = 1e-12


def _fields():
    nx, ny, nz = SHAPE
    xg = (np.arange(nx) * SCALES[0] / nx)[:, None, None]
    yg = np.linspace(0.0, SCALES[1], ny)[None, :, None]
    zg = (np.arange(nz) * SCALES[2] / nz)[None, None, :]
    u = 0.3 + 0.1 * np.sin(2 * np.pi * xg / 2.0) * np.cos(
        2 * np.pi * zg / 1.6) * np.ones_like(yg)
    w = np.broadcast_to(-0.2 + 0.1 * np.cos(2 * np.pi * xg / 2.0) * yg,
                        SHAPE).copy()
    return u, w


SCENARIOS = {
    "drift": dict(seed=4, drift=(0.37, -0.21), dt=0.05, n_steps=40,
                  fields=None),
    "interpolation": dict(seed=9, drift=(0.0, 0.0), dt=0.04, n_steps=30,
                          fields=_fields()),
}


def _jax_run(seed, drift, dt, n_steps, fields):
    """tlab_tpu's slots (X, T, M) per device after the scenario."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as PS
    from tlab_tpu.grid import uniform_grid
    from tlab_tpu.parallel import make_mesh
    from tlab_tpu.particles import core as pc
    from tlab_tpu.particles import parallel as pp
    mesh = make_mesh(PX, PZ, devices=jax.devices()[:PX * PZ])
    grid = uniform_grid(*SHAPE, *SCALES)
    ps = pc.init_particles(grid, N_PART, seed=seed)
    X, V, T, M = pp.shard_particles(grid, ps, PX, PZ, CAP)
    locate = pp.make_block_locator(grid, PX, PZ)
    sp, sf = PS(("x", "z")), PS("x", None, "z")
    u, w = fields if fields is not None else (np.zeros(SHAPE),) * 2

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(sp, sp, sp, sp, sf, sf),
                       out_specs=(sp,) * 3, check_vma=False)
    def run(x, v, t, m, uf, wf):
        p = pp.ShardedParticles(x=x[0], v=v[0], tags=t[0], mask=m[0])
        uh, wh = pp.halo_exchange(uf), pp.halo_exchange(wf)

        def step(_, p):
            if fields is None:
                du, dw = drift[0] * dt, drift[1] * dt
            else:
                loc = locate(p.x)
                du = dt * pp.interpolate_block(uh, loc)
                dw = dt * pp.interpolate_block(wh, loc)
            nx_ = p.x.at[:, 0].add(du).at[:, 2].add(dw)
            nx_ = nx_.at[:, 0].set(jnp.mod(nx_[:, 0] - grid.x.nodes[0],
                                           grid.x.scale) + grid.x.nodes[0])
            nx_ = nx_.at[:, 2].set(jnp.mod(nx_[:, 2] - grid.z.nodes[0],
                                           grid.z.scale) + grid.z.nodes[0])
            p = pp.ShardedParticles(nx_, p.v, p.tags, p.mask)
            return pp.migrate(pp.migrate(p, grid, "x", PX), grid, "z", PZ)

        p = jax.lax.fori_loop(0, n_steps, step, p)
        return p.x[None], p.tags[None], p.mask[None]

    args = [jax.device_put(jnp.asarray(a), NamedSharding(mesh, s))
            for a, s in ((X, sp), (V, sp), (T, sp), (M, sp), (u, sf),
                         (w, sf))]
    xo, to, mo = (np.asarray(a) for a in jax.jit(run)(*args))
    return xo, to, mo


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    top = str(tmp_path_factory.mktemp("particles"))
    out = {}
    for name, sc in SCENARIOS.items():
        port = pmesh.spawn(W.particles_job, PX, PZ, "cpu", SHAPE, SCALES,
                           N_PART, CAP, sc["seed"], sc["drift"], sc["dt"],
                           sc["n_steps"], sc["fields"], store_dir=top,
                           timeout_s=300)
        out[name] = (port, _jax_run(**sc))
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_slots_match_tlab_tpu(results, name):
    port, (xo, to, mo) = results[name]
    for r, (slots, _) in enumerate(port):
        X, _, T, M = slots
        assert np.array_equal(M, mo[r]), r
        assert np.array_equal(T[M], to[r][mo[r]]), r
        assert np.abs(X[M] - xo[r][mo[r]]).max() <= TOL, r
        # ownership: each particle sits in its rank's block
        ix, iz = divmod(r, PZ)
        lx, lz = SCALES[0] / PX, SCALES[2] / PZ
        assert np.all((X[M, 0] >= ix * lx - 1e-9)
                      & (X[M, 0] < (ix + 1) * lx + 1e-9))
        assert np.all((X[M, 2] >= iz * lz - 1e-9)
                      & (X[M, 2] < (iz + 1) * lz + 1e-9))


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_from_mesh_gathers_every_particle(results, name):
    port, (xo, to, mo) = results[name]
    whole = port[0][1]
    assert all(p[1] is None for p in port[1:])      # rank 0 alone
    x, v, props, tags = whole
    assert np.array_equal(tags, np.arange(N_PART))
    want = np.concatenate([xo[r][mo[r]] for r in range(PX * PZ)])
    order = np.argsort(np.concatenate([to[r][mo[r]]
                                       for r in range(PX * PZ)]))
    assert np.abs(x - want[order]).max() <= TOL
    assert v.shape == (N_PART, 3) and props.shape == (N_PART, 0)
