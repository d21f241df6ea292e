"""The pencil engine of the port (tlab_tpu_torch/parallel/{mesh,pencil}.py)
on the CPU over gloo, float64: ranks spawned by parallel.mesh.spawn, one
job a mesh shape whose results every case reads.

- each of the four transposes (and on a 4-D stack) and the round trip
  equal a NumPy block permutation exactly at 2x2, 4x1 and 1x4, and a
  transpose with two chunks swapped fails that comparison;
- pencil_poisson, pencil_helmholtz and pencil_poisson_factorize on a grid
  whose nkx = 13 pads to 16 (the odd extent) equal the port's
  single-device solves to 1e-12 of the max, and tlab_tpu's pencil solves
  on its 8-device virtual mesh at 4x2 to 1e-10;
- make_pencil_step and make_pencil_step_compressible: one RK step equals
  one device's to 1e-12 (the compressible one with outflow NSCBC and the
  transverse terms: the mesh-global Mach drift, the tangential planes
  through the transposes); float32 on the wire moves it by more than
  round-off and less than 1e-4;
- transpose_check: residual 0, a time and a rate.
"""
import types

import numpy as np
import pytest
import torch

import test_torch_mesh_workers as W
from tlab_tpu_torch.dycore import incompressible as dyn
from tlab_tpu_torch.dycore.state import State
from tlab_tpu_torch.ops import elliptic
from tlab_tpu_torch.ops import elliptic_factorize as fac
from tlab_tpu_torch.parallel import mesh as pmesh

SHAPES = ((2, 2), (4, 1), (1, 4))
ARR = np.arange(8 * 3 * 8, dtype=np.float64).reshape(8, 3, 8)
STACK = np.stack([ARR, -ARR])
SOLVE_TOL = 1e-12
JAX_TOL = 1e-10
STEP_TOL = 1e-12


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """{(px, pz): [rank results]} of pencil_job: every part at 2x2, the
    transposes and solves at 4x1 and 1x4."""
    top = str(tmp_path_factory.mktemp("pencil"))
    rng = np.random.default_rng(5)
    wire = rng.standard_normal(ARR.shape)
    out = {"wire": wire}
    for px, pz in SHAPES:
        parts = ("solves", "steps", "check") if (px, pz) == (2, 2) \
            else ("solves",)
        out[(px, pz)] = pmesh.spawn(W.pencil_job, px, pz, "cpu", ARR, wire,
                                    parts, store_dir=top, timeout_s=300)
    return out


def expected(arr, px, pz, rank, kind):
    """The NumPy block permutation a transpose must give at `rank`."""
    ix, iz = divmod(rank, pz)
    nxl, nzl = arr.shape[-3] // px, arr.shape[-1] // pz
    if kind == "gather_x":          # x whole, z chunk ix of block iz
        c = nzl // px
        z0 = iz * nzl + ix * c
        return arr[..., z0:z0 + c]
    if kind == "gather_z":          # z whole, x chunk iz of block ix
        c = nxl // pz
        x0 = ix * nxl + iz * c
        return arr[..., x0:x0 + c, :, :]
    return arr[..., ix * nxl:(ix + 1) * nxl, :, iz * nzl:(iz + 1) * nzl]


@pytest.mark.parametrize("kind", ["gather_x", "gather_z", "scatter_x",
                                  "scatter_z", "roundtrip", "block"])
@pytest.mark.parametrize("shape", SHAPES)
def test_transpose_is_the_block_permutation(jobs, shape, kind):
    for r, got in enumerate(jobs[shape]):
        want = expected(ARR, *shape, r, kind)
        assert got[kind].shape == want.shape, (shape, r, kind)
        assert np.array_equal(got[kind], want), (shape, r, kind)


def test_a_swapped_chunk_order_fails_the_check(jobs):
    """The comparison sees a transpose whose received chunks sit in the
    wrong peer order: every norm is the same, the blocks are not."""
    got = jobs[(2, 2)][1]["gather_x"]          # rank (0, 1): x whole
    nxl = ARR.shape[0] // 2
    swapped = np.concatenate([got[nxl:], got[:nxl]])
    want = expected(ARR, 2, 2, 1, "gather_x")
    assert np.array_equal(got, want)
    assert np.linalg.norm(swapped) == np.linalg.norm(want)
    assert not np.array_equal(swapped, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_scatter_and_gather_field(jobs, shape):
    """scatter_field hands out rank 0's array in blocks, gather_field puts
    them back on rank 0 alone."""
    for r, got in enumerate(jobs[shape]):
        assert np.array_equal(got["scatter_field"],
                              expected(ARR, *shape, r, "block"))
        if r == 0:
            assert np.array_equal(got["gather_field"], ARR)
        else:
            assert got["gather_field"] is None


def test_four_dimensional_stack_and_wire(jobs):
    """float32 on the wire: the block permutation of the float32-rounded
    array, cast back (tlab_tpu's cast_on_wire)."""
    wire = jobs["wire"]
    for r, got in enumerate(jobs[(2, 2)]):
        want = expected(wire.astype(np.float32).astype(np.float64), 2, 2, r,
                        "gather_x")
        assert got["wire_gather_x"].dtype == np.float64
        assert np.array_equal(got["wire_gather_x"], want)


def _assemble(blocks, px, pz):
    """The global array of the ranks' (nxl, ny, nzl) blocks."""
    rows = [np.concatenate(blocks[ix * pz:(ix + 1) * pz], axis=-1)
            for ix in range(px)]
    return np.concatenate(rows, axis=-3)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


@pytest.fixture(scope="module")
def single_solves():
    """The port's single-device solves of the same inputs."""
    _, P = W.solve_plans()
    f, bb, bt = (torch.as_tensor(a) for a in W.solve_inputs())
    p, dpdy = elliptic.poisson(P["ell"], f, bb, bt, d1y=P["d1y"])
    h = elliptic.helmholtz(P["ell"], f, -3.0, bb, bt)
    pf, df = fac.poisson_factorize(P["ell_fac"], f, bb, bt)
    return {"poisson": (p.numpy(), dpdy.numpy()), "helmholtz": h.numpy(),
            "factorize": (pf.numpy(), df.numpy())}


@pytest.mark.parametrize("solve", ["poisson", "helmholtz", "factorize"])
@pytest.mark.parametrize("shape", SHAPES)
def test_pencil_solves_match_one_device(jobs, single_solves, shape, solve):
    want = single_solves[solve]
    got = [r[solve] for r in jobs[shape]]
    if solve == "helmholtz":
        assert _rel(_assemble(got, *shape), want) <= SOLVE_TOL
    else:
        for k in range(2):
            assert _rel(_assemble([g[k] for g in got], *shape),
                        want[k]) <= SOLVE_TOL, (solve, k)


@pytest.fixture(scope="module")
def jax_solves():
    """tlab_tpu's pencil solves on its 8-device virtual mesh at 4x2."""
    import functools
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as PS
    from tlab_tpu.dycore import incompressible as jdyn
    from tlab_tpu.fdm.plan import build_fdm_plan
    from tlab_tpu.grid import uniform_grid
    from tlab_tpu.ops import elliptic_factorize as jfac
    from tlab_tpu.parallel import make_mesh, pencil as jp
    from tlab_tpu.physics.params import NSParams
    nx, ny, nz = W.SOLVE_SHAPE
    grid = uniform_grid(nx, ny, nz, 2.0 * np.pi, 1.0, np.pi)
    bcs = jdyn.WallBCs.from_velocity_kind(
        "freeslip", "freeslip", scalar_bcs=(("neumann", "neumann"),))
    fdm = build_fdm_plan(grid)
    P = jdyn.build_device_plans(fdm, NSParams(reynolds=5000.0,
                                              schmidt=(1.0,)),
                                bcs, dtype=jnp.float64)
    P["ell_fac"] = jfac.device_factorize_plan(jfac.build_factorize_plan(fdm),
                                              jnp.float64)
    mesh = make_mesh(4, 2)
    Pp = jp.pencil_plans(mesh, P)
    f, bb, bt = W.solve_inputs()
    fs, ps = PS("x", None, "z"), PS("x", "z")

    def run(fn, n_out):
        body = functools.partial(shard_map, mesh=mesh,
                                 in_specs=(fs, ps, ps),
                                 out_specs=(fs,) * n_out if n_out > 1 else fs,
                                 check_vma=False)(fn)
        args = [jax.device_put(jnp.asarray(a), NamedSharding(mesh, s))
                for a, s in ((f, fs), (bb, ps), (bt, ps))]
        out = jax.jit(body)(*args)
        return tuple(np.asarray(o) for o in out) if n_out > 1 \
            else np.asarray(out)

    return {
        "poisson": run(lambda a, b, c: jp.pencil_poisson(
            Pp["ell"], a, Pp["comm"], b, c, d1y=P["d1y"]), 2),
        "helmholtz": run(lambda a, b, c: jp.pencil_helmholtz(
            Pp["ell"], a, Pp["comm"], -3.0, b, c), 1),
        "factorize": run(lambda a, b, c: jp.pencil_poisson_factorize(
            Pp["ell_fac"], a, Pp["comm"], b, c), 2)}


@pytest.mark.parametrize("solve", ["poisson", "helmholtz", "factorize"])
def test_pencil_solves_match_tlab_tpu_mesh(jobs, jax_solves, solve):
    """The port's 2x2 solves against tlab_tpu's 4x2 ones."""
    want = jax_solves[solve]
    got = [r[solve] for r in jobs[(2, 2)]]
    if solve == "helmholtz":
        assert _rel(_assemble(got, 2, 2), want) <= JAX_TOL
    else:
        for k in range(2):
            assert _rel(_assemble([g[k] for g in got], 2, 2),
                        want[k]) <= JAX_TOL, (solve, k)


def test_pencil_step_matches_one_device(jobs):
    P, state = W.step_setup()
    new, p = dyn.rk_step(P, state, 1e-3)
    got = [r["step"] for r in jobs[(2, 2)]]
    for k, want in enumerate([*new[:3], new.s[0], p]):
        blocks = [g[k] if k != 3 else g[3][0] for g in got]
        assert _rel(_assemble(blocks, 2, 2), want.numpy()) <= STEP_TOL, k


def test_pencil_wire_precision_option(jobs):
    """float32 on the wire: close to the float64 step, not equal
    (reference TransposeTypeK=single)."""
    for r in jobs[(2, 2)]:
        err = np.abs(r["step_wire"][0] - r["step"][0]).max()
        assert 1e-14 < err < 1e-4, err


def test_pencil_step_compressible_matches_one_device(jobs):
    Pc, U, step_fn = W.comp_setup()
    want = step_fn(Pc, U, 1e-4)
    got = [r["comp_step"] for r in jobs[(2, 2)]]
    for k, a in enumerate(want):
        if a is None:
            continue
        blocks = [g[k] for g in got]
        assert _rel(_assemble(blocks, 2, 2), a.numpy()) <= STEP_TOL, k


def test_transpose_check(jobs):
    reports = [r["check"] for r in jobs[(2, 2)]]
    rep = reports[0]
    assert all(r == rep for r in reports)       # one dict on every rank
    assert rep["transpose_roundtrip_residual"] == 0.0
    assert rep["transpose_roundtrip_time_s"] > 0.0
    assert rep["transpose_bandwidth_GBps"] > 0.0
    assert (rep["mesh"], rep["backend"], rep["shape"]) == \
        ("2x2", "gloo", W.SOLVE_SHAPE)


def test_decomposition_rule():
    """tlab_tpu's rule and message (tools/dns.py:727-735)."""
    from tlab_tpu_torch.parallel.pencil import check_decomposition
    check_decomposition(2, 2, 24, 16)
    with pytest.raises(ValueError, match=r"mesh \(4,2\) incompatible with "
                       r"grid \(24,12\)"):
        check_decomposition(4, 2, 24, 12)


def test_block_state_round_trip():
    """_assemble inverts the blocks of mesh.block's layout."""
    blocks = [expected(ARR, 2, 2, r, "block") for r in range(4)]
    assert np.array_equal(_assemble(blocks, 2, 2), ARR)


def test_dryrun_multichip_on_four_ranks():
    """entry.dryrun_multichip: every mesh path once on 2x2 CPU ranks."""
    from tlab_tpu_torch import entry
    out = entry.dryrun_multichip(4, "cpu")
    assert [r["rank"] for r in out] == [0, 1, 2, 3]
    assert out[0]["particles"] == 64 and out[1]["particles"] is None
    assert out[0]["dns_log"] == out[3]["dns_log"]
    assert out[0]["describe"] == "mesh 2x2: 4 ranks, backend gloo (on the " \
        "CPU)"


def _comm(px, pz, rank):
    ix, iz = divmod(rank, pz)
    mesh = types.SimpleNamespace(px=px, pz=pz, ix=ix, iz=iz)
    return {"px": px, "pz": pz, "mesh": mesh}


@pytest.mark.parametrize("shape", SHAPES)
def test_localized_tables_are_the_global_ones_cut(shape):
    """ibm.localize_fill (gathered and not), localize_block,
    apply_ibm_state(comm=) and buffer.localize are pure indexing: on every
    rank's view they give the global result's slice bit for bit."""
    from tlab_tpu_torch import ibm
    from tlab_tpu_torch.dycore import buffer
    from tlab_tpu_torch.grid import uniform_grid
    px, pz = shape
    grid = uniform_grid(16, 12, 8, 2.0, 1.0, 1.5)
    eps = np.asarray(ibm.geometry_xbars(grid, 2, 3, 2), float)
    fills = ibm.build_ibm_spline(eps, grid, torch.float64, "cpu")
    plan = ibm.build_ibm(eps, torch.float64, "cpu")
    u = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (2, 16, 12, 8)))
    state = State(u=u[0], v=u[1], w=-u[0], s=u[1:])
    buf = {"tau_x": torch.arange(16.0)[:, None, None],
           "refs_x": {"u": torch.rand(1, 12, 8), "v": torch.rand(1, 12, 1)}}
    for r in range(px * pz):
        comm = _comm(px, pz, r)
        ix, iz = divmod(r, pz)
        for name, fill in fills.items():
            gathered = name != "y" and comm[f"p{name}"] > 1
            x0, xs, z0, zs = ibm._view(comm, name, (16, 12, 8), gathered)
            view = (slice(None), slice(x0, x0 + xs), slice(None),
                    slice(z0, z0 + zs))
            want = ibm.apply_spline_fill(u, fill)[view]
            got = ibm.apply_spline_fill(
                u[view].contiguous(),
                ibm.localize_fill(fill, name, comm, (16, 12, 8), gathered))
            assert torch.equal(got, want), (shape, r, name)
        xb = slice(ix * 16 // px, (ix + 1) * 16 // px)
        zb = slice(iz * 8 // pz, (iz + 1) * 8 // pz)
        assert torch.equal(ibm.localize_block(plan["eps"], comm),
                           plan["eps"][xb, :, zb])
        local = State(*(a[..., xb, :, zb] for a in state[:4]))
        got = ibm.apply_ibm_state(plan, local, comm)
        want = ibm.apply_ibm_state(plan, state)
        for a, b in zip(got[:4], want[:4]):
            assert torch.equal(a, b[..., xb, :, zb])
        lb = buffer.localize(buf, comm)
        assert torch.equal(lb["tau_x"], buf["tau_x"][xb])
        assert torch.equal(lb["refs_x"]["u"], buf["refs_x"]["u"][..., zb])
        assert torch.equal(lb["refs_x"]["v"], buf["refs_x"]["v"])
