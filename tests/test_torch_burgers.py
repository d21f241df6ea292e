"""The port's fused Burgers term (tlab_tpu_torch/ops/burgers.py) against
tlab_tpu: the Pallas TPU kernel itself, run in interpret mode on the CPU,
and the dycore's einsum path.  Inputs are made with numpy from a seed."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tlab_tpu.dycore import incompressible as jdyn
from tlab_tpu.fdm.plan import build_fdm_plan
from tlab_tpu.grid import uniform_grid
from tlab_tpu.ops import pallas_burgers as pb
from tlab_tpu.physics.params import NSParams
from tlab_tpu_torch import entry
from tlab_tpu_torch.dycore import incompressible as tdyn
from tlab_tpu_torch.ops import burgers


def _operands(F, shape, axis, dtype, seed=0):
    rng = np.random.default_rng(seed)
    n = shape[axis]
    return (rng.standard_normal((2 * n, n)).astype(dtype),
            rng.standard_normal((F,) + shape).astype(dtype),
            rng.standard_normal(shape).astype(dtype),
            rng.uniform(0.1, 1.0, F).astype(dtype))


@pytest.mark.parametrize("F", [4, 5])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_fused_burgers_matches_pallas_kernel(F, axis):
    """fp32 against the TPU kernel in interpret mode at HIGHEST precision:
    both sum 128 fp32 products in different orders, so 1e-5 of the
    largest result is ~100x the expected round-off."""
    ops = _operands(F, (16, 16, 128), axis, np.float32, seed=F + 10 * axis)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pb.fused_burgers(*map(jnp.asarray, ops), axis,
                                          "highest"))
    got = burgers.fused_burgers(*map(torch.from_numpy, ops), axis).numpy()
    assert got.dtype == np.float32
    assert np.max(np.abs(got - ref)) <= 1e-5 * np.max(np.abs(ref))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_burgers_all_matches_jax(axis):
    """The dycore's per-direction Burgers for the whole stack, float64."""
    grid = uniform_grid(32, 33, 16, 2.0 * np.pi, 1.0, np.pi)
    fdm = build_fdm_plan(grid)
    nsp = NSParams(reynolds=300.0, schmidt=(1.0,))
    PJ = jdyn.build_device_plans(
        fdm, nsp, jdyn.WallBCs.from_velocity_kind("freeslip", "freeslip"),
        dtype=jnp.float64, with_elliptic=False)
    name = "xyz"[axis]
    rng = np.random.default_rng(7 + axis)
    fields = rng.standard_normal((4,) + grid.shape)
    conv = fields[axis]
    nu = np.array([0.01, 0.01, 0.01, 0.02])[:, None, None, None]
    ref = np.asarray(jdyn._burgers_all(PJ, name, axis, jnp.asarray(fields),
                                       jnp.asarray(conv), jnp.asarray(nu)))
    PT = {f"d12{name}": torch.from_numpy(np.asarray(PJ[f"d12{name}"]))}
    got = tdyn._burgers_all(PT, name, axis, torch.from_numpy(fields),
                            torch.from_numpy(conv), torch.from_numpy(nu))
    err = np.max(np.abs(got.numpy() - ref)) / np.max(np.abs(ref))
    assert err <= 1e-12, err


def test_cpu_stack_takes_the_dense_path():
    """The kernel gate needs a CUDA float32 stack: on the CPU the dycore
    runs the dense product and launches nothing."""
    d12, x, conv, nu = map(torch.from_numpy,
                           _operands(4, (8, 8, 8), 0, np.float32))
    before = {k: list(v) for k, v in burgers.contract_launches.items()}
    assert not tdyn._fused_burgers_ok({"d12x": d12}, "x", x)
    tdyn._burgers_all({"d12x": d12}, "x", 0, x, conv, nu[:, None, None, None])
    assert burgers.contract_launches == before


@pytest.mark.parametrize("bad, exc", [
    ("dtype", TypeError), ("d12_shape", ValueError), ("conv_shape", ValueError),
    ("nu_shape", ValueError), ("strided", ValueError), ("axis", ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, exc):
    d12, x, conv, nu = map(torch.from_numpy,
                           _operands(4, (8, 12, 16), 1, np.float32))
    axis = 1
    if bad == "dtype":
        x = x.double()
    elif bad == "d12_shape":
        d12 = d12[:-1]
    elif bad == "conv_shape":
        conv = conv[:, :, :-1]
    elif bad == "nu_shape":
        nu = nu[:3]
    elif bad == "strided":
        conv = conv.transpose(0, 2).contiguous().transpose(0, 2)
    else:
        axis = 3
    with pytest.raises(exc):
        burgers._check(d12, x, conv, nu, axis)


# (F, shapes by contracted axis): n = 512 on the contracted axis for F = 4
SPLIT_SHAPES = {4: ((512, 8, 128), (4, 512, 128), (4, 8, 512)),
                5: ((96, 8, 128), (4, 96, 128), (4, 8, 96))}


def _split_case(F, axis):
    ops = _operands(F, SPLIT_SHAPES[F][axis], axis, np.float32,
                    seed=F + 10 * axis)
    t = [torch.from_numpy(a) for a in ops]
    ref64 = burgers.fused_burgers_plain(*(a.double() for a in t),
                                        axis).numpy()
    return ops, t, ref64


@pytest.mark.parametrize("F", [4, 5])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_split_plain_matches_fp64(F, axis):
    """The arithmetic of the tensor-core kernels (3 TF32 products of the
    hi/lo split, fp32 sums) against a float64 product.  hi + lo keeps ~22
    significant bits and the dropped lo.lo term is ~2^-22 relative, so the
    split is as close to float64 as a full-fp32 product is (~5e-7 of the
    largest result over 512 terms): 2e-6 holds it with a factor of 4."""
    _, t, ref64 = _split_case(F, axis)
    got = burgers.fused_burgers_split_plain(*t, axis)
    assert got.dtype == torch.float32
    err = np.max(np.abs(got.numpy() - ref64)) / np.max(np.abs(ref64))
    assert err <= 2e-6, err


def _plan_operator_z(n=256):
    """d12z (float32) of the shear layer's 8 x 8 x n grid: the z operator
    that the row kernel is given on the card, from the port's own plans."""
    _, P, _ = entry.build(8, 8, n, torch.float32, "cpu")
    return P["d12z"]


def test_split_plain_row_form_with_the_plan_operator_matches_fp64():
    """The case the card runs along z: n = 256 and the plan's compact
    [D1; D2] (rows of ~256 decaying entries with alternating signs, D2's of
    order (n / L)^2), not a random matrix.  The 3xTF32 arithmetic stays
    within 2e-6 of the largest float64 result there too, and as close as
    the full-fp32 product is within a factor of 4."""
    d12 = _plan_operator_z()
    assert tuple(d12.shape) == (512, 256)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 8, 8, 256))
                         .astype(np.float32))
    conv = torch.from_numpy(rng.standard_normal((8, 8, 256))
                            .astype(np.float32))
    nu = torch.tensor([2e-4, 2e-4, 2e-4, 2e-4], dtype=torch.float32)
    ref64 = burgers.fused_burgers_plain(d12.double(), x.double(),
                                        conv.double(), nu.double(), 2)
    scale = float(ref64.abs().max())
    got = burgers.fused_burgers_split_plain(d12, x, conv, nu, 2)
    full = burgers.fused_burgers_plain(d12, x, conv, nu, 2)
    err = float((got - ref64).abs().max()) / scale
    err_full = float((full - ref64).abs().max()) / scale
    assert got.dtype == torch.float32
    assert err <= 2e-6, err
    assert err <= 4 * err_full, (err, err_full)


@pytest.mark.parametrize("F", [4, 5])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_split_plain_matches_pallas_kernel_at_high(F, axis):
    """Against the TPU kernel in interpret mode at its default "high"
    precision, the 3-pass bf16 split this design is the counterpart of.
    That split keeps ~16 bits (measured ~5e-6 of the largest result from
    float64), which is what the 2e-5 allows for; the TF32 split is the
    closer of the two."""
    ops, t, ref64 = _split_case(F, axis)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pb.fused_burgers(*map(jnp.asarray, ops), axis))
    got = burgers.fused_burgers_split_plain(*t, axis).numpy()
    scale = np.max(np.abs(ref64))
    assert np.max(np.abs(got - ref)) <= 2e-5 * scale
    assert np.max(np.abs(got - ref64)) < np.max(np.abs(ref - ref64))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_single_tf32_pass_misses_the_kernel_limit(axis):
    """Why the split is there: one TF32 pass (x_hi . d_hi alone) is off by
    ~3e-4 of the largest result, far over the 1e-5 that the kernels are
    held to against their plain version."""
    _, t, ref64 = _split_case(4, axis)
    one = burgers.fused_burgers_split_plain(*t, axis, passes=1).numpy()
    err = np.max(np.abs(one - ref64)) / np.max(np.abs(ref64))
    assert err > 1e-5, err
    with pytest.raises(ValueError):
        burgers.fused_burgers_split_plain(*t, axis, passes=2)


def test_tf32_round_is_nearest_even_on_10_bits():
    v = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -1.0 - 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12,
                      0.0, 3.0e38], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -9, -1.0, 1.0 + 2.0 ** -10,
                         0.0, 3.0e38], dtype=torch.float32)
    got = burgers.tf32_round(v)
    assert torch.equal(got[:5], want[:5])
    assert abs(float(got[5]) / 3.0e38 - 1.0) <= 2.0 ** -11
    assert int((got.view(torch.int32) & 0x1FFF).abs().max()) == 0
    hi, lo = burgers.tf32_split(torch.from_numpy(
        np.random.default_rng(0).standard_normal(4096).astype(np.float32)))
    x = hi.double() + lo.double()
    assert float((x - (hi + lo).double()).abs().max()) == 0.0
    assert float(lo.abs().max()) <= 2.0 ** -11 * float(hi.abs().max())


def _unpack_operator(pack, n):
    """[D1 hi, D1 lo, D2 hi, D2 lo] (4, n, n) back from pack_operator's
    layout (the swizzle is its own inverse)."""
    at, kt, _, rows, chunks, _ = pack.shape
    r = torch.arange(rows)
    c = torch.arange(chunks)
    src = c[None, :] ^ ((r[:, None] >> 1) & 3)
    q = pack.gather(4, src[None, None, None, :, :, None].expand_as(pack))
    q = q.permute(2, 0, 3, 1, 4, 5).reshape(4, at * rows, kt * chunks * 4)
    return q[:, :n, :n]


@pytest.mark.parametrize("n", [7, 23, 128, 130])
def test_pack_operator_layout(n):
    """The split operator as K1-K3 copy it into shared memory: zero
    padding to whole tiles, the four tiles D1 hi, D1 lo, D2 hi, D2 lo per
    (row tile, K tile), and the 64-byte swizzle of each tile's chunks."""
    rows, depth = 128, 16
    d12 = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (2 * n, n)).astype(np.float32))
    pack = burgers.pack_operator(d12, rows, depth)
    at, kt = -(-n // rows), -(-n // depth)
    assert tuple(pack.shape) == (at, kt, 4, rows, depth // 4, 4)
    assert pack.is_contiguous()
    hi, lo = burgers.tf32_split(d12.reshape(2, n, n))
    want = torch.stack((hi[0], lo[0], hi[1], lo[1]))
    assert torch.equal(_unpack_operator(pack, n), want)
    # everything outside the operator is zero padding
    assert float(pack.abs().sum()) == pytest.approx(
        float(want.abs().sum()), rel=1e-5)
    # one element by hand: row a, column k of D2 hi
    flat = pack.reshape(at, kt, 4, rows * depth)
    for a, k in ((0, 0), (n - 1, n - 1), (n // 2, n // 3)):
        r, c = a % rows, (k % depth) // 4
        pos = r * depth + ((c ^ ((r >> 1) & 3)) * 4) + k % 4
        assert flat[a // rows, k // depth, 2, pos] == hi[1][a, k]
    with pytest.raises(ValueError):
        burgers.pack_operator(d12, rows, 32)


def test_pack_operator_round_trips_the_z_operator_at_256():
    """The operator the row kernel streams on the card: the plan's d12z at
    n = 256 packs into two row tiles of 16 K tiles with no padding, and
    unpacks to its own TF32 split, whose parts add up to the operator
    within 2^-21 of each entry (the far off-diagonal entries that have
    decayed below 1e-20, towards the denormals, are held by the absolute
    bound alone)."""
    d12 = _plan_operator_z()
    pack = burgers.pack_operator(d12, 128, 16)
    assert tuple(pack.shape) == (2, 16, 4, 128, 4, 4)
    assert pack.numel() == 2 * d12.numel()
    parts = _unpack_operator(pack, 256)
    hi, lo = burgers.tf32_split(d12.reshape(2, 256, 256))
    assert torch.equal(parts, torch.stack((hi[0], lo[0], hi[1], lo[1])))
    back = torch.cat((parts[0].double() + parts[1].double(),
                      parts[2].double() + parts[3].double()))
    assert float((back - d12.double()).abs().max()) <= \
        2.0 ** -21 * float(d12.abs().max())
    normal = d12.abs() > 1e-20
    assert int(normal.sum()) > d12.numel() // 4
    assert torch.all(((back - d12.double()).abs()
                      <= 2.0 ** -21 * d12.double().abs())[normal])


@pytest.mark.parametrize("prec_name", ["default", "high", "highest"])
def test_fused_burgers_on_the_cpu_is_plain_for_every_contract(prec_name):
    """On a CPU tensor every contract gives the full-fp32 plain version (as
    tlab_tpu off a TPU computes full fp32 whatever the name) and launches
    nothing; an unknown name raises."""
    d12, x, conv, nu = map(torch.from_numpy,
                           _operands(3, (6, 10, 12), 2, np.float32))
    before = {k: list(v) for k, v in burgers.contract_launches.items()}
    got = burgers.fused_burgers(d12, x, conv, nu, 2, prec_name)
    assert torch.equal(got, burgers.fused_burgers_plain(d12, x, conv, nu, 2))
    assert burgers.contract_launches == before
    with pytest.raises(ValueError, match="prec_name"):
        burgers.fused_burgers(d12, x, conv, nu, 2, "hihg")


@pytest.mark.parametrize("prec_name", ["high", "default"])
@pytest.mark.parametrize("n", [7, 23, 128, 130])
def test_pack_operator_bf16_layout(prec_name, n):
    """The bf16 contracts' operator as the kernels copy it: bfloat16 tiles
    of 128 rows x 32 deep (64 bytes a row, as the TF32 tiles), the bf16
    split's parts D1 hi, D1 lo, D2 hi, D2 lo ("high") or D1, D2 ("default")
    per (row tile, K tile), zero padding, and the 64-byte swizzle of each
    row's four 16-byte chunks of 8 elements."""
    rows, depth = 128, 32
    d12 = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (2 * n, n)).astype(np.float32))
    pack = burgers.pack_operator(d12, rows, depth, prec_name)
    parts = 4 if prec_name == "high" else 2
    at, kt = -(-n // rows), -(-n // depth)
    assert pack.dtype == torch.bfloat16 and pack.is_contiguous()
    assert tuple(pack.shape) == (at, kt, parts, rows, 4, 8)
    assert pack.numel() * 2 == at * kt * parts * 8192
    hi, lo = burgers.bf16_split(d12.reshape(2, n, n))
    want = torch.stack((hi[0], lo[0], hi[1], lo[1]) if parts == 4
                       else (hi[0], hi[1]))
    r = torch.arange(rows)
    src = torch.arange(4)[None, :] ^ ((r[:, None] >> 1) & 3)
    q = pack.float().gather(
        4, src[None, None, None, :, :, None].expand_as(pack))
    q = q.permute(2, 0, 3, 1, 4, 5).reshape(parts, at * rows, kt * depth)
    assert torch.equal(q[:, :n, :n], want)
    assert float(q.abs().sum()) == pytest.approx(float(want.abs().sum()),
                                                 rel=1e-5)
    # one element by hand: row a, column k of D2's hi part
    flat = pack.reshape(at, kt, parts, rows * depth)
    for a, k in ((0, 0), (n - 1, n - 1), (n // 2, n // 3)):
        rr, c = a % rows, (k % depth) // 8
        pos = rr * depth + ((c ^ ((rr >> 1) & 3)) * 8) + k % 8
        assert float(flat[a // rows, k // depth, parts // 2, pos]) == \
            float(hi[1][a, k])
    with pytest.raises(ValueError):
        burgers.pack_operator(d12, rows, 16, prec_name)


# (F, (nx, ny, nz)): the ragged shapes, those that leave the bf16 column
# kernel's clusters partly empty (n = 300: 3 row tiles; nz = 300: 3 line
# tiles a slab; F = 1; a short last K tile, n = 513; ncol 23 beside 24) and
# the main path's
COLUMN_SHAPES = [(5, (24, 20, 36)), (5, (23, 19, 37)), (3, (7, 5, 6)),
                 (3, (6, 10, 200)), (2, (300, 20, 36)), (2, (6, 40, 300)),
                 (1, (300, 24, 40)), (1, (40, 300, 23)), (1, (40, 300, 24)),
                 (3, (513, 8, 12)), (4, (512, 256, 256))]


def _column_launch(F, shape, axis):
    """(n, ncol, G) of K1 (axis 0) or K2 (axis 1), as burgers.cu's entry
    points hand them to the column kernel."""
    nx, ny, nz = shape
    return (nx, ny * nz, 1) if axis == 0 else (ny, nz, nx)


@pytest.mark.parametrize("F, shape", COLUMN_SHAPES)
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("bulk", [True, False])
def test_column_walk_covers_every_output_tile_once(F, shape, axis, bulk):
    """The persistent walk of the bf16 column kernel: over all cluster
    tiles and ranks, every (line tile, row tile) of the launch is owned
    exactly once, every other slot is a padded one, and the line tiles
    decode to every (field, slab, column tile) once, fields fastest."""
    n, ncol, G = _column_launch(F, shape, axis)
    s = burgers.column_schedule(n, ncol, G, F, bulk)
    cs = s["cc"] * s["ca"]
    assert cs <= 8 and s["cc"] & (s["cc"] - 1) == 0 \
        and s["ca"] & (s["ca"] - 1) == 0
    owned, padded = [], 0
    for T in range(s["tiles"]):
        for rank in range(cs):
            L, A = burgers.column_tile(s, T, rank)
            if L < s["lines"] and A < s["at"]:
                owned.append((L, A))
            else:
                padded += 1
    assert sorted(owned) == [(L, A) for L in range(s["lines"])
                             for A in range(s["at"])]
    assert padded == s["tiles"] * cs - s["lines"] * s["at"]
    decoded = [burgers.column_line(s, L, F) for L in range(s["lines"])]
    assert sorted(decoded) == sorted(
        (f, g, c0) for f in range(F) for g in range(G)
        for c0 in range(0, ncol, burgers.TILE))
    assert [d[0] for d in decoded[:F]] == list(range(F))


@pytest.mark.parametrize("n, ncol, G, F, bulk, want", [
    # K1 and K2 at 512x256x256, F = 4: 2 x 4 and 4 x 2 blocks
    (512, 256 * 256, 1, 4, True, (2, 4, 1024)),
    (256, 256, 512, 4, True, (4, 2, 1024)),
    # 3 row tiles: pairs of them, the second pair half padded
    (300, 720, 1, 2, True, (4, 2, 6)),
    # off the bulk path no field is shared: 8 line tiles a cluster
    (300, 23, 40, 1, False, (8, 1, 15)),
    # fewer line tiles than 8 / ca: the cluster shrinks to cover them
    (7, 30, 1, 3, True, (4, 1, 1)),
    (5, 6, 7, 3, False, (8, 1, 3)),
])
def test_column_cluster_extents(n, ncol, G, F, bulk, want):
    s = burgers.column_schedule(n, ncol, G, F, bulk)
    assert (s["cc"], s["ca"], s["tiles"]) == want
