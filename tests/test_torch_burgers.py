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
    before = list(burgers.launches)
    assert not tdyn._fused_burgers_ok({"d12x": d12}, "x", x)
    tdyn._burgers_all({"d12x": d12}, "x", 0, x, conv, nu[:, None, None, None])
    assert burgers.launches == before


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
    """The split operator as K1 and K2 copy it into shared memory: zero
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
