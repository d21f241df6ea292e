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
