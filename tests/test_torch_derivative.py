"""The port's dense derivative application against tlab_tpu's, float64."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tlab_tpu.fdm.plan import build_fdm_plan
from tlab_tpu.grid import uniform_grid
from tlab_tpu.constants import BC
from tlab_tpu.ops import derivative as jder
from tlab_tpu_torch.ops import derivative as tder


@pytest.mark.parametrize("ndim", [3, 4])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_der1_der12_match_jax(ndim, axis):
    grid = uniform_grid(12, 17, 10, 2.0 * np.pi, 1.0, np.pi)
    plan = build_fdm_plan(grid).axis(axis)
    rng = np.random.default_rng(axis + 3 * ndim)
    u = rng.standard_normal(((3,) if ndim == 4 else ()) + grid.shape)
    ax = axis + ndim - 3
    d1, d12 = plan.d1[BC.DD], plan.d12[BC.DD]
    ref1 = np.asarray(jder.der1(jnp.asarray(d1), jnp.asarray(u), ax))
    got1 = tder.der1(torch.from_numpy(d1), torch.from_numpy(u), ax)
    assert np.max(np.abs(got1.numpy() - ref1)) <= 1e-12 * np.max(np.abs(ref1))
    refs = jder.der12(jnp.asarray(d12), jnp.asarray(u), ax)
    gots = tder.der12(torch.from_numpy(d12), torch.from_numpy(u), ax)
    for got, ref in zip(gots, refs):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        assert np.max(np.abs(got.numpy() - ref)) <= 1e-12 * np.max(np.abs(ref))
