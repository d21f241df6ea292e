"""The hand-written CUDA kernels K1-K3 on the card.

These tests need a CUDA card and skip without one.  This file imports no
JAX, so it also runs on a machine with the card and no JAX, where
tests/conftest.py (which imports JAX) must be left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from tlab_tpu_torch.dycore import incompressible as tdyn
from tlab_tpu_torch.ops import burgers

# (F, shape): ragged edges in every tile dimension; the odd widths take the
# kernels' scalar loads and epilogue, the multiples of 4 their 16-byte
# ones; (7, 5, 6) is smaller than one tile in every dimension
SHAPES = [(5, (24, 20, 36)), (5, (23, 19, 37)), (4, (130, 20, 68)),
          (3, (7, 5, 6))]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _operands(F, shape, axis, dev, dtype=torch.float32):
    rng = np.random.default_rng(F + sum(shape) + axis)
    n = shape[axis]
    return tuple(torch.from_numpy(a).to(dev, dtype) for a in (
        rng.standard_normal((2 * n, n)), rng.standard_normal((F,) + shape),
        rng.standard_normal(shape), rng.uniform(0.1, 1.0, F)))


@pytest.mark.cuda
@pytest.mark.parametrize("F, shape", SHAPES)
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_kernel_matches_plain_version(F, shape, axis):
    """Sums of <= 130 products in another order, in fp32 (K3) or from the
    3xTF32 split (K1, K2, ~22 bits an operand): 1e-5 of the largest result
    is well above their round-off."""
    d12, x, conv, nu = _operands(F, shape, axis, _card())
    before = burgers.launches[axis]
    got = burgers.fused_burgers(d12, x, conv, nu, axis)
    ref = burgers.fused_burgers_plain(d12, x, conv, nu, axis)
    torch.cuda.synchronize()
    assert burgers.launches[axis] == before + 1
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.cuda
def test_gate_launches_for_float32_only():
    """A CUDA float32 stack goes through the kernel; float64 takes the
    dense path (tlab_tpu's own general path) and launches nothing."""
    dev = _card()
    for dtype, launched in ((torch.float32, 1), (torch.float64, 0)):
        d12, x, conv, nu = _operands(4, (16, 12, 8), 0, dev, dtype)
        before = burgers.launches[0]
        tdyn._burgers_all({"d12x": d12}, "x", 0, x, conv,
                          nu[:, None, None, None])
        assert burgers.launches[0] == before + launched


@pytest.mark.cuda
def test_wrapper_raises_on_cuda_input_it_does_not_take():
    d12, x, conv, nu = _operands(4, (16, 12, 8), 2, _card())
    with pytest.raises(ValueError):
        burgers.fused_burgers(d12, x, conv.transpose(0, 1).contiguous()
                              .transpose(0, 1), nu, 2)
    with pytest.raises(TypeError):
        burgers.fused_burgers(d12, x.double(), conv, nu, 2)
