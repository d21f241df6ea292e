"""The compressible set's derivative products on the tensor cores
(tlab_tpu_torch/ops/burgers.py deriv1, deriv12) on the CPU: the wrappers'
plain branch, the 3xTF32 arithmetic of the kernels against float64 at
case02's operators, the gate in dycore/compressible.py and the launch
counter.  The kernels themselves run in tests/test_torch_cuda.py."""
import re
import types

import numpy as np
import pytest
import torch

from tlab_tpu_torch import grid as tgrid
from tlab_tpu_torch.constants import BC
from tlab_tpu_torch.dycore import compressible as tcomp
from tlab_tpu_torch.dycore import incompressible as tdyn
from tlab_tpu_torch.fdm.plan import build_fdm_plan
from tlab_tpu_torch.ops import burgers
from tlab_tpu_torch.ops.derivative import der1, der12
from tlab_tpu_torch.physics.params import NSParams
from tlab_tpu_torch.utils import nantrap, trace

# case02's grid on one card: x periodic over 2, y between walls over 1, z
# periodic over 1
CASE02_SHAPE = (512, 256, 256)


@pytest.fixture(scope="module")
def case02_operators():
    """[D1; D2] of each direction of case02's grid, float32."""
    fdm = build_fdm_plan(tgrid.uniform_grid(*CASE02_SHAPE, 2.0, 1.0, 1.0))
    return tuple(torch.from_numpy(p.d12[BC.DD]).float()
                 for p in (fdm.x, fdm.y, fdm.z))


def _stack(F, n, axis, dtype=torch.float32, seed=0):
    """(F, ...) fields with n points along spatial `axis`, 4 and 6 across."""
    shape = [4, 6, 5]
    shape[axis] = n
    rng = np.random.default_rng(seed + axis)
    return torch.from_numpy(rng.standard_normal((F, *shape))).to(dtype)


@pytest.mark.parametrize("ndim", [3, 4])
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_branch_is_der1_and_der12_exactly(ndim, axis, dtype):
    """On a CPU tensor deriv1 is der1 of the operator's D1 rows and deriv12
    is der12, bit for bit, on a field and on a stack."""
    x = _stack(3, 12, axis, dtype)
    if ndim == 3:
        x = x[0]
    a = axis + ndim - 3
    rng = np.random.default_rng(1)
    d12 = torch.from_numpy(rng.standard_normal((24, 12))).to(dtype)
    assert torch.equal(burgers.deriv1(d12, x, a),
                       der1(d12[:12].clone(), x, a))
    got, want = burgers.deriv12(d12, x, a), der12(d12, x, a)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_split_arithmetic_at_case02_operators_matches_fp64(
        case02_operators, axis):
    """The kernels' 3xTF32 arithmetic (der12_split_plain) of a d1 and a
    [D1; D2] product with case02's operators (x periodic 512, y with walls
    256, z periodic 256) against a float64 product of the same float32
    operands: within the 2e-6 of the largest result that the K1-K3 split
    tests hold, and as close as the full-fp32 product within a factor of
    4.  d1 is the first half of the same products (the kernel's D1 rows)."""
    d12 = case02_operators[axis]
    n = CASE02_SHAPE[axis]
    x = _stack(2, n, axis)
    got = burgers.der12_split_plain(d12, x, axis + 1)
    full = der12(d12, x, axis + 1)
    ref = der12(d12.double(), x.double(), axis + 1)
    for g, f, r in zip(got, full, ref):
        scale = float(r.abs().max())
        err = float((g.double() - r).abs().max()) / scale
        err_full = float((f.double() - r).abs().max()) / scale
        assert g.dtype == torch.float32
        assert err <= 2e-6, err
        assert err <= 4 * err_full, (err, err_full)


def test_gate_takes_float32_cuda_dense_lines_only():
    """The kernels take a float32 CUDA tensor on a direction without a
    banded plan; float64, the CPU and a banded (long) line keep the
    incompressible set's products."""
    P = {}
    cuda32 = types.SimpleNamespace(is_cuda=True, dtype=torch.float32)
    cuda64 = types.SimpleNamespace(is_cuda=True, dtype=torch.float64)
    assert tcomp._tensor_cores(P, "x", cuda32)
    assert not tcomp._tensor_cores(P, "x", cuda64)
    assert not tcomp._tensor_cores(P, "x", torch.zeros(2))
    assert not tcomp._tensor_cores({"d1x_banded": {}}, "x", cuda32)


def _plans():
    """The port's float64 CPU plans of a 16 x 12 (walls) x 8 box."""
    return tdyn.build_device_plans(
        build_fdm_plan(tgrid.uniform_grid(16, 12, 8, 2.0, 1.0, 1.0)),
        NSParams(reynolds=100.0, schmidt=(1.0,)),
        tdyn.WallBCs.from_velocity_kind("freeslip", "freeslip"),
        dtype=torch.float64, device="cpu", with_elliptic=False)


@pytest.mark.parametrize("gate", [True, False])
def test_call_sites_route_by_the_gate(monkeypatch, gate):
    """Where the gate holds, _d1 and _d12_stack hand the plan's [D1; D2]
    to deriv1 and deriv12 and return their outputs as they come (no cat);
    elsewhere they call dyn._d1 and dyn._d12_apply, and nothing launches."""
    P = _plans()
    calls = []
    monkeypatch.setattr(tcomp, "_tensor_cores", lambda *a: gate)
    monkeypatch.setattr(burgers, "deriv1",
                        lambda d12, g, axis: calls.append(("deriv1", d12,
                                                           axis)) or g)
    outs = (torch.ones(1), torch.zeros(1))
    monkeypatch.setattr(burgers, "deriv12",
                        lambda d12, g, axis: calls.append(("deriv12", d12,
                                                           axis)) or outs)
    a = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 16, 12, 8)))
    before = {k: list(v) for k, v in burgers.deriv_launches.items()}
    d1 = tcomp._d1(P, "y", 2, a)
    d1x, d2x = tcomp._d12_stack(P, "z", 2, a)
    if gate:
        assert [(k, d is P[f"d12{ax}"], axis) for (k, d, axis), ax in
                zip(calls, "yz")] == [("deriv1", True, 2),
                                      ("deriv12", True, 3)]
        assert d1 is a and d1x is outs[0] and d2x is outs[1]
    else:
        assert calls == []
        assert torch.equal(d1, tdyn._d1(P, "y", 2, a))
        want = tdyn._d12_apply(P, "z", 2, a)
        assert torch.equal(d1x, want[0]) and torch.equal(d2x, want[1])
    assert burgers.deriv_launches == before


def test_wrappers_refuse_an_axis_that_is_not_spatial():
    x = torch.zeros(2, 4, 6, 5)
    with pytest.raises(ValueError):
        burgers.deriv1(torch.zeros(8, 4), x, 0)
    with pytest.raises(ValueError):
        burgers.deriv12(torch.zeros(8, 4), x[0, 0], 0)


@pytest.mark.parametrize("kind", burgers.DERIV_KINDS)
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_the_nan_trap_names_the_entry_point(kind, axis):
    """deriv1 and deriv12 (the plain products on the CPU, the kernels on the
    card) are one op to the per-op check: a NaN in their output names the
    entry point."""
    x = _stack(2, 12, axis)
    x[0, 1, 1, 1] = float("nan")
    d12 = torch.ones(24, 12)
    with nantrap.trap():
        with pytest.raises(FloatingPointError,
                           match=re.escape(f"{kind}_{'xyz'[axis]}") + "$"):
            getattr(burgers, kind)(d12, x, axis + 1)


def test_the_launches_are_the_counter_ops_derivative_k():
    """ops.derivative.k is the sum of deriv1's and deriv12's launches; the
    registry's reset() sets them to 0."""
    burgers.reset_deriv_launches()
    burgers.deriv_launches["deriv1"][0] += 3
    burgers.deriv_launches["deriv12"][2] += 2
    try:
        assert trace.totals()["counters"]["ops.derivative.k"] == 5
        trace.reset()
        assert trace.totals()["counters"]["ops.derivative.k"] == 0
        assert burgers.deriv_launches == {"deriv1": [0, 0, 0],
                                          "deriv12": [0, 0, 0]}
    finally:
        burgers.reset_deriv_launches()
