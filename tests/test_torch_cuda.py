"""The hand-written CUDA kernels K1-K3 on the card.

These tests need a CUDA card and skip without one.  This file imports no
JAX, so it also runs on a machine with the card and no JAX, where
tests/conftest.py (which imports JAX) must be left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from tlab_tpu_torch import entry
from tlab_tpu_torch.config import load_case
from tlab_tpu_torch.dycore import incompressible as tdyn
from tlab_tpu_torch.ops import burgers
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.tools import dns as tdns
from tlab_tpu_torch.tools.initialize import initial_state

CASE3D = os.path.join(os.path.dirname(__file__), "data",
                      "case01_small3d.ini")

# (F, shape): ragged edges in every tile dimension; the odd widths take the
# kernels' scalar loads and epilogue, the multiples of 4 their 16-byte
# ones; (7, 5, 6) is smaller than one tile in every dimension; in
# (6, 10, 200) nz spans two operator tiles and ends in a ragged K tile; in
# (3, 7, 130) the rows of a field are far fewer than a row tile and F is odd
SHAPES = [(5, (24, 20, 36)), (5, (23, 19, 37)), (4, (130, 20, 68)),
          (3, (7, 5, 6)), (3, (6, 10, 200)), (5, (3, 7, 130))]


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
    """Sums of <= 200 products in another order, from the 3xTF32 split
    (all three kernels, ~22 bits an operand): 1e-5 of the largest result is
    well above their round-off."""
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


@pytest.mark.cuda
def test_two_dimensional_step_launches_no_z_kernel():
    """nz == 1 (the reference's Case01 shape): an RK4 step launches K1 and
    K2 once a substep and K3 never, and stays close to the float64 step."""
    dev = _card()
    out = {}
    for dtype in (torch.float32, torch.float64):
        _, P, state = entry.build(64, 48, 1, dtype, dev, seed=1)
        before = list(burgers.launches)
        state, _ = tdyn.rk_step(P, state, 1e-3)
        torch.cuda.synchronize()
        out[dtype] = (state, [b - a for a, b in zip(before,
                                                    burgers.launches)])
    assert out[torch.float32][1] == [5, 5, 0]
    assert out[torch.float64][1] == [0, 0, 0]
    u32, u64 = out[torch.float32][0].u.double(), out[torch.float64][0].u
    assert (u32 - u64).abs().max() <= 3e-4 * u64.abs().max()


@pytest.mark.cuda
def test_dns_run_float32_follows_float64(tmp_path):
    """10 adaptive-dt steps of case01_small3d.ini through dns.run on the
    card: float32 (every Burgers term through K1-K3) against float64 (the
    dense path) from the same initial state, within the 3e-4 that 5 RK4
    steps are held to (tlab_tpu's production accuracy a step, 5.9e-5, over
    the steps); dt follows the CFL in both, so the times agree too."""
    dev = _card()
    case = load_case(CASE3D)
    sim64 = Simulation.from_case(case, dtype=torch.float64, device=dev)
    start = initial_state(sim64, seed=7)
    runs = {}
    for dtype in (torch.float32, torch.float64):
        sim = Simulation.from_case(case, dtype=dtype, device=dev)
        state = type(start)(*(t.to(dtype) for t in start[:4]))
        out = tmp_path / str(dtype)
        before = list(burgers.launches)
        runs[dtype] = tdns.run(sim, state, outdir=str(out), n_steps=10,
                               log_path=str(out / "dns.out"))
        launched = [b - a for a, b in zip(before, burgers.launches)]
        assert launched == ([50] * 3 if dtype == torch.float32 else [0] * 3)
    r32, r64 = runs[torch.float32], runs[torch.float64]
    assert abs(r32.rtime - r64.rtime) <= 3e-4 * r64.rtime
    for a, b in zip(r32.state[:4], r64.state[:4]):
        assert (a.double() - b).abs().max() <= 3e-4 * b.abs().max()
    assert sorted(os.listdir(tmp_path / str(torch.float32))) == [
        "avg10", "avg10s1", "avg5", "avg5s1", "dns.out", "flow.10.1",
        "flow.10.2", "flow.10.3", "scal.10.1", "tlab.log"]


CASE93 = os.path.join(os.path.dirname(__file__), "data",
                      "case93_small3d.ini")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ibm_fill_on_the_card_matches_the_cpu(dtype):
    """The spline fill of every direction of case93_small3d.ini's bars, on
    the card against the same fill on the CPU in float64: the gather and
    the weighted sum in the same order (1e-6 of max|field| in fp32)."""
    dev = _card()
    sim = Simulation.from_case(load_case(CASE93), dtype=dtype, device=dev)
    cpu = Simulation.from_case(load_case(CASE93), dtype=torch.float64,
                               device="cpu")
    rng = np.random.default_rng(0)
    q = rng.standard_normal((4,) + tuple(sim.grid.shape))
    from tlab_tpu_torch import ibm
    for name, fill in sim.P["ibm"]["fills"].items():
        got = ibm.apply_spline_fill(torch.from_numpy(q).to(dev, dtype),
                                    fill).double().cpu()
        want = ibm.apply_spline_fill(torch.from_numpy(q),
                                     cpu.P["ibm"]["fills"][name])
        tol = 1e-6 if dtype == torch.float32 else 1e-14
        assert (got - want).abs().max() <= tol * want.abs().max(), name


@pytest.mark.cuda
def test_surface_step_and_sponge_on_the_card_match_the_cpu():
    """surface_bc_step (both walls) and the filter sponge's blend on the
    card in fp64 against the CPU: 1e-13 of max|field|."""
    dev = _card()
    text = ("[Main]\nType=temporal\n[Parameters]\nReynolds=100\nSchmidt=1.0\n"
            "[BoundaryConditions]\nScalar1Jmin=dirichlet\n"
            "Scalar1Jmax=dirichlet\nScalar1SfcTypeJmin=linear\n"
            "Scalar1CouplingJmin=0.5\nScalar1SfcTypeJmax=linear\n"
            "Scalar1CouplingJmax=0.25\n[BufferZone]\nType=filter\n"
            "PointsImin=6\nPointsImax=8\n"
            "[IniGridOx]\nperiodic=yes\nsegments=1\npoints_1=33\n"
            "scales_1=2.0\n[IniGridOy]\nperiodic=no\nsegments=1\n"
            "points_1=33\nscales_1=1.0\nopts_1=uniform\n[IniGridOz]\n"
            "periodic=yes\nsegments=1\npoints_1=9\nscales_1=1.0\n")
    from tlab_tpu_torch.config import Ini
    from tlab_tpu_torch.convert import state_from_numpy, state_to_numpy
    from tlab_tpu_torch.dycore import buffer
    rng = np.random.default_rng(1)
    shape = (1, 32, 33, 8)
    s_pre, s_new = rng.standard_normal(shape), rng.standard_normal(shape)
    sfc = rng.standard_normal((2, 1, 32, 8))
    uvw = [rng.standard_normal(shape[1:]) for _ in range(3)]
    out = {}
    for device in (dev, "cpu"):
        sim = Simulation.from_case(load_case(Ini(text=text)),
                                   dtype=torch.float64, device=device)
        st = state_from_numpy(*uvw, s_pre, device, torch.float64)
        sim.attach_buffer(st)
        t = [torch.from_numpy(a).to(device) for a in (s_pre, s_new, sfc)]
        s1, sfc1 = tdyn.surface_bc_step(sim.P, *t, 1e-3)
        blended = buffer.apply_filter_sponge(*sim.filter_sponge, st)
        out[str(device)] = [s1.cpu().numpy(), sfc1.cpu().numpy(),
                            *state_to_numpy(blended)]
    for a, b in zip(out[str(dev)], out["cpu"]):
        assert np.max(np.abs(a - b)) <= 1e-13 * np.max(np.abs(b))


@pytest.mark.cuda
@pytest.mark.parametrize("n, periodic", [(2304, False), (2304, True),
                                         (4096, True)])
@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-10),
                                        (torch.float32, 1e-5)])
def test_banded_der1_on_the_card_matches_the_dense_product(n, periodic,
                                                           dtype, tol):
    """The long lines' substructured first derivative (ops/thomas.py) on
    the card against the dense D1 product on the same lines: an exact block
    LU of the same operator, so fp64 agrees to round-off and fp32 to its
    own round-off."""
    from tlab_tpu_torch import grid as tgrid
    from tlab_tpu_torch.constants import BC
    from tlab_tpu_torch.fdm.plan import build_deriv_plan
    from tlab_tpu_torch.ops import thomas
    from tlab_tpu_torch.ops.derivative import der1
    dev = _card()
    nodes = np.arange(n) * (2 * np.pi / n) if periodic \
        else np.linspace(0.0, 1.0, n) ** 1.2
    plan = build_deriv_plan(tgrid.make_axis(nodes, periodic))
    nt = np.float64 if dtype == torch.float64 else np.float32
    bp = thomas.device_plan(thomas.banded_plan(plan.A1, plan.B1, nt,
                                               periodic=periodic), dtype, dev)
    d1 = torch.from_numpy(plan.d1[BC.DD]).to(dev, dtype)
    u = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (4, 8, n))).to(dev, dtype)
    got = thomas.banded_der1(bp, u, 2)
    ref = der1(d1, u, 2)
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= tol
