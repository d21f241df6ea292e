"""The hand-written CUDA kernels K1-K3 on the card.

These tests need a CUDA card and skip without one.  This file imports no
JAX, so it also runs on a machine with the card and no JAX, where
tests/conftest.py (which imports JAX) must be left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import functools
import os

import numpy as np
import pytest
import torch

from tlab_tpu_torch import entry
from tlab_tpu_torch.config import load_case
from tlab_tpu_torch.dycore import incompressible as tdyn
from tlab_tpu_torch.ops import burgers
from tlab_tpu_torch.ops.derivative import der1, der12
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
    before = burgers.contract_launches["highest"][axis]
    got = burgers.fused_burgers(d12, x, conv, nu, axis)
    ref = burgers.fused_burgers_plain(d12, x, conv, nu, axis)
    torch.cuda.synchronize()
    assert burgers.contract_launches["highest"][axis] == before + 1
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.cuda
def test_gate_launches_for_float32_only():
    """A CUDA float32 stack goes through the kernel; float64 takes the
    dense path (tlab_tpu's own general path) and launches nothing."""
    dev = _card()
    for dtype, launched in ((torch.float32, 1), (torch.float64, 0)):
        d12, x, conv, nu = _operands(4, (16, 12, 8), 0, dev, dtype)
        before = burgers.contract_launches["highest"][0]
        tdyn._burgers_all({"d12x": d12}, "x", 0, x, conv,
                          nu[:, None, None, None])
        assert burgers.contract_launches["highest"][0] == before + launched


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
        before = list(burgers.contract_launches["highest"])
        state, _ = tdyn.rk_step(P, state, 1e-3)
        torch.cuda.synchronize()
        out[dtype] = (state, [b - a for a, b in zip(
            before, burgers.contract_launches["highest"])])
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
        before = list(burgers.contract_launches["highest"])
        runs[dtype] = tdns.run(sim, state, outdir=str(out), n_steps=10,
                               log_path=str(out / "dns.out"))
        launched = [b - a for a, b in zip(
            before, burgers.contract_launches["highest"])]
        assert launched == ([50] * 3 if dtype == torch.float32 else [0] * 3)
    r32, r64 = runs[torch.float32], runs[torch.float64]
    assert abs(r32.rtime - r64.rtime) <= 3e-4 * r64.rtime
    for a, b in zip(r32.state[:4], r64.state[:4]):
        assert (a.double() - b).abs().max() <= 3e-4 * b.abs().max()
    assert sorted(os.listdir(tmp_path / str(torch.float32))) == [
        "avg10", "avg10s1", "avg5", "avg5s1", "dns.out", "flow.10.1",
        "flow.10.2", "flow.10.3", "scal.10.1", "tlab.log"]


@pytest.mark.cuda
@pytest.mark.parametrize("ibc", ["nn", "dd"])
def test_poisson_solve_on_the_card_does_not_synchronise(ibc):
    """poisson_factorize of a 64x32x64 float32 plan (four singular modes)
    under CUDA's sync debug mode "error": no call of the solve waits for the
    card (a host write of a scalar into a device tensor would raise); p and
    dp/dy equal the CPU's float64 solve within the 3e-4 of max that the
    float32 step is held to above."""
    from tlab_tpu_torch import grid as tgrid
    from tlab_tpu_torch.fdm.plan import build_fdm_plan
    from tlab_tpu_torch.ops import elliptic_factorize as fac
    dev = _card()
    plan = fac.build_factorize_plan(build_fdm_plan(
        tgrid.uniform_grid(64, 32, 64, 2.0, 1.0, 1.5)))
    assert len(plan.sing_idx) == 4
    rng = np.random.default_rng(21)
    data = (rng.standard_normal((64, 32, 64)),
            rng.standard_normal((64, 64)), rng.standard_normal((64, 64)))
    ref = fac.poisson_factorize(
        fac.device_factorize_plan(plan, torch.float64, "cpu"),
        *(torch.from_numpy(a) for a in data), ibc=ibc)
    plan32 = fac.device_factorize_plan(plan, torch.float32, dev)
    args = [torch.from_numpy(a).to(dev, torch.float32) for a in data]
    fac.poisson_factorize(plan32, *args, ibc=ibc)   # cuFFT plans, handles
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fac.poisson_factorize(plan32, *args, ibc=ibc)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for a, b in zip(got, ref):
        assert (a.double().cpu() - b).abs().max() <= 3e-4 * b.abs().max()


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


# shapes that leave the bf16 column kernel's clusters partly empty: K1 with
# n = 300 (3 operator row tiles, paired), K2 with three 128-line tiles a
# slab (nz = 300), F = 1, a short last K tile (n = 513, one row), and an
# unaligned ncol (23: the cp.async path) beside an aligned one (24)
BF16_EDGE_SHAPES = [(2, (300, 20, 36)), (2, (6, 40, 300)), (1, (300, 24, 40)),
                    (3, (513, 8, 12)), (1, (40, 300, 23)), (1, (40, 300, 24))]


@pytest.mark.cuda
@pytest.mark.parametrize("prec_name", ["high", "default"])
@pytest.mark.parametrize("F, shape", SHAPES + BF16_EDGE_SHAPES)
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_bf16_kernel_matches_its_split(prec_name, F, shape, axis):
    """The bf16 variants ("high": 3-pass split, "default": one pass)
    against the plain version of the same split: sums of the same exact
    products in another order, within 1e-5 of the largest result; each
    launch counted under its contract alone."""
    d12, x, conv, nu = _operands(F, shape, axis, _card())
    unit, passes = burgers.CONTRACTS[prec_name]
    before = {k: list(v) for k, v in burgers.contract_launches.items()}
    got = burgers.fused_burgers(d12, x, conv, nu, axis, prec_name)
    ref = burgers.fused_burgers_split_plain(d12, x, conv, nu, axis, passes,
                                            unit)
    torch.cuda.synchronize()
    before[prec_name][axis] += 1
    assert burgers.contract_launches == before
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("prec_name", ["high", "default"])
@pytest.mark.parametrize("axis", [0, 1])
def test_bf16_column_kernel_on_a_misaligned_field(prec_name, axis):
    """x 4 bytes off a 16-byte boundary: the column kernel copies the field
    by cp.async (no tensor map) and stores from the epilogue tile by rows,
    within 1e-5 of the split's plain version."""
    d12, x, conv, nu = _operands(3, (64, 64, 64), axis, _card())
    xm = torch.empty(x.numel() + 1, device=x.device)[1:].view(x.shape)
    xm.copy_(x)
    unit, passes = burgers.CONTRACTS[prec_name]
    got = burgers.fused_burgers(d12, xm, conv, nu, axis, prec_name)
    ref = burgers.fused_burgers_split_plain(d12, x, conv, nu, axis, passes,
                                            unit)
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.cuda
def test_column_schedule_matches_the_library():
    """The bf16 column kernel's cluster extents and tile count as the
    library computes them (burgers_col_schedule) against
    ops/burgers.py::column_schedule, which the CPU tests hold."""
    import ctypes
    from tlab_tpu_torch.ops import _build
    _card()
    fn = _build.library("burgers").burgers_col_schedule
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    for n, ncol, G, F in ((512, 65536, 1, 4), (256, 256, 512, 4),
                          (300, 720, 1, 2), (40, 300, 6, 2), (513, 96, 1, 3),
                          (7, 30, 1, 3), (2303, 128, 2, 5)):
        for bulk in (True, False):
            out = (ctypes.c_int * 3)()
            fn(n, ncol, G, F, int(bulk), out)
            s = burgers.column_schedule(n, ncol, G, F, bulk)
            assert list(out) == [s["cc"], s["ca"], s["tiles"]]


@pytest.mark.cuda
@pytest.mark.parametrize("setting", [None, "high", "default", "highest"])
def test_setting_picks_the_contract(monkeypatch, setting):
    """_burgers_all on a CUDA float32 stack launches the entry point of
    TLAB_TPU_MATMUL_PRECISION's contract; unset, the 3xTF32 one."""
    if setting is None:
        monkeypatch.delenv("TLAB_TPU_MATMUL_PRECISION", raising=False)
    else:
        monkeypatch.setenv("TLAB_TPU_MATMUL_PRECISION", setting)
    d12, x, conv, nu = _operands(4, (16, 12, 8), 1, _card())
    burgers.reset_launches()
    tdyn._burgers_all({"d12y": d12}, "y", 1, x, conv,
                      nu[:, None, None, None])
    want = setting or "highest"
    assert burgers.contract_launches == {
        k: [0, 1, 0] if k == want else [0, 0, 0]
        for k in burgers.CONTRACTS}


@functools.lru_cache(maxsize=None)
def _case02_operators(shape):
    """The [D1; D2] operators of case02's box at `shape` (x periodic over
    2, y between walls over 1, z periodic over 1), float32 on the card."""
    from tlab_tpu_torch import grid as tgrid
    from tlab_tpu_torch.constants import BC
    from tlab_tpu_torch.fdm.plan import build_fdm_plan
    fdm = build_fdm_plan(tgrid.uniform_grid(*shape, 2.0, 1.0, 1.0))
    return tuple(torch.from_numpy(p.d12[BC.DD]).to(_card(), torch.float32)
                 for p in (fdm.x, fdm.y, fdm.z))


# case02's grid with one field and with four, and ragged shapes: F = 3 with
# nz spanning two operator tiles and ending in a ragged K tile, 96-point
# lines (a d1 pair whose second row tile lies beyond n), odd widths (the
# scalar loads and stores), a box smaller than one tile (6 points: the
# fewest that the wall rows' stencils take)
DERIV_CASES = [(1, (512, 256, 256)), (4, (512, 256, 256)),
               (3, (6, 10, 200)), (3, (96, 96, 96)), (5, (23, 19, 37)),
               (3, (7, 6, 6))]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", burgers.DERIV_KINDS)
@pytest.mark.parametrize("F, shape", DERIV_CASES)
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_derivative_kernel_matches_plain_version(kind, F, shape, axis):
    """deriv1 and deriv12 with case02's operators against the full-fp32
    product (der1, der12): sums of <= 512 products in another order, from
    the 3xTF32 split (~22 bits an operand), within 1e-6 of the largest
    result; the outputs contiguous and separate, one launch counted."""
    d12 = _case02_operators(shape)[axis]
    n = shape[axis]
    x = torch.from_numpy(np.random.default_rng(F + axis).standard_normal(
        (F,) + shape)).to(_card(), torch.float32)
    before = burgers.deriv_launches[kind][axis]
    got = getattr(burgers, kind)(d12, x, axis + 1)
    if kind == "deriv1":
        got, ref = (got,), (der1(d12[:n], x, axis + 1),)
    else:
        ref = der12(d12, x, axis + 1)
    torch.cuda.synchronize()
    assert burgers.deriv_launches[kind][axis] == before + 1
    assert all(g.is_contiguous() and g.shape == x.shape for g in got)
    assert len({g.data_ptr() for g in got}) == len(got)
    for g, r in zip(got, ref):
        assert (g - r).abs().max() <= 1e-6 * r.abs().max()


@pytest.mark.cuda
def test_derivative_kernel_takes_a_field_and_raises_on_what_it_does_not():
    """A 3-D field is a stack of one; a strided or float64 CUDA input
    raises (the gate keeps float64 off the kernel)."""
    d12 = _case02_operators((96, 96, 96))[1]
    x = torch.randn(96, 96, 96, device=_card())
    got = burgers.deriv1(d12, x, 1)
    torch.cuda.synchronize()
    ref = der1(d12[:96], x, 1)
    assert (got - ref).abs().max() <= 1e-6 * ref.abs().max()
    with pytest.raises(ValueError):
        burgers.deriv12(d12, x.transpose(0, 2), 1)
    with pytest.raises(TypeError):
        burgers.deriv1(d12, x.double(), 1)


def _compressible_case(dtype, shape=(64, 32, 32), ns=1, seed=2):
    """(P, U) of a random primitive state on a box (x, z periodic, y
    between free-slip walls, ns scalars) on the card, in `dtype`."""
    from tlab_tpu_torch import grid as tgrid
    from tlab_tpu_torch.dycore import compressible as tcomp
    from tlab_tpu_torch.fdm.plan import build_fdm_plan
    from tlab_tpu_torch.physics.params import NSParams
    dev = _card()
    P = tdyn.build_device_plans(
        build_fdm_plan(tgrid.uniform_grid(*shape, 2.0, 1.0, 1.0)),
        NSParams(reynolds=1000.0, schmidt=((1.0, 0.7) + (1.0,) * ns)[:ns]),
        tdyn.WallBCs.from_velocity_kind(
            "freeslip", "freeslip",
            scalar_bcs=(("neumann", "neumann"),) * ns),
        dtype=dtype, device=dev, with_elliptic=False)
    rng = np.random.default_rng(seed)
    prim = [1.0 + 0.05 * rng.standard_normal(shape)] \
        + [0.1 * rng.standard_normal(shape) for _ in range(3)] \
        + [1.0 + 0.05 * rng.standard_normal(shape)]
    s = rng.random((ns,) + shape)
    U = tcomp.from_primitive(
        *(torch.from_numpy(a).to(dev, dtype) for a in prim), 1.4, 0.3,
        s=torch.from_numpy(s).to(dev, dtype) if ns else None,
        energy="internal")
    return P, U


def _compressible_rhs(dtype, seed=2, shape=(64, 32, 32), ns=1):
    """rhs_compressible_internal of _compressible_case's state (64x32x32,
    one scalar unless said)."""
    from tlab_tpu_torch.dycore import compressible as tcomp
    P, U = _compressible_case(dtype, shape, ns, seed)
    return tcomp.rhs_compressible_internal(P, U, 1.4, 0.3, 1e-3, 0.7)


@pytest.mark.cuda
def test_compressible_rhs_float32_on_the_kernels_follows_float64(
        monkeypatch):
    """One internal-energy RHS in float32: its 24 d1 and 6 [D1;D2]
    products through the kernels, and each tendency no further from the
    float64 RHS than twice the float32 RHS on cuBLAS's products (the gate
    turned off here, in the test alone)."""
    from tlab_tpu_torch.dycore import compressible as tcomp
    ref = _compressible_rhs(torch.float64)
    burgers.reset_deriv_launches()
    got = _compressible_rhs(torch.float32)
    assert {k: sum(v) for k, v in burgers.deriv_launches.items()} == {
        "deriv1": 24, "deriv12": 6}
    monkeypatch.setattr(tcomp, "_tensor_cores", lambda *a: False)
    cublas = _compressible_rhs(torch.float32)
    assert sum(map(sum, burgers.deriv_launches.values())) == 30
    for name, a, b, r in zip(tcomp.CompState._fields, got, cublas, ref):
        scale = r.abs().max()
        gap = (a.double() - r).abs().max() / scale
        gap_cublas = (b.double() - r).abs().max() / scale
        assert gap <= 2 * gap_cublas, (name, gap.item(), gap_cublas.item())


@pytest.mark.cuda
def test_derivative_kernels_do_not_synchronise():
    """deriv1 and deriv12 along each axis under CUDA's sync debug mode
    "error", after a first call that packs the operators."""
    ops = _case02_operators((96, 96, 96))
    x = torch.randn(2, 96, 96, 96, device=_card())
    calls = [(fn, ops[axis], axis + 1) for axis in range(3)
             for fn in (burgers.deriv1, burgers.deriv12)]
    for fn, d12, axis in calls:
        fn(d12, x, axis)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn, d12, axis in calls:
            fn(d12, x, axis)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


# the fused compressible algebra (ops/comp_rhs.py): a point count that is
# not a multiple of 4 (one point a thread) and one that is (16-byte
# accesses)
COMP_SHAPES = [(31, 17, 13), (64, 32, 32)]


def _comp_operands(shape, ns, axis, seed=3):
    """A random float32 state, one direction's random derivatives, random
    tendencies and the other directions' gradients, on the card."""
    from tlab_tpu_torch.dycore import compressible as tcomp
    from tlab_tpu_torch.ops import comp_rhs
    rng = np.random.default_rng(seed + ns + axis)

    def f(*lead, lo=None):
        a = rng.standard_normal(lead + shape)
        if lo is not None:
            a = lo + 0.1 * np.abs(a)
        return torch.from_numpy(a).to(_card(), torch.float32)
    U = tcomp.CompState(f(lo=0.8), f(), f(), f(), f(lo=2.0),
                        f(ns) if ns else None)
    der = comp_rhs.Derivs(f(), (f(), f(), f(), f()) + ((f(ns),) if ns
                                                        else ()),
                          f(4), f(4), f(ns) if ns else None,
                          f(ns) if ns else None, f() if ns else None)
    grads = {d: f(3) for d in range(3) if d != axis}
    return U, der, f(5 + ns), grads, [f(), None, f()]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", COMP_SHAPES)
@pytest.mark.parametrize("ns", [0, 2])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_comp_rhs_kernels_match_their_plain_versions(shape, ns, axis):
    """comp_flux_<d>, comp_assemble_<d> (first, middle and last direction,
    and one direction alone) and comp_final against their plain versions
    in float32 on the card: the same operations, contracted into FMAs and
    summed in another order, within 1e-5 of the largest result."""
    from tlab_tpu_torch.ops import comp_rhs
    U, der, h0, grads, dd = _comp_operands(shape, ns, axis)
    cT, cP, mu, cond = 0.0504, 7.9365, 1e-3, 0.0397
    diff = (1e-3, 1.4e-3)[:ns]

    def close(got, want):
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                assert g.shape == w.shape and g.is_contiguous()
                assert (g - w).abs().max() <= 1e-5 * w.abs().max()
    close(comp_rhs.flux(axis, U, cT, cP, True),
          comp_rhs.flux_plain(axis, U, cT, cP, True))
    close(comp_rhs.flux(axis, U, cT, cP, False)[:1],
          comp_rhs.flux_plain(axis, U, cT, cP, False)[:1])
    for first, last in ((True, False), (False, False), (False, True),
                        (True, True)):
        args = (grads, first, last, mu, cond, cT, cP, diff)
        close(comp_rhs.assemble(axis, der, U, h0.clone(), *args),
              comp_rhs.assemble_plain(axis, der, U, h0.clone(), *args))
    close([comp_rhs.final(h0.clone(), dd, mu)],
          [comp_rhs.final_plain(h0.clone(), dd, mu)])
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", COMP_SHAPES)
@pytest.mark.parametrize("ns", [0, 1, 2])
def test_fused_compressible_rhs_follows_float64(monkeypatch, shape, ns):
    """One internal-energy RHS in float32 through the fused kernels: 7
    launches (dycore.comp_fused.k), the same 24 + 6 derivative products
    (18 + 3 without a scalar), and each tendency no further from the
    float64 RHS than 1.5 times the float32 RHS on the PyTorch algebra (the
    gate turned off here, in the test alone)."""
    from tlab_tpu_torch.dycore import compressible as tcomp
    from tlab_tpu_torch.ops import comp_rhs
    from tlab_tpu_torch.utils import trace
    ref = _compressible_rhs(torch.float64, shape=shape, ns=ns)
    trace.reset()
    got = _compressible_rhs(torch.float32, shape=shape, ns=ns)
    counters = trace.totals()["counters"]
    assert counters["dycore.comp_fused.k"] == 7
    assert comp_rhs.launches == {
        **{f"comp_{k}_{d}": 1 for k in ("flux", "assemble") for d in "xyz"},
        "comp_final": 1}
    assert {k: sum(v) for k, v in burgers.deriv_launches.items()} == (
        {"deriv1": 24, "deriv12": 6} if ns else
        {"deriv1": 18, "deriv12": 3})
    monkeypatch.setattr(tcomp, "_fused", lambda *a: False)
    plain = _compressible_rhs(torch.float32, shape=shape, ns=ns)
    assert trace.totals()["counters"]["dycore.comp_fused.k"] == 7
    for name, a, b, r in zip(tcomp.CompState._fields, got, plain, ref):
        assert (a is None) == (r is None), name
        if r is None:
            continue
        scale = r.abs().max()
        gap = (a.double() - r).abs().max() / scale
        gap_plain = (b.double() - r).abs().max() / scale
        assert gap <= 1.5 * gap_plain, (name, gap.item(), gap_plain.item())


@pytest.mark.cuda
def test_fused_compressible_rhs_does_not_synchronise():
    """A whole fused internal-energy RHS (its 30 products, 7 kernels and
    the scalar's diffusivity as a kernel argument) under CUDA's sync debug
    mode "error", after a warm call that packs the operators."""
    from tlab_tpu_torch.dycore import compressible as tcomp
    P, U = _compressible_case(torch.float32, ns=2)
    tcomp.rhs_compressible_internal(P, U, 1.4, 0.3, 1e-3, 0.7)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tcomp.rhs_compressible_internal(P, U, 1.4, 0.3, 1e-3, 0.7)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_fused_compressible_rhs_raises_beyond_the_kernels_scalars():
    """Past comp_rhs.MAX_SCALARS scalars the gate still holds and the
    fused RHS raises before any launch: no fallback to the PyTorch
    algebra."""
    from tlab_tpu_torch.dycore import compressible as tcomp
    from tlab_tpu_torch.ops import comp_rhs
    from tlab_tpu_torch.utils import trace
    P, U = _compressible_case(torch.float32, shape=(16, 12, 8),
                              ns=comp_rhs.MAX_SCALARS + 1)
    trace.reset()
    with pytest.raises(ValueError, match="at most"):
        tcomp.rhs_compressible_internal(P, U, 1.4, 0.3, 1e-3, 0.7)
    assert trace.totals()["counters"]["dycore.comp_fused.k"] == 0


@pytest.mark.cuda
def test_comp_rhs_library_takes_the_scalars_the_wrapper_allows():
    from tlab_tpu_torch.ops import _build, comp_rhs
    _card()
    assert _build.library("comp_rhs").comp_rhs_max_scalars() \
        == comp_rhs.MAX_SCALARS
