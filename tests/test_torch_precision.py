"""tlab_tpu's switches that change what a run computes, in the port:
TLAB_TPU_MATMUL_PRECISION (the Burgers kernels' arithmetic contract,
ops/derivative.py::op_precision, ops/burgers.py), TLAB_TPU_SING_MODE=legacy
(the singular mode of the factorized Neumann solve) and the two crossovers
of the long lines, TLAB_TPU_THOMAS_MIN_N and TLAB_TPU_PARTITION_MIN_N.

The contracts' arithmetic (the bf16 split, 3 passes or 1) is held against
tlab_tpu's Pallas kernel in interpret mode and against a NumPy product of
bf16-rounded operands; the kernels themselves run only on the card
(chip_smoke.py phase 19).  Inputs are made with numpy from a seed; float64
unless stated."""
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from test_golden import INI
from tlab_tpu.config import Ini as JIni, load_case as jload_case
from tlab_tpu.dycore import incompressible as jdyn
from tlab_tpu.fdm.plan import build_fdm_plan
from tlab_tpu.grid import uniform_grid
from tlab_tpu.ops import elliptic_factorize as jfac
from tlab_tpu.ops import pallas_burgers as pb
from tlab_tpu.physics.params import NSParams
from tlab_tpu.runtime import Simulation as JSimulation
from tlab_tpu_torch import entry
from tlab_tpu_torch import grid as tgrid
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.convert import state_from_numpy
from tlab_tpu_torch.dycore import incompressible as tdyn
from tlab_tpu_torch.fdm.plan import build_fdm_plan as tbuild_fdm_plan
from tlab_tpu_torch.ops import burgers
from tlab_tpu_torch.ops import derivative as tder
from tlab_tpu_torch.ops import elliptic_factorize as tfac
from tlab_tpu_torch.physics.params import NSParams as TNSParams
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.utils import nantrap

F64 = torch.float64
# the test workers share the machine's cores
torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _operands(F, shape, axis, seed):
    rng = np.random.default_rng(seed)
    n = shape[axis]
    return (rng.standard_normal((2 * n, n)).astype(np.float32),
            rng.standard_normal((F,) + shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            rng.uniform(0.1, 1.0, F).astype(np.float32))


def _fp64(ops, axis):
    return burgers.fused_burgers_plain(
        *(torch.from_numpy(a).double() for a in ops), axis).numpy()


# ---------------------------------------------------------------------------
# TLAB_TPU_MATMUL_PRECISION: the contracts' arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("F", [4, 5])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_high_split_matches_pallas_kernel_at_high(F, axis):
    """"high": the bf16 3-split plain version against tlab_tpu's kernel at
    prec_name="high" in interpret mode, both the same split with fp32 sums
    in other orders: within 1e-6 of max|fp64| (2.6e-7 measured), and both
    within 2e-5 of fp64 (the split's ~16 bits: ~5e-6 measured)."""
    ops = _operands(F, (16, 16, 128), axis, seed=20 + F + 10 * axis)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pb.fused_burgers(*map(jnp.asarray, ops), axis,
                                          "high"))
    got = burgers.fused_burgers_split_plain(
        *map(torch.from_numpy, ops), axis, 3, "bf16").numpy()
    ref64 = _fp64(ops, axis)
    scale = np.max(np.abs(ref64))
    assert got.dtype == np.float32
    assert np.max(np.abs(got - ref)) <= 1e-6 * scale
    assert np.max(np.abs(got - ref64)) <= 2e-5 * scale
    assert np.max(np.abs(ref - ref64)) <= 2e-5 * scale


def _bf16(a):
    """float32 `a` rounded to bf16 by JAX, back in float64."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                      .astype(jnp.float32)).astype(np.float64)


@pytest.mark.parametrize("F", [4, 5])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_default_single_pass_matches_a_bf16_product(F, axis):
    """"default": the one-pass plain version against a NumPy product of the
    operands rounded to bf16 by JAX (tlab_tpu's interpret mode cannot
    witness it: the CPU ignores a product's precision), within 1e-6 of
    max; and more than 1e-4 from fp64 (~2.5e-3), the witness that it is
    one pass of 8-bit operands."""
    ops = _operands(F, (16, 16, 128), axis, seed=40 + F + 10 * axis)
    d12, x, conv, nu = ops
    witness = burgers.fused_burgers_plain(
        torch.from_numpy(_bf16(d12)), torch.from_numpy(_bf16(x)),
        torch.from_numpy(conv.astype(np.float64)),
        torch.from_numpy(nu.astype(np.float64)), axis).numpy()
    got = burgers.fused_burgers_split_plain(
        *map(torch.from_numpy, ops), axis, 1, "bf16").numpy()
    ref64 = _fp64(ops, axis)
    scale = np.max(np.abs(ref64))
    assert np.max(np.abs(got - witness)) <= 1e-6 * np.max(np.abs(witness))
    assert np.max(np.abs(got - ref64)) > 1e-4 * scale


def test_bf16_round_is_nearest_even_on_8_bits():
    """The cases of test_tf32_round_is_nearest_even_on_10_bits at bf16's
    spacing (2^-7 at 1): ties go to the even neighbour, the rest to the
    nearest; then JAX's and torch's own bf16 casts on random numbers."""
    v = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8,
                      -1.0 - 2.0 ** -8, 1.0 + 2.0 ** -7 + 2.0 ** -9,
                      0.0, 3.0e38], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -6, -1.0, 1.0 + 2.0 ** -7,
                         0.0, 3.0e38], dtype=torch.float32)
    got = burgers.bf16_round(v)
    assert torch.equal(got[:5], want[:5])
    assert abs(float(got[5]) / 3.0e38 - 1.0) <= 2.0 ** -8
    assert int((got.view(torch.int32) & 0xFFFF).abs().max()) == 0
    r = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    got = burgers.bf16_round(torch.from_numpy(r))
    assert torch.equal(got, torch.from_numpy(r).to(torch.bfloat16).float())
    assert np.array_equal(got.numpy().astype(np.float64), _bf16(r))
    hi, lo = burgers.bf16_split(torch.from_numpy(r))
    assert torch.equal(hi, got)
    assert float(lo.abs().max()) <= 2.0 ** -8 * float(hi.abs().max())


@pytest.mark.parametrize("value, want", [
    (None, "highest"), ("highest", "highest"), ("high", "high"),
    ("default", "default"), ("HIGH", "high"),
])
def test_op_precision_reads_the_variable_at_each_call(monkeypatch, value,
                                                      want):
    """float32: the variable's value, lower-cased as tlab_tpu reads it;
    unset is the port's "highest" (tlab_tpu's "high", ROADMAP C); any
    other dtype None."""
    if value is None:
        monkeypatch.delenv("TLAB_TPU_MATMUL_PRECISION", raising=False)
    else:
        monkeypatch.setenv("TLAB_TPU_MATMUL_PRECISION", value)
    assert tder.op_precision(torch.float32) == want
    assert tder.op_precision(torch.float64) is None
    monkeypatch.setenv("TLAB_TPU_MATMUL_PRECISION", "default")
    assert tder.op_precision(torch.float32) == "default"


def test_op_precision_refuses_an_unknown_value(monkeypatch):
    monkeypatch.setenv("TLAB_TPU_MATMUL_PRECISION", "hihg")
    with pytest.raises(ValueError, match="default.*high.*highest"):
        tder.op_precision(torch.float32)
    assert tder.op_precision(torch.float64) is None


def _burgers_plans(dtype):
    grid = uniform_grid(32, 33, 16, 2.0 * np.pi, 1.0, np.pi)
    return jdyn.build_device_plans(
        build_fdm_plan(grid), NSParams(reynolds=300.0, schmidt=(1.0,)),
        jdyn.WallBCs.from_velocity_kind("freeslip", "freeslip"),
        dtype=dtype, with_elliptic=False), grid


@pytest.mark.parametrize("setting", [None, "default", "high", "highest"])
@pytest.mark.parametrize("dtype, tol", [(np.float64, 1e-12),
                                        (np.float32, 1e-5)])
def test_burgers_all_under_each_setting_matches_jax(monkeypatch, setting,
                                                    dtype, tol):
    """The dycore's Burgers term of the stack along each direction equals
    tlab_tpu's under the same setting: on the CPU both packages compute it
    in full precision whatever the setting says."""
    if setting is None:
        monkeypatch.delenv("TLAB_TPU_MATMUL_PRECISION", raising=False)
    else:
        monkeypatch.setenv("TLAB_TPU_MATMUL_PRECISION", setting)
    PJ, grid = _burgers_plans(jnp.float32 if dtype == np.float32
                              else jnp.float64)
    rng = np.random.default_rng(17)
    fields = rng.standard_normal((4,) + grid.shape).astype(dtype)
    nu = np.array([0.01, 0.01, 0.01, 0.02], dtype)[:, None, None, None]
    for axis, name in enumerate("xyz"):
        ref = np.asarray(jdyn._burgers_all(
            PJ, name, axis, jnp.asarray(fields), jnp.asarray(fields[axis]),
            jnp.asarray(nu)))
        PT = {f"d12{name}": torch.from_numpy(np.asarray(PJ[f"d12{name}"]))}
        got = tdyn._burgers_all(PT, name, axis, torch.from_numpy(fields),
                                torch.from_numpy(fields[axis]),
                                torch.from_numpy(nu))
        assert got.dtype == torch.from_numpy(fields).dtype
        assert _rel(got.numpy(), ref) <= tol


@pytest.mark.parametrize("setting, want", [
    (None, "highest"), ("high", "high"), ("default", "default"),
    ("highest", "highest"),
])
def test_kernel_call_takes_the_setting(monkeypatch, setting, want):
    """Where the kernel's gate holds (a float32 CUDA stack, which the CPU
    has not: the gate is forced here), _burgers_all hands the setting's
    contract to fused_burgers; unset, today's 3xTF32 one."""
    if setting is None:
        monkeypatch.delenv("TLAB_TPU_MATMUL_PRECISION", raising=False)
    else:
        monkeypatch.setenv("TLAB_TPU_MATMUL_PRECISION", setting)
    seen = []

    def record(d12, x, conv, nu, axis, prec_name="highest"):
        seen.append((axis, prec_name))
        return burgers.fused_burgers_plain(d12, x, conv, nu, axis)

    monkeypatch.setattr(tdyn, "_fused_burgers_ok", lambda *a: True)
    monkeypatch.setattr(burgers, "fused_burgers", record)
    d12, x, conv, nu = map(torch.from_numpy,
                           _operands(4, (8, 12, 16), 1, seed=5))
    tdyn._burgers_all({"d12y": d12}, "y", 1, x, conv,
                      nu[:, None, None, None])
    assert seen == [(1, want)]


@pytest.mark.parametrize("prec_name", ["default", "high", "highest"])
def test_trap_names_the_contracts_entry_point(prec_name):
    """Under the NaN trap a NaN out of fused_burgers is named after the
    contract's entry point (burgers_y_high, ...), on the CPU's plain
    version too."""
    rng = np.random.default_rng(6)
    d12 = torch.from_numpy(rng.standard_normal((24, 12)).astype(np.float32))
    x = torch.from_numpy((3e38 * rng.uniform(-1, 1, (2, 8, 12, 6)))
                         .astype(np.float32))
    conv = torch.from_numpy(rng.uniform(0.5, 1.0, (8, 12, 6))
                            .astype(np.float32))
    nu = torch.tensor([1e-3, 2e-3], dtype=torch.float32)
    assert torch.isnan(burgers.fused_burgers(d12, x, conv, nu, 1,
                                             prec_name)).any()
    name = burgers.entry_points(prec_name)[1]
    assert name == "burgers_y" + ("" if prec_name == "highest"
                                  else "_" + prec_name)
    with nantrap.trap():
        with pytest.raises(FloatingPointError,
                           match=re.escape(name) + "$"):
            burgers.fused_burgers(d12, x, conv, nu, 1, prec_name)


# ---------------------------------------------------------------------------
# TLAB_TPU_SING_MODE=legacy
# ---------------------------------------------------------------------------

def _factorize_pair(monkeypatch, mode, nx=16, ny=33, nz=8):
    """poisson_factorize of both packages under `mode` (None: unset), on a
    seeded forcing plus 3 cos(pi y), fresh calls (nothing of tlab_tpu's is
    traced under another mode)."""
    if mode is None:
        monkeypatch.delenv("TLAB_TPU_SING_MODE", raising=False)
    else:
        monkeypatch.setenv("TLAB_TPU_SING_MODE", mode)
    grid = uniform_grid(nx, ny, nz, 2.0, 1.0, 1.5)
    dev_j = jfac.device_factorize_plan(
        jfac.build_factorize_plan(build_fdm_plan(grid)), jnp.float64)
    dev_t = tfac.device_factorize_plan(
        tfac.build_factorize_plan(tbuild_fdm_plan(
            tgrid.uniform_grid(nx, ny, nz, 2.0, 1.0, 1.5))), F64, "cpu")
    y = np.asarray(grid.y.nodes)
    f = np.random.default_rng(11).standard_normal((nx, ny, nz)) \
        + 3.0 * np.cos(np.pi * y)[None, :, None]
    got = tfac.poisson_factorize(dev_t, torch.from_numpy(f))
    ref = jfac.poisson_factorize(dev_j, jnp.asarray(f))
    return [a.numpy() for a in got], [np.asarray(a) for a in ref]


def test_legacy_sing_mode_factorize_matches_jax(monkeypatch):
    """poisson_factorize's p and dp/dy under legacy equal tlab_tpu's to
    1e-10 of each one's max, and differ from the reference mode's by more
    than 1e-3 of it (0.674 of max|p| 0.852, 0.114 of max|dp/dy| 1.146
    measured): the switch changes the numbers."""
    got, ref = _factorize_pair(monkeypatch, "legacy")
    for a, b in zip(got, ref):
        assert _rel(a, b) <= 1e-10
    base, base_ref = _factorize_pair(monkeypatch, None)
    for a, b in zip(base, base_ref):
        assert _rel(a, b) <= 1e-10
    for a, b in zip(got, base):
        assert np.max(np.abs(a - b)) > 1e-3 * np.max(np.abs(b))


def test_legacy_sing_mode_rk_step_matches_jax(monkeypatch):
    """One RK4 step of the shear layer (32x33x16, free-slip walls: the
    projection's NN singular mode) under legacy, port against tlab_tpu,
    each field to 1e-10 of its max."""
    monkeypatch.setenv("TLAB_TPU_SING_MODE", "legacy")
    grid = uniform_grid(32, 33, 16, 2.0 * np.pi, 1.0, np.pi)
    fdm = build_fdm_plan(grid)
    sbc = (("neumann", "neumann"),)
    PJ = jdyn.build_device_plans(
        fdm, NSParams(reynolds=500.0, schmidt=(1.0,)),
        jdyn.WallBCs.from_velocity_kind("freeslip", "freeslip",
                                        scalar_bcs=sbc), dtype=jnp.float64)
    PJ["ell_fac"] = jfac.device_factorize_plan(jfac.build_factorize_plan(fdm),
                                               jnp.float64)
    PT = tdyn.build_device_plans(
        tbuild_fdm_plan(tgrid.uniform_grid(32, 33, 16, 2.0 * np.pi, 1.0,
                                           np.pi)),
        TNSParams(reynolds=500.0, schmidt=(1.0,)),
        tdyn.WallBCs.from_velocity_kind("freeslip", "freeslip",
                                        scalar_bcs=sbc),
        dtype=F64, device="cpu")
    assert "ell_fac" in PT
    u, v, w, s = entry.initial_fields(grid, seed=3)
    rng = np.random.default_rng(4)
    u, v, w = (a + 0.1 * rng.standard_normal(a.shape) for a in (u, v, w))
    s = np.array(s)
    sj, pj = jdyn.rk_step(PJ, jdyn.State(u=jnp.asarray(u), v=jnp.asarray(v),
                                         w=jnp.asarray(w), s=jnp.asarray(s)),
                          1e-3)
    st, pt = tdyn.rk_step(PT, state_from_numpy(u, v, w, s, "cpu", F64), 1e-3)
    for a, b in zip(st[:4], sj[:4]):
        assert _rel(a, b) <= 1e-10
    assert _rel(pt, pj) <= 1e-10


# ---------------------------------------------------------------------------
# TLAB_TPU_THOMAS_MIN_N, TLAB_TPU_PARTITION_MIN_N
# ---------------------------------------------------------------------------

# the golden case in 2-D: x periodic of 96 points, y between walls of 80
LONG_TEXT = INI.replace("points_1=33\nscales_1=4.0",
                        "points_1=97\nscales_1=4.0").replace(
    "points_1=33\nscales_1=2.0", "points_1=80\nscales_1=2.0").replace(
    "points_1=16\nscales_1=2.0", "points_1=1\nscales_1=2.0")


@pytest.mark.parametrize("thomas, partition, keys", [
    (64, 90, {"d1x_banded", "d2x_banded", "d1y_banded"}),
    (90, 64, {"d1x_banded", "d2x_banded"}),
    (64, 100, {"d1y_banded"}),
    (None, None, set()),
])
def test_crossovers_select_jax_keys(monkeypatch, thomas, partition, keys):
    """Each variable sets its own kind of line: TLAB_TPU_THOMAS_MIN_N the
    line between walls (y, 80 points), TLAB_TPU_PARTITION_MIN_N the
    periodic one (x, 96); both packages' Simulation.from_case and the
    port's entry.build take the same banded keys (none when unset)."""
    for var, value in (("TLAB_TPU_THOMAS_MIN_N", thomas),
                       ("TLAB_TPU_PARTITION_MIN_N", partition)):
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, str(value))
    tsim = Simulation.from_case(load_case(Ini(text=LONG_TEXT)), dtype=F64,
                                device="cpu")
    jsim = JSimulation.from_case(jload_case(JIni(text=LONG_TEXT)))
    assert tsim.grid.shape == (96, 80, 1)
    banded = {k for k in tsim.P if k.endswith("_banded")}
    assert banded == keys == {k for k in jsim.P if k.endswith("_banded")}
    _, P, _ = entry.build(96, 80, 8, F64, "cpu")
    assert {k for k in P if k.endswith("_banded")} == keys


def test_threshold_keyword_overrides_the_variables(monkeypatch):
    """from_case(banded_min_n=...) keeps its meaning where the variables
    are set: one crossover for both kinds of line."""
    monkeypatch.setenv("TLAB_TPU_THOMAS_MIN_N", "64")
    monkeypatch.setenv("TLAB_TPU_PARTITION_MIN_N", "64")
    tsim = Simulation.from_case(load_case(Ini(text=LONG_TEXT)), dtype=F64,
                                device="cpu", banded_min_n=90)
    assert {k for k in tsim.P if k.endswith("_banded")} == \
        {"d1x_banded", "d2x_banded"}
    assert tdyn.banded_crossovers(90) == {"banded_min_n": 90,
                                          "periodic_min_n": 90}
    assert tdyn.banded_crossovers() == {"banded_min_n": 64,
                                        "periodic_min_n": 64}
