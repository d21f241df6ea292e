"""The compressible internal-energy right-hand side's fused pointwise
algebra (tlab_tpu_torch/ops/comp_rhs.py, dycore/compressible.py
_rhs_internal_fused) on the CPU: the layout of flux, assemble and final
around the derivative products, in their plain versions, against the
PyTorch algebra of rhs_compressible_internal in float64; the gate that
keeps float64, the CPU, a transport law and the mixtures on that algebra;
the NaN trap's names; the launch counter.  The kernels themselves run in
tests/test_torch_cuda.py."""
import re
import types

import numpy as np
import pytest
import torch

from tlab_tpu_torch import grid as tgrid
from tlab_tpu_torch.dycore import compressible as tcomp
from tlab_tpu_torch.dycore import incompressible as tdyn
from tlab_tpu_torch.fdm.plan import build_fdm_plan
from tlab_tpu_torch.ops import comp_rhs
from tlab_tpu_torch.physics import eos as teos
from tlab_tpu_torch.physics import mixtures as tmx
from tlab_tpu_torch.physics.params import NSParams
from tlab_tpu_torch.utils import nantrap, trace

GAMMA, MACH, VISC, PRANDTL = 1.4, 0.3, 1e-2, 0.7


def _case(shape, ns, periodic_y=False, seed=0, mix=False):
    """(P, U) of a random primitive state on a uniform float64 CPU box:
    x, z periodic, y between free-slip walls or periodic, ns scalars."""
    P = tdyn.build_device_plans(
        build_fdm_plan(tgrid.uniform_grid(*shape, 2.0, 1.0, 1.0)),
        NSParams(reynolds=1 / VISC, schmidt=(1.0, 0.7, 1.3)[:ns]),
        tdyn.WallBCs.from_velocity_kind(
            "freeslip", "freeslip",
            scalar_bcs=(("neumann", "neumann"),) * ns),
        dtype=torch.float64, device="cpu", with_elliptic=False)
    P["y_periodic"] = periodic_y
    rng = np.random.default_rng(seed)
    prim = [1.0 + 0.05 * rng.standard_normal(shape)] \
        + [0.1 * rng.standard_normal(shape) for _ in range(3)] \
        + [1.0 + 0.05 * rng.standard_normal(shape)]
    s = torch.from_numpy(0.1 + 0.3 * rng.random((ns,) + shape)) \
        if ns else None
    U = tcomp.from_primitive(*(torch.from_numpy(a) for a in prim), GAMMA,
                             MACH, s=s, energy="internal")
    return P, U


# 3-D with walls and with a periodic y, no scalar and two; a box with one
# point along z and one with one point along x (the missing direction
# first: the second direction writes the tendencies)
CASES = [((16, 12, 8), 1, False), ((16, 12, 8), 0, True),
         ((15, 11, 9), 2, False), ((10, 12, 1), 2, False),
         ((1, 12, 8), 1, True)]


@pytest.mark.parametrize("shape, ns, periodic_y", CASES)
def test_fused_layout_follows_the_torch_algebra(shape, ns, periodic_y):
    """The fused layout in its plain versions (float64, CPU) against the
    PyTorch algebra of rhs_compressible_internal: the same terms from the
    same products, summed in another order, to float64 round-off."""
    P, U = _case(shape, ns, periodic_y)
    want = tcomp.rhs_compressible_internal(P, U, GAMMA, MACH, VISC, PRANDTL)
    got = tcomp._rhs_internal_fused(P, U, GAMMA, MACH, VISC, PRANDTL)
    for name, g, w in zip(tcomp.CompState._fields, got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            assert g.shape == w.shape, name
            err = float((g - w).abs().max() / w.abs().max())
            assert err <= 1e-13, (name, err)


def _stand_in(dtype=torch.float32, is_cuda=True, ns=1):
    """A state the gate reads: rho's device and type, the scalars' count."""
    rho = types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype)
    rhos = types.SimpleNamespace(shape=(ns,)) if ns else None
    return types.SimpleNamespace(rho=rho, rhos=rhos)


def test_gate_takes_float32_cuda_at_constant_viscosity_alone():
    """The fused kernels take a float32 CUDA state with a constant
    viscosity, no mixture and no ViscousI/J/K rows, whatever its scalars
    (beyond MAX_SCALARS the kernels raise); anything else keeps the
    PyTorch algebra."""
    const = teos.GasParams(transport="none")
    assert tcomp._fused({}, _stand_in(), None, None)
    assert tcomp._fused({}, _stand_in(ns=0), const, None)
    assert tcomp._fused({"visc_bc": {}}, _stand_in(), None, None)
    assert tcomp._fused({}, _stand_in(ns=comp_rhs.MAX_SCALARS), None, None)
    assert not tcomp._fused({}, _stand_in(torch.float64), None, None)
    assert not tcomp._fused({}, _stand_in(is_cuda=False), None, None)
    for law in ("powerlaw", "sutherland"):
        assert not tcomp._fused({}, _stand_in(),
                                teos.GasParams(transport=law), None)
    assert not tcomp._fused({}, _stand_in(), None, object())
    assert not tcomp._fused({"visc_bc": {"x": "outflow"}}, _stand_in(),
                            None, None)
    assert tcomp._fused({}, _stand_in(ns=comp_rhs.MAX_SCALARS + 1),
                        None, None)
    with pytest.raises(ValueError, match="at most"):
        comp_rhs._check_scalars(comp_rhs.MAX_SCALARS + 1)


@pytest.mark.parametrize("which", ["float64", "transport", "mixture"])
def test_cpu_float64_transport_law_and_mixture_take_the_torch_path(
        monkeypatch, which):
    """On the CPU in float64, with a transport law mu(T) and with a
    mixture, rhs_compressible_internal runs the PyTorch algebra: the fused
    layout is never called and dycore.comp_fused.k stays 0."""
    def refuse(*a, **k):
        raise AssertionError("the fused layout ran")
    monkeypatch.setattr(tcomp, "_rhs_internal_fused", refuse)
    gas = mix = None
    ns = 1
    if which == "transport":
        gas = teos.GasParams(gamma=GAMMA, mach=MACH, transport="sutherland")
    elif which == "mixture":
        mix = tmx.build_mixture("unidecomp")
        ns = mix.nsp - 1
    P, U = _case((12, 10, 6), ns)
    trace.reset()
    h = tcomp.rhs_compressible_internal(P, U, GAMMA, MACH, VISC, PRANDTL,
                                        gas=gas, mix=mix)
    assert all(torch.isfinite(x).all() for x in h if x is not None)
    assert trace.totals()["counters"]["dycore.comp_fused.k"] == 0


def _derivs(shape, ns, seed=1):
    rng = np.random.default_rng(seed)

    def f(*lead):
        return torch.from_numpy(rng.standard_normal(lead + shape))
    return comp_rhs.Derivs(f(), (f(), f(), f(), f()) + ((f(ns),) if ns
                                                          else ()),
                           f(4), f(4), f(ns) if ns else None,
                           f(ns) if ns else None, f() if ns else None)


@pytest.mark.parametrize("entry", ["comp_flux_y", "comp_assemble_z",
                                   "comp_final"])
def test_the_nan_trap_names_the_entry_point(entry):
    """Each call is one op to the per-op check (the plain versions on the
    CPU, the kernels on the card): a NaN it makes names its entry point."""
    P, U = _case((8, 8, 6), 1)
    U = U._replace(rhou=U.rhou.clone())
    U.rhou[1, 2, 3] = float("nan")
    der = _derivs((8, 8, 6), 1)
    der.d2[0, 1, 1, 1] = float("nan")
    h = torch.zeros((6, 8, 8, 6), dtype=torch.float64)
    dd = [torch.full((8, 8, 6), float("nan"), dtype=torch.float64), None,
          None]
    calls = {
        "comp_flux_y": lambda: comp_rhs.flux(1, U, 1.0, 1.0, True),
        "comp_assemble_z": lambda: comp_rhs.assemble(
            2, der, U._replace(rhou=U.rhou.nan_to_num()), None, {}, True,
            True, 0.1, 0.1, 1.0, 1.0, (0.1,)),
        "comp_final": lambda: comp_rhs.final(h, dd, 0.1)}
    with nantrap.trap():
        with pytest.raises(FloatingPointError,
                           match=re.escape(entry) + "$"):
            calls[entry]()


def test_assemble_takes_one_diffusivity_a_scalar():
    P, U = _case((8, 8, 6), 2)
    with pytest.raises(ValueError):
        comp_rhs.assemble(0, _derivs((8, 8, 6), 2), U, None, {}, True,
                          True, 0.1, 0.1, 1.0, 1.0, (0.1,))


def test_the_launches_are_the_counter_dycore_comp_fused_k():
    """dycore.comp_fused.k is the sum of the entry points' launches; the
    registry's reset() sets it to 0."""
    comp_rhs.reset_launches()
    comp_rhs.launches.update(comp_flux_x=2, comp_final=1)
    try:
        assert trace.totals()["counters"]["dycore.comp_fused.k"] == 3
        trace.reset()
        assert trace.totals()["counters"]["dycore.comp_fused.k"] == 0
        assert comp_rhs.launches == {}
    finally:
        comp_rhs.reset_launches()
