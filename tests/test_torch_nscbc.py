"""The port's characteristic (NSCBC) boundaries (tlab_tpu_torch/dycore/
nscbc.py and the nscbc argument of rk_step_compressible) against tlab_tpu's,
float64 on the CPU: the edge-plane pieces (one-sided normal derivatives,
tangential plane derivatives, the NR_3 flow and scalar corrections on both
sides and in both directions' formulations, the Lodato transverse terms)
exactly or to round-off; apply_nscbc on a state; one RK step and five of
the cases of tlab_tpu's tests/test_compressible.py (:113 outflow, :143 x
outflow, :412 inflow relaxation, :443 transverse terms, :483 scalar
outflow) to 1e-10 of each field's max; the spec the runtime builds from a
case file; a y line on the substructured plans (the edge rows stay the
dense D1's); and, in the port alone, what those tests hold tlab_tpu to
(a pulse leaves through an outflow with < 5% reflection, an inflow holds
its reference, a scalar blob leaves)."""
import dataclasses
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from threadpoolctl import threadpool_limits

from tlab_tpu import grid as jgrid
from tlab_tpu.config import Ini as JIni, load_case as jload_case
from tlab_tpu.dycore import compressible as jcomp
from tlab_tpu.dycore import incompressible as jdyn
from tlab_tpu.dycore import nscbc as jn
from tlab_tpu.fdm.plan import build_fdm_plan
from tlab_tpu.physics.params import NSParams
from tlab_tpu.runtime import Simulation as JSimulation
from tlab_tpu_torch import grid as tgrid
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.dycore import compressible as tcomp
from tlab_tpu_torch.dycore import incompressible as tdyn
from tlab_tpu_torch.dycore import nscbc as tn
from tlab_tpu_torch.fdm.plan import build_fdm_plan as tbuild_fdm_plan
from tlab_tpu_torch.physics.params import NSParams as TNSParams
from tlab_tpu_torch.runtime import Simulation

F64 = torch.float64
TOL = 1e-10
GAMMA, MACH = 1.4, 0.5                    # tlab_tpu's test_compressible.py
P_INF = 1.0 / (GAMMA * MACH ** 2)
CASE02 = os.path.join(os.path.dirname(__file__), "data",
                      "case02_small3d.ini")

torch.set_num_threads(2)
threadpool_limits(1, user_api="blas")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.max(np.abs(b))
    return np.max(np.abs(a - b)) / scale if scale > 0 \
        else np.max(np.abs(a - b))


def _close(a, b, tol=TOL):
    """Field by field to tol of its max; the three momenta as one vector
    (a momentum that vanishes analytically is round-off in both)."""
    a, b = list(a), list(b)
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
    if len(a) >= 5:
        mom = max(float(np.max(np.abs(np.asarray(y)))) for y in b[1:4])
        for x, y in zip(a[1:4], b[1:4]):
            assert np.max(np.abs(np.asarray(x) - np.asarray(y))) \
                <= tol * mom
        a, b = a[:1] + a[4:], b[:1] + b[4:]
    for x, y in zip(a, b):
        if x is not None:
            assert _rel(x, y) <= tol


def _grids(nx, ny, nz, x_periodic=True, y_periodic=False):
    """tlab_tpu's test _setup grid in both packages (x periodic over 2 pi,
    or [0, 1] between open ends)."""
    def grid(mod):
        gx = mod.make_axis(np.arange(nx) * (2 * np.pi / nx), True) \
            if x_periodic else mod.make_axis(np.linspace(0, 1, nx), False)
        gy = mod.make_axis(np.arange(ny) * (1.0 / ny), True) if y_periodic \
            else mod.make_axis(np.linspace(0, 1, ny), False)
        gz = mod.make_axis(np.zeros(1), False) if nz == 1 else \
            mod.make_axis(np.arange(nz) * (1.0 / nz), True)
        return mod.Grid(gx, gy, gz)
    return grid(jgrid), grid(tgrid)


def _plans(nx, ny, nz=1, schmidt=(), x_periodic=True, y_periodic=False,
           banded_min_n=tdyn.BANDED_MIN_N):
    """Both packages' compressible plans (reynolds 1e9 as tlab_tpu's
    NSCBC tests), and the grid."""
    gj, gt = _grids(nx, ny, nz, x_periodic, y_periodic)
    kw = dict(reynolds=1e9, schmidt=schmidt)
    sbc = (("neumann", "neumann"),) * len(schmidt)
    PJ = jdyn.build_device_plans(
        build_fdm_plan(gj), NSParams(**kw),
        jdyn.WallBCs.from_velocity_kind("freeslip", "freeslip",
                                        scalar_bcs=sbc),
        dtype=jnp.float64, with_elliptic=False)
    PT = tdyn.build_device_plans(
        tbuild_fdm_plan(gt), TNSParams(**kw),
        tdyn.WallBCs.from_velocity_kind("freeslip", "freeslip",
                                        scalar_bcs=sbc),
        dtype=F64, device="cpu", with_elliptic=False,
        banded_min_n=banded_min_n)
    PJ["y_periodic"] = PT["y_periodic"] = y_periodic
    return gj, PJ, PT


def _state(prim, s=None):
    """(tlab_tpu CompState, port CompState) of NumPy primitives."""
    Uj = jcomp.from_primitive(*(jnp.asarray(a) for a in prim), GAMMA, MACH,
                              s=None if s is None else jnp.asarray(s))
    Ut = tcomp.from_primitive(*(torch.from_numpy(a) for a in prim), GAMMA,
                              MACH,
                              s=None if s is None else torch.from_numpy(s))
    return Uj, Ut


def _pulse(grid, axis="y", amp=1e-4, modulated=False):
    """tlab_tpu's acoustic pulse at 0.5 moving toward the max end."""
    nx, ny, nz = grid.shape
    X = grid.x.nodes[:, None, None] * np.ones((nx, ny, nz))
    Y = grid.y.nodes[None, :, None] * np.ones((nx, ny, nz))
    c = 1.0 / MACH
    g = np.exp(-((((Y if axis == "y" else X) - 0.5) / 0.05) ** 2))
    if modulated:
        g = g * (1.0 + 0.3 * np.sin(2.0 * np.pi * X / X.max()))
    z = np.zeros((nx, ny, nz))
    vel = c * amp * g
    prim = (1.0 + amp * g, vel if axis == "x" else z,
            vel if axis == "y" else z, z, 1.0 + (GAMMA - 1.0) * amp * g)
    return prim


# the cases of tlab_tpu's tests/test_compressible.py: (plan kwargs, spec,
# state builder)
def _case(name):
    if name == "outflow":                                      # :113
        g, PJ, PT = _plans(8, 256)
        spec = dict(ymin="outflow", ymax="outflow", p_inf=P_INF)
        return PJ, PT, spec, _state(_pulse(g))
    if name == "x_outflow":                                    # :143
        g, PJ, PT = _plans(256, 8, x_periodic=False, y_periodic=True)
        spec = dict(ymin="wall", ymax="wall", xmin="outflow",
                    xmax="outflow", p_inf=P_INF)
        return PJ, PT, spec, _state(_pulse(g, "x"))
    if name == "inflow":                                       # :412
        g, PJ, PT = _plans(8, 128)
        one = np.ones(g.shape)
        spec = dict(ymin="inflow", ymax="outflow", p_inf=P_INF,
                    rho_inf=1.0, u_inf=(0.0, 0.3, 0.0), cinf=2.0)
        return PJ, PT, spec, _state((one, 0 * one, 0.3 * one, 0 * one, one))
    if name == "transverse":                                   # :443
        g, PJ, PT = _plans(32, 128)
        spec = dict(ymin="outflow", ymax="outflow", p_inf=P_INF, ctan=0.25)
        return PJ, PT, spec, _state(_pulse(g, modulated=True))
    if name == "scalar":                                       # :483
        g, PJ, PT = _plans(8, 192, schmidt=(1.0,))
        nx, ny, nz = g.shape
        Y = g.y.nodes[None, :, None] * np.ones((nx, ny, nz))
        one = np.ones((nx, ny, nz))
        s0 = np.exp(-(((Y - 0.6) / 0.08) ** 2))
        spec = dict(ymin="inflow", ymax="outflow", p_inf=P_INF,
                    u_inf=(0.0, 0.3, 0.0), cinf=2.0)
        return PJ, PT, spec, _state((one, 0 * one, 0.3 * one, 0 * one, one),
                                    s=s0[None])
    raise KeyError(name)


CASES = ("outflow", "x_outflow", "inflow", "transverse", "scalar")


@pytest.mark.parametrize("name", CASES)
def test_rk_steps_match_jax(name):
    """One RK4 step and five of each case, dt 2e-4 as tlab_tpu's tests."""
    PJ, PT, spec, (Uj, Ut) = _case(name)
    sj, st = jn.NSCBCSpec(**spec), tn.NSCBCSpec(**spec)
    step = jax.jit(lambda U: jcomp.rk_step_compressible(
        PJ, U, 2e-4, GAMMA, MACH, 0.0, 1.0, nscbc=sj, ly=1.0))
    for n in range(1, 6):
        Uj = step(Uj)
        Ut = tcomp.rk_step_compressible(PT, Ut, 2e-4, GAMMA, MACH, 0.0, 1.0,
                                        nscbc=st, ly=1.0)
        if n in (1, 5):
            _close(Ut, Uj)


def _planes(rng, shape, positive=False):
    a = rng.standard_normal(shape)
    return 1.0 + 0.1 * np.abs(a) if positive else 0.3 * a


@pytest.mark.parametrize("side", [0, 1])
@pytest.mark.parametrize("idir", [1, 2])
def test_nr_corrections_match_jax(side, idir):
    """BOUNDARY_BCS_FLOW_NR_3 and BOUNDARY_BCS_SCAL_NR_3 on random edge
    planes: every branch (inflow, outflow, supersonic) is taken."""
    rng = np.random.default_rng(side + 2 * idir)
    shape = (16, 4)
    r, p, gam = (_planes(rng, shape, True) for _ in range(3))
    un = 2.0 * rng.standard_normal(shape)        # some supersonic points
    v1, v2, drdn, dundn, dv1dn, dv2dn, dpdn, s, dsdn = (
        _planes(rng, shape) for _ in range(9))
    pl_out, pl_inf = 0.3 * np.ones(shape), 0.7 * np.ones(shape)
    refs = tuple(_planes(rng, shape, True) for _ in range(5))
    args = (side, r, un, v1, v2, p, gam, drdn, dundn, dv1dn, dv2dn, dpdn,
            -0.4, pl_out, pl_inf, refs)
    got = tn._nr_corrections(*(_t(a) for a in args), idir=idir)
    ref = jn._nr_corrections(*(_j(a) for a in args), idir=idir)
    _close(got, ref, 1e-14)
    sargs = (side, r, un, s, p, gam, drdn, dundn, dsdn, dpdn, -0.4, pl_out,
             pl_inf, refs[4], refs[0], refs[1])
    assert _rel(tn._nr_scalar_corrections(*(_t(a) for a in sargs),
                                          idir=idir),
                jn._nr_scalar_corrections(*(_j(a) for a in sargs),
                                          idir=idir)) <= 1e-14


def _t(a):
    if isinstance(a, tuple):
        return tuple(_t(x) for x in a)
    return torch.from_numpy(a) if isinstance(a, np.ndarray) else a


def _j(a):
    if isinstance(a, tuple):
        return tuple(_j(x) for x in a)
    return jnp.asarray(a) if isinstance(a, np.ndarray) else a


@pytest.mark.parametrize("side", [0, 1])
def test_edge_pieces_match_jax(side):
    """The one-sided normal derivatives (the dense D1's edge rows), the
    tangential plane derivatives, max Mach^2 and the Lodato transverse
    terms."""
    _, PJ, PT = _plans(24, 40, nz=8)
    rng = np.random.default_rng(side)
    a = rng.standard_normal(PT["sizes"])
    for axis in (0, 1):
        assert _rel(tn._edge_deriv(PT, torch.from_numpy(a), axis, side),
                    jn._edge_deriv(PJ, jnp.asarray(a), axis, side)) <= 1e-14
    plane = rng.standard_normal((24, 8))
    for which in ("x", "z"):
        assert _rel(tn._plane_d1(PT, torch.from_numpy(plane), 0, which),
                    jn._plane_d1(PJ, jnp.asarray(plane), 0, which)) <= 1e-14
    shape = PT["sizes"]
    prim = (1.0 + 0.1 * np.abs(rng.standard_normal(shape)),
            *(0.2 * rng.standard_normal(shape) for _ in range(3)),
            1.0 + 0.1 * np.abs(rng.standard_normal(shape)))
    Uj, Ut = _state(prim)
    assert _rel(tn.max_mach2(Ut, GAMMA, MACH),
                jn.max_mach2(Uj, GAMMA, MACH)) <= 1e-14
    pl = (24, 8)
    r, p, gam = (_planes(rng, pl, True) for _ in range(3))
    un, v1, v2 = (_planes(rng, pl) for _ in range(3))
    args = (side, r, un, v1, v2, p, gam, (0.1, -0.2), 0.25)
    _close(tn._transverse_corrections(PT, *(_t(x) for x in args)),
           jn._transverse_corrections(PJ, *(_j(x) for x in args)), 1e-13)


@pytest.mark.parametrize("energy", ["total", "internal"])
@pytest.mark.parametrize("ctan", [0.0, 0.25])
def test_apply_nscbc_matches_jax(energy, ctan):
    """apply_nscbc on a random state with a scalar: inflow at ymin, outflow
    at ymax, gravity along y, the tendency of the interior right-hand
    side."""
    _, PJ, PT = _plans(16, 33, nz=8, schmidt=(0.7,))
    rng = np.random.default_rng(7)
    shape = PT["sizes"]
    prim = (1.0 + 0.05 * rng.standard_normal(shape),
            *(0.2 * rng.standard_normal(shape) for _ in range(3)),
            1.0 + 0.05 * rng.standard_normal(shape))
    s = rng.random((1,) + tuple(shape))
    Uj = jcomp.from_primitive(*(jnp.asarray(a) for a in prim), GAMMA, MACH,
                              s=jnp.asarray(s), energy=energy)
    Ut = tcomp.CompState(*(torch.from_numpy(np.asarray(a)) for a in Uj))
    hj = jcomp.rhs_compressible(PJ, Uj, GAMMA, MACH, 1e-3, 0.7) \
        if energy == "total" else jcomp.rhs_compressible_internal(
            PJ, Uj, GAMMA, MACH, 1e-3, 0.7)
    ht = tcomp.CompState(*(torch.from_numpy(np.asarray(a)) for a in hj))
    spec = dict(ymin="inflow", ymax="outflow", p_inf=P_INF, cinf=1.5,
                u_inf=(0.1, 0.2, 0.0), ctan=ctan)
    kw = dict(gvec=(0.0, -0.3, 0.0), energy=energy)
    _close(tn.apply_nscbc(PT, Ut, ht, GAMMA, MACH, tn.NSCBCSpec(**spec),
                          1.0, **kw),
           jn.apply_nscbc(PJ, Uj, hj, GAMMA, MACH, jn.NSCBCSpec(**spec),
                          1.0, **kw), 1e-13)


def test_a_banded_y_keeps_the_dense_edge_rows():
    """A y line on the substructured plans (banded_min_n below ny): the
    plan keeps the dense D1 beside them (build_device_plans), whose edge
    rows are the one-sided compact derivatives tlab_tpu reads too, and the
    step matches the dense plan's to round-off."""
    _, PJ, PT = _plans(8, 96)
    _, _, PB = _plans(8, 96, banded_min_n=64)
    assert "d1y_banded" in PB and "d1y_banded" not in PT
    assert torch.equal(PB["d1y"], PT["d1y"])
    g, _, _ = _plans(8, 96)
    _, Ut = _state(_pulse(g))
    spec = tn.NSCBCSpec(ymin="outflow", ymax="outflow", p_inf=P_INF)
    a = tcomp.rk_step_compressible(PT, Ut, 2e-4, GAMMA, MACH, 0.0, 1.0,
                                   nscbc=spec)
    b = tcomp.rk_step_compressible(PB, Ut, 2e-4, GAMMA, MACH, 0.0, 1.0,
                                   nscbc=spec)
    _close(b, a, 1e-12)


def test_a_mesh_plan_raises_with_its_item():
    """The mesh-global max Mach^2 (an MPI_ALLREDUCE in the reference) is
    the mesh's all-reduce now (tests/test_torch_pencil.py steps the set on
    four ranks): _global_max hands the value to the rank's mesh, and a
    plan whose "comm" has no mesh is refused."""
    g, _, PT = _plans(8, 32)
    _, Ut = _state(_pulse(g))
    spec = tn.NSCBCSpec(ymin="outflow", ymax="outflow", p_inf=P_INF)
    with pytest.raises(ValueError, match="pencil_plans"):
        tcomp.rk_step_compressible(dict(PT, comm={}), Ut, 2e-4, GAMMA, MACH,
                                   0.0, 1.0, nscbc=spec)

    class Mesh:
        def all_reduce(self, v, op):
            return ("reduced", v, op)

    assert tn._global_max(None, 1.0) == 1.0
    assert tn._global_max({"comm": {"mesh": Mesh()}}, 1.0) == \
        ("reduced", 1.0, "max")


@pytest.mark.parametrize("edits", [
    {"VelocityJmin=freeslip": "VelocityJmin=outflow"},
    {"VelocityJmin=freeslip": "VelocityJmin=inflow",
     "VelocityJmax=freeslip": "VelocityJmax=outflow"}],
    ids=["outflow_wall", "inflow_outflow"])
def test_the_runtime_builds_jax_spec(edits):
    """The spec Simulation.from_case builds from case02_small3d.ini with
    open y sides equals tlab_tpu's, field for field; a wall side keeps the
    wall rows (and the step matches tlab_tpu's, one step)."""
    with open(CASE02) as fh:
        text = fh.read()
    for old, new in edits.items():
        assert old in text
        text = text.replace(old, new)
    text = text.replace("Imax=128", "Imax=32").replace(
        "points_1=129", "points_1=33")
    jsim = JSimulation.from_case(jload_case(JIni(text=text)))
    tsim = Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                                device="cpu")
    assert dataclasses.asdict(tsim.comp["nscbc"]) == \
        dataclasses.asdict(jsim.comp["nscbc"])
    rng = np.random.default_rng(3)
    shape = tsim.P["sizes"]
    prim = (1.0 + 0.05 * rng.standard_normal(shape),
            *(0.2 * rng.standard_normal(shape) for _ in range(3)),
            1.0 + 0.05 * rng.standard_normal(shape))
    s = rng.random((1,) + tuple(shape))
    Uj = jcomp.from_primitive(*(jnp.asarray(a) for a in prim),
                              jsim.comp["gamma"], jsim.comp["mach"],
                              s=jnp.asarray(s), energy="internal")
    Ut = tcomp.CompState(*(torch.from_numpy(np.asarray(a)) for a in Uj))
    jc, tc = jsim.comp, tsim.comp
    common = dict(energy="internal", ly=tc["ly"], lx=tc["lx"])
    _close(tcomp.rk_step_compressible(
               tsim.P, Ut, 1e-3, tc["gamma"], tc["mach"], tsim.nsp.visc,
               tc["prandtl"], nscbc=tc["nscbc"], **common),
           jcomp.rk_step_compressible(
               jsim.P, Uj, 1e-3, jc["gamma"], jc["mach"], jsim.nsp.visc,
               jc["prandtl"], nscbc=jc["nscbc"], **common))


# what tlab_tpu's tests hold it to, in the port alone (fewer steps where
# the property shows earlier: the pulse's crossing is what counts)

def _run(PT, Ut, spec, n, dt=2e-4):
    for _ in range(n):
        Ut = tcomp.rk_step_compressible(PT, Ut, dt, GAMMA, MACH, 0.0, 1.0,
                                        nscbc=spec, ly=1.0)
    return Ut


@pytest.mark.slow
def test_outflow_lets_a_pulse_leave():
    """tests/test_compressible.py:113: a pulse through an outflow leaves
    < 5% of itself (a wall reflects ~100%).  1075 RK4 steps, ~50 s on the
    CPU: slow."""
    PJ, PT, spec, (_, Ut) = _case("outflow")
    c = 1.0 / MACH
    n = int(0.45 / (c * 2e-4)) + 400
    U = _run(PT, Ut, tn.NSCBCSpec(**spec), n)
    residual = float((U.rho - 1.0).abs().max()) / 1e-4
    assert np.isfinite(residual) and residual < 0.05, residual


def test_inflow_holds_its_reference():
    """tests/test_compressible.py:412: uniform advection from an inflow
    stays uniform at its reference."""
    PJ, PT, spec, (_, Ut) = _case("inflow")
    U = _run(PT, Ut, tn.NSCBCSpec(**spec), 400)
    v = U.rhov / U.rho
    assert abs(float(v[:, 0, :].mean()) - 0.3) < 1e-3
    assert float((U.rho - 1.0).abs().max()) < 1e-3


@pytest.mark.slow
def test_x_outflow_lets_a_pulse_leave():
    """tests/test_compressible.py:143: the same through the open x ends of
    a periodic-y box.  1075 RK4 steps, ~50 s on the CPU: slow."""
    PJ, PT, spec, (_, Ut) = _case("x_outflow")
    c = 1.0 / MACH
    n = int(0.45 / (c * 2e-4)) + 400
    U = Ut
    st = tn.NSCBCSpec(**spec)
    for _ in range(n):
        U = tcomp.rk_step_compressible(PT, U, 2e-4, GAMMA, MACH, 0.0, 1.0,
                                       nscbc=st, ly=1.0, lx=1.0)
    residual = float((U.rho - 1.0).abs().max()) / 1e-4
    assert np.isfinite(residual) and residual < 0.08, residual   # as :143
