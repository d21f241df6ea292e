"""The port's bil_cloud droplet particles (tlab_tpu_torch/particles/
bil_cloud.py) against tlab_tpu's, float64 on the CPU: the counterparts of
tests/test_bil_cloud.py (the Eulerian sources against their analytic
values and tlab_tpu's, the droplet equations, the residence clocks and the
clip, the coupled step) and of tests/test_particles.py's radiation coupling,
plus `dns` with BilinearCloudFour particles through both packages."""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlab_tpu.config import Ini as JIni, load_case as jload_case
from tlab_tpu.dycore.incompressible import (WallBCs as JWallBCs,
                                            build_device_plans as jplans)
from tlab_tpu.dycore.state import State as JState
from tlab_tpu.fdm.plan import build_fdm_plan as jfdm_plan
from tlab_tpu.grid import uniform_grid as juniform_grid
from tlab_tpu.particles import bil_cloud as jbc
from tlab_tpu.particles import core as jpc
from tlab_tpu.particles.stepping import rk_step_with_particles as jstep
from tlab_tpu.physics.params import NSParams as JNSParams
from tlab_tpu.runtime import Simulation as JSimulation
from tlab_tpu.tools import dns as jdns
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.convert import state_from_numpy
from tlab_tpu_torch.dycore.incompressible import WallBCs, build_device_plans
from tlab_tpu_torch.dycore.state import State
from tlab_tpu_torch.fdm.plan import build_fdm_plan
from tlab_tpu_torch.grid import uniform_grid
from tlab_tpu_torch.particles import bil_cloud as bc
from tlab_tpu_torch.particles import core as pc
from tlab_tpu_torch.particles import io as pio
from tlab_tpu_torch.particles.stepping import rk_step_with_particles
from tlab_tpu_torch.physics.params import NSParams
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.tools import dns as tdns

REPO = pathlib.Path(__file__).resolve().parent.parent
F64 = torch.float64
TOL = 1e-10

torch.set_num_threads(2)


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _setup(nx=32, ny=33, nz=8):
    """Both packages' plans of tests/test_bil_cloud.py's box: two scalars
    on Dirichlet walls, Re 100."""
    args = (nx, ny, nz, 2 * np.pi, 2.0, np.pi)
    grid, jgrid = uniform_grid(*args), juniform_grid(*args)
    sbc = (("dirichlet", "dirichlet"), ("dirichlet", "dirichlet"))
    nsp = NSParams(reynolds=100.0, schmidt=(1.0, 1.0))
    # tlab_tpu's build_device_plans builds no factorized plan (its
    # Simulation adds one): both project with the direct eigen plan
    P = build_device_plans(build_fdm_plan(grid), nsp, WallBCs(s=sbc),
                           dtype=F64, device="cpu", factorize=False)
    jP = jplans(jfdm_plan(jgrid), JNSParams(reynolds=100.0,
                                            schmidt=(1.0, 1.0)),
                JWallBCs(s=sbc), dtype=jnp.float64)
    return grid, jgrid, nsp, P, jP


def test_eulerian_sources_analytic_and_as_jax():
    """s1 = sin(x), s2 = const: xi = 1 - th1 sin(x) - th2 c; Lap s1 =
    -sin(x); |grad xi|^2 = th1^2 cos^2(x); and tlab_tpu's four fields to
    1e-12 of their max, with a radiation field too."""
    grid, jgrid, nsp, P, jP = _setup()
    th = (0.3, 0.2, 1.5)
    x = grid.x.nodes
    s1 = np.broadcast_to(np.sin(x)[:, None, None], grid.shape)
    s = np.stack([s1, np.full(grid.shape, 0.4)])
    params = bc.BilCloudParams(thermo=th)
    src = bc.eulerian_sources(P, torch.as_tensor(s), nsp.visc,
                              params).numpy()
    assert np.max(np.abs(src[1] - (1.0 - th[0] * s1 - th[1] * 0.4))) < 1e-12
    assert np.max(np.abs(src[0] - nsp.visc * th[0] * s1)) < 1e-6
    gr = nsp.visc * th[0] ** 2 * np.cos(x)[:, None, None] ** 2
    assert np.max(np.abs(src[2] - gr)) < 1e-6
    assert np.max(np.abs(src[3])) == 0.0
    rad = np.random.default_rng(0).standard_normal(grid.shape)
    for radiation in (None, rad):
        got = bc.eulerian_sources(
            P, torch.as_tensor(s), nsp.visc, params,
            radiation=None if radiation is None else torch.as_tensor(rad))
        ref = jbc.eulerian_sources(
            jP, jnp.asarray(s), nsp.visc, jbc.BilCloudParams(thermo=th),
            radiation=None if radiation is None else jnp.asarray(rad))
        for k in range(4):
            assert np.abs(got[k].numpy() - np.asarray(ref[k])).max() <= \
                1e-12 * max(np.abs(np.asarray(ref[k])).max(), 1.0)


def test_droplet_rhs_formula_and_as_jax():
    """At a particle on a grid node the interpolation is exact and the
    droplet equations (rhs_part_1.f90:135-140) hold pointwise; at random
    particles the port equals tlab_tpu's to round-off."""
    grid, jgrid, _, _, _ = _setup()
    th = (0.3, 0.2, 1.5)
    params = bc.BilCloudParams(thermo=th)
    src = np.random.default_rng(0).standard_normal((4,) + grid.shape)
    i, j, k = 5, 7, 3
    pos = np.array([[grid.x.nodes[i], grid.y.nodes[j], grid.z.nodes[k]]])
    d = bc.droplet_rhs(params, torch.as_tensor(src),
                       pc.make_locator(grid)(torch.as_tensor(pos)))[0]
    inv0 = 1.0 / (th[0] * th[2])
    sa, xi, gr, ra = (float(src[m, i, j, k]) for m in range(4))
    sig = 1.0 / (1.0 + np.exp(xi * inv0))
    assert abs(float(d[0]) - (-sa * sig)) < 1e-12
    d5 = -ra * sig - gr * (-0.25 * inv0) / np.cosh(xi * (-0.5 * inv0)) ** 2
    assert abs(float(d[1]) - d5) < 1e-12
    pos = np.random.default_rng(1).uniform(0.1, 1.9, (64, 3))
    got = bc.droplet_rhs(params, torch.as_tensor(src),
                         pc.make_locator(grid)(torch.as_tensor(pos)))
    ref = jbc.droplet_rhs(jbc.BilCloudParams(thermo=th), jnp.asarray(src),
                          jpc.make_locator(jgrid)(jnp.asarray(pos)))
    assert _rel(got.numpy(), ref) <= 1e-13


def test_residence_and_clipping_as_jax():
    params = bc.BilCloudParams(thermo=(1, 1, 1), y_lambda=1.5, y_base=0.5,
                               variant=4)
    y = torch.tensor([2.0, 1.0, 0.2], dtype=F64)
    out = bc.residence_update(params, 0.1, y, torch.ones(3, 2, dtype=F64))
    assert np.allclose(out[0], [1.1, 1.1])       # both clocks tick
    assert np.allclose(out[1], [1.0, 1.1])       # only the base clock ticks
    assert np.allclose(out[2], [0.0, 0.0])       # memory loss below base
    ref = jbc.residence_update(jbc.BilCloudParams(
        thermo=(1, 1, 1), y_lambda=1.5, y_base=0.5, variant=4), 0.1,
        jnp.asarray(y.numpy()), jnp.ones((3, 2)))
    assert np.array_equal(out.numpy(), np.asarray(ref))
    v = np.array([-0.3, 0.7, 0.0, -1e-300])
    assert np.array_equal(bc.liquid_clip(torch.as_tensor(v)).numpy(),
                          np.asarray(jbc.liquid_clip(jnp.asarray(v))))
    res = np.random.default_rng(2).uniform(0, 1, (100, 2))
    for (c, e), (jc, je) in zip(bc.residence_pdf(torch.as_tensor(res), 1.0,
                                                 10),
                                jbc.residence_pdf(jnp.asarray(res), 1.0, 10)):
        assert np.array_equal(c, jc) and np.array_equal(e, je)


def test_coupled_step_as_jax():
    """One coupled RK step with bil_cloud_4 particles on a stratified layer
    (tests/test_bil_cloud.py's case): finite, droplet props moved,
    residence clocks ticked above the base; the flow, positions and props
    equal tlab_tpu's to 1e-10 of their max, after one step and after five."""
    grid, jgrid, nsp, P, jP = _setup(16, 17, 8)
    y = grid.y.nodes
    rng = np.random.default_rng(1)
    s1 = np.broadcast_to(np.tanh((y - 1.0) / 0.3)[None, :, None],
                         grid.shape) + 0.01 * rng.standard_normal(grid.shape)
    s = np.stack([s1, 0.5 * s1 + 0.1])
    u = 0.1 * rng.standard_normal(grid.shape)
    z = np.zeros(grid.shape)
    n_p = 50
    pos = np.column_stack([rng.uniform(0, 2 * np.pi, n_p),
                           rng.uniform(0.1, 1.9, n_p),
                           rng.uniform(0, np.pi, n_p)])
    kw = dict(thermo=(0.5, 0.3, 1.2), y_lambda=1.6, y_base=0.3, variant=4)
    st = State(*(torch.as_tensor(a) for a in (u, z, z, s)))
    jst = JState(u=jnp.asarray(u), v=jnp.asarray(z), w=jnp.asarray(z),
                 s=jnp.asarray(s))
    ps = pc.ParticleState(torch.as_tensor(pos), torch.zeros(n_p, 3,
                                                            dtype=F64),
                          torch.zeros(n_p, 4, dtype=F64), torch.arange(n_p))
    jps = jpc.ParticleState(jnp.asarray(pos), jnp.zeros((n_p, 3)),
                            jnp.zeros((n_p, 4)), jnp.arange(n_p))
    props = pc.ParticleProps(type="bil_cloud_4",
                             bil_cloud=bc.BilCloudParams(**kw))
    jprops = jpc.ParticleProps(type="bil_cloud_4",
                               bil_cloud=jbc.BilCloudParams(**kw))
    for n in range(5):
        st, ps = rk_step_with_particles(P, grid, pc.make_locator(grid),
                                        props, st, ps, 0.01)
        jst, jps = jstep(jP, jgrid, jpc.make_locator(jgrid), jprops, jst,
                         jps, 0.01)
        if n in (0, 4):
            for a, b in ((st.u, jst.u), (st.s, jst.s), (ps.x, jps.x),
                         (ps.props, jps.props)):
                assert _rel(a.numpy(), b) <= TOL, n
        if n == 0:
            assert torch.isfinite(ps.props).all() and \
                torch.isfinite(st.u).all()
            assert float(ps.props[:, 0].abs().max()) > 0.0
            above = ps.x[:, 1] > 0.3
            assert torch.allclose(ps.props[above, 3],
                                  torch.tensor(0.01, dtype=F64))
    assert float(ps.props[:, :2].min()) >= 0.0


BASE = (REPO / "tests" / "data" / "case01_small.ini").read_text() \
    .replace("Schmidt=1.0", "Schmidt=1.0,1.0") \
    .replace("[Scalar]\nProfileScalar1=Tanh", """[Scalar]
ProfileScalar2=Tanh
ThickScalar2=0.05
DeltaScalar2=-1.0
MeanScalar2=0.5
Scalar2Jmin=neumann
Scalar2Jmax=neumann
ProfileScalar1=Tanh""")
RADIATION = """
[Infrared]
Type=grayliquid
Scalar=1
BoundaryConditions=1.0, 0.0
AbsorptionComponent1=10.0
"""


def test_radiation_coupling_as_jax():
    """Radiation enters the droplet equations (reference rhs_part_1.f90:
    82-86; tests/test_particles.py::test_bil_cloud_radiation_coupling):
    with [Infrared] the non-diffusive droplet property moves differently
    than without; each equals tlab_tpu's to 1e-10 of its max."""
    assert "ProfileScalar2=Tanh" in BASE
    outs = {}
    for tag, txt in (("norad", BASE), ("rad", BASE + RADIATION)):
        sim = Simulation.from_case(load_case(Ini(text=txt)), dtype=F64,
                                   device="cpu")
        jsim = JSimulation.from_case(jload_case(JIni(text=txt)))
        nx, ny, nz = sim.grid.shape
        rng = np.random.default_rng(4)
        sfield = np.broadcast_to(
            0.5 + 0.3 * np.sin(np.pi * sim.grid.y.nodes)[None, :, None],
            (nx, ny, nz))
        s = np.stack([sfield] * 2)
        z = np.zeros((nx, ny, nz))
        n = 32
        x = np.stack([rng.uniform(0.2, 1.8, n), rng.uniform(0.2, 0.8, n),
                      np.zeros(n)], axis=1)
        kw = dict(type="bil_cloud_3")
        st = state_from_numpy(z, z, z, s, "cpu", F64)
        ps = pc.ParticleState(torch.as_tensor(x), torch.zeros(n, 3,
                                                              dtype=F64),
                              torch.zeros(n, 2, dtype=F64), torch.arange(n))
        _, ps = rk_step_with_particles(
            sim.P, sim.grid, pc.make_locator(sim.grid),
            pc.ParticleProps(bil_cloud=bc.BilCloudParams(
                thermo=(1.0, 0.5, 0.2)), **kw), st, ps, 1e-3)
        jst = JState(u=jnp.asarray(z), v=jnp.asarray(z), w=jnp.asarray(z),
                     s=jnp.asarray(s))
        jps = jpc.ParticleState(jnp.asarray(x), jnp.zeros((n, 3)),
                                jnp.zeros((n, 2)), jnp.arange(n))
        _, jps = jstep(jsim.P, jsim.grid, jpc.make_locator(jsim.grid),
                       jpc.ParticleProps(bil_cloud=jbc.BilCloudParams(
                           thermo=(1.0, 0.5, 0.2)), **kw), jst, jps, 1e-3)
        assert _rel(ps.props.numpy(), jps.props) <= TOL, tag
        outs[tag] = ps.props.numpy()
    d = np.abs(outs["rad"][:, 1] - outs["norad"][:, 1])
    assert d.max() > 0.0, "radiation did not reach the droplet equations"
    assert np.isfinite(outs["rad"]).all()


@pytest.mark.parametrize("ptype", ["BilinearCloudFour", "Inertia"])
def test_dns_with_droplets_matches_jax(tmp_path, ptype):
    """dns.run of the two-scalar case01_small.ini with 100 particles whose
    props start empty (dns pads them to n_props for the droplet types),
    4 steps through both packages: dns.out to every printed digit, the
    final part.<it> to 1e-10 (props and positions), the liquid >= 0."""
    text = BASE.replace("End=10", "End=4").replace("Restart=10",
                                                    "Restart=4") \
        + f"\n[Particles]\nType={ptype}\nParameters=0.5,0.2\n" \
          "\n[Thermodynamics]\nParameters=0.5,0.3,1.2\n"
    jsim = JSimulation.from_case(jload_case(JIni(text=text)))
    tsim = Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                                device="cpu")
    from tlab_tpu.tools.initialize import initial_state as jinitial_state
    st = jinitial_state(jsim, seed=7)
    start = tuple(np.asarray(a) for a in (st.u, st.v, st.w, st.s))
    for name, mod, sim, state, pmod, kw in (
            ("jax", jdns, jsim, st, jpc, {}),
            ("torch", tdns, tsim, state_from_numpy(*start, "cpu", F64), pc,
             {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        ps = pmod.init_particles(sim.grid, 100, seed=2, **kw)
        mod.run(sim, state, outdir=str(d), log_path=str(d / "dns.out"),
                pstate=ps, particle_props=pmod.props_from_ini(sim.case.ini))
    rows = [[ln.split() for ln in open(tmp_path / n / "dns.out")
             if not ln.startswith("#")] for n in ("jax", "torch")]
    assert rows[0] == rows[1]
    a, _ = pio.read_particles(str(tmp_path / "jax" / "part.4"), device="cpu")
    b, _ = pio.read_particles(str(tmp_path / "torch" / "part.4"),
                              device="cpu")
    want = 4 if ptype == "BilinearCloudFour" else 0
    assert b.props.shape == (100, want) == a.props.shape
    for x, y in ((b.x, a.x), (b.v, a.v), (b.props, a.props)):
        if y.numel():
            assert _rel(x.numpy(), y.numpy()) <= TOL
    if want:
        assert float(b.props[:, :2].min()) >= 0.0
        assert float(b.props[:, :2].abs().max()) > 0.0
