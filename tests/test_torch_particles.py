"""The port's Lagrangian particles (tlab_tpu_torch/particles) against
tlab_tpu's, float64 on the CPU: the counterparts of tests/test_particles.py
(interpolation, scatter, advection, inertia, tinia, PDFs, trajectories),
init_particles and `inipart` byte for byte, rk_step_with_particles one step
and five (flow and positions <= 1e-10 of their max), `dns` with particles
through both packages (dns.out to every printed digit, part.<it>,
trajectories and particle PDFs), the hooks the particle step skips as
tlab_tpu's does (ROADMAP C 28) and the float32 witness."""
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlab_tpu.config import Ini as JIni, load_case as jload_case
from tlab_tpu.dycore.state import State as JState
from tlab_tpu.dycore.timemarch import RK4
from tlab_tpu.grid import uniform_grid as juniform_grid
from tlab_tpu.particles import core as jpc
from tlab_tpu.particles import io as jpio
from tlab_tpu.particles.stepping import rk_step_with_particles as jstep
from tlab_tpu.runtime import Simulation as JSimulation
from tlab_tpu.tools import cli as jcli
from tlab_tpu.tools import dns as jdns
from tlab_tpu.tools.initialize import initial_state as jinitial_state
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.convert import state_from_numpy
from tlab_tpu_torch.dycore import incompressible as tdyn
from tlab_tpu_torch.dycore.state import State
from tlab_tpu_torch.fdm.plan import build_fdm_plan
from tlab_tpu_torch.grid import uniform_grid
from tlab_tpu_torch.io import fields_io as tio
from tlab_tpu_torch.particles import core as pc
from tlab_tpu_torch.particles import io as pio
from tlab_tpu_torch.particles.stepping import rk_step_with_particles
from tlab_tpu_torch.physics.params import NSParams
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.tools import cli
from tlab_tpu_torch.tools import dns as tdns

REPO = pathlib.Path(__file__).resolve().parent.parent
F64 = torch.float64
TOL = 1e-10

torch.set_num_threads(2)

# tests/data/case01_small3d.ini at 32x24x16, 4 steps, restarts and
# statistics every 2
SMALL = (REPO / "tests" / "data" / "case01_small3d.ini").read_text()
for _old, _new in (("Imax=128", "Imax=32"), ("Jmax=64", "Jmax=24"),
                   ("points_1=129", "points_1=33"),
                   ("points_1=64", "points_1=24"), ("End=10", "End=4"),
                   ("Restart=10", "Restart=2"),
                   ("Statistics=5", "Statistics=2")):
    assert _old in SMALL
    SMALL = SMALL.replace(_old, _new)
PARTICLES = """
[Particles]
Type={type}
Number=300
DiamIniP=0.3
YMeanRelativeIniP=0.5
TrajNumber=8
CalculatePDF=yes
PdfMax=1.0
PdfInterval=0.1
"""


def _grid(nx=32, ny=33, nz=16):
    return (uniform_grid(nx, ny, nz, 2.0, 1.0, 1.5),
            juniform_grid(nx, ny, nz, 2.0, 1.0, 1.5))


def _positions(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0.1, 1.7, n), rng.uniform(0.05, 0.95, n),
                     rng.uniform(0.1, 1.3, n)], axis=1)


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_trilinear_exact_on_linear_field():
    grid, jgrid = _grid()
    X = grid.x.nodes[:, None, None]
    Y = grid.y.nodes[None, :, None]
    Z = grid.z.nodes[None, None, :]
    f = 2.0 * X + 3.0 * Y - 1.5 * Z + 0.7 * np.ones(grid.shape)
    pos = _positions(500, 0)
    vals = pc.interpolate_to_particles(
        torch.as_tensor(f), pc.make_locator(grid)(torch.as_tensor(pos)))
    exact = 2.0 * pos[:, 0] + 3.0 * pos[:, 1] - 1.5 * pos[:, 2] + 0.7
    assert float(np.abs(vals.numpy() - exact).max()) < 1e-12


def test_scatter_conserves_total_and_matches_jax():
    """particles_to_field (index_put_ with accumulate over the 8 corners):
    the total equals the sum of the values to round-off, the field
    tlab_tpu's scatter-add to 1e-13 of its max (sums in another order)."""
    grid, jgrid = _grid()
    pos = _positions(200, 1)
    vals = np.random.default_rng(1).standard_normal(200)
    fld = pc.particles_to_field(torch.as_tensor(vals),
                                pc.make_locator(grid)(torch.as_tensor(pos)),
                                grid.shape)
    assert abs(float(fld.sum()) - float(vals.sum())) < 1e-10
    ref = jpc.particles_to_field(jnp.asarray(vals),
                                 jpc.make_locator(jgrid)(jnp.asarray(pos)),
                                 jgrid.shape)
    assert _rel(fld.numpy(), ref) <= 1e-13


def _uniform_plans(grid):
    fdm = build_fdm_plan(grid)
    nsp = NSParams(reynolds=1e6, schmidt=())
    bcs = tdyn.WallBCs.from_velocity_kind("freeslip", "freeslip",
                                          scalar_bcs=())
    return tdyn.build_device_plans(fdm, nsp, bcs, dtype=F64, device="cpu")


def test_tracer_uniform_advection():
    """Constant velocity: exact linear trajectories with the periodic wrap
    (tests/test_particles.py's case through the port's coupled step)."""
    grid, _ = _grid()
    P = _uniform_plans(grid)
    locate = pc.make_locator(grid)
    nx, ny, nz = grid.shape
    u0, dt = 0.7, 0.01
    z = torch.zeros(grid.shape, dtype=F64)
    state = State(u=torch.full(grid.shape, u0, dtype=F64), v=z, w=z,
                  s=torch.zeros((0, nx, ny, nz), dtype=F64))
    ps = pc.init_particles(grid, 100, seed=3, device="cpu")
    x0 = ps.x.numpy().copy()
    props = pc.ParticleProps(type="tracer")
    for _ in range(20):
        state, ps = rk_step_with_particles(P, grid, locate, props, state, ps,
                                           dt)
    expect_x = np.mod(x0[:, 0] + u0 * dt * 20, grid.x.scale)
    got_x = np.mod(ps.x[:, 0].numpy(), grid.x.scale)
    diff = np.minimum(np.abs(got_x - expect_x),
                      grid.x.scale - np.abs(got_x - expect_x))
    assert np.max(diff) < 1e-8
    assert np.max(np.abs(ps.x[:, 1].numpy() - x0[:, 1])) < 1e-10


def test_inertia_relaxes_to_flow():
    """A heavy particle in uniform flow approaches the fluid velocity at
    the Stokes rate: v(t) = u (1 - e^{-t/St})."""
    grid, _ = _grid()
    locate = pc.make_locator(grid)
    u = torch.ones(grid.shape, dtype=F64)
    zeros = torch.zeros(grid.shape, dtype=F64)
    props = pc.ParticleProps(type="inertia", stokes=0.5)
    ps = pc.init_particles(grid, 10, seed=5, device="cpu")
    dt, n = 0.01, 200
    for _ in range(n):
        hx = torch.zeros_like(ps.x)
        hv = torch.zeros_like(ps.v)
        for i, k in enumerate(RK4.kdt):
            dpx, dpv = pc.particle_rhs(props, ps, locate, u, zeros, zeros)
            hx, hv = hx + dpx, hv + dpv
            ps = pc.ParticleState(
                x=pc.wrap_positions(grid, ps.x + dt * k * hx),
                v=ps.v + dt * k * hv, props=ps.props, tags=ps.tags)
            if i < 4:
                hx, hv = RK4.kco[i] * hx, RK4.kco[i] * hv
    expect = 1.0 - np.exp(-dt * n / 0.5)
    assert abs(float(ps.v[:, 0].mean()) - expect) < 1e-6


def test_tinia_type_sticks():
    """PART_TYPE_TINIA_1 carries zero tendency; a stick-BC tracer parked at
    the wall stays frozen while the others move (as tlab_tpu's)."""
    grid, jgrid = _grid()
    n = 16
    x = np.random.default_rng(0).uniform(0.1, 0.9, (n, 3))
    x[0, 1] = grid.y.nodes[0]
    u = torch.ones(grid.shape, dtype=F64)
    ps = pc.ParticleState(x=torch.as_tensor(x), v=torch.zeros(n, 3, dtype=F64),
                          props=torch.zeros(n, 0, dtype=F64),
                          tags=torch.arange(n))
    jps = jpc.ParticleState(x=jnp.asarray(x), v=jnp.zeros((n, 3)),
                            props=jnp.zeros((n, 0)), tags=jnp.arange(n))
    locate, jlocate = pc.make_locator(grid), jpc.make_locator(jgrid)
    dx, _ = pc.particle_rhs(pc.ParticleProps(type="tinia", bcs="stick"), ps,
                            locate, u, u, u)
    assert float(dx.abs().max()) == 0.0
    for typ in ("tracer", "inertia"):
        kw = dict(type=typ, bcs="stick", stokes=0.3, settling=0.2)
        dx, dv = pc.particle_rhs(pc.ParticleProps(**kw), ps, locate, u, u, u)
        jdx, jdv = jpc.particle_rhs(jpc.ParticleProps(**kw), jps, jlocate,
                                    *(jnp.ones(jgrid.shape),) * 3)
        moving = dx if typ == "tracer" else dv
        assert float(moving[0].abs().max()) == 0.0
        assert float(moving[1:, 0].abs().min()) > 0.0
        assert np.array_equal(dx.numpy(), np.asarray(jdx))
        assert np.array_equal(dv.numpy(), np.asarray(jdv))


@pytest.mark.parametrize("kw", [
    {}, {"mode": "hardcoded", "ymean": 0.4}, {"ymean": 0.3, "diam": 0.2},
    {"y_profile": "gauss"}, {"mode": "scalar", "scal_mean": 0.5}])
def test_init_particles_matches_jax(kw):
    """init_particles draws tlab_tpu's NumPy stream in its order: the
    positions equal tlab_tpu's bit for bit, tags 0..n-1."""
    grid, jgrid = _grid()
    if kw.get("y_profile") == "gauss":
        kw = dict(kw, y_profile=lambda y: np.exp(-((y - 0.5) / 0.2) ** 2))
    if kw.get("mode") == "scalar":
        rng = np.random.default_rng(9)
        kw = dict(kw, scal=rng.uniform(0.0, 1.0, grid.shape))
    ps = pc.init_particles(grid, 257, seed=11, device="cpu", **kw)
    jps = jpc.init_particles(jgrid, 257, seed=11, **kw)
    assert np.array_equal(ps.x.numpy(), np.asarray(jps.x))
    assert np.array_equal(ps.tags.numpy(), np.asarray(jps.tags))
    assert ps.props.shape == (257, 0) and float(ps.v.abs().max()) == 0.0


def _inipart_both(tmp_path, text, scal=None):
    """inipart of `text` through both CLIs (float64) into their own
    directories; `scal`: scal.0.<i> files written first. Returns the two
    part.0 files' bytes."""
    out = []
    for name, main, extra in (("jax", jcli.main, ["--cpu", "--x64"]),
                              ("torch", cli.main,
                               ["--device", "cpu", "--x64"])):
        d = tmp_path / name
        d.mkdir()
        (d / "tlab.ini").write_text(text)
        for i, f in enumerate(scal or ()):
            tio.write_field(str(d / f"scal.0.{i + 1}"), f)
        assert main(["inipart", "--ini", str(d / "tlab.ini"), "--outdir",
                     str(d), *extra]) in (0, None)
        out.append((d / "part.0").read_bytes())
    return out


@pytest.mark.parametrize("profile", ["TanhSymmetric", "hardcoded", "scalar"])
def test_inipart_matches_jax(tmp_path, profile):
    """`inipart` of the small case with [Particles] ProfileIniP: part.0
    byte for byte as tlab_tpu's.  TanhSymmetric (examples/particle_shear)
    is read by neither package: both draw the default uniform slab
    (ROADMAP C)."""
    text = SMALL + PARTICLES.format(type="Tracer") \
        + f"ProfileIniP={profile}\n"
    scal = [np.random.default_rng(2).uniform(0, 1, (32, 24, 16))]
    a, b = _inipart_both(tmp_path, text, scal)
    assert a == b
    ps, it = pio.read_particles(str(tmp_path / "torch" / "part.0"),
                                device="cpu")
    assert it == 0 and ps.x.shape == (300, 3) and ps.props.shape == (300, 0)
    if profile == "TanhSymmetric":
        # the default slab: ymean 0.5 of the y scale, width DiamIniP
        y = ps.x[:, 1].numpy()
        y0, ly = 0.0, 1.0
        assert y.min() >= y0 + 0.35 * ly and y.max() <= y0 + 0.65 * ly


def test_inipart_bil_cloud_starts_at_the_local_liquid(tmp_path):
    """BilinearCloudFour on an airwaterlinear two-scalar case: the droplet
    scalars start at the liquid interpolated to each particle, the
    residence clocks at 0, as tlab_tpu's part.0."""
    text = SMALL.replace("Schmidt=1.0", "Schmidt=1.0,1.0") \
        + PARTICLES.format(type="BilinearCloudFour") \
        + "\n[Thermodynamics]\nType=anelastic\nMixture=AirWaterLinear\n" \
          "Parameters=-2.0,0.5,0.1\n"
    rng = np.random.default_rng(3)
    scal = [rng.uniform(0.0, 1.0, (32, 24, 16)) for _ in range(2)]
    a, b = _inipart_both(tmp_path, text, scal)
    # header, tags, positions, velocities byte for byte; the liquid through
    # the softplus-smoothed airwater_linear (logaddexp in each package) to
    # round-off (tests/test_torch_thermo.py holds the function to 1e-10)
    head = 24 + 300 * (8 + 48)
    assert a[:head] == b[:head] and len(a) == len(b)
    assert _rel(np.frombuffer(b[head:]), np.frombuffer(a[head:])) <= 1e-14
    ps, _ = pio.read_particles(str(tmp_path / "torch" / "part.0"),
                               device="cpu")
    assert ps.props.shape == (300, 4)
    assert float(ps.props[:, :2].max()) > 0.0
    assert torch.equal(ps.props[:, 0], ps.props[:, 1])
    assert float(ps.props[:, 2:].abs().max()) == 0.0


@pytest.fixture(scope="module")
def small_pair():
    """Both packages' Simulation of SMALL and tlab_tpu's initial state."""
    jsim = JSimulation.from_case(jload_case(JIni(text=SMALL)))
    tsim = Simulation.from_case(load_case(Ini(text=SMALL)), dtype=F64,
                                device="cpu")
    st = jinitial_state(jsim, seed=7)
    return jsim, tsim, tuple(np.asarray(a) for a in (st.u, st.v, st.w, st.s))


def _in_box(grid, n, seed):
    """n positions uniform in the grid's box."""
    lo = np.array([grid.x.nodes[0], grid.y.nodes[0], grid.z.nodes[0]])
    hi = np.array([grid.x.nodes[0] + grid.x.scale, grid.y.nodes[-1],
                   grid.z.nodes[0] + grid.z.scale])
    return lo + np.random.default_rng(seed).uniform(0, 1, (n, 3)) * (hi - lo)


def _steps(jsim, tsim, start, props_kw, x, n_steps, props_cols=0,
           dt=0.01):
    """n_steps of both packages' particle step from the same state; returns
    the (jax, torch) flow and particle states after each step."""
    u, v, w, s = start
    n = x.shape[0]
    rng = np.random.default_rng(5)
    v0 = 0.1 * rng.standard_normal((n, 3))
    pr = rng.uniform(0, 1, (n, props_cols))
    jst, tst = JState(u=u, v=v, w=w, s=s), state_from_numpy(u, v, w, s,
                                                            "cpu", F64)
    jps = jpc.ParticleState(x=jnp.asarray(x), v=jnp.asarray(v0),
                            props=jnp.asarray(pr), tags=jnp.arange(n))
    tps = pc.ParticleState(x=torch.as_tensor(x), v=torch.as_tensor(v0),
                           props=torch.as_tensor(pr), tags=torch.arange(n))
    jl, tl = jpc.make_locator(jsim.grid), pc.make_locator(tsim.grid)
    jprops = jpc.ParticleProps(**props_kw)
    tprops = pc.ParticleProps(**props_kw)
    out = []
    for _ in range(n_steps):
        jst, jps = jstep(jsim.P, jsim.grid, jl, jprops, jst, jps, dt)
        tst, tps = rk_step_with_particles(tsim.P, tsim.grid, tl, tprops, tst,
                                          tps, dt)
        out.append(((jst, jps), (tst, tps)))
    return out


def _held(pair):
    (jst, jps), (tst, tps) = pair
    errs = {n: _rel(getattr(tst, n).numpy(), getattr(jst, n))
            for n in ("u", "v", "w", "s")}
    errs.update({f"p{n}": _rel(getattr(tps, n).numpy(), getattr(jps, n))
                 for n in ("x", "v")})
    return errs


@pytest.mark.parametrize("props_kw", [
    dict(type="tracer"), dict(type="inertia", stokes=0.2, settling=0.5),
    dict(type="tracer", bcs="stick")])
def test_step_matches_jax(small_pair, props_kw):
    """rk_step_with_particles one step and five from tlab_tpu's initial
    state of the small case, 300 particles (some at a wall for the stick
    BC): the flow and the particles <= 1e-10 of their max."""
    jsim, tsim, start = small_pair
    x = _in_box(tsim.grid, 300, 7)
    x[:5, 1] = tsim.grid.y.nodes[0]
    x[5:10, 1] = tsim.grid.y.nodes[-1]
    pairs = _steps(jsim, tsim, start, props_kw, x, 5)
    for k in (0, 4):
        errs = _held(pairs[k])
        assert max(errs.values()) <= TOL, (k, errs)
    (_, _), (_, tps) = pairs[-1]
    assert float((tps.x[:, 0] - torch.as_tensor(x[:, 0])).abs().max()) > 0
    if props_kw.get("bcs") == "stick":
        assert torch.equal(tps.x[:10], torch.as_tensor(x[:10]))


def test_particle_step_skips_the_clip_as_jax(small_pair):
    """ROADMAP C 28: tlab_tpu's particle step calls its unstacked
    substep_rhs and skips rk_step's scalar clip (and the wall values, the
    surface, the immersed boundary); the port's does the same.  With
    [Control] ScalLimit on and bounds [0.4, 0.6] inside the scalar's range
    [0, 1], the particle step leaves the scalar outside them, equal to
    tlab_tpu's, where the plain step clips."""
    _, _, start = small_pair
    text = SMALL + "\n[Control]\nScalLimit=yes\nMinScalar=0.4\n" \
        "MaxScalar=0.6\n"
    jsim = JSimulation.from_case(jload_case(JIni(text=text)))
    tsim = Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                                device="cpu")
    assert tsim.P.get("scal_bounds") is not None
    pair = _steps(jsim, tsim, start, dict(type="tracer"),
                  _in_box(tsim.grid, 50, 2), 1)[0]
    assert max(_held(pair).values()) <= TOL
    s = pair[1][0].s
    assert float(s.max()) > 0.6 + 0.1 and float(s.min()) < 0.4 - 0.1
    clipped, _ = tdyn.rk_step(tsim.P, state_from_numpy(*start, "cpu", F64),
                              0.01)
    assert float(clipped.s.max()) <= 0.6 and float(clipped.s.min()) >= 0.4


def test_particle_files_match_jax(tmp_path):
    """write_particles / read_particles: the port's file equals tlab_tpu's
    byte for byte for the same state, each package reads the other's."""
    n = 40
    rng = np.random.default_rng(0)
    x, v, pr = rng.uniform(0, 1, (n, 3)), rng.standard_normal((n, 3)), \
        rng.standard_normal((n, 2))
    tags = rng.permutation(n)
    pio.write_particles(str(tmp_path / "t"), pc.ParticleState(
        torch.as_tensor(x), torch.as_tensor(v), torch.as_tensor(pr),
        torch.as_tensor(tags)), 12)
    jpio.write_particles(str(tmp_path / "j"), jpc.ParticleState(
        jnp.asarray(x), jnp.asarray(v), jnp.asarray(pr), jnp.asarray(tags)),
        12)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    ps, it = pio.read_particles(str(tmp_path / "j"), device="cpu")
    assert it == 12 and np.array_equal(ps.x.numpy(), x) \
        and np.array_equal(ps.tags.numpy(), tags)
    f32, _ = pio.read_particles(str(tmp_path / "j"), dtype=torch.float32,
                                device="cpu")
    assert f32.x.dtype == torch.float32 and f32.tags.dtype == torch.int64


@pytest.mark.parametrize("order", ["positional", "reordered"])
def test_trajectories_match_jax(tmp_path, order):
    """TrajectoryAccumulator: the tagged rows gathered on the device (the
    positional identity) and the tag search (reordered slots, a tag
    absent: NaN), flushed to the same npz arrays as tlab_tpu's."""
    n = 30
    rng = np.random.default_rng(1)
    tags = np.arange(n) if order == "positional" \
        else rng.permutation(n + 5)[:n]
    got = {}
    for name, mod, pmod, arr in (("torch", pio, pc, torch.as_tensor),
                                 ("jax", jpio, jpc, jnp.asarray)):
        acc = mod.TrajectoryAccumulator(tag_ids=np.arange(8))
        for it in (1, 2, 3):
            r = np.random.default_rng(it)
            ps = pmod.ParticleState(arr(r.uniform(0, 1, (n, 3))),
                                    arr(r.standard_normal((n, 3))),
                                    arr(np.zeros((n, 0))), arr(tags))
            acc.accumulate(it, 0.1 * it, ps)
        d = tmp_path / name
        d.mkdir()
        acc.flush(str(d))
        got[name] = np.load(d / "trajectories.1-3.npz")
    for k in ("itimes", "rtimes", "x", "v", "tags"):
        assert np.array_equal(got["torch"][k], got["jax"][k],
                              equal_nan=True), k


def test_particle_pdfs_and_assembly(tmp_path):
    """particle_pdfs (counts in the right y slab and value bin, as
    tlab_tpu's), particle_pdf_reference's ASCII file equal to tlab_tpu's,
    assemble_trajectories across restart files."""
    n = 200
    rng = np.random.default_rng(0)
    x = np.column_stack([rng.uniform(0, 1, n), rng.uniform(0, 1, n),
                         rng.uniform(0, 1, n)])
    props = np.where(x[:, 1:2] < 0.5, 0.25, 0.75) * np.ones((1, 2))
    ps = pc.ParticleState(torch.as_tensor(x), torch.zeros(n, 3, dtype=F64),
                          torch.as_tensor(props), torch.arange(n))
    jps = jpc.ParticleState(jnp.asarray(x), jnp.zeros((n, 3)),
                            jnp.asarray(props), jnp.arange(n))
    counts, edges = pio.particle_pdfs(ps, 0, [0.0, 0.5, 1.0], 0.0, 1.0, 4)
    jc, je = jpio.particle_pdfs(jps, 0, [0.0, 0.5, 1.0], 0.0, 1.0, 4)
    assert counts[0, 1] == counts[0].sum() > 0
    assert counts[1, 3] == counts[1].sum() > 0
    assert np.array_equal(counts, jc) and np.array_equal(edges, je)
    grid, jgrid = _grid(16, 17, 8)
    f = np.random.default_rng(3).uniform(0, 1, grid.shape)
    for mod, g, p, fld, loc in (
            (pio, grid, ps, torch.as_tensor(f), pc.make_locator(grid)),
            (jpio, jgrid, jps, jnp.asarray(f), jpc.make_locator(jgrid))):
        mod.particle_pdf_reference(g, p, fld, loc, (0.0, 0.5), 1.0, 0.1,
                                   str(tmp_path / f"pdf_{mod.__name__}"))
    texts = [(tmp_path / f"pdf_{m.__name__}").read_text()
             for m in (pio, jpio)]
    assert texts[0] == texts[1] and len(texts[0].splitlines()) == 10
    for k, it in enumerate([0, 5, 10]):
        pio.write_particles(str(tmp_path / f"part.{it}"), ps._replace(
            x=ps.x + 0.1 * k), it)
    traj, its = pio.assemble_trajectories(str(tmp_path), [0, 5, 10], [3, 7])
    jtraj, _ = jpio.assemble_trajectories(str(tmp_path), [0, 5, 10], [3, 7])
    assert traj.shape == (3, 2, 3) and np.array_equal(traj, jtraj)
    assert np.allclose(traj[2, 0] - traj[0, 0], 0.2)


def _dns_both(tmp_path, text, ptype, n_part=300):
    """dns.run of `text` with particles through both packages from
    tlab_tpu's initial state and the same init_particles draw."""
    jsim = JSimulation.from_case(jload_case(JIni(text=text)))
    tsim = Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                                device="cpu")
    st = jinitial_state(jsim, seed=7)
    start = tuple(np.asarray(a) for a in (st.u, st.v, st.w, st.s))
    runs = {}
    for name, mod, sim, state, pmod in (
            ("jax", jdns, jsim, st, jpc),
            ("torch", tdns, tsim, state_from_numpy(*start, "cpu", F64), pc)):
        d = tmp_path / name
        d.mkdir()
        kw = {} if pmod is jpc else {"device": "cpu"}
        ps = pmod.init_particles(sim.grid, n_part, seed=1, ymean=0.5,
                                 diam=0.3, **kw)
        runs[name] = mod.run(sim, state, outdir=str(d),
                             log_path=str(d / "dns.out"), pstate=ps,
                             particle_props=pmod.props_from_ini(sim.case.ini))
    return runs


def _rows(path):
    return [ln.split() for ln in open(path) if not ln.startswith("#")]


def test_dns_with_particles_matches_jax(tmp_path):
    """dns.run of the small case with 300 tracers, TrajNumber and
    CalculatePDF through both packages: dns.out to every printed digit,
    part.<it> and the trajectories to 1e-10 of the positions' max (the
    tags and the iterations exactly), the particle PDF files equal, the
    final flow <= 1e-10."""
    text = SMALL + PARTICLES.format(type="Tracer")
    runs = _dns_both(tmp_path, text, "tracer")
    J, T = tmp_path / "jax", tmp_path / "torch"
    assert _rows(J / "dns.out") == _rows(T / "dns.out")
    assert runs["torch"].itime == 4 and runs["torch"].pstate is not None
    for it in (2, 4):
        a, _ = pio.read_particles(str(J / f"part.{it}"), device="cpu")
        b, _ = pio.read_particles(str(T / f"part.{it}"), device="cpu")
        assert torch.equal(a.tags, b.tags)
        assert _rel(b.x.numpy(), a.x.numpy()) <= TOL
        assert (J / f"particle_pdf.{it}").read_text() == \
            (T / f"particle_pdf.{it}").read_text()
    for name in ("trajectories.1-2.npz", "trajectories.3-4.npz"):
        a, b = np.load(J / name), np.load(T / name)
        assert np.array_equal(a["itimes"], b["itimes"])
        assert np.array_equal(a["tags"], b["tags"]) and b["x"].shape == \
            (2, 8, 3)
        assert _rel(b["x"], a["x"]) <= TOL
    for n in ("u", "v", "w", "s"):
        assert _rel(getattr(runs["torch"].state, n).numpy(),
                    getattr(runs["jax"].state, n)) <= TOL


def test_cli_dns_engages_particles(tmp_path):
    """ini, inipart and dns of the small case through the port's CLI: the
    particles ride the run only where part.<Start> exists, as tlab_tpu's
    CLI; without it the run is the flow alone."""
    ini = tmp_path / "tlab.ini"
    ini.write_text(SMALL + PARTICLES.format(type="Tracer"))
    common = ["--ini", str(ini), "--outdir", str(tmp_path), "--device",
              "cpu", "--x64", "--steps", "2"]
    assert cli.main(["ini", *common]) == 0
    assert cli.main(["dns", *common]) == 0
    assert not (tmp_path / "part.2").exists()
    assert cli.main(["inipart", *common]) == 0
    assert cli.main(["dns", *common]) == 0
    ps, it = pio.read_particles(str(tmp_path / "part.2"), device="cpu")
    assert it == 2 and ps.x.shape == (300, 3)
    assert (tmp_path / "trajectories.1-2.npz").exists()


def test_particle_refusals(tmp_path, small_pair):
    """What tlab_tpu has no path for stays refused: an unsteady inflow with
    particles (tlab_tpu/tools/dns.py:767).  (Particles on a rank mesh, once
    refused here, run: tests/test_torch_mesh_features.py.)"""
    _, tsim, start = small_pair
    ps = pc.init_particles(tsim.grid, 10, device="cpu")
    state = state_from_numpy(*start, "cpu", F64)
    with pytest.raises(NotImplementedError, match="unsteady inflow"):
        tdns.run(tsim, state, outdir=str(tmp_path), n_steps=1, pstate=ps,
                 particle_props=pc.ParticleProps(), inflow=object())


# the float32 witness: tlab_tpu's particle step in float32 (x64 off, as its
# CLI runs by default) in a subprocess, on the inputs the test writes
_X64_OFF = """
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import jax
jax.config.update("jax_platforms", "cpu")
assert not jax.config.jax_enable_x64
import jax.numpy as jnp
from tlab_tpu.config import Ini, load_case
from tlab_tpu.dycore.state import State
from tlab_tpu.particles import core as pc
from tlab_tpu.particles.stepping import rk_step_with_particles
from tlab_tpu.runtime import Simulation
d = np.load(sys.argv[2])
sim = Simulation.from_case(load_case(Ini(text=str(d["text"]))),
                           dtype=jnp.float32)
f32 = lambda a: jnp.asarray(a, jnp.float32)
st = State(u=f32(d["u"]), v=f32(d["v"]), w=f32(d["w"]), s=f32(d["s"]))
n = d["x"].shape[0]
ps = pc.ParticleState(x=f32(d["x"]), v=jnp.zeros((n, 3), jnp.float32),
                      props=jnp.zeros((n, 0), jnp.float32),
                      tags=jnp.arange(n))
step = jax.jit(lambda st, ps: rk_step_with_particles(
    sim.P, sim.grid, pc.make_locator(sim.grid), pc.ParticleProps(), st, ps,
    float(d["dt"])))
for _ in range(int(d["steps"])):
    st, ps = step(st, ps)
assert ps.x.dtype == jnp.float32
np.save(sys.argv[3], np.asarray(ps.x, np.float64))
"""

WITNESS_STEPS = 5


def test_positions_in_float32_drift_as_tlab_tpus(tmp_path, small_pair):
    """5 steps of dt 0.01 of the small case with 300 tracers in float32
    in both packages against the port's float64: max|x32 - x64| /
    max|x64| of the positions; the port's drift may be no more than 2x
    tlab_tpu's (its CLI default, x64 off).  Printed with pytest -s."""
    jsim, tsim, (u, v, w, s) = small_pair
    x = pc.init_particles(tsim.grid, 300, seed=1, ymean=0.5, diam=0.3,
                          device="cpu").x.numpy()
    dt = 0.01
    out = {}
    for dtype in (torch.float64, torch.float32):
        sim = Simulation.from_case(load_case(Ini(text=SMALL)), dtype=dtype,
                                   device="cpu")
        st = state_from_numpy(u, v, w, s, "cpu", dtype)
        n = x.shape[0]
        ps = pc.ParticleState(torch.as_tensor(x, dtype=dtype),
                              torch.zeros(n, 3, dtype=dtype),
                              torch.zeros(n, 0, dtype=dtype),
                              torch.arange(n))
        for _ in range(WITNESS_STEPS):
            st, ps = rk_step_with_particles(sim.P, sim.grid,
                                            pc.make_locator(sim.grid),
                                            pc.ParticleProps(), st, ps, dt)
        assert ps.x.dtype == dtype
        out[dtype] = ps.x.double().numpy()
    npz = tmp_path / "in.npz"
    np.savez(npz, text=SMALL, u=u, v=v, w=w, s=s, x=x, dt=dt,
             steps=WITNESS_STEPS)
    proc = subprocess.run([sys.executable, "-c", _X64_OFF, str(REPO),
                           str(npz), str(tmp_path / "jax32.npy")],
                          capture_output=True, text=True, timeout=600,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    ref = out[torch.float64]
    port32 = _rel(out[torch.float32], ref)
    jax32 = _rel(np.load(tmp_path / "jax32.npy"), ref)
    print(f"\nfloat32 positions after {WITNESS_STEPS} steps: port "
          f"{port32:.3e}, tlab_tpu {jax32:.3e}")
    assert 0.0 < port32 <= 2.0 * jax32
