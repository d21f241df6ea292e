"""The port's buffer zones, filter sponge and interactive surface BC
(tlab_tpu_torch/dycore/buffer.py, surface_bc_step and their hooks in the
step and in dns.run) against tlab_tpu, float64 on the CPU.

The relaxation profiles are NumPy copies (exact); relax and the sponge
agree to 1e-14, attach_buffer's plane means to 1e-13 (their summation
order), surface_bc_step to 1e-12 on both sides, a step
with each to 1e-10 of max|field|; the Ekman layer of
examples/ekman_mesh/tlab.ini (its [Parallel] mesh and [SaveTowers] taken
out) with a Jmax sponge and an interactive bottom
surface runs at 32x24x32 through both command lines with dns.out and
dns.obs equal in every printed digit."""
import pathlib
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tlab_tpu.config import Ini as JIni, load_case as jload_case
from tlab_tpu.dycore import buffer as jbuf
from tlab_tpu.dycore import incompressible as jdyn
from tlab_tpu.dycore.state import State as JState
from tlab_tpu.ops import filter as jfilter
from tlab_tpu.runtime import Simulation as JSimulation
from tlab_tpu.tools import cli as jcli
from tlab_tpu.tools.initialize import initial_state as jinitial_state
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.convert import (plans_from_jax, state_from_numpy,
                                    state_to_numpy)
from tlab_tpu_torch.dycore import buffer as tbuf
from tlab_tpu_torch.dycore import incompressible as tdyn
from tlab_tpu_torch.ops import filter as tfilter
from tlab_tpu_torch.io import fields_io as tio
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.stats import averages as tavg
from tlab_tpu_torch.tools import cli

REPO = pathlib.Path(__file__).resolve().parent.parent
EKMAN = REPO / "examples" / "ekman_mesh" / "tlab.ini"
F64 = torch.float64
TOL = 1e-10

torch.set_num_threads(2)


def _rel(a, b):
    """max|a - b| / max|b| (max|a - b| where b is all zero)."""
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) or 1.0)


def _t(a):
    return torch.as_tensor(np.array(a, np.float64))


def edit(text: str, changes: dict) -> str:
    """The case file's text with {(section, key): value} set: a key the
    section has is changed, another is added at its head."""
    for (section, key), value in changes.items():
        pat = re.compile(rf"(\[{section}\][^\[]*?^{key}=)[^\n]*",
                         re.M | re.S)
        text, n = pat.subn(rf"\g<1>{value}", text)
        if not n:
            text = text.replace(f"[{section}]\n",
                                f"[{section}]\n{key}={value}\n", 1)
    return text


def ekman_case(shape=(32, 24, 32), points_jmax=4, steps=4) -> str:
    """examples/ekman_mesh/tlab.ini without its device mesh and towers, at
    `shape`, with a Jmax sponge of `points_jmax` points and scalar 1 on
    Dirichlet walls with a linear profile, noise in a layer on the bottom
    wall and an interactive bottom surface (the case of chip_smoke.py 9b,
    cut in size)."""
    text = EKMAN.read_text()
    for section in ("Parallel", "SaveTowers"):
        text, n = re.subn(rf"^\[{section}\]\n[^\[]*", "", text, flags=re.M)
        assert n == 1
    nx, ny, nz = shape
    return edit(text, {
        ("Grid", "Imax"): nx, ("Grid", "Jmax"): ny, ("Grid", "Kmax"): nz,
        ("IniGridOx", "points_1"): nx + 1, ("IniGridOy", "points_1"): ny,
        ("IniGridOz", "points_1"): nz + 1,
        ("Iteration", "End"): steps, ("Iteration", "Restart"): steps,
        ("Iteration", "Statistics"): steps // 2,
        ("BufferZone", "PointsJmax"): points_jmax,
        ("Scalar", "ProfileScalar1"): "Linear",
        ("Scalar", "MeanScalar1"): 0.5,
        ("Scalar", "DeltaScalar1"): -0.5,
        ("Scalar", "ThickScalar1"): 0.2,
        ("BoundaryConditions", "Scalar1Jmin"): "dirichlet",
        ("BoundaryConditions", "Scalar1Jmax"): "dirichlet",
        ("BoundaryConditions", "Scalar1SfcTypeJmin"): "linear",
        ("BoundaryConditions", "Scalar1CouplingJmin"): 0.5,
        # broadband noise in a layer on the bottom wall: a flux anomaly
        ("IniFields", "Scalar"): "LayerBroadband",
        ("IniFields", "ProfileIniS"): "Gaussian",
        ("IniFields", "ThickIniS"): 0.01,
        ("IniFields", "YMeanRelativeIniS"): 0.0,
        ("IniFields", "NormalizeS"): 0.01})


SPECS = [jbuf.BufferSpec(type="relaxation", points_jmin=6, points_jmax=9,
                         strength=1.5, sigma=2.0),
         jbuf.BufferSpec(type="both", points_imin=8, points_imax=12,
                         strength=2.0, sigma=3.0),
         jbuf.BufferSpec(type="relaxation", points_jmax=1, points_imin=1)]


@pytest.mark.parametrize("spec", SPECS)
def test_tau_profiles_equal_the_copy(spec):
    y = np.cumsum(np.linspace(0.01, 0.05, 24))
    x = np.arange(40) * 0.1
    tspec = tbuf.BufferSpec(**spec.__dict__)
    assert np.array_equal(tbuf.tau_profile(y, tspec),
                          jbuf.tau_profile(y, spec))
    assert np.array_equal(tbuf.tau_profile_x(x, tspec),
                          jbuf.tau_profile_x(x, spec))
    for pts in ((0, 12), (8, 0), (8, 12)):
        want = np.asarray(jbuf.filter_sponge_amp(x, *pts))
        got = tbuf.filter_sponge_amp(x, *pts, dtype=F64, device="cpu")
        assert np.array_equal(got.numpy(), want)


def _both(text):
    return (JSimulation.from_case(jload_case(JIni(text=text))),
            Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                                 device="cpu"))


@pytest.fixture(scope="module")
def ekman():
    """Both packages' simulations of the reduced Ekman case and a noisy
    start (the reference's own initial state plus noise in the scalar)."""
    text = ekman_case()
    jsim, tsim = _both(text)
    st = jinitial_state(jsim, seed=2)
    rng = np.random.default_rng(2)
    ny = jsim.grid.shape[1]
    env = np.sin(np.pi * np.linspace(0.0, 1.0, ny))[None, :, None]
    s = np.asarray(st.s) + 0.02 * env * rng.standard_normal(st.s.shape)
    start = (np.asarray(st.u), np.asarray(st.v), np.asarray(st.w), s)
    return text, jsim, tsim, start


def test_attach_buffer_and_relax_match(ekman):
    text, jsim, tsim, start = ekman
    jsim.attach_buffer(JState(*(jnp.asarray(a) for a in start)))
    tsim.attach_buffer(state_from_numpy(*start, "cpu", F64))
    bj, bt = jsim.P["buffer"], tsim.P["buffer"]
    assert sorted(bj) == sorted(bt) == ["refs", "tau"]
    assert np.array_equal(bt["tau"].numpy(), np.asarray(bj["tau"]))
    assert tbuf.tau_profile(tsim.grid.y.nodes, tsim.case.buffer)[
        :-4].max() == 0.0                  # 0 below the strip
    assert sorted(bt["refs"]) == sorted(bj["refs"])
    for k in bj["refs"]:
        # plane means of O(1) fields (v's is round-off) in another
        # summation order than XLA's: 2.4e-14 measured
        assert np.max(np.abs(bt["refs"][k].numpy()
                             - np.asarray(bj["refs"][k]))) <= 1e-13
    rng = np.random.default_rng(5)
    for k in ("u", "w", "s0"):
        q = rng.standard_normal(jsim.grid.shape)
        h = rng.standard_normal(jsim.grid.shape)
        want = jbuf.relax(bj, k, jnp.asarray(q), jnp.asarray(h))
        got = tbuf.relax(bt, k, _t(q), _t(h))
        assert _rel(got, want) <= 1e-14 and _rel(got, h) > 1e-6
    assert tsim.filter_sponge is None


def test_spatial_buffer_strips_match():
    """attach_buffer in spatial mode: the Imin/Imax strips relax toward the
    inflow plane, and Type=both adds the filter sponge."""
    from test_torch_spatial import SPATIAL_JET, jet_start
    text = SPATIAL_JET.replace("Type=relaxation", "Type=both")
    jsim, tsim = _both(text)
    start = jet_start(jsim)
    jsim.attach_buffer(JState(*(jnp.asarray(a) for a in start)))
    tsim.attach_buffer(state_from_numpy(*start, "cpu", F64))
    bj, bt = jsim.P["buffer"], tsim.P["buffer"]
    assert sorted(bt) == sorted(bj) == ["refs_x", "tau_x"]   # no Jmin/Jmax
    assert np.array_equal(bt["tau_x"].numpy(), np.asarray(bj["tau_x"]))
    for key in ("refs_x",):
        for k in bj[key]:
            assert np.max(np.abs(bt[key][k].numpy()
                                 - np.asarray(bj[key][k]))) <= 1e-14
    amp_j, mats_j = jsim.filter_sponge
    amp_t, mats_t = tsim.filter_sponge
    assert np.array_equal(amp_t.numpy(), np.asarray(amp_j))
    amp = amp_t.numpy().ravel()
    assert amp[len(amp) // 2] == 0.0 and amp[-1] > 0.9


def test_filter_sponge_blend_matches(ekman):
    text, jsim, tsim, start = ekman
    x = tsim.grid.x.nodes
    amp_j = jbuf.filter_sponge_amp(x, 6, 8)
    amp_t = tbuf.filter_sponge_amp(x, 6, 8, dtype=F64, device="cpu")
    mats_j = jfilter.build_filter_matrices(
        jsim.fdm, jfilter.FilterSpec(type="explicit6"), jnp.float64)
    mats_t = tfilter.build_filter_matrices(
        tsim.fdm, tfilter.FilterSpec(type="explicit6"), F64, "cpu")
    want = jbuf.apply_filter_sponge(amp_j, mats_j,
                                    JState(*(jnp.asarray(a) for a in start)))
    got = tbuf.apply_filter_sponge(amp_t, mats_t,
                                   state_from_numpy(*start, "cpu", F64))
    for a, b in zip(state_to_numpy(got), state_to_numpy(want)):
        assert _rel(a, b) <= 1e-14
    # the blend is the state outside the strips
    mid = len(x) // 2
    assert np.array_equal(state_to_numpy(got)[0][mid], start[0][mid])


SURFACE_INI = """
[Main]
Type=temporal
Equations=incompressible
SpaceOrder=CompactJacobian6
TimeOrder=RungeKuttaExplicit3
TimeCFL=0.8
[Control]
ScalLimit=no
[Parameters]
Reynolds=100
Schmidt=1.0
[Flow]
ProfileVelocityX=none
[Scalar]
ProfileScalar1=Linear
ThickScalar1=1.0
DeltaScalar1=1.0
[BoundaryConditions]
VelocityJmin=noslip
VelocityJmax=noslip
Scalar1Jmin=dirichlet
Scalar1Jmax=dirichlet
Scalar1SfcTypeJmin=linear
Scalar1CouplingJmin=0.5
Scalar1SfcTypeJmax=linear
Scalar1CouplingJmax=0.25
[IniGridOx]
periodic=yes
segments=1
points_1=32
scales_1=2.0
[IniGridOy]
periodic=no
segments=1
points_1=33
scales_1=1.0
opts_1=uniform
[IniGridOz]
periodic=yes
segments=1
points_1=8
scales_1=1.0
"""


def _surface_start(sim):
    """tests/test_cases.py:470-476's scalar: an x-varying near-wall
    gradient, so the flux has an anomaly at both walls."""
    nx, ny, nz = sim.grid.shape
    y = sim.grid.y.nodes
    x = sim.grid.x.nodes[:, None, None]
    s0 = (y[None, :, None] * (1.0 + 0.3 * np.cos(2 * np.pi * x / 2.0))
          * np.ones((1, 1, nz)))
    z = np.zeros((nx, ny, nz))
    return z, z, z, s0[None]


@pytest.mark.parametrize("sides", ["jmin", "jmax", "both"])
def test_surface_bc_step_matches(sides):
    """surface_bc_step on test_cases.py's interactive-surface case, with
    the coupling on one side or both: the new wall values and the surface
    state to 1e-12; then one RK3 step and five from it to 1e-10."""
    text = SURFACE_INI
    if sides == "jmin":
        text = text.replace("Scalar1SfcTypeJmax=linear\n", "")
    elif sides == "jmax":
        text = text.replace("Scalar1SfcTypeJmin=linear\n", "")
    jsim, tsim = _both(text)
    assert tsim.P["surface_bc"] == jsim.P["surface_bc"]
    u, v, w, s = _surface_start(jsim)
    rng = np.random.default_rng(3)
    s_new = s + 1e-3 * rng.standard_normal(s.shape)
    sfc = 1e-2 * rng.standard_normal((2, 1, s.shape[1], s.shape[3]))
    want = jdyn.surface_bc_step(jsim.P, jnp.asarray(s), jnp.asarray(s_new),
                                jnp.asarray(sfc), 1e-3)
    got = tdyn.surface_bc_step(tsim.P, _t(s), _t(s_new), _t(sfc), 1e-3)
    for a, b in zip(got, want):
        assert np.max(np.abs(a.numpy() - np.asarray(b))) <= \
            1e-12 * np.max(np.abs(np.asarray(b)))
    assert not np.array_equal(got[1].numpy(), sfc)
    sj = JState(u=jnp.asarray(u), v=jnp.asarray(v), w=jnp.asarray(w),
                s=jnp.asarray(s))
    st = state_from_numpy(u, v, w, s, "cpu", F64)
    carried = plans_from_jax(jsim.P, "cpu", F64)
    sc = st
    for i in range(5):
        sj, _ = jdyn.rk_step(jsim.P, sj, 1e-3, unroll=True)
        st, _ = tdyn.rk_step(tsim.P, st, 1e-3)
        sc, _ = tdyn.rk_step(carried, sc, 1e-3)
        if i in (0, 4):
            for a, b, c in zip(state_to_numpy(st, sfc=True),
                               state_to_numpy(sj, sfc=True),
                               state_to_numpy(sc, sfc=True)):
                assert _rel(a, b) <= TOL and _rel(c, b) <= TOL, i
    wall0 = s[0, :, 0, :]
    moved = state_to_numpy(st)[3][0, :, 0, :] - wall0
    if sides != "jmax":
        assert np.abs(moved).max() > 0.0
        # only the anomaly couples: the plane mean stays
        assert abs(moved.mean()) <= 1e-12 * np.abs(moved).max()


def test_ekman_steps_match(ekman):
    """One RK3 step and five of the Ekman case with its sponge (references
    from the start) and the interactive surface, through from_case plans
    and through the plan carried from tlab_tpu."""
    text, jsim, tsim, start = ekman
    jsim.attach_buffer(JState(*(jnp.asarray(a) for a in start)))
    tsim.attach_buffer(state_from_numpy(*start, "cpu", F64))
    carried = plans_from_jax(jsim.P, "cpu", F64,
                             bodyforce=tsim.P["bodyforce"])
    assert sorted(carried["buffer"]) == ["refs", "tau"]
    sj = JState(*(jnp.asarray(a) for a in start))
    st = state_from_numpy(*start, "cpu", F64)
    sc = st
    for i in range(5):
        sj, _ = jdyn.rk_step(jsim.P, sj, 2e-3, unroll=True)
        st, _ = tdyn.rk_step(tsim.P, st, 2e-3)
        sc, _ = tdyn.rk_step(carried, sc, 2e-3)
        if i in (0, 4):
            for a, b, c in zip(state_to_numpy(st, sfc=True),
                               state_to_numpy(sj, sfc=True),
                               state_to_numpy(sc, sfc=True)):
                assert _rel(a, b) <= TOL and _rel(c, b) <= TOL, i


def test_loop_creates_the_surface_state(ekman):
    """rk_loop_stacked starts a missing surface state at zero and pins the
    walls each step, as tlab_tpu's loop of rk_step does (its own loop
    needs state.sfc set: it is given zeros here)."""
    text, jsim, tsim, start = ekman
    sfc0 = np.zeros((2, 1, start[0].shape[0], start[0].shape[2]))
    sj = JState(*(jnp.asarray(a) for a in start), sfc=jnp.asarray(sfc0))
    sj, _ = jdyn.rk_loop_stacked(jsim.P, sj, 2e-3, 3)
    st, _ = tdyn.rk_loop_stacked(tsim.P, state_from_numpy(*start, "cpu",
                                                          F64), 2e-3, 3)
    assert st.sfc is not None
    for a, b in zip(state_to_numpy(st, sfc=True),
                    state_to_numpy(sj, sfc=True)):
        assert _rel(a, b) <= TOL


def test_ekman_case_through_both_clis(tmp_path):
    """inigrid, ini and dns (4 steps) of the reduced Ekman case through
    both command lines: dns.out and dns.obs in every printed digit, the
    restart fields to 1e-10, the avg files to their printed digits."""
    text = ekman_case()
    dirs = {}
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        ini = str(d / "tlab.ini")
        (d / "tlab.ini").write_text(text)
        for command in ("inigrid", "ini", "dns"):
            if pkg == "jax":
                rc = jcli.main([command, "--ini", ini, "--outdir", str(d),
                                "--cpu", "--x64"])
            else:
                rc = cli.main([command, "--ini", ini, "--outdir", str(d),
                               "--device", "cpu", "--x64"])
            assert rc == 0, (pkg, command)
        dirs[pkg] = d
    dj, dt = dirs["jax"], dirs["port"]
    for name in ("dns.out", "dns.obs"):
        lj = (dj / name).read_text().splitlines()
        lt = (dt / name).read_text().splitlines()
        assert lt == lj and len(lt) >= 4, name
    got = tio.read_state(str(dt / "flow"), str(dt / "scal"), 4, 1)
    want = tio.read_state(str(dj / "flow"), str(dj / "scal"), 4, 1)
    for a, b in zip(got[:4], want[:4]):
        assert _rel(a, b) <= TOL
    for name in ("avg2", "avg4", "avg4s1"):
        _, gj, cj = tavg.read_avg(str(dj / name))
        _, gt, ct = tavg.read_avg(str(dt / name))
        assert gj == gt and list(cj) == list(ct)
        for k in cj:
            assert np.max(np.abs(ct[k] - cj[k])) <= max(
                1e-8 * np.max(np.abs(cj[k])), 1e-13), (name, k)
