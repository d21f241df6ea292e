"""The port's semi-implicit diffusion (tlab_tpu_torch/dycore/implicit.py,
TimeOrder=RungeKuttaDiffusion3) against tlab_tpu's, float64 on the CPU:
the SMR91 step on free-slip walls (the Neumann Helmholtz pencil) and on a
no-slip channel (the Dirichlet one), with a Neumann and a Dirichlet scalar,
with a [ViscChange] factor, a 32x24x32 copy of examples/ekman_mesh through
both command lines, and a diffusion decay at 20 times the explicit limit."""
import os
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from threadpoolctl import threadpool_limits

from test_channel import INI_TEXT as CHANNEL
from tlab_tpu.config import Ini as JIni, load_case as jload_case
from tlab_tpu.dycore import implicit as jimp
from tlab_tpu.dycore.state import State as JState
from tlab_tpu.io import fields_io as jio
from tlab_tpu.runtime import Simulation as JSimulation
from tlab_tpu.stats import averages as javg
from tlab_tpu.tools import cli as jcli
from tlab_tpu.tools.initialize import initial_state as jinitial_state
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.convert import state_from_numpy, state_to_numpy
from tlab_tpu_torch.dycore import implicit as timp
from tlab_tpu_torch.io import fields_io as tio
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.stats import averages as tavg
from tlab_tpu_torch.tools import cli

F64 = torch.float64
TOL = 1e-10
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASE01 = os.path.join(ROOT, "tests", "data", "case01_small3d.ini")
EKMAN = os.path.join(ROOT, "examples", "ekman_mesh", "tlab.ini")

# the test workers share the machine's cores: with every worker's products
# on all of them, the threads spin on each other and a step takes 20x longer
torch.set_num_threads(2)
# the same holds for NumPy's BLAS, which the host plans call many times
# (small inverses and solves, each waking every BLAS thread)
threadpool_limits(1, user_api="blas")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _case(walls: str) -> str:
    """tests/data/case01_small3d.ini at 32x33x16 with the SMR91 scheme,
    velocity walls of kind `walls` and a second scalar on Dirichlet walls
    (scalar 1 keeps its Neumann ones)."""
    with open(CASE01) as fh:
        text = fh.read()
    for old, new in (("TimeOrder=RungeKuttaExplicit4",
                      "TimeOrder=RungeKuttaDiffusion3"),
                     ("Imax=128", "Imax=32"), ("Jmax=64", "Jmax=33"),
                     ("points_1=129", "points_1=33"),
                     ("points_1=64", "points_1=33"),
                     ("VelocityJmin=freeslip", f"VelocityJmin={walls}"),
                     ("VelocityJmax=freeslip", f"VelocityJmax={walls}"),
                     ("Schmidt=1.0", "Schmidt=1.0,0.7"),
                     ("Scalar1Jmax=neumann", "Scalar1Jmax=neumann\n"
                      "Scalar2Jmin=dirichlet\nScalar2Jmax=dirichlet"),
                     ("MeanScalar1=0.5", "MeanScalar1=0.5\n"
                      "ProfileScalar2=Tanh\nThickScalar2=0.05\n"
                      "DeltaScalar2=1.0\nMeanScalar2=0.5")):
        assert old in text
        text = text.replace(old, new, 1)
    return text


def _start(text):
    """Both Simulations of `text` and tlab_tpu's initial state with noise
    (every term of the step exercised)."""
    jsim = JSimulation.from_case(jload_case(JIni(text=text)))
    tsim = Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                                device="cpu")
    u, v, w, s = state_to_numpy(jinitial_state(jsim, seed=3))
    rng = np.random.default_rng(4)
    u, v, w = (a + 0.05 * rng.standard_normal(a.shape) for a in (u, v, w))
    return jsim, tsim, (u, v, w, s)


@pytest.mark.parametrize("walls", ["freeslip", "noslip"])
def test_rk_step_implicit_matches_jax(walls):
    """One SMR91 step and five: every field to 1e-10 of its max, v's wall
    rows exactly 0; the no-slip walls take the Dirichlet pencil."""
    jsim, tsim, (u, v, w, s) = _start(_case(walls))
    P = tsim.P
    wall_plan = timp._plan_for(P, P["wall_bc_types"]["u"])
    assert wall_plan is (P["ell_dd"] if walls == "noslip" else P["ell"])
    assert timp._plan_for(P, P["wall_bc_types"]["s"][1]) is P["ell_dd"]
    assert timp._plan_for(P, P["wall_bc_types"]["s"][0]) is P["ell"]
    sj = JState(u=jnp.asarray(u), v=jnp.asarray(v), w=jnp.asarray(w),
                s=jnp.asarray(s))
    st = state_from_numpy(u, v, w, s, "cpu", F64)
    dt = 2e-3
    for n in range(1, 6):
        sj, pj = jimp.rk_step_implicit(jsim.P, sj, dt)
        st, pt = timp.rk_step_implicit(P, st, dt)
        if n in (1, 5):
            for a, b in zip(st[:4], sj[:4]):
                assert _rel(a, b) <= TOL
            assert _rel(pt, pj) <= TOL
    assert float(st.v[:, (0, -1), :].abs().max()) == 0.0


def test_visc_scale_matches_jax():
    jsim, tsim, (u, v, w, s) = _start(_case("noslip"))
    aux = {"visc_scale": 0.7}
    sj, _ = jimp.rk_step_implicit(
        jsim.P, JState(u=jnp.asarray(u), v=jnp.asarray(v), w=jnp.asarray(w),
                       s=jnp.asarray(s)), 2e-3, aux=aux)
    st, _ = timp.rk_step_implicit(tsim.P,
                                  state_from_numpy(u, v, w, s, "cpu", F64),
                                  2e-3, aux=aux)
    s1, _ = timp.rk_step_implicit(tsim.P,
                                  state_from_numpy(u, v, w, s, "cpu", F64),
                                  2e-3)
    for a, b in zip(st[:4], sj[:4]):
        assert _rel(a, b) <= TOL
    assert _rel(st.u, s1.u) > 1e-6          # the factor acts


def _ekman_text(steps=5):
    """examples/ekman_mesh/tlab.ini at 32x24x32 with the SMR91 scheme (as
    the reference's Ekman cases 85-87 run), without its [Parallel] mesh and
    [SaveTowers]."""
    with open(EKMAN) as fh:
        text = fh.read()
    for section in ("Parallel", "SaveTowers"):
        text, n = re.subn(rf"^\[{section}\]\n[^\[]*", "", text, flags=re.M)
        assert n == 1
    for old, new in (("TimeOrder=RungeKuttaExplicit3",
                      "TimeOrder=RungeKuttaDiffusion3"),
                     ("Imax=128", "Imax=32"), ("Jmax=96", "Jmax=24"),
                     ("Kmax=128", "Kmax=32"), ("End=20", f"End={steps}"),
                     ("Restart=20", f"Restart={steps}"),
                     ("Statistics=10", f"Statistics={steps}")):
        assert old in text
        text = text.replace(old, new)
    return text.replace("points_1=129", "points_1=33").replace(
        "points_1=96", "points_1=24")


def wall_deviation(outdir, it) -> float:
    """max over u and w of |q - ref| on the no-slip Jmin wall of
    flow.<it>.{1,3} in `outdir`, ref the case's mean profiles there
    (tlab_tpu's SMR91 step pins only v on the walls)."""
    from tlab_tpu_torch.runtime import grid_from_case
    case = load_case(os.path.join(str(outdir), "tlab.ini"))
    y0 = np.array([grid_from_case(case).y.nodes[0]])
    return max(float(np.max(np.abs(
        tio.read_field(os.path.join(str(outdir), f"flow.{it}.{i}"))[0][:, 0]
        - case.vel_profiles[k](y0)[0]))) for i, k in ((1, 0), (3, 2)))


def test_ekman_copy_through_both_clis(tmp_path):
    """ini + dns of the Ekman copy through both command lines: dns.out to
    every printed digit (a CFL column at TimeCFL with a diffusion number
    past the explicit RK3 limit), the fields to 1e-10 of their max, the avg
    columns to 1e-8 of theirs, dns.obs to 1e-8."""
    text = _ekman_text()
    outs = {}
    for name, main, extra in (("torch", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, ["--cpu"])):
        out = tmp_path / name
        out.mkdir()
        ini = str(out / "tlab.ini")
        (out / "tlab.ini").write_text(text)
        common = ["--ini", ini, "--outdir", str(out), "--x64", *extra]
        assert main(["ini", *common]) == 0
        assert main(["dns", *common]) == 0
        outs[name] = out
    t, j = outs["torch"], outs["jax"]
    assert (t / "dns.out").read_text() == (j / "dns.out").read_text()
    rows = [r.split() for r in (t / "dns.out").read_text().splitlines()
            if not r.startswith("#")]
    assert all(float(r[4]) == 0.9 for r in rows)            # TimeCFL
    assert max(float(r[5]) for r in rows) > 1.0              # D# > RK3's
    for f in ("flow.5.1", "flow.5.2", "flow.5.3", "scal.5.1"):
        a, b = tio.read_field(str(t / f))[0], jio.read_field(str(j / f))[0]
        assert np.max(np.abs(a - b)) <= TOL * np.max(np.abs(b)), f
    v = tio.read_field(str(t / "flow.5.2"))[0]
    assert np.abs(v[:, (0, -1), :]).max() == 0.0
    # u and w keep what the start and the projection leave on the wall
    assert 0.0 < wall_deviation(t, 5) == pytest.approx(
        wall_deviation(j, 5), rel=TOL)
    for name in ("avg5", "avg5s1"):
        _, gj, cj = javg.read_avg(str(j / name))
        _, gt, ct = tavg.read_avg(str(t / name))
        assert gt == gj and list(ct) == list(cj)
        for n in cj:
            assert np.max(np.abs(cj[n] - ct[n])) <= max(
                1e-8 * np.max(np.abs(cj[n])), 1e-13), (name, n)
    oj = np.loadtxt(str(j / "dns.obs"))
    ot = np.loadtxt(str(t / "dns.obs"))
    assert oj.shape == ot.shape
    assert np.max(np.abs(oj - ot)) <= 1e-8 * np.max(np.abs(oj))


def test_diffusion_decay_large_dt():
    """tests/test_implicit.py's decay on the port: a sin(pi y) mode
    between no-slip walls, 30 steps at 20 times the explicit diffusive
    limit, decays as exp(-nu k^2 t) to 2%."""
    text = CHANNEL.replace("TimeOrder=RungeKuttaExplicit4",
                           "TimeOrder=RungeKuttaDiffusion3")
    sim = Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                               device="cpu")
    nx, ny, nz = sim.grid.shape
    y = sim.grid.y.nodes
    nu = sim.nsp.visc
    sim.P["bodyforce"] = None
    k = np.pi
    u0 = np.broadcast_to(np.sin(k * y)[None, :, None], (nx, ny, nz))
    zero = np.zeros((nx, ny, nz))
    state = state_from_numpy(u0, zero, zero, zero[None], "cpu", F64)
    dy = y[1] - y[0]
    dt = 20 * 0.3 / (nu / dy ** 2)
    n = 30
    for _ in range(n):
        state, _ = timp.rk_step_implicit(sim.P, state, dt)
    decay = np.exp(-nu * k ** 2 * n * dt)
    got = float(state.u[0, ny // 2, 0])
    assert np.isfinite(got)
    assert abs(got - decay) / decay < 0.02, (got, decay)


def test_cli_runs_implicit_from_its_restart(tmp_path):
    """dns picks the SMR91 step from the case file on a restart too: 5
    steps from the Ekman copy's own flow.5 files continue its time."""
    text = _ekman_text()
    out = tmp_path
    (out / "tlab.ini").write_text(text)
    common = ["--ini", str(out / "tlab.ini"), "--outdir", str(out),
              "--device", "cpu", "--x64"]
    assert cli.main(["ini", *common]) == 0
    assert cli.main(["dns", *common]) == 0
    t5 = tio.read_field(str(out / "flow.5.1"))[1][0]
    (out / "tlab.ini").write_text(text.replace("Start=0", "Start=5")
                                  .replace("End=5", "End=7"))
    os.remove(out / "dns.out")
    assert cli.main(["dns", *common]) == 0
    rows = [r.split() for r in (out / "dns.out").read_text().splitlines()
            if not r.startswith("#")]
    assert [int(r[1]) for r in rows] == [5, 6, 7]
    assert abs(float(rows[0][2]) - t5) <= 5e-7      # its 6 printed digits


def test_dirichlet_walls_need_the_dd_pencil():
    """A plan without P["ell_dd"] (an explicit scheme's, or
    build_device_plans alone) refuses the SMR91 step on Dirichlet walls
    instead of solving them with the Neumann pencil, which tlab_tpu's
    fallback does without a word."""
    text = _case("noslip").replace("TimeOrder=RungeKuttaDiffusion3",
                                   "TimeOrder=RungeKuttaExplicit4")
    tsim = Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                                device="cpu")
    assert "ell_dd" not in tsim.P
    u, v, w, s = (np.zeros(tsim.grid.shape),) * 3 + (
        np.zeros((2,) + tsim.grid.shape),)
    with pytest.raises(ValueError, match="ell_dd"):
        timp.rk_step_implicit(tsim.P,
                              state_from_numpy(u, v, w, s, "cpu", F64), 2e-3)


def test_the_kernels_get_contiguous_operands(monkeypatch):
    """The SMR91 stages hand the Burgers term (the CUDA kernels on the card,
    which take contiguous operands only) contiguous fields and velocities,
    though a stage's velocity leaves the inverse FFTs with permuted
    strides."""
    from tlab_tpu_torch.dycore import incompressible as tdyn
    jsim, tsim, (u, v, w, s) = _start(_case("noslip"))
    real = tdyn._burgers_all
    seen = []

    def checked(P, name, axis, fields, conv, nu):
        seen.append(fields.is_contiguous() and conv.is_contiguous())
        return real(P, name, axis, fields, conv, nu)

    monkeypatch.setattr(tdyn, "_burgers_all", checked)
    st, _ = timp.rk_step_implicit(tsim.P,
                                  state_from_numpy(u, v, w, s, "cpu", F64),
                                  2e-3)
    assert len(seen) == 9 and all(seen)
    assert not st.u.is_contiguous()      # what the stages start from


if __name__ == "__main__":
    # the witness of chip_smoke.py's phase 10a: tlab_tpu in float64 on the
    # CPU, inigrid, ini and dns of the case 10a runs (examples/ekman_mesh at
    # 128x96x128 with the SMR91 scheme, 10 steps); prints the no-slip wall's
    # deviation at the start and after the last step.  Run from the root of
    # the repo: PYTHONPATH=. python tests/test_torch_implicit.py (~40 s)
    import tempfile
    import chip_smoke
    with tempfile.TemporaryDirectory() as out:
        text = chip_smoke.edit_case(
            chip_smoke.ekman_smr91_case(chip_smoke.EKMAN_SHAPE,
                                        chip_smoke.SMR91_STEPS),
            {("Iteration", "Restart"): chip_smoke.SMR91_STEPS})
        with open(os.path.join(out, "tlab.ini"), "w") as fh:
            fh.write(text)
        for command in ("inigrid", "ini", "dns"):
            assert jcli.main([command, "--ini", os.path.join(out, "tlab.ini"),
                              "--outdir", out, "--cpu", "--x64"]) == 0
        print(f"no-slip wall |u, w - ref|: start "
              f"{wall_deviation(out, 0):.16e}, step "
              f"{chip_smoke.SMR91_STEPS} "
              f"{wall_deviation(out, chip_smoke.SMR91_STEPS):.16e}")
