"""The port's spatial mode (the Imin/Imax buffer strips, the filter sponge,
dycore/inflow.py's unsteady inflow and stats/spatial.py's station
statistics in dns.run) against tlab_tpu, float64 on the CPU.

The inflow planes equal tlab_tpu's exactly (box sequence, adaptation ramp,
y-centring); the spatial jet of tests/test_cases.py runs 10 steps through
both packages' dns.run with relaxation strips, with an inflow box and with
Type=both, dns.out equal in every printed digit and the final state to
1e-10 of max|field|; the running (z, t) sums of the same fields agree to
1e-12 (those of the two runs to 1e-10) and the station budget files
(avg_zt<it>) to their printed digits."""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from test_cases import SPATIAL_JET
from tlab_tpu.config import Ini as JIni, load_case as jload_case
from tlab_tpu.dycore import inflow as jinflow
from tlab_tpu.dycore.state import State as JState
from tlab_tpu.ops import elliptic as jelliptic
from tlab_tpu.runtime import Simulation as JSimulation
from tlab_tpu.stats.spatial import SpatialStats as JSpatialStats
from tlab_tpu.tools import dns as jdns
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.convert import state_from_numpy, state_to_numpy
from tlab_tpu_torch.dycore import inflow as tinflow
from tlab_tpu_torch.io import fields_io as tio
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.stats.spatial import SpatialStats, state_fields
from tlab_tpu_torch.tools import dns as tdns

F64 = torch.float64
TOL = 1e-10

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) or 1.0)


def jet_start(sim):
    """tests/test_cases.py's start: the co-flow + Bickley jet broadcast in
    x and z, v = w = 0, the Gaussian scalar."""
    nx, ny, nz = sim.grid.shape
    y = sim.grid.y.nodes
    prof = sim.case.vel_profiles[0](y)
    u = np.broadcast_to(prof[None, :, None], (nx, ny, nz)).copy()
    s = np.broadcast_to(sim.case.scal_profiles[0](y)[None, :, None],
                        (nx, ny, nz))[None].copy()
    z = np.zeros((nx, ny, nz))
    return u, z, z.copy(), s


def jet_box(sim, nbox=32, amp=0.03):
    """tests/test_cases.py:362-375's inflow box: the jet's u and scalar,
    v = amp g(y) sin(2 pi i / nbox) Taylor-swept past the inlet."""
    ny = sim.grid.shape[1]
    y = sim.grid.y.nodes
    prof = sim.case.vel_profiles[0](y)
    g = np.exp(-((y - y[ny // 2]) / 0.2) ** 2)
    phases = np.sin(2 * np.pi * np.arange(nbox) / nbox)
    return {
        "u": np.broadcast_to(prof[None, :], (nbox, ny)).copy(),
        "v": amp * phases[:, None] * g[None, :],
        "w": np.zeros((nbox, ny)),
        "s0": np.broadcast_to(sim.case.scal_profiles[0](y)[None, :],
                              (nbox, ny)).copy(),
    }


BOXES = {
    "plain": dict(adapt=0.0, seq=False, ny=None),
    "ramp": dict(adapt=0.7, seq=False, ny=None),
    "sequence": dict(adapt=0.0, seq=True, ny=None),
    "centred": dict(adapt=0.3, seq=True, ny=15),
}


@pytest.mark.parametrize("kind", list(BOXES))
def test_refs_at_equals_jax(kind):
    """InflowBox.refs_at at times across the sweep, the ramp and the box
    sequence, 2-D (ny) and 3-D (ny, nz) boxes, y-centred into a larger
    plane: exactly tlab_tpu's numbers."""
    opt = BOXES[kind]
    rng = np.random.default_rng(1)
    fields = {"u": rng.standard_normal((12, 11)),
              "v": rng.standard_normal((12, 11, 5))}
    boxes = [fields, {k: 2.0 * v for k, v in fields.items()},
             {k: -v for k, v in fields.items()}] if opt["seq"] else None
    jb = jinflow.InflowBox(fields=fields, u_convect=0.8, lx=1.5,
                           adapt=opt["adapt"], boxes=boxes)
    tb = tinflow.InflowBox(fields=fields, u_convect=0.8, lx=1.5,
                           adapt=opt["adapt"], boxes=boxes)
    for t in (0.0, 0.13, 0.5, 1.9, 4.4, 7.77):
        want = jb.refs_at(t, dtype=jnp.float64, ny=opt["ny"])
        got = tb.refs_at(t, dtype=F64, ny=opt["ny"], device="cpu")
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), t


def test_boxes_from_a_state_and_from_restart_files(tmp_path):
    rng = np.random.default_rng(2)
    u, v, w = (rng.standard_normal((8, 6, 4)) for _ in range(3))
    s = rng.standard_normal((2, 8, 6, 4))
    st = state_from_numpy(u, v, w, s, "cpu", F64)
    sj = JState(*(jnp.asarray(a) for a in (u, v, w, s)))
    for z_mean in (False, True):
        got = tinflow.from_temporal_snapshot(st, 1.0, 2.0, 0.5, z_mean)
        want = jinflow.from_temporal_snapshot(sj, 1.0, 2.0, 0.5, z_mean)
        assert sorted(got.fields) == sorted(want.fields)
        for k in want.fields:
            assert np.array_equal(got.fields[k], np.asarray(want.fields[k]))
    for it in (3, 7):
        tio.write_state(str(tmp_path / "flow"), str(tmp_path / "scal"), it,
                        st, 0.1 * it, 1e-3)
    for its in (3, [3, 7]):
        got = tinflow.from_restart_files(str(tmp_path / "flow"),
                                         str(tmp_path / "scal"), its, 2,
                                         1.0, 2.0)
        want = jinflow.from_restart_files(str(tmp_path / "flow"),
                                          str(tmp_path / "scal"), its, 2,
                                          1.0, 2.0)
        assert (got.boxes is None) == (want.boxes is None)
        for t in (0.0, 1.3, 2.9):
            a = got.refs_at(t, device="cpu")
            b = want.refs_at(t)
            for k in b:
                assert np.array_equal(a[k].numpy(), np.asarray(b[k]))


def test_spatial_sums_match():
    """accumulate_device of the same fields, gradients and pressure: the
    sums to 1e-12 of their max, and the derived tables alike."""
    rng = np.random.default_rng(3)
    shape = (10, 7, 6)
    names = ["u", "v", "w", "s1", "s2"]
    jst = JSpatialStats.create(10, 7, names)
    tst = SpatialStats.create(10, 7, names)
    for _ in range(3):
        f = {n: rng.standard_normal(shape) for n in names}
        g = {n: rng.standard_normal(shape) for n in SpatialStats.GRAD_NAMES}
        p = rng.standard_normal(shape)
        jst.accumulate_device({k: jnp.asarray(v) for k, v in f.items()},
                              grads={k: jnp.asarray(v) for k, v in g.items()},
                              p=jnp.asarray(p))
        tst.accumulate_device({k: torch.from_numpy(v) for k, v in f.items()},
                              grads={k: torch.from_numpy(v)
                                     for k, v in g.items()},
                              p=torch.from_numpy(p))
    assert tst.n_samples == jst.n_samples == 3
    for key in ("sums", "pair_sums", "grad_sums", "gradx_sums", "p_sums",
                "triple_sums"):
        assert _rel(getattr(tst, key), getattr(jst, key)) <= 1e-12, key
    d1 = rng.standard_normal((7, 7))
    dx = rng.standard_normal((10, 10))
    stations = [2, 5, 8]
    for got, want in (
            (tst.station_table(None, None, stations),
             jst.station_table(None, None, stations)),
            (tst.reduce_station_table(stations, 1e-3, d1y=d1),
             jst.reduce_station_table(stations, 1e-3, d1y=d1)),
            (tst.station_budgets(stations, 1e-3, d1x=dx, d1y=d1),
             jst.station_budgets(stations, 1e-3, d1x=dx, d1y=d1))):
        assert sorted(got) == sorted(want)
        for ix in want:
            assert list(got[ix]) == list(want[ix])
            for k in want[ix]:
                assert _rel(got[ix][k], want[ix][k]) <= 1e-10, (ix, k)


CASES = {
    "relaxation": (SPATIAL_JET, False),
    "inflow": (SPATIAL_JET, True),
    "both": (SPATIAL_JET.replace("Type=relaxation", "Type=both"), False),
}


def _jet_text(text):
    """10 steps, a restart (and st<it>.npz) at 10, station budgets at 5
    and 10."""
    return (text.replace("End=60", "End=10").replace("Restart=60",
                                                     "Restart=10")
            .replace("Statistics=0", "Statistics=5"))


def _same_log(path_j, path_t):
    """dns.out in every printed digit, but where the dilatation is
    round-off: the jet starts divergence-free, so its start row's DilMin
    and DilMax (~5e-15) are the summation order's, held to 1e-13."""
    lj = path_j.read_text().splitlines()
    lt = path_t.read_text().splitlines()
    assert len(lt) == len(lj) and lt[:3] == lj[:3]
    for a, b in zip(lj[3:], lt[3:]):
        a, b = a.split(), b.split()
        assert a[:7] == b[:7]
        for x, y in zip(a[7:], b[7:]):
            x, y = float(x), float(y)
            assert x == y or max(abs(x), abs(y)) < 1e-13


@pytest.mark.parametrize("case", list(CASES))
def test_spatial_jet_runs_as_jax(tmp_path, case):
    """The spatial jet through both packages' dns.run: dns.out in every
    printed digit, the final state and st10.npz's sums to 1e-10, the
    avg_zt5/avg_zt10 station files to their printed digits."""
    text, with_inflow = CASES[case]
    text = _jet_text(text)
    jsim = JSimulation.from_case(jload_case(JIni(text=text)))
    tsim = Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                                device="cpu")
    start = jet_start(jsim)
    runs = {}
    for pkg, mod, sim, state in (
            ("jax", jdns, jsim, JState(*(jnp.asarray(a) for a in start))),
            ("port", tdns, tsim, state_from_numpy(*start, "cpu", F64))):
        out = tmp_path / pkg
        out.mkdir()
        kw = {}
        if with_inflow:
            cls = jinflow.InflowBox if pkg == "jax" else tinflow.InflowBox
            kw["inflow"] = cls(fields=jet_box(jsim), u_convect=1.0, lx=2.0)
        runs[pkg] = mod.run(sim, state, outdir=str(out), n_steps=10,
                            log_path=str(out / "dns.out"), **kw)
    dj, dt = tmp_path / "jax", tmp_path / "port"
    _same_log(dj / "dns.out", dt / "dns.out")
    for a, b in zip(state_to_numpy(runs["port"].state),
                    state_to_numpy(runs["jax"].state)):
        assert _rel(a, b) <= TOL
    ss_t = SpatialStats.load(str(dt / "st10.npz"))
    ss_j = JSpatialStats.load(str(dj / "st10.npz"))
    assert ss_t.n_samples == ss_j.n_samples == 10
    assert ss_t.names == ss_j.names and ss_t.pairs == ss_j.pairs
    for key in ("sums", "pair_sums", "grad_sums", "gradx_sums", "p_sums",
                "triple_sums"):     # sums of states that agree to 1e-13
        assert _rel(getattr(ss_t, key), getattr(ss_j, key)) <= TOL, key
    for name in ("avg_zt5", "avg_zt10"):
        lj = (dj / name).read_text().splitlines()
        lt = (dt / name).read_text().splitlines()
        assert lt[:3] == lj[:3] and len(lt) == len(lj)
        vj = np.array([[float(x) for x in ln.split()] for ln in lj[3:]])
        vt = np.array([[float(x) for x in ln.split()] for ln in lt[3:]])
        # 9 printed digits of each column (round-off of budgets that
        # cancel to ~0 in a laminar jet: 1e-13 absolute)
        scale = np.max(np.abs(vj), axis=0)
        assert np.all(np.abs(vt - vj) <= np.maximum(1e-8 * scale, 1e-13))
    if with_inflow:
        v_in = state_to_numpy(runs["port"].state)[1][:10, :, 0]
        assert np.max(np.abs(v_in)) > 1e-6
    if case == "both":
        amp = tsim.filter_sponge[0].numpy().ravel()
        assert amp[len(amp) // 2] == 0.0 and amp[-1] > 0.9


def test_state_fields_names():
    st = state_from_numpy(*(np.zeros((2, 3, 4)),) * 3,
                          np.zeros((2, 2, 3, 4)), "cpu", F64)
    assert list(state_fields(st)) == ["u", "v", "w", "s1", "s2"]


def test_non_periodic_x_is_refused_with_what_jax_does():
    """A spatial case with non-periodic x: tlab_tpu builds no factorized
    plan and gives its eigen plan lam_x = 0 for every x mode; the port
    refuses it and says so."""
    text = SPATIAL_JET.replace("[IniGridOx]\nperiodic=yes",
                               "[IniGridOx]\nperiodic=no") \
        + "[Grid]\nXPeriodic=no\n"
    jsim = JSimulation.from_case(jload_case(JIni(text=text)))
    assert not jsim.grid.x.periodic and "ell_fac" not in jsim.P
    plan = jelliptic.build_elliptic_plan(jsim.fdm)
    assert plan.lam_x.shape == (1,) and plan.lam_x[0] == 0.0
    with pytest.raises(NotImplementedError, match="lam_x = 0"):
        Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                             device="cpu")


# the compressible spatial mode: the density-weighted (Favre) families and
# the MA_* registers (make_comp_spatial_reducer, accumulate_comp_stack,
# favre_station_table, register_station_table; tlab_tpu/stats/spatial.py
# :465-767), against tlab_tpu's on the same states

def _comp_spatial_text(kind="ideal", steps=4, shape=(32, 24, 8)):
    """A compressible case with Type=spatial: tests/data/
    case02_small3d.ini (the ideal gas, or its unidecomp mixture) or
    case14_small3d.ini (AirWater) at `shape`, `steps` steps, statistics
    and the restart file at the last."""
    import os
    import re
    data = os.path.join(os.path.dirname(__file__), "data")
    name = "case14_small3d.ini" if kind == "airwater" \
        else "case02_small3d.ini"
    with open(os.path.join(data, name)) as fh:
        text = fh.read()
    nx, ny, nz = shape
    for section, key, value in (
            ("Main", "Type", "spatial"), ("Iteration", "End", steps),
            ("Iteration", "Restart", steps),
            ("Iteration", "Statistics", steps),
            ("Grid", "Imax", nx), ("Grid", "Jmax", ny), ("Grid", "Kmax", nz),
            ("IniGridOx", "points_1", nx + 1),
            ("IniGridOy", "points_1", ny),
            ("IniGridOz", "points_1", nz + 1)):
        text, n = re.subn(rf"(\[{section}\][^\[]*?^{key}=)[^\n]*",
                          rf"\g<1>{value}", text, flags=re.M | re.S)
        assert n == 1, (section, key)
    if kind == "mixture":
        text = text.replace("[Flow]", "[Thermodynamics]\nMixture=unidecomp\n"
                                      "[Flow]", 1)
    return text


def _comp_sims(text):
    return (JSimulation.from_case(jload_case(JIni(text=text))),
            Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                                 device="cpu"))


def _comp_states(jsim, n=2):
    """n seeded perturbations of the case's initial state (a velocity of
    ~0.1, density and energy of ~1%: a pressure that varies, whose
    derivatives are not round-off), as tlab_tpu's CompState."""
    from tlab_tpu.dycore import compressible as jcomp
    from tlab_tpu.tools.initialize import compressible_initial_state
    U0 = compressible_initial_state(jsim, seed=1)
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        arrs = [np.array(a) for a in U0]
        shape = arrs[0].shape
        for i in (1, 2, 3):
            arrs[i] = arrs[i] + 0.1 * arrs[0] * rng.standard_normal(shape)
        for i in (0, 4):
            arrs[i] = arrs[i] * (1.0 + 0.01 * rng.standard_normal(shape))
        out.append(jcomp.CompState(*(jnp.asarray(a) for a in arrs)))
    return out


@pytest.mark.parametrize("kind", ["ideal", "mixture", "airwater"])
def test_comp_spatial_reducer_matches_jax(kind):
    """The one device reduction of a conservative state (primitive
    decomposition of the set's kind, 18 gradients, the stress tensor,
    every family and the 238 registers): each row to 1e-12 of the size of
    the terms it sums, every sum taken in magnitudes (|D1|, |fields|), so
    that a row that vanishes analytically (the z-mean of a z-derivative)
    or a derivative of a field with a large mean (p) is held to its
    round-off as chip_smoke.py's 13e holds the card's.  AirWater's T comes
    out of the saturation inversion 6e-13 apart (ROADMAP C 18): its powers
    to 1e-11 (2.4e-12 read for T^4)."""
    from tlab_tpu.stats.spatial import make_comp_spatial_reducer as jred
    from tlab_tpu_torch.dycore.compressible import CompState
    from tlab_tpu_torch.stats.spatial import make_comp_spatial_reducer
    jsim, tsim = _comp_sims(_comp_spatial_text(kind))
    nx, ny, _ = tsim.grid.shape
    names = ["u", "v", "w"] + [f"s{i + 1}"
                               for i in range(tsim.nsp.n_scalars)]
    jst = JSpatialStats.create(nx, ny, names)
    tst = SpatialStats.create(nx, ny, names)
    fj, ft = jred(jsim, jst), make_comp_spatial_reducer(tsim, tst)
    P_abs = {k: v.abs() if k.startswith("d1") and torch.is_tensor(v) else v
             for k, v in tsim.P.items()}
    fabs = make_comp_spatial_reducer(dataclasses.replace(tsim, P=P_abs),
                                     tst)
    for Uj in _comp_states(jsim):
        Ut = CompState(*(torch.from_numpy(np.array(a)) for a in Uj))
        got, want = ft(Ut), np.asarray(fj(Uj))
        scale = fabs(CompState(*(a.abs() for a in Ut))).flatten(1) \
            .max(dim=1).values.numpy()
        err = np.abs(got.numpy() - want).reshape(len(want), -1).max(axis=1)
        assert got.shape == want.shape
        tol = 1e-11 if kind == "airwater" else 1e-12
        assert np.all(err <= tol * np.where(scale > 0, scale, 1.0))
        jst.accumulate_comp_stack(want)
        tst.accumulate_comp_stack(got)
    for key in ("sums", "pair_sums", "grad_sums", "gradx_sums", "p_sums",
                "triple_sums", "comp_sums", "reg_sums"):
        assert getattr(tst, key).shape == getattr(jst, key).shape, key


def test_favre_and_register_tables_match_jax(tmp_path):
    """accumulate_comp_stack of the same stacks, the Favre station table
    and the MA_* register table to 1e-12; the sums survive st<it>.npz
    (read by either package)."""
    from tlab_tpu.stats import spatial as jspatial
    from tlab_tpu_torch.stats import spatial as tspatial
    rng = np.random.default_rng(4)
    nx, ny = 9, 6
    names = ["u", "v", "w", "s1"]
    jst = JSpatialStats.create(nx, ny, names)
    tst = SpatialStats.create(nx, ny, names)
    k = (4 * 4 + len(tst.pairs) + 18 + len(tst.GRADX_PAIRS) + 14
         + len(tst.TRIPLES) + len(tst.COMP_NAMES)
         + len(tspatial.sreg.NAMES))
    for _ in range(3):
        stack = rng.standard_normal((k, nx, ny))
        stack[4 * 4 + len(tst.pairs) + 18 + len(tst.GRADX_PAIRS) + 14
              + len(tst.TRIPLES)] += 3.0          # <rho> away from 0
        jst.accumulate_comp_stack(stack)
        tst.accumulate_comp_stack(torch.from_numpy(stack))
    stations = [1, 4, 7]
    for got, want in ((tst.favre_station_table(stations),
                       jst.favre_station_table(stations)),
                      (tspatial.register_station_table(tst, stations),
                       jspatial.register_station_table(jst, stations))):
        assert sorted(got) == sorted(want)
        for ix in want:
            assert list(got[ix]) == list(want[ix])
            for c in want[ix]:
                assert _rel(got[ix][c], want[ix][c]) <= 1e-12, (ix, c)
    tst.save(str(tmp_path / "st.npz"), 3)
    back = JSpatialStats.load(str(tmp_path / "st.npz"))
    for key in ("comp_sums", "reg_sums"):
        assert np.array_equal(getattr(back, key), getattr(tst, key))
    jst.save(str(tmp_path / "sj.npz"), 3)
    back = SpatialStats.load(str(tmp_path / "sj.npz"))
    assert np.array_equal(back.reg_sums, jst.reg_sums)


def test_favre_station_table_matches_direct():
    """tests/test_spatial_stats.py:178 on the port: the Favre columns from
    the accumulated COMP_NAMES sums match their direct (z, t) averages."""
    nx, ny, nz = 8, 10, 12
    rng = np.random.default_rng(5)
    ss = SpatialStats.create(nx, ny, ("u", "v", "w"))
    ss.comp_sums = np.zeros((len(ss.COMP_NAMES), nx, ny))
    snaps = []
    for _ in range(3):
        f = {k: rng.standard_normal((nx, ny, nz)) for k in ("u", "v", "w")}
        rho = 1.0 + 0.4 * rng.uniform(size=(nx, ny, nz))
        T = 1.0 + 0.2 * rng.standard_normal((nx, ny, nz))
        snaps.append((f, rho, T))
        prods = {"r": rho, "T": T, "ru": rho * f["u"], "rv": rho * f["v"],
                 "rw": rho * f["w"], "rT": rho * T,
                 "ruu": rho * f["u"] ** 2, "ruv": rho * f["u"] * f["v"],
                 "rvv": rho * f["v"] ** 2, "rvT": rho * f["v"] * T,
                 "ruuv": rho * f["u"] ** 2 * f["v"]}
        for i, name in enumerate(ss.COMP_NAMES):
            if name in prods:
                ss.comp_sums[i] += prods[name].mean(axis=2)
        ss.n_samples += 1
    tab = ss.favre_station_table([2])[2]

    def zt(arrs):
        return np.mean([a[2].mean(axis=-1) for a in arrs], axis=0)

    rR = zt([r for _, r, _ in snaps])
    fU = zt([r * f["u"] for f, r, _ in snaps]) / rR
    fV = zt([r * f["v"] for f, r, _ in snaps]) / rR
    fT = zt([r * T for _, r, T in snaps]) / rR
    assert np.allclose(tab["rR"], rR, rtol=1e-12)
    assert np.allclose(tab["fU"], fU, rtol=1e-12)
    assert np.allclose(tab["fT"], fT, rtol=1e-12)
    Ruv = zt([r * f["u"] * f["v"] for f, r, _ in snaps]) / rR - fU * fV
    assert np.allclose(tab["fRuv"], Ruv, rtol=1e-12)
    RvT = zt([r * f["v"] * T for f, r, T in snaps]) / rR - fV * fT
    assert np.allclose(tab["fRvT"], RvT, rtol=1e-12)
    ruuv = zt([r * f["u"] ** 2 * f["v"] for f, r, _ in snaps])
    ruu = zt([r * f["u"] ** 2 for f, r, _ in snaps])
    ruv = zt([r * f["u"] * f["v"] for f, r, _ in snaps])
    Tuu = ruuv - 2.0 * fU * ruv - fV * ruu + 2.0 * rR * fU * fU * fV
    assert np.allclose(tab["fTuuy"], Tuu, rtol=1e-11)


@pytest.mark.parametrize("kind", ["ideal", "airwater"])
def test_compressible_spatial_runs_as_jax(tmp_path, kind):
    """A compressible Type=spatial case through both packages' dns.run
    from tlab_tpu's initial state, 4 steps: dns.out in every printed
    digit; st4.npz's sums (the Favre and register families included) to
    1e-10 of their max; avg_zt4 (the Favre station table) and avgMA_zt4
    (the registers) written, 3 samples, to 1e-8 of each column's max
    (1e-13 absolute)."""
    from tlab_tpu.tools.initialize import compressible_initial_state
    from tlab_tpu_torch.dycore.compressible import CompState
    text = _comp_spatial_text(kind)
    jsim, tsim = _comp_sims(text)
    Uj = compressible_initial_state(jsim, seed=1)
    Ut = CompState(*(torch.from_numpy(np.array(a)) for a in Uj))
    for pkg, mod, sim, U in (("jax", jdns, jsim, Uj),
                             ("port", tdns, tsim, Ut)):
        out = tmp_path / pkg
        out.mkdir()
        mod.run(sim, U, outdir=str(out), log_path=str(out / "dns.out"))
    dj, dt = tmp_path / "jax", tmp_path / "port"
    if kind == "ideal":
        assert (dt / "dns.out").read_text() == (dj / "dns.out").read_text()
    else:
        # Case14's momenta are the pressure's round-off floor (ROADMAP C):
        # the log's columns agree, the files' momenta are held below
        assert (dt / "dns.out").read_text().splitlines()[-1].split()[7:] \
            == (dj / "dns.out").read_text().splitlines()[-1].split()[7:]
    ss_t = SpatialStats.load(str(dt / "st4.npz"))
    ss_j = JSpatialStats.load(str(dj / "st4.npz"))
    assert ss_t.n_samples == ss_j.n_samples == 4
    keys = ("sums", "pair_sums", "grad_sums", "gradx_sums", "p_sums",
            "triple_sums", "comp_sums", "reg_sums")
    if kind == "ideal":
        for key in keys:
            assert _rel(getattr(ss_t, key), getattr(ss_j, key)) <= TOL, key
    else:
        # the density, energy and thermodynamic moments to 1e-10
        for i, name in enumerate(ss_t.COMP_NAMES):
            if name in ("r", "r2", "T", "T2", "p", "rT"):
                assert _rel(ss_t.comp_sums[i], ss_j.comp_sums[i]) <= TOL
    for name in ("avg_zt4", "avgMA_zt4"):
        lj = (dj / name).read_text().splitlines()
        lt = (dt / name).read_text().splitlines()
        assert lt[:3] == lj[:3] and len(lt) == len(lj)
        if kind != "ideal":
            continue
        vj = np.array([[float(x) for x in ln.split()] for ln in lj[3:]])
        vt = np.array([[float(x) for x in ln.split()] for ln in lt[3:]])
        scale = np.max(np.abs(vj), axis=0)
        assert np.all(np.abs(vt - vj) <= np.maximum(1e-8 * scale, 1e-13))
