"""The port's in-run statistics (tlab_tpu_torch/stats/averages.py) against
tlab_tpu's, float64 on the CPU, on the same state and pressure.

Every column agrees to 1e-9 of the column's max.  A column that vanishes
analytically (the mean spanwise vorticity, products with the mean of v) is
round-off of O(1) fields in both packages, summed in another order: those
are held to 1e-13 absolute instead."""
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tlab_tpu.config import Ini as JIni, load_case as jload_case
from tlab_tpu.dycore import incompressible as jdyn
from tlab_tpu.runtime import Simulation as JSimulation
from tlab_tpu.stats import averages as javg
from tlab_tpu.tools import dns as jdns
from tlab_tpu.tools.initialize import initial_state as jinitial_state
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.convert import state_from_numpy
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.stats import averages as tavg
from tlab_tpu_torch.tools import dns as tdns

DATA = os.path.join(os.path.dirname(__file__), "data")
F64 = torch.float64
RTOL, ATOL = 1e-9, 1e-13

# the test workers share the machine's cores: with every worker's products
# on all of them, the threads spin on each other and a step takes 20x longer
torch.set_num_threads(2)


# a linear stratification, an explicit Coriolis force with a component
# along y, and a second gravity component, so that every buoyancy and
# Coriolis column is filled
NUMBERS = "[Parameters]\nFroude=2.0\nRossby=3.0\n"
FORCES = """
[Gravity]
Type=Linear
Vector=0.5,-1.0,0.0
Parameters=1.0
[Rotation]
Type=explicit
Vector=0.0,1.0,0.25
"""


@pytest.fixture(scope="module", params=["case01_small.ini",
                                        "case01_small3d.ini",
                                        "case01_small3d.ini+stratified"])
def tables(request, tmp_path_factory):
    """Both packages' tables and avg files of one state: tlab_tpu's initial
    state after two of its RK steps, with that step's pressure."""
    name, _, variant = request.param.partition("+")
    with open(os.path.join(DATA, name)) as fh:
        text = fh.read()
    if variant:
        text = text.replace("[Parameters]\n", NUMBERS, 1) + FORCES
    jsim = JSimulation.from_case(jload_case(JIni(text=text)))
    sj = jinitial_state(jsim, seed=7)
    for _ in range(2):
        sj, pj = jdyn.rk_step(jsim.P, sj, 2e-3)
    tsim = Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                                device="cpu")
    st = state_from_numpy(sj.u, sj.v, sj.w, sj.s, "cpu", F64)
    pt = torch.from_numpy(np.array(pj))
    out = tmp_path_factory.mktemp("avg")
    (out / "jax").mkdir()
    (out / "torch").mkdir()
    jdns.write_statistics(jsim, sj, str(out / "jax"), 2, 4e-3, p=pj)
    tdns.write_statistics(tsim, st, str(out / "torch"), 2, 4e-3, p=pt)
    return (javg.make_stats_tables_fn(jsim)(sj, pj),
            tavg.stats_tables(tsim, st, pt), out, tsim, st, pt, jsim, sj)


# the legacy skewness/flatness aliases, the variance they divide by and
# the mean whose digits the fluctuation loses
_MOMENT_OF = {"SU": ("Rxx", "rU"), "FU": ("Rxx", "rU"),
              "SV": ("Ryy", "rV"), "FV": ("Ryy", "rV"),
              "SW": ("Rzz", "rW"), "FW": ("Rzz", "rW"),
              "Ss": ("rS2", "rS"), "Fs": ("rS2", "rS")}


def _assert_columns(ref: dict, got: dict, names, rtol=RTOL):
    for n in names:
        a, b = np.asarray(ref[n], np.float64), np.asarray(got[n], np.float64)
        assert a.shape == b.shape and np.isfinite(b).all(), n
        if n in _MOMENT_OF:
            # a quotient of two round-off numbers where the variance is
            # round-off of the field (a free stream): held where it is not
            var, mean = (np.asarray(ref[k], np.float64)
                         for k in _MOMENT_OF[n])
            keep = var > 1e-10 * max(np.max(var), np.max(mean ** 2))
            if keep.any():              # else a field that is 0 (2-D w)
                a, b = a[keep], b[keep]
        assert np.max(np.abs(a - b)) <= max(rtol * np.max(np.abs(a)), ATOL), n


def test_flow_columns_match_jax(tables):
    (flow_j, _), (flow_t, _) = tables[:2]
    names = [n for _, vars_ in tavg.FLOW_GROUPS for n in vars_.split()]
    aliases = ["SU", "FU", "SV", "FV", "SW", "FW", "Prod"]
    assert len(names) == 191
    assert sorted(flow_t) == sorted(names + aliases) == sorted(flow_j)
    _assert_columns(flow_j, flow_t, names + aliases)
    assert float(np.max(flow_t["Tke"])) > 1e-3 and np.all(flow_t["rR"] == 1)


def test_extras_match_jax(tables):
    """build_extras: the same keys as tlab_tpu's, the same values, and the
    buoyancy field to 1e-12; the columns they fill are filled exactly where
    the case has the force."""
    tsim, st, jsim, sj = tables[3], tables[4], tables[6], tables[7]
    ext, exj = tavg.build_extras(tsim, st), javg.build_extras(jsim, sj)
    assert sorted(ext) == sorted(exj)
    for k in ext:
        a, b = np.asarray(ext[k]), np.asarray(exj[k])
        if k == "b":
            assert np.max(np.abs(a - b)) <= 1e-12 * np.max(np.abs(b))
        else:
            assert np.array_equal(a, b), k
    flow, scal = tables[1][0], tables[1][1][0]
    forced = "b" in ext
    assert forced == (tsim.P["bodyforce"] is not None)
    for n in ("rB", "Bxx", "Byy", "Bxy", "Buo", "Pot", "Fxx", "Fzz", "Fxy",
              "Fxz", "Fyz"):
        assert bool(np.any(flow[n])) == forced, n
    for n in ("Bsv", "Fsu", "Fsw"):
        assert bool(np.any(scal[n])) == forced, n


def test_scalar_columns_match_jax(tables):
    (_, scal_j), (_, scal_t) = tables[:2]
    names = [n for _, vars_ in tavg.scal_groups(1) for n in vars_.split()]
    names += ["Ss", "Fs", "Chi", "Rss"]               # the legacy aliases
    assert len(scal_t) == len(scal_j) == 1 and len(names) == 79
    assert sorted(scal_t[0]) == sorted(names) == sorted(scal_j[0])
    _assert_columns(scal_j[0], scal_t[0], names)


@pytest.mark.parametrize("name", ["avg2", "avg2s1"])
def test_avg_files_match_jax(tables, name):
    """The ASCII files after read_avg: the same time, groups and columns;
    the values carry 9 printed digits, so 1e-8 of the column's max."""
    out = tables[2]
    rt_j, groups_j, cols_j = javg.read_avg(str(out / "jax" / name))
    rt_t, groups_t, cols_t = tavg.read_avg(str(out / "torch" / name))
    assert rt_t == rt_j == 4e-3 and groups_t == groups_j
    assert list(cols_t) == list(cols_j)
    _assert_columns(cols_j, cols_t, cols_j, rtol=1e-8)
    # each package parses the other's file
    assert list(javg.read_avg(str(out / "torch" / name))[2]) == list(cols_j)
    head_j = (out / "jax" / name).read_text().split("\n1 ")[0]
    assert (out / "torch" / name).read_text().startswith(head_j[:200])


def test_table_round_trip(tmp_path):
    y = np.linspace(0.0, 1.0, 5)
    cols = {"a": y ** 2, "b": -y}
    tavg.write_table(str(tmp_path / "t"), y, cols, 3, 0.5)
    got = tavg.read_table(str(tmp_path / "t"))
    want = javg.read_table(str(tmp_path / "t"))
    assert list(got) == list(want) == ["Y", "a", "b"]
    for k in got:
        assert np.array_equal(got[k], want[k])
    javg.write_table(str(tmp_path / "j"), y, cols, 3, 0.5)
    assert (tmp_path / "j").read_text() == (tmp_path / "t").read_text()


def test_float32_tables_follow_float64(tables):
    """The tables of the float32 state: finite, in float32, and within
    1e-3 of the float64 ones where the column is not round-off."""
    _, (flow64, _), _, tsim, st, pt = tables[:6]
    sim32 = Simulation.from_case(tsim.case, dtype=torch.float32,
                                 device="cpu")
    st32 = state_from_numpy(st.u, st.v, st.w, st.s, "cpu", torch.float32)
    flow32, scal32 = tavg.stats_tables(sim32, st32, pt.float())
    assert flow32["rU"].dtype == np.float32
    for n in ("rU", "Tke", "Rxx", "Rxy", "rP2", "Wz", "Eps", "U_y1"):
        assert np.max(np.abs(flow32[n] - flow64[n])) <= \
            1e-3 * np.max(np.abs(flow64[n])), n
    assert all(np.isfinite(v).all() for v in scal32[0].values())


@pytest.mark.parametrize("call", ["no_pressure", "extras", "extras_rho",
                                  "rho", "netcdf"])
def test_statistics_once_refused_match_jax(tables, tmp_path, call):
    """What raised until ROADMAP A14, against tlab_tpu on the same state:
    the tables without a pressure (the diagnostic pressure solved), a
    sound-speed profile, the scalar sources, a density field with the
    compressible gravity, and the NetCDF writer."""
    tsim, st, pt, jsim, sj = tables[3], tables[4], tables[5], tables[6], \
        tables[7]
    ext, exj = tavg.build_extras(tsim, st), javg.build_extras(jsim, sj)
    if call == "no_pressure":
        got = [tavg.flow_statistics(tsim.P, st, tsim.nsp.visc, extras=ext),
               tavg.scalar_statistics(tsim.P, st, 1e-3, 0,
                                      visc=tsim.nsp.visc, extras=ext)]
        ref = [javg.flow_statistics(jsim.P, sj, jsim.nsp.visc, extras=exj),
               javg.scalar_statistics(jsim.P, sj, 1e-3, 0,
                                      visc=jsim.nsp.visc, extras=exj)]
    elif call == "extras":
        c2 = st.u[0, :, 0] ** 2 + 1.0
        got = [tavg.flow_statistics(tsim.P, st, tsim.nsp.visc, p=pt,
                                    extras={**ext, "c2": c2})]
        ref = [javg.flow_statistics(jsim.P, sj, jsim.nsp.visc,
                                    p=jnp.asarray(pt.numpy()),
                                    extras={**exj, "c2": jnp.asarray(
                                        c2.numpy())})]
        assert np.array_equal(got[0]["C2"].numpy(), c2.numpy())
    elif call == "extras_rho":
        q = torch.sin(st.s) + st.u[None]
        got = [tavg.scalar_statistics(tsim.P, st, 1e-3, 0, p=pt,
                                      extras={"scalar_sources": q})]
        ref = [javg.scalar_statistics(jsim.P, sj, 1e-3, 0,
                                      p=jnp.asarray(pt.numpy()),
                                      extras={"scalar_sources":
                                              jnp.asarray(q.numpy())})]
        assert float(torch.amax(torch.abs(got[0]["Qss"]))) > 1e-6
    elif call == "rho":
        rho = 1.0 + 0.1 * st.u
        got = [tavg.scalar_statistics(tsim.P, st, 1e-3, 0, p=pt, rho=rho,
                                      extras={"grav_y": -1.0})]
        ref = [javg.scalar_statistics(jsim.P, sj, 1e-3, 0,
                                      p=jnp.asarray(pt.numpy()),
                                      rho=jnp.asarray(rho.numpy()),
                                      extras={"grav_y": -1.0})]
        assert float(torch.amax(torch.abs(got[0]["Bsv"]))) > 0.0
    else:
        case = load_case(Ini(text="[Main]\nFileFormat=netcdf\n"))
        assert tavg.avg_writer(case) is tavg.write_avg_nc
        flow = tables[1][0]
        y = tsim.grid.y.nodes
        tavg.avg_writer(case)(str(tmp_path / "t"), y, flow, tavg.FLOW_GROUPS,
                              3, 0.5)
        javg.write_avg_nc(str(tmp_path / "j"), y, flow, javg.FLOW_GROUPS, 3,
                          0.5)
        assert (tmp_path / "t.nc").read_bytes() == \
            (tmp_path / "j.nc").read_bytes()
        got = [tavg.read_avg_nc(str(tmp_path / "t.nc"))[2]]
        ref = [javg.read_avg_nc(str(tmp_path / "j.nc"))[2]]
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        _assert_columns(r, g, list(r))