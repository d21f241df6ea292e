"""The a-priori LES analysis (tools/apriori.py) and the `apriori` command
(postprocess.run_apriori, [PostProcessing] ParamStructure 1 and 2) against
tlab_tpu, float64 on the CPU.

Limits: the functions' profiles 1e-12 of each one's max (the same products
in another order), one that vanishes analytically (the plane mean of an x
or z derivative) 1e-13 absolute, the round-off of O(1) fields; the tables
tau<it>, sgs<it> and gradU<it> through both CLIs on the same restart 1e-8
of each column's max (9 printed digits), a column that vanishes
analytically 1e-13 absolute.  Then
tests/test_observability.py's properties on the port's tables."""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlab_tpu.config import Ini as JIni, load_case as jload_case
from tlab_tpu.dycore.state import State as JState
from tlab_tpu.ops import filter as jfilt
from tlab_tpu.runtime import Simulation as JSimulation
from tlab_tpu.tools import apriori as jap
from tlab_tpu.tools import cli as jcli
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.convert import state_from_numpy
from tlab_tpu_torch.ops import filter as tfilt
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.stats import averages as tavg
from tlab_tpu_torch.tools import apriori as tap
from tlab_tpu_torch.tools import cli as tcli

DATA = os.path.join(os.path.dirname(__file__), "data")
SMALL = [("Imax=128", "Imax=32"), ("Jmax=64", "Jmax=24"),
         ("points_1=129", "points_1=33"), ("points_1=64", "points_1=24")]
F64 = torch.float64

torch.set_num_threads(2)


def _text(extra=""):
    with open(os.path.join(DATA, "case01_small3d.ini")) as fh:
        text = fh.read()
    for old, new in SMALL:
        assert old in text, old
        text = text.replace(old, new, 1)
    return text + extra


@pytest.fixture(scope="module")
def pair():
    """Both packages' simulations of the case and one seeded state."""
    text = _text()
    tsim = Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                                device="cpu")
    jsim = JSimulation.from_case(jload_case(JIni(text=text)))
    rng = np.random.default_rng(5)
    shape = tsim.grid.shape
    u, v, w = (rng.standard_normal(shape) for _ in range(3))
    s = rng.standard_normal((1,) + shape)
    st = state_from_numpy(u, v, w, s, "cpu", F64)
    sj = JState(u=jnp.asarray(u), v=jnp.asarray(v), w=jnp.asarray(w),
                s=jnp.asarray(s))
    return tsim, jsim, st, sj


FILTERS = [dict(type="compact", parameters=(0.49,)),
           dict(type="tophat", parameters=(4,)),
           dict(type="explicit6", parameters=(), active=(True, False, True))]


def _mats(tsim, jsim, spec):
    return (tfilt.build_filter_matrices(tsim.fdm, tfilt.FilterSpec(**spec),
                                        F64, "cpu"),
            jfilt.build_filter_matrices(jsim.fdm, jfilt.FilterSpec(**spec),
                                        jnp.float64))


def _close(got, want, tol=1e-12):
    assert list(got) == list(want)
    for k in want:
        a = got[k].numpy() if torch.is_tensor(got[k]) else np.asarray(got[k])
        b = np.asarray(want[k])
        assert a.shape == b.shape and np.isfinite(a).all(), k
        assert np.max(np.abs(a - b)) <= max(tol * np.max(np.abs(b)),
                                            1e-13), k


@pytest.mark.parametrize("spec", FILTERS)
def test_functions_match(pair, spec):
    tsim, jsim, st, sj = pair
    tm, jm = _mats(tsim, jsim, spec)
    tau_t, filt_t = tap.subgrid_stress(tm, st.u, st.v, st.w)
    tau_j, filt_j = jap.subgrid_stress(jm, sj.u, sj.v, sj.w)
    _close(tau_t, tau_j)
    _close(filt_t, filt_j)
    delta = 2.0 * tsim.grid.x.scale / tsim.grid.x.size
    _close(tap.apriori_statistics(tsim.P, tm, st, delta),
           jap.apriori_statistics(jsim.P, jm, sj, delta))
    _close(tap.filtered_gradients(tsim.P, tm, st),
           jap.filtered_gradients(jsim.P, jm, sj))


def test_tophat_subgrid_energy_is_positive(pair):
    """tests/test_stats.py::test_apriori_subgrid on the port."""
    tsim, jsim, st, _ = pair
    tm, _ = _mats(tsim, jsim, FILTERS[1])
    out = tap.apriori_statistics(tsim.P, tm, st, delta=4 * 2 * np.pi / 32)
    assert bool((out["Ksgs"] > 0).all())
    assert bool(torch.isfinite(out["Cs2"]).all())


MODES = [("", 1, ("tau0", "sgs0")),
         ("ParamStructure=2\n", 2, ("gradU0",)),
         ("ParamStructure=1\n", 1, ("tau0", "sgs0"))]


@pytest.mark.parametrize("keys, mode, tables", MODES)
@pytest.mark.parametrize("filt", ["", "\n[Filter]\nType=tophat\n"
                                      "Parameters=4\nStep=1000\n"])
def test_command_matches(tmp_path, keys, mode, tables, filt):
    """`apriori` of the port's initial fields through both CLIs: modes 1
    (the default and ParamStructure=1) and 2, with the fallback compact
    test filter and with an active [Filter]."""
    text = _text(filt + "\n[PostProcessing]\nFiles=0\n" + keys)
    t, j = tmp_path / "t", tmp_path / "j"
    t.mkdir()
    (t / "tlab.ini").write_text(text)
    common = ["--ini", str(t / "tlab.ini")]
    assert tcli.main(["ini", *common, "--outdir", str(t), "--device", "cpu",
                      "--x64"]) == 0
    shutil.copytree(t, j)
    assert tcli.main(["apriori", *common, "--outdir", str(t), "--device",
                      "cpu", "--x64"]) == 0
    assert jcli.main(["apriori", *common, "--outdir", str(j), "--cpu",
                      "--x64"]) == 0
    for name in tables:
        got = tavg.read_table(str(t / name))
        want = tavg.read_table(str(j / name))
        assert list(got) == list(want), name
        for k in want:
            assert np.isfinite(got[k]).all(), (name, k)
            assert np.max(np.abs(got[k] - want[k])) <= max(
                1e-8 * np.max(np.abs(want[k])), 1e-13), (name, k)
        with open(t / name) as fa, open(j / name) as fb:
            assert fa.readline() == fb.readline()     # it= and rtime=
    if mode == 1:
        tau = tavg.read_table(str(t / "tau0"))
        assert {"Tauxx", "Tauyy", "Tauzz", "Tauxy", "Tauxz",
                "Tauyz"} == set(tau) - {"Y"}
        sgs = tavg.read_table(str(t / "sgs0"))
        assert {"Ksgs", "EpsSgs", "Tauuv", "Snorm", "Cs2"} == \
            set(sgs) - {"Y"}
        # Ksgs = (Tauxx + Tauyy + Tauzz) / 2 between the two tables
        trace = 0.5 * (tau["Tauxx"] + tau["Tauyy"] + tau["Tauzz"])
        assert np.max(np.abs(sgs["Ksgs"] - trace)) <= \
            1e-8 * np.max(np.abs(trace))
    else:
        grad = tavg.read_table(str(t / "gradU0"))
        assert "Ux" in grad and "Wz2" in grad
        assert np.all(grad["Uy2"] >= -1e-12)
