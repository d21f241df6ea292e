"""The port's field I/O engine, visual files, [SavePlanes]/[SaveTowers] and
their NetCDF converters against tlab_tpu's, float64 on the CPU.

1. The restart engine (native/tlabio.cpp, built by ops/_build.
   host_extension): its files equal the NumPy writer's and tlab_tpu's byte
   for byte, its reads equal NumPy's and tlab_tpu's bit for bit; float32
   and big-endian files go through NumPy as in tlab_tpu; a failed build
   raises with the compiler's message.
2. Visual files (raw float32 and the restart format) byte for byte.
3. Planes and towers written from the same states as tlab_tpu's (the
   states of tlab_tpu's own dns run): the files byte for byte; and both
   packages' dns runs with [SavePlanes]/[SaveTowers] (tests/test_io.py:63,
   tests/test_observability.py:156, :252): the same files, equal to the
   runs' round-off.
4. planes_to_nc, towers_to_nc and the CLI's planes2nc/tower2nc on the same
   files: equal variables."""
import filecmp
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

from tlab_tpu.config import Ini as JIni, load_case as jload_case
from tlab_tpu.io import fields_io as jio
from tlab_tpu.io import planes as jplanes
from tlab_tpu.runtime import Simulation as JSimulation
from tlab_tpu.tools import convert as jconvert
from tlab_tpu.tools import dns as jdns
from tlab_tpu.tools.initialize import (compressible_initial_state as
                                       jcomp_initial_state,
                                       initial_state as jinitial_state)
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.convert import state_from_numpy
from tlab_tpu_torch.dycore.compressible import CompState
from tlab_tpu_torch.io import fields_io as tio
from tlab_tpu_torch.io import planes as tplanes
from tlab_tpu_torch.ops import _build
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.tools import cli
from tlab_tpu_torch.tools import convert as tconvert
from tlab_tpu_torch.tools import dns as tdns

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))
from test_observability import COMP_SMALL, INC_SMALL  # noqa: E402

F64 = torch.float64
TOL = 1e-10

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# 1. the restart engine
# ---------------------------------------------------------------------------

def test_engine_builds_from_the_native_source():
    mod = _build.host_extension("tlabio")
    assert mod.__name__ == "_tlabio"
    assert {"write_field", "read_field"} <= set(dir(mod))
    assert _build.host_extension("tlabio") is mod


@pytest.mark.parametrize("shape", [(17, 9, 13), (64, 33, 1), (1, 5, 7)])
def test_engine_equals_numpy_and_jax(tmp_path, shape):
    """write_field (the engine) against write_field_plain and tlab_tpu's
    write_field: the same bytes; read_field against read_field_plain and
    tlab_tpu's read_field: the same bits, params and iteration."""
    a = np.random.default_rng(1).standard_normal(shape)
    paths = {k: str(tmp_path / k) for k in ("engine", "plain", "jax")}
    tio.write_field(paths["engine"], a, itime=3, params=(0.5, 2e-3))
    tio.write_field_plain(paths["plain"], a, itime=3, params=(0.5, 2e-3))
    jio.write_field(paths["jax"], a, itime=3, params=(0.5, 2e-3))
    assert filecmp.cmp(paths["engine"], paths["plain"], shallow=False)
    assert filecmp.cmp(paths["engine"], paths["jax"], shallow=False)
    got = [tio.read_field(paths["jax"]), tio.read_field_plain(paths["jax"]),
           jio.read_field(paths["engine"])]
    for arr, params, it in got:
        assert np.array_equal(arr, a) and it == 3
        assert np.array_equal(params, [0.5, 2e-3])


@pytest.mark.parametrize("dtype, byteorder", [("<f4", "<"), ("<f8", ">")])
def test_other_formats_go_through_numpy(tmp_path, dtype, byteorder):
    """float32 and big-endian files: the NumPy path in both packages, the
    same bytes; read back with the byte order detected from the header."""
    a = np.random.default_rng(2).standard_normal((9, 8, 7))
    tio.write_field(str(tmp_path / "t"), a, 5, (1.0, 2.0), dtype=dtype,
                    byteorder=byteorder)
    jio.write_field(str(tmp_path / "j"), a, 5, (1.0, 2.0), dtype=dtype,
                    byteorder=byteorder)
    assert filecmp.cmp(tmp_path / "t", tmp_path / "j", shallow=False)
    out, params, it = tio.read_field(str(tmp_path / "t"))
    ref = a.astype(np.float32) if dtype == "<f4" else a
    assert np.array_equal(out, ref) and it == 5 and list(params) == [1, 2]


def test_failed_build_raises_with_the_compiler_message(tmp_path,
                                                       monkeypatch):
    """A source that does not compile raises RuntimeError with g++'s
    stderr; nothing falls back to NumPy."""
    (tmp_path / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(_build, "NATIVE", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="failed to build broken.cpp"):
        _build.host_extension("broken")


def test_checkpoint_through_the_engine_reads_in_jax(tmp_path):
    """write_state of a float32 State (as on the card) and read_state of
    tlab_tpu: the float32 values exactly."""
    rng = np.random.default_rng(3)
    u, v, w = (rng.standard_normal((8, 6, 4)) for _ in range(3))
    s = rng.standard_normal((2, 8, 6, 4))
    st = state_from_numpy(u, v, w, s, "cpu", torch.float32)
    tio.write_state(str(tmp_path / "flow"), str(tmp_path / "scal"), 7, st,
                    0.25, 1e-3)
    ju, jv, jw, js, rtime, visc = jio.read_state(
        str(tmp_path / "flow"), str(tmp_path / "scal"), 7, 2)
    assert np.array_equal(ju, u.astype(np.float32)) and rtime == 0.25
    assert np.array_equal(js, s.astype(np.float32)) and visc == 1e-3


# ---------------------------------------------------------------------------
# 2. visual files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["single", "general"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_visual_files_match_jax(tmp_path, fmt, dtype):
    a = np.random.default_rng(4).standard_normal((12, 10, 6))
    t = torch.as_tensor(a, dtype=dtype)
    tio.write_visual(str(tmp_path / "t"), t, 9, (0.5,), fmt=fmt)
    jio.write_visual(str(tmp_path / "j"), np.asarray(t.numpy()), 9, (0.5,),
                     fmt=fmt)
    assert filecmp.cmp(tmp_path / "t", tmp_path / "j", shallow=False)
    back = tio.read_visual(str(tmp_path / "t"), a.shape)
    assert np.array_equal(back, jio.read_visual(str(tmp_path / "j"),
                                                a.shape))
    ref = a.astype(np.float32) if fmt == "single" or dtype == torch.float32 \
        else a
    assert np.array_equal(back, ref.astype(np.float64))


# ---------------------------------------------------------------------------
# 3. planes and towers
# ---------------------------------------------------------------------------

CASE2D = (REPO / "tests" / "data" / "case01_small.ini").read_text()
# tests/test_io.py::test_planes_and_towers_in_dns_loop's case, restarts
# every 2 steps so that the towers flush
PLANES_2D = CASE2D.replace("[Iteration]", "[Iteration]\nSavePlanes=2") \
    .replace("Restart=10", "Restart=2") + (
    "\n[SavePlanes]\nPlanesJ=1,32\n[SaveTowers]\nStride=16,1\n"
    "Pressure=yes\n")


def _same_files(a, b, prefix):
    names = sorted(n for n in os.listdir(a) if n.startswith(prefix))
    assert names and names == sorted(n for n in os.listdir(b)
                                     if n.startswith(prefix))
    return names


def _close_files(a, b, names, dtype, tol=TOL):
    """The files of `names` in a and b: equal shape, within tol of the
    largest value of each."""
    for n in names:
        x = np.fromfile(os.path.join(a, n), dtype)
        y = np.fromfile(os.path.join(b, n), dtype)
        assert x.shape == y.shape and np.isfinite(x).all(), n
        assert np.abs(x - y).max() <= tol * max(np.abs(y).max(), 1e-300), n


def _run_pair(tmp_path, text, compressible=False, n_steps=4):
    """dns.run of `text` through both packages from tlab_tpu's initial
    state; returns the two output directories (jax, torch)."""
    jsim = JSimulation.from_case(jload_case(JIni(text=text)))
    tsim = Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                                device="cpu")
    if compressible:
        U = jcomp_initial_state(jsim, seed=3)
        tstate = CompState(*(None if a is None else torch.as_tensor(
            np.asarray(a)) for a in U))
        jstate = U
    else:
        jstate = jinitial_state(jsim, seed=7)
        tstate = state_from_numpy(*(np.asarray(a) for a in (
            jstate.u, jstate.v, jstate.w, jstate.s)), "cpu", F64)
    dirs = []
    for name, mod, sim, st in (("jax", jdns, jsim, jstate),
                               ("torch", tdns, tsim, tstate)):
        d = tmp_path / name
        d.mkdir()
        mod.run(sim, st, outdir=str(d), n_steps=n_steps,
                log_path=str(d / "dns.out"))
        dirs.append(str(d))
    return dirs


def test_planes_and_towers_from_the_same_states(tmp_path):
    """write_planes and TowerAccumulator of the port on the states of
    tlab_tpu's own run (2 steps of the 2-D case): planes files and tower
    columns byte for byte as tlab_tpu's; the tower means (a mean in each
    package's order of sums) to 1e-15 of their max."""
    jsim = JSimulation.from_case(jload_case(JIni(text=PLANES_2D)))
    st = jinitial_state(jsim, seed=7)
    specs = [("j", (1, 32)), ("i", (0, 5, 127)), ("k", (0,))]
    jacc = jplanes.TowerAccumulator(stride=(16, 1, 1))
    tacc = tplanes.TowerAccumulator(stride=(16, 1, 1))
    step, _ = jdns.make_step_functions(jsim)
    for it in (1, 2):
        st, p, _, _ = step(st, 1e-3)
        tst = state_from_numpy(*(np.asarray(a) for a in (st.u, st.v, st.w,
                                                         st.s)), "cpu", F64)
        tp = torch.as_tensor(np.array(p))
        for ax, idx in specs:
            jplanes.write_planes(str(tmp_path), it, st,
                                 [jplanes.PlaneSpec(ax, idx)], pressure=p)
            os.rename(tmp_path / f"planes{ax.upper()}.{it}",
                      tmp_path / f"jax.{ax}{it}")
            tplanes.write_planes(str(tmp_path), it, tst,
                                 [tplanes.PlaneSpec(ax, idx)], pressure=tp)
            assert filecmp.cmp(tmp_path / f"jax.{ax}{it}",
                               tmp_path / f"planes{ax.upper()}.{it}",
                               shallow=False)
        jacc.accumulate(it, 1e-3 * it, st, pressure=p)
        tacc.accumulate(it, 1e-3 * it, tst, pressure=tp)
    for acc, sub in ((jacc, "jax"), (tacc, "torch")):
        (tmp_path / sub).mkdir()
        acc.flush(str(tmp_path / sub))
    names = _same_files(tmp_path / "jax", tmp_path / "torch", "tower.")
    for n in names:
        if ".mean." in n:
            _close_files(tmp_path / "jax", tmp_path / "torch", [n], "<f8",
                         tol=1e-15)
        else:
            assert filecmp.cmp(tmp_path / "jax" / n, tmp_path / "torch" / n,
                               shallow=False), n


def test_extract_plane_on_the_device_tensor():
    a = torch.arange(60, dtype=F64).reshape(3, 4, 5)
    got = tplanes.extract_plane(a, tplanes.PlaneSpec("k", (4, 0)))
    assert got.shape == (3, 4, 2) and torch.equal(got[..., 0], a[..., 4])
    assert np.array_equal(got.numpy(), jplanes.extract_plane(
        a.numpy(), jplanes.PlaneSpec("k", (4, 0))))


@pytest.mark.parametrize("case", ["test_io", "pressure_planes",
                                  "compressible"])
def test_dns_planes_and_towers_match_jax(tmp_path, case):
    """[SavePlanes]/[SaveTowers] in dns.run through both packages, 4 steps:
    the case of tests/test_io.py:63 (2-D, towers with the pressure), of
    tests/test_observability.py:252 (the projection pressure's planes) and
    :156 (compressible: the primitive view and the EOS pressure); the same
    files, planes (float32) and towers (float64) equal to the run's
    round-off; the towers read back by rf.read_tower_file."""
    if case == "test_io":
        text, comp = PLANES_2D, False
    elif case == "pressure_planes":
        text = INC_SMALL.format(control_extra="", iter_extra="SavePlanes=2",
                                extra="[SavePlanes]\nPlanesJ=7\n"
                                      "PressureJ=yes\n")
        comp = False
    else:
        text = COMP_SMALL.format(
            flow_limit="no", control_extra="", iter_extra="SavePlanes=2\n"
            "Restart=4", main_extra="\n[SavePlanes]\nPlanesJ=5\n"
            "[SaveTowers]\nStride=8,1,1\nPressure=yes\n")
        comp = True
    jd, td = _run_pair(tmp_path, text, compressible=comp)
    planes = _same_files(jd, td, "planes")
    assert len(planes) == 2                      # it = 2 and it = 4
    _close_files(jd, td, planes, "<f4", tol=1e-6)
    if case != "pressure_planes":
        towers = _same_files(jd, td, "tower.")
        _close_files(jd, td, towers, "<f8")
    rows = [[ln.split() for ln in open(os.path.join(d, "dns.out"))
             if not ln.startswith("#")] for d in (jd, td)]
    assert len(rows[0]) == len(rows[1]) == 5
    for a, b in zip(*rows):
        if comp:
            assert a == b
        else:
            # DilMin/DilMax of a field at rest are round-off (~6e-15),
            # held to 1e-13 absolute as tests/test_torch_dns.py holds them
            assert a[:7] == b[:7]
            assert all(abs(float(x) - float(y)) <= 1e-13
                       for x, y in zip(a[7:], b[7:]))


# ---------------------------------------------------------------------------
# 4. the NetCDF converters
# ---------------------------------------------------------------------------

def _nc_vars(path):
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as f:
        return {k: np.array(v[:]) for k, v in f.variables.items()}


def test_converters_match_jax(tmp_path):
    """planes_to_nc / towers_to_nc of the port and of tlab_tpu on the files
    of one run (tlab_tpu's dns of the 2-D case with planes every 2 steps and
    towers flushed every 2): every variable equal; and the CLI's planes2nc
    and tower2nc write the same files."""
    jsim = JSimulation.from_case(jload_case(JIni(text=PLANES_2D)))
    d = tmp_path / "run"
    d.mkdir()
    jdns.run(jsim, jinitial_state(jsim, seed=7), outdir=str(d), n_steps=4)
    (d / "tlab.ini").write_text(PLANES_2D)
    jnc = {}
    for p in jconvert.planes_to_nc(jsim, str(d), [2, 4]):
        jnc[p] = _nc_vars(p)
    tower = jconvert.towers_to_nc(jsim, str(d))
    jnc[tower] = _nc_vars(tower)
    for p in jnc:
        os.remove(p)
    common = ["--ini", str(d / "tlab.ini"), "--outdir", str(d)]
    assert cli.main(["planes2nc", *common, "--files", "2,4"]) == 0
    assert cli.main(["tower2nc", *common]) == 0
    tsim = Simulation.from_case(load_case(Ini(text=PLANES_2D)), dtype=F64,
                                device="cpu")
    assert sorted(tconvert.planes_to_nc(tsim, str(d), [2, 4])
                  + [tconvert.towers_to_nc(tsim, str(d))]) == sorted(jnc)
    for p, ref in jnc.items():
        got = _nc_vars(p)
        assert sorted(got) == sorted(ref), p
        for k in ref:
            assert np.array_equal(got[k], ref[k]), (p, k)
    assert "VelocityX" in jnc[str(d / "planesJ.2.nc")]
    assert jnc[tower]["Pressure"].shape == (4, 64, 8)
