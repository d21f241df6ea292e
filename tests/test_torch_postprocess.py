"""The slice as a whole: `ini | dns | averages | pdfs | spectra | superlayer
| stats2nc` of a 32x24x16 copy of tests/data/case01_small3d.ini (4 steps,
statistics at 2 and 4 with [Statistics] Pdfs/Intermittency/Spectrums/
Correlations, [Iteration] PhaseAvg=2) through the port's CLI (--device cpu
--x64) and tlab_tpu's (--cpu --x64), every output file compared; the
post-processing commands of the port also run on tlab_tpu's own restarts,
where they see the same fields; the compressible averages and pdfs of
case02_small3d.ini; [Main] FileFormat=netcdf.

Limits: restarts 1e-10 of max|field| and dns.out in every printed digit
(the port's earlier tests); avg, cavg, int and NetCDF tables 1e-8 of each
column's max (a column that vanishes analytically, 1e-13 absolute: round-off
of O(1) fields); spectra and superlayer 1e-10 on the same fields and 1e-6
of the max (float32 files) after the two runs' round-off; pdf counts equal
on the same fields, and within one sample a row after the runs' round-off
(the sample on a trimmed edge of the reference's two-pass range).  tlab_tpu
writes its plane fractions (int<it>) in float32: 1e-7."""
import os
import shutil

import numpy as np
import pytest
import torch

from tlab_tpu.io import fields_io as jio
from tlab_tpu.stats import averages as javg
from tlab_tpu.tools import cli as jcli
from tlab_tpu_torch.io import reference_formats as rf
from tlab_tpu_torch.stats import averages as tavg
from tlab_tpu_torch.tools import cli as tcli

DATA = os.path.join(os.path.dirname(__file__), "data")

torch.set_num_threads(2)

EDITS = [("Imax=128", "Imax=32"), ("Jmax=64", "Jmax=24"),
         ("points_1=129", "points_1=33"), ("points_1=64", "points_1=24"),
         ("End=10", "End=4"), ("Restart=10", "Restart=4"),
         ("Statistics=5", "Statistics=2"),
         ("IteraLog=1", "IteraLog=1\nPhaseAvg=2"),
         ("[BufferZone]", "[Statistics]\nPdfs=yes\nIntermittency=yes\n"
          "Spectrums=yes\nCorrelations=yes\n\n[PostProcessing]\nFiles=4\n"
          "ParamSpectra=4\nParamAverages=5\n\n[BufferZone]")]
POST = [("averages", ["--gate-scalar", "1", "--gate-level", "0.5"]),
        ("pdfs", []), ("spectra", []), ("superlayer", []),
        ("stats2nc", ["--files", "2,4"])]
RESTART = ("flow.4.1", "flow.4.2", "flow.4.3", "scal.4.1")


def _case(name, edits):
    with open(os.path.join(DATA, name)) as fh:
        text = fh.read()
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new)
    return text


def _run(cli, top, name, text, commands, common):
    d = top / name
    d.mkdir(exist_ok=True)
    (d / "tlab.ini").write_text(text)
    args = ["--ini", str(d / "tlab.ini"), "--outdir", str(d), *common]
    for cmd, extra in commands:
        assert cli.main([cmd, *args, *extra]) == 0, cmd
    return d


TORCH = ["--device", "cpu", "--x64"]
JAX = ["--cpu", "--x64"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """t: the port's whole chain; j: tlab_tpu's; tj: the port's
    post-processing of tlab_tpu's restarts."""
    top = tmp_path_factory.mktemp("slice")
    text = _case("case01_small3d.ini", EDITS)
    pre = [("inigrid", []), ("ini", []), ("dns", [])]
    t = _run(tcli, top, "t", text, pre + POST, TORCH)
    j = _run(jcli, top, "j", text, pre + POST, JAX)
    (top / "tj").mkdir()
    for n in RESTART + ("avg2", "avg4"):
        shutil.copy(j / n, top / "tj" / n)
    tj = _run(tcli, top, "tj", text, POST, TORCH)
    return t, j, tj


def _cols(ref, got, what, rtol=1e-8, atol=1e-13):
    assert list(got) == list(ref), what
    for k in ref:
        a, b = np.asarray(got[k], float), np.asarray(ref[k], float)
        assert a.shape == b.shape and np.isfinite(a).all(), (what, k)
        assert np.max(np.abs(a - b)) <= max(rtol * np.max(np.abs(b)),
                                            atol), (what, k)


def _avg(path):
    return tavg.read_avg(str(path))


def _pdf_counts_close(a_path, b_path, same_fields):
    a = rf.read_pdf_file(str(a_path))[2]
    b = rf.read_pdf_file(str(b_path))[2]
    nb = a.shape[1] - 2
    assert np.max(np.abs(a[:, nb:] - b[:, nb:])) <= \
        1e-6 * np.max(np.abs(b[:, nb:])), a_path
    moved = np.abs(a[:, :nb] - b[:, :nb]).sum(1)
    assert np.all(moved <= (0 if same_fields else 1)), a_path


def _spectrum_close(a_path, b_path, rtol):
    a = np.fromfile(a_path, "<f4")
    b = np.fromfile(b_path, "<f4")
    assert a.shape == b.shape and np.max(np.abs(a - b)) <= \
        rtol * np.max(np.abs(b)), a_path


def test_the_same_files(runs):
    t, j, tj = runs
    names = sorted(os.listdir(t))
    assert names == sorted(os.listdir(j))
    for n in ("phavg4.npz", "avg4.nc", "sl4.npz", "cavg4", "int4", "int2",
              "pdf2.u", "pdf4.p", "pdf4.s1", "xsp4.Euv", "pow4.Euv",
              "zcr4.C11", "rsp4.E11", "avgW24", "xcr2.Cuu"):
        assert n in names, n
    post = sorted(set(os.listdir(tj)) - set(RESTART) - {"tlab.ini"})
    assert set(post) <= set(names)
    assert all(("flow" not in n and "dns" not in n) for n in post)


def test_dns_matches_jax(runs):
    t, j, _ = runs
    assert (t / "dns.out").read_text() == (j / "dns.out").read_text()
    for n in RESTART:
        x = jio.read_field(str(t / n))[0]
        y = jio.read_field(str(j / n))[0]
        assert np.max(np.abs(x - y)) <= 1e-10 * np.max(np.abs(y)), n


@pytest.mark.parametrize("name", ["avg2", "avg2s1", "avg4", "avg4s1"])
def test_avg_tables_match_jax(runs, name):
    t, j, tj = runs
    rt, gt, ct = _avg(t / name)
    rj, gj, cj = javg.read_avg(str(j / name))
    assert rt == rj and gt == gj
    _cols(cj, ct, name)


@pytest.mark.parametrize("name", ["pdf2.u", "pdf2.v", "pdf2.w", "pdf2.s1",
                                  "pdf4.u", "pdf4.p", "pdf4.s1"])
def test_pdfs_match_jax(runs, name):
    """In-run (2) and offline (4) tables after the runs' round-off; the
    offline ones of tlab_tpu's restart equal on the fields both read, and
    within a sample a row on the pressure each solves."""
    t, j, tj = runs
    _pdf_counts_close(t / name, j / name, False)
    if name.startswith("pdf4"):
        _pdf_counts_close(tj / name, j / name, name != "pdf4.p")


@pytest.mark.parametrize("prefix", ["xsp", "zsp", "xcr", "zcr", "rsp",
                                    "pow", "pha"])
def test_spectra_match_jax(runs, prefix):
    t, j, tj = runs
    names = [n for n in os.listdir(j)
             if n.startswith(prefix) and not n.endswith(".npz")]
    assert names
    for n in names:
        dirs = [(t, 1e-6)] + ([(tj, 1e-10)] if n[3:].startswith("4.")
                              else [])
        for d, tol in dirs:
            if prefix != "pha":
                _spectrum_close(d / n, j / n, tol)
                continue
            # the phase, where the power is not round-off
            power = np.fromfile(j / ("pow" + n[3:]), "<f4")
            keep = power > 1e-6 * np.max(power)
            a = np.fromfile(d / n, "<f4")[keep]
            b = np.fromfile(j / n, "<f4")[keep]
            assert keep.any() and np.max(np.abs(a - b)) <= 1e-3, n


@pytest.mark.parametrize("name", ["cavg4", "int2", "int4", "avgW24"])
def test_tables_match_jax(runs, name):
    t, j, tj = runs
    rtol = 1e-7 if name.startswith("int") else 1e-8
    for d in (t, tj) if name != "int2" else (t,):
        _cols(javg.read_table(str(j / name)), tavg.read_table(str(d / name)),
              name, rtol=rtol)


def test_phase_average_matches_jax(runs):
    t, j, _ = runs
    a, b = np.load(t / "phavg4.npz"), np.load(j / "phavg4.npz")
    assert sorted(a.files) == sorted(b.files)
    assert np.array_equal(a["counts"], b["counts"]) and a["counts"].sum() == 2
    assert list(a["names"]) == ["u", "v", "w", "p", "s1"]
    for k in ("sums", "stress_sums"):
        assert np.max(np.abs(a[k] - b[k])) <= 1e-10 * np.max(np.abs(b[k]))


def test_superlayer_matches_jax(runs):
    t, j, tj = runs
    b = np.load(j / "sl4.npz")
    for d, tol in ((tj, 1e-10), (t, 1e-8)):
        a = np.load(d / "sl4.npz")
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            x, y = np.asarray(a[k], float), np.asarray(b[k], float)
            assert np.max(np.abs(x - y)) <= tol * max(np.max(np.abs(y)),
                                                      1e-300), k


def test_stats2nc_matches_the_tables(runs):
    """avg<it>.nc: read_avg_nc equals read_avg of the table it converted to
    float32 rounding, and tlab_tpu's .nc of the same table."""
    t, j, tj = runs
    for it in (2, 4):
        rt, gt, ct = tavg.read_avg_nc(str(t / f"avg{it}.nc"))
        ra, ga, ca = tavg.read_avg(str(t / f"avg{it}"))
        assert abs(rt - ra) <= 1e-7 * ra and gt == ga
        _cols({k: np.float32(v) for k, v in ca.items()}, ct, "nc", 0.0, 0.0)
        _, gj, cj = javg.read_avg_nc(str(j / f"avg{it}.nc"))
        assert gj == gt
        _cols(cj, ct, "nc", 1e-6)
    # the same table through both converters: the same file
    assert (tj / "avg2.nc").read_bytes() == (j / "avg2.nc").read_bytes()


def test_compressible_averages_and_pdfs(tmp_path):
    """case02_small3d.ini (Equations=internal) cut to 32x24x16 and 2 steps:
    tlab_tpu's ini + dns, then both packages' averages and pdfs of its
    restart: the Favre tables to 1e-8, the pdf files byte for byte."""
    edits = EDITS[:4] + [("End=10", "End=2"), ("Restart=10", "Restart=2"),
                         ("Statistics=5", "Statistics=2")]
    text = _case("case02_small3d.ini", edits)
    j = _run(jcli, tmp_path, "j", text,
             [("inigrid", []), ("ini", []), ("dns", []),
              ("averages", ["--files", "2"]), ("pdfs", ["--files", "2"])],
             JAX)
    (tmp_path / "t").mkdir()
    for n in os.listdir(j):
        if n.startswith("flow.2"):
            shutil.copy(j / n, tmp_path / "t" / n)
    t = _run(tcli, tmp_path, "t", text, [("averages", ["--files", "2"]),
                                         ("pdfs", ["--files", "2"])], TORCH)
    for n in ("avg2", "avg2s1"):
        rt, gt, ct = _avg(t / n)
        rj, gj, cj = javg.read_avg(str(j / n))
        assert rt == rj and gt == gj
        _cols(cj, ct, n)
    pdfs = sorted(n for n in os.listdir(j) if n.startswith("pdf2"))
    assert pdfs == ["pdf2.s1", "pdf2.u", "pdf2.v", "pdf2.w"]
    for n in pdfs:
        assert (t / n).read_bytes() == (j / n).read_bytes(), n


def test_netcdf_file_format(tmp_path):
    """[Main] FileFormat=netcdf: dns writes avg<it>.nc (the reference's
    USE_NETCDF layout) in both packages: the same groups and columns, each
    to float32 rounding of tlab_tpu's."""
    edits = EDITS[:4] + [("End=10", "End=2"), ("Restart=10", "Restart=2"),
                         ("Statistics=5", "Statistics=2"),
                         ("[Main]", "[Main]\nFileFormat=netcdf")]
    text = _case("case01_small3d.ini", edits)
    pre = [("ini", []), ("dns", [])]
    t = _run(tcli, tmp_path, "t", text, pre, TORCH)
    j = _run(jcli, tmp_path, "j", text, pre, JAX)
    for n in ("avg2.nc", "avg2s1.nc"):
        assert not (t / n[:-3]).exists()
        rt, gt, ct = tavg.read_avg_nc(str(t / n))
        rj, gj, cj = javg.read_avg_nc(str(j / n))
        assert rt == rj and gt == gj
        _cols(cj, ct, n, 1e-6, 1e-13)
