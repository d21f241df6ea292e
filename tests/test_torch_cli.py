"""The port's command line (tlab_tpu_torch/tools/cli.py) on the CPU: the
files `ini` and `dns` leave behind, against tlab_tpu's CLI on the same case,
tlab_tpu's commands, and the message for what is not ported."""
import argparse
import os
import shutil
from unittest import mock

import numpy as np
import pytest
import torch

from tlab_tpu.io import fields_io as jio
from tlab_tpu.tools import cli as jcli
from tlab_tpu_torch.io import fields_io as tio
from tlab_tpu_torch.stats import averages as tavg
from tlab_tpu_torch.tools import cli

DATA = os.path.join(os.path.dirname(__file__), "data")
CASE3D = os.path.join(DATA, "case01_small3d.ini")

# the test workers share the machine's cores: with every worker's products
# on all of them, the threads spin on each other and a step takes 20x longer
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def rundir(tmp_path_factory):
    """inigrid, ini and dns through the port's CLI in float64 on the CPU."""
    out = tmp_path_factory.mktemp("cli")
    ini = str(out / "tlab.ini")
    shutil.copy(CASE3D, ini)
    common = ["--ini", ini, "--outdir", str(out), "--device", "cpu", "--x64"]
    assert cli.main(["inigrid", *common]) == 0
    assert cli.main(["ini", *common]) == 0
    assert cli.main(["dns", *common]) == 0
    return out


def test_files_are_written(rundir):
    assert sorted(os.listdir(rundir)) == [
        "avg10", "avg10s1", "avg5", "avg5s1", "dns.out", "flow.0.1",
        "flow.0.2", "flow.0.3", "flow.10.1", "flow.10.2", "flow.10.3",
        "grid", "scal.0.1", "scal.10.1", "tlab.ini", "tlab.ini.bak",
        "tlab.log"]
    rows = [ln for ln in (rundir / "dns.out").read_text().splitlines()
            if not ln.startswith("#")]
    assert len(rows) == 11 and all(r.startswith("0 ") for r in rows)
    _, _, cols = tavg.read_avg(str(rundir / "avg10"))
    assert all(np.isfinite(v).all() for v in cols.values())


def test_matches_the_jax_cli(rundir, tmp_path):
    """tlab_tpu's CLI on the same case file (float64, CPU): the initial
    fields agree to 1e-11, the final ones to 1e-10 of max|field|, and
    dns.out row for row in its printed digits."""
    ini = str(tmp_path / "tlab.ini")
    shutil.copy(CASE3D, ini)
    common = ["--ini", ini, "--outdir", str(tmp_path), "--cpu", "--x64"]
    assert jcli.main(["ini", *common]) == 0
    assert jcli.main(["dns", *common]) == 0
    for it, tol in ((0, 1e-11), (10, 1e-10)):
        for name in (f"flow.{it}.1", f"flow.{it}.2", f"flow.{it}.3",
                     f"scal.{it}.1"):
            a, pa, _ = jio.read_field(str(tmp_path / name))
            b, pb, _ = tio.read_field(str(rundir / name))
            assert np.max(np.abs(a - b)) <= tol * np.max(np.abs(a)), name
            assert abs(pa[0] - pb[0]) <= 1e-12 * max(abs(pa[0]), 1.0)
            assert pa[1] == pb[1]
    assert (tmp_path / "dns.out").read_text() == \
        (rundir / "dns.out").read_text()


def test_dns_restarts_from_its_own_files(rundir, tmp_path):
    """`dns` with [Iteration] Start=10 picks up flow.10.* and its time."""
    for name in ("flow.10.1", "flow.10.2", "flow.10.3", "scal.10.1"):
        shutil.copy(rundir / name, tmp_path / name)
    ini = tmp_path / "tlab.ini"
    with open(CASE3D) as fh:
        ini.write_text(fh.read().replace("Start=0", "Start=10")
                       .replace("End=10", "End=12"))
    assert cli.main(["dns", "--ini", str(ini), "--outdir", str(tmp_path),
                     "--device", "cpu", "--x64", "--inner-steps", "2"]) == 0
    rows = [ln.split() for ln in
            (tmp_path / "dns.out").read_text().splitlines()
            if not ln.startswith("#")]
    assert [int(r[1]) for r in rows] == [10, 12]
    t10 = tio.read_field(str(rundir / "flow.10.1"))[1][0]
    assert abs(float(rows[0][2]) - t10) <= 1e-6 * t10


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("there is a card: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["ini", "--ini", CASE3D, "--outdir", str(tmp_path)])


def command_choices(main) -> list:
    """The `command` choices of the parser that a CLI's main builds, read
    where it calls parse_args (which then exits before parsing)."""
    found = []

    def grab(parser, *args, **kwargs):
        found.extend(next(a.choices for a in parser._actions
                          if a.dest == "command"))
        raise SystemExit(0)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        with pytest.raises(SystemExit):
            main([])
    return found


# tlab_tpu's commands, from its parser; the port refuses none
JAX_COMMANDS = command_choices(jcli.main)


def test_the_port_has_tlab_tpus_commands():
    assert len(JAX_COMMANDS) > 1
    assert sorted(command_choices(cli.main)) == sorted(JAX_COMMANDS)


@pytest.mark.parametrize("command", JAX_COMMANDS)
def test_every_command_of_tlab_tpu_is_a_command(command, capsys):
    """Each of tlab_tpu's commands parses in the port's CLI (`--help`
    exits 0; an unknown command exits 2); tests/test_torch_{visuals,
    apriori,interpolate,cloudstate}.py hold the ones ported last."""
    with pytest.raises(SystemExit) as e:
        cli.main([command, "--help"])
    assert e.value.code == 0
    with pytest.raises(SystemExit) as e:
        cli.main([command + "x", "--help"])
    assert e.value.code == 2
    capsys.readouterr()


def test_inipart_once_refused_matches_jax(tmp_path):
    """`inipart`, refused until the particles were ported: the 3-D case
    with [Particles] through both command lines, part.0 byte for byte."""
    with open(CASE3D) as fh:
        text = fh.read() + ("\n[Particles]\nType=Tracer\nNumber=500\n"
                            "DiamIniP=0.2\nYMeanRelativeIniP=0.4\n")
    for name, main, extra in (("torch", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, ["--cpu"])):
        out = tmp_path / name
        out.mkdir()
        (out / "tlab.ini").write_text(text)
        assert main(["inipart", "--ini", str(out / "tlab.ini"), "--outdir",
                     str(out), "--x64", *extra]) == 0
    assert (tmp_path / "torch" / "part.0").read_bytes() == \
        (tmp_path / "jax" / "part.0").read_bytes()


@pytest.mark.parametrize("section, prefix", [
    ("[SavePlanes]\nPlanesJ=3,40\nPlanesK=2\n", "planes"),
    ("[SaveTowers]\nStride=16,4,8\nPressure=yes\n", "tower.")])
def test_saveplanes_and_savetowers_through_both_clis(rundir, tmp_path,
                                                      section, prefix):
    """[SavePlanes] and [SaveTowers], refused until this slice: dns of 2
    steps of the 3-D case from the port's initial fields through both
    command lines (planes every step, the towers flushed at the restart of
    step 2), then planes2nc / tower2nc: dns.out in every printed digit, the
    same files, equal to the runs' round-off (planes in float32, towers in
    float64), and the NetCDF variables of each to the same round-off."""
    with open(CASE3D) as fh:
        text = fh.read().replace("Restart=10", "Restart=2").replace(
            "IteraLog=1", "IteraLog=1\nSavePlanes=1") + "\n" + section
    for name, main, extra in (("torch", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, ["--cpu"])):
        out = tmp_path / name
        out.mkdir()
        (out / "tlab.ini").write_text(text)
        for f in ("flow.0.1", "flow.0.2", "flow.0.3", "scal.0.1"):
            shutil.copy(rundir / f, out / f)
        common = ["--ini", str(out / "tlab.ini"), "--outdir", str(out),
                  "--x64", *extra]
        assert main(["dns", *common, "--steps", "2"]) == 0
        conv = "planes2nc" if prefix == "planes" else "tower2nc"
        assert main([conv, *common, "--files", "1,2"]) == 0
    t, j = tmp_path / "torch", tmp_path / "jax"
    assert (t / "dns.out").read_text() == (j / "dns.out").read_text()
    names = sorted(n for n in os.listdir(j) if n.startswith(prefix)
                   and not n.endswith(".nc"))
    assert names == sorted(n for n in os.listdir(t) if n.startswith(prefix)
                           and not n.endswith(".nc"))
    assert len(names) == (4 if prefix == "planes" else 5 * 8 * 2 + 5)
    dt, tol = ("<f4", 1e-6) if prefix == "planes" else ("<f8", 1e-10)
    for n in names:
        a, b = np.fromfile(t / n, dt), np.fromfile(j / n, dt)
        assert np.abs(a - b).max() <= tol * np.abs(b).max(), n
    from scipy.io import netcdf_file
    ncs = sorted(n for n in os.listdir(j) if n.endswith(".nc"))
    assert ncs and ncs == sorted(n for n in os.listdir(t)
                                 if n.endswith(".nc"))
    for n in ncs:
        with netcdf_file(t / n, "r", mmap=False) as ft, \
                netcdf_file(j / n, "r", mmap=False) as fj:
            assert sorted(ft.variables) == sorted(fj.variables)
            for k, v in fj.variables.items():
                a, b = np.array(ft.variables[k][:]), np.array(v[:])
                assert a.shape == b.shape, (n, k)
                assert np.abs(a - b).max() <= 1e-6 * max(np.abs(b).max(),
                                                           1e-30), (n, k)


COMPRESSIBLE = ("Equations=incompressible", "Equations=internal")


@pytest.mark.parametrize("edits, item", [
    # the options the case file can ask for beyond the port (the
    # compressible set's characteristic boundaries and moist mixture run
    # now: test_compressible_option_once_refused_runs_as_jax; the
    # [Statistics] pdfs and spectra: tests/test_torch_postprocess.py;
    # [SavePlanes] and [SaveTowers]: tests/test_torch_planes.py and
    # test_saveplanes_and_savetowers_through_both_clis below)
    ((("[BufferZone]\nType=none",
       "[BufferZone]\nType=none\n[Parallel]\nMesh=4,2"),), "A17")])
def test_unported_option_exits_with_its_item(rundir, tmp_path, edits, item):
    for name in ("flow.0.1", "flow.0.2", "flow.0.3", "scal.0.1"):
        shutil.copy(rundir / name, tmp_path / name)
    ini = tmp_path / "tlab.ini"
    with open(CASE3D) as fh:
        text = fh.read()
    for old, new in edits:
        assert old in text
        text = text.replace(old, new)
    ini.write_text(text)
    common = ["--ini", str(ini), "--outdir", str(tmp_path), "--device",
              "cpu", "--x64", "--steps", "1"]
    with pytest.raises(SystemExit, match=f"ROADMAP {item}"):
        cli.main(["ini", *common])
        cli.main(["dns", *common])


def test_compressible_option_once_refused_runs_as_jax(tmp_path):
    """The characteristic (NSCBC) outflow at Jmin of the compressible set,
    refused until it was ported: inigrid, ini and dns (3 steps) of the 3-D
    case with Equations=internal through both command lines, dns.out in
    every printed digit."""
    from tlab_tpu.tools import cli as jcli
    with open(CASE3D) as fh:
        text = fh.read()
    for old, new in (COMPRESSIBLE,
                     ("VelocityJmin=freeslip", "VelocityJmin=outflow")):
        assert old in text
        text = text.replace(old, new)
    for name, main, extra in (("torch", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, ["--cpu"])):
        out = tmp_path / name
        out.mkdir()
        (out / "tlab.ini").write_text(text)
        common = ["--ini", str(out / "tlab.ini"), "--outdir", str(out),
                  "--x64", "--steps", "3", *extra]
        for command in ("inigrid", "ini", "dns"):
            assert main([command, *common]) == 0
    got = (tmp_path / "torch" / "dns.out").read_text()
    assert got == (tmp_path / "jax" / "dns.out").read_text()
    rows = [r.split() for r in got.splitlines() if not r.startswith("#")]
    assert len(rows) == 4 and all(r[0] == "0" for r in rows)
