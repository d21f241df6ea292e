"""The port's dns on a rank mesh through its command line (tlab_tpu's
tests/test_mesh_driver.py for the port): ini, then dns on one device and
with `--mesh 2,2 --device cpu --x64` (four ranks spawned over gloo), for
tlab_tpu's six cases: dns.out equal in every printed digit (the NewtonRs
column aside) and the restart fields to 1e-12 of their max (1e-8 absolute
for case14, whose momenta are round-off of p ~ 8e4, as tlab_tpu's test).
case01 also against `tlab_tpu dns --mesh 2,2` (1e-10), and with
[Parallel] Mesh=2,2 in the case file instead of --mesh; a decomposition
the mesh does not divide is refused with tlab_tpu's message."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from tlab_tpu_torch.io.fields_io import read_field
from tlab_tpu_torch.tools import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
FIELD_TOL = 1e-12
JAX_TOL = 1e-10


def _rows(path):
    return [ln.split() for ln in open(os.path.join(path, "dns.out"))
            if not ln.startswith("#")]


def _single_and_mesh(tmp_path, ini, mesh_args=("--mesh", "2,2")):
    """(single-device dir, mesh dir) after ini and both dns runs."""
    one, many = str(tmp_path / "single"), str(tmp_path / "mesh")
    common = ["--ini", ini, "--device", "cpu", "--x64"]
    assert cli.main(["ini", *common, "--outdir", one]) == 0
    shutil.copytree(one, many)
    assert cli.main(["dns", *common, "--outdir", one]) == 0
    assert cli.main(["dns", *common, "--outdir", many, *mesh_args]) == 0
    return one, many


def _restarts(path):
    return sorted(f for f in os.listdir(path)
                  if f.startswith(("flow.10.", "scal.10.")))


@pytest.mark.parametrize("ini,newton,atol", [
    ("case01_small3d.ini", False, 0.0),
    ("case02_small3d.ini", False, 0.0),
    ("case93_small3d.ini", False, 0.0),
    ("case93stag_small3d.ini", False, 0.0),
    ("case14_small3d.ini", True, 1e-8),
    ("case_filter_small3d.ini", False, 0.0),
])
def test_mesh_dns_matches_one_device(tmp_path, ini, newton, atol):
    one, many = _single_and_mesh(tmp_path, os.path.join(DATA, ini))
    a, b = _rows(one), _rows(many)
    assert len(a) == len(b) == 11
    for ra, rb in zip(a, b):
        if newton:          # the last column is NewtonRs
            ra, rb = ra[:-1], rb[:-1]
        assert ra == rb, (ra, rb)
    names = _restarts(one)
    assert names and names == _restarts(many)
    for name in names:
        x = read_field(os.path.join(one, name))[0]
        y = read_field(os.path.join(many, name))[0]
        err = np.abs(x - y).max()
        assert err <= max(FIELD_TOL * np.abs(x).max(), atol), (name, err)
    log = open(os.path.join(many, "tlab.log")).read()
    assert "mesh 2x2: 4 ranks, backend gloo (on the CPU)" in log
    # rank 0 writes every file, the others none: no second dns.out header
    assert open(os.path.join(many, "dns.out")).read().count("Itn.") == 1


def test_case_file_mesh_and_tlab_tpu_mesh(tmp_path):
    """case01 with [Parallel] Mesh=2,2 in its file (no --mesh) equals the
    single-device run, and tlab_tpu's `dns --mesh 2,2` of the same initial
    fields to 1e-10."""
    text = open(os.path.join(DATA, "case01_small3d.ini")).read()
    ini = tmp_path / "tlab.ini"
    ini.write_text(text + "\n[Parallel]\nMesh=2,2\n")
    one, many = _single_and_mesh(tmp_path, str(ini), mesh_args=())
    assert _rows(one) == _rows(many)
    jdir = str(tmp_path / "jax")
    shutil.copytree(one, jdir, ignore=shutil.ignore_patterns(
        "dns.out", "avg*", "*.10.*", "tlab.log"))
    env = dict(os.environ, XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "").replace(
            "--xla_force_host_platform_device_count=8", "")
        + " --xla_force_host_platform_device_count=4").strip())
    r = subprocess.run(
        [sys.executable, "-m", "tlab_tpu.tools.cli", "dns", "--ini",
         str(ini), "--cpu", "--x64", "--outdir", jdir, "--mesh", "2,2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    for name in _restarts(many):
        x = read_field(os.path.join(jdir, name))[0]
        y = read_field(os.path.join(many, name))[0]
        assert np.abs(x - y).max() <= JAX_TOL * np.abs(x).max(), name


def test_bad_decomposition_is_refused(tmp_path):
    """nx = 128 does not split over px = 3: tlab_tpu's ValueError, before
    any rank starts."""
    ini = os.path.join(DATA, "case01_small3d.ini")
    with pytest.raises(ValueError, match=r"mesh \(3,2\) incompatible with "
                       r"grid \(128,16\): needs nx%px==0"):
        cli.main(["dns", "--ini", ini, "--device", "cpu", "--x64",
                  "--outdir", str(tmp_path), "--mesh", "3,2"])
