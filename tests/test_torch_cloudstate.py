"""The cloud-state tools (tools/cloudstate.py) and the commands state,
smooth, saturation and reversal against tlab_tpu, float64 on the CPU.

Limits: the functions' arrays 1e-12 of each one's max; the commands' .dat
files (tlab_tpu with --x64) equal in every printed digit.  Then
tests/test_thermo.py's properties on the port: the vapor table partitions
qt into ql + qv, and the cloud-top pair shows buoyancy reversal with
chi_star in [0, 1] and b_star <= 0."""
import os

import numpy as np
import pytest
import torch

from tlab_tpu.physics import thermo as jthermo
from tlab_tpu.tools import cli as jcli
from tlab_tpu.tools import cloudstate as jcs
from tlab_tpu_torch.physics import thermo as tthermo
from tlab_tpu_torch.tools import cli as tcli
from tlab_tpu_torch.tools import cloudstate as tcs

TOL = 1e-12
KW = dict(mixture="airwater", scale_height_inv=0.01, T_ref=298.0,
          L_ref=100.0)
TP_T, TP_J = tthermo.ThermoParams(**KW), jthermo.ThermoParams(**KW)
# tests/test_thermo.py:90-103: a cloudy parcel and its warm, dry
# environment
CLOUD = (0.95, 0.02, 1.01, 0.004)
CLOUDTOP = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                        "cloudtop_anelastic", "tlab.ini")


def _close(got: dict, want: dict, keys):
    for k in keys:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape, k
        assert np.max(np.abs(a - b)) <= TOL * max(np.max(np.abs(b)),
                                                  1e-300), k


def test_mixing_diagram_and_reversal_match():
    got = tcs.buoyancy_reversal(TP_T, *CLOUD, 1.0, device="cpu")
    want = jcs.buoyancy_reversal(TP_J, *CLOUD, 1.0)
    _close(got, want, ("chi", "h", "qt", "T", "ql", "b"))
    for k in ("chi_star", "b_star", "chi_s"):
        assert abs(got[k] - want[k]) <= TOL, k


def test_vapor_table_and_saturation_curve_match():
    qt = np.linspace(0.0, 0.03, 31)
    _close(tcs.vapor_table(TP_T, 1.0, 0.95, qt, device="cpu"),
           jcs.vapor_table(TP_J, 1.0, 0.95, qt), ("qt", "ql", "qv", "qs",
                                                  "T"))
    T = np.linspace(0.85, 1.05, 41)
    a = tcs.saturation_curve(TP_T, T, 0.9, device="cpu")
    b = jcs.saturation_curve(TP_J, T, 0.9)
    assert np.max(np.abs(a - b)) <= TOL * np.max(np.abs(b))


def test_reversal_and_partition_properties():
    """tests/test_thermo.py's test_vapor_table_and_reversal on the port."""
    h1, qt1, h2, qt2 = CLOUD
    tab = tcs.vapor_table(TP_T, 1.0, h1, np.linspace(0.0, 0.03, 31),
                          device="cpu")
    assert np.all(tab["ql"] >= -1e-14)
    assert np.allclose(tab["qt"], tab["ql"] + tab["qv"], atol=1e-12)
    unsat = tab["qv"] < 0.98 * tab["qs"]
    assert np.all(tab["ql"][unsat] < 1e-10)
    d = tcs.buoyancy_reversal(TP_T, h1, qt1, h2, qt2, 1.0, device="cpu")
    assert 0.0 <= d["chi_star"] <= 1.0
    assert d["b_star"] <= 0.0 and d["b_star"] <= d["b"][-1] + 1e-12
    assert np.isfinite(d["chi_s"])


def test_functions_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("there is a card: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcs.saturation_curve(TP_T, np.linspace(0.9, 1.0, 3), 1.0)


COMMANDS = [
    ("state", ["--p", "1.0", "--h", "0.97", "--qt", "0.02"], "state.dat"),
    ("smooth", ["--p", "1.0", "--h", "0.97", "--range", "0.0,0.05,51"],
     "vapor.dat"),
    ("smooth", ["--p", "0.9", "--h", "0.95", "--npts", "17"], "vapor.dat"),
    ("saturation", ["--p", "0.9", "--range", "0.85,1.05,41"], "sat.dat"),
    ("saturation", ["--p", "1.0"], "sat.dat"),
    ("reversal", ["--p", "1.0", "--h", "0.95", "--qt", "0.02", "--h2",
                  "1.01", "--qt2", "0.004", "--npts", "101"],
     "reversal.dat"),
    ("reversal", ["--h", "0.9421", "--qt", "0.0266", "--h2", "1.0215",
                  "--qt2", "0.0053"], "reversal.dat")]


@pytest.mark.parametrize("ini", ["absent", "cloudtop"])
@pytest.mark.parametrize("command, flags, out", COMMANDS)
def test_commands_match(tmp_path, command, flags, out, ini):
    """Each command through both CLIs (tlab_tpu with --x64), without a case
    file and with examples/cloudtop_anelastic's [Thermodynamics]: the
    .dat file in every printed digit."""
    path = CLOUDTOP if ini == "cloudtop" else str(tmp_path / "absent.ini")
    files = {}
    for name, main, extra in (("t", tcli.main, ["--device", "cpu"]),
                              ("j", jcli.main, ["--cpu", "--x64"])):
        d = tmp_path / name
        assert main([command, "--ini", path, "--outdir", str(d), *flags,
                     *extra]) == 0
        files[name] = (d / out).read_text()
    assert files["t"] == files["j"]
    assert len(files["t"].splitlines()) >= 2


def test_missing_flags_exit():
    with pytest.raises(SystemExit, match="--h and --qt required"):
        tcli.main(["state", "--ini", "absent.ini", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--h --qt --h2 --qt2 required"):
        tcli.main(["reversal", "--ini", "absent.ini", "--h", "1.0",
                   "--device", "cpu"])
