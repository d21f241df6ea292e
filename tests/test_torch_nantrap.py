"""The port's NaN trap (tlab_tpu_torch/utils/nantrap.py: `--debug-nans`,
`[Main] DebugNans=yes`) against tlab_tpu's jax_debug_nans, float64 on the
CPU: the flag on every command of tlab_tpu's parser and the case key on
every command that reads a case; a blow-up case through both command lines
(FloatingPointError after the same dns.out rows, with the flag and with the
key, where the untrapped run writes its NaN row and stops with status 1);
sane runs of the incompressible, compressible and particle steps with the
trap on and off (bit for bit in the port, dns.out equal to tlab_tpu
--debug-nans's in every printed digit), the post-processing commands the
same way; regions (a masked 0/0 does not trap, a NaN names its aten op),
the Burgers entry points under the per-op check; and on a 2x1 gloo mesh
the blow-up case and the flag every rank reads."""
import ast
import re
import os
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tlab_tpu_torch import entry
from tlab_tpu_torch.ops import burgers
from tlab_tpu_torch.parallel import mesh as pmesh
from tlab_tpu_torch.tools import cli
from tlab_tpu_torch.utils import nantrap

import test_torch_mesh_workers as workers

REPO = pathlib.Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
F64 = torch.float64
NAN_MSG = "invalid value (nan) encountered in "

torch.set_num_threads(2)


def _cut(text, pairs):
    for old, new in pairs:
        assert old in text, old
        text = text.replace(old, new)
    return text


# tests/data/case01_small3d.ini at 32x32x16 with TimeStep=0.5: the step
# makes a NaN at the third step
BLOW_UP = _cut((DATA / "case01_small3d.ini").read_text(), (
    ("Imax=128", "Imax=32"), ("Jmax=64", "Jmax=32"),
    ("points_1=129", "points_1=33"), ("points_1=64", "points_1=32"),
    ("TimeStep=-0.016", "TimeStep=0.5")))
# the sane cases: 32x24x16, 3 steps, a restart and a statistics step at 3
_SANE_CUT = (("Imax=128", "Imax=32"), ("Jmax=64", "Jmax=24"),
             ("points_1=129", "points_1=33"), ("points_1=64", "points_1=24"),
             ("End=10", "End=3"), ("Restart=10", "Restart=3"),
             ("Statistics=5", "Statistics=3"))
SANE = {
    "incompressible": _cut((DATA / "case01_small3d.ini").read_text(),
                           _SANE_CUT),
    "compressible": _cut((DATA / "case02_small3d.ini").read_text(),
                         _SANE_CUT),
    "particles": _cut((DATA / "case01_small3d.ini").read_text(), _SANE_CUT)
    + "\n[Particles]\nType=Tracer\nNumber=300\nDiamIniP=0.3\n"
      "YMeanRelativeIniP=0.5\nTrajNumber=8\n",
    # the regions of the statistics: in-run PDFs and spectra, phase
    # averages, planes, towers with the diagnostic pressure
    "statistics": _cut((DATA / "case01_small3d.ini").read_text(),
                       _SANE_CUT + (("IteraLog=1", "IteraLog=1\nPhaseAvg=1"
                                     "\nSavePlanes=3"),))
    + "\n[Statistics]\nPdfs=yes\nIntermittency=yes\nSpectrums=yes\n"
      "Correlations=yes\n[SavePlanes]\nPlanesJ=5\n[SaveTowers]\n"
      "Stride=8,1,1\nPressure=yes\n"}


def _jax_commands() -> list:
    """The command choices of tlab_tpu's parser
    (tlab_tpu/tools/cli.py's add_argument("command", choices=...))."""
    tree = ast.parse((REPO / "tlab_tpu" / "tools" / "cli.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and node.args[0].value == "command":
            for kw in node.keywords:
                if kw.arg == "choices":
                    return ast.literal_eval(kw.value)
    raise AssertionError("no command choices in tlab_tpu's parser")


def _torch(*argv):
    return cli.main([*argv, "--device", "cpu", "--x64"])


def _jax(*argv, timeout=300):
    """tlab_tpu's command line in a subprocess (jax.config is global)."""
    return subprocess.run(
        [sys.executable, "-m", "tlab_tpu.tools.cli", *argv, "--cpu",
         "--x64"], cwd=REPO, capture_output=True, text=True,
        timeout=timeout, env=dict(os.environ, PYTHONPATH=str(REPO)))


def _case_dir(path, text, debug_key=False):
    path.mkdir(parents=True, exist_ok=True)
    if debug_key:
        text = text.replace("[Main]\n", "[Main]\nDebugNans=yes\n", 1)
    (path / "tlab.ini").write_text(text)
    return ["--ini", str(path / "tlab.ini"), "--outdir", str(path)]


def _files(path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())
            if p.name not in ("tlab.log", "tlab.ini") and p.is_file()}


def _log_rows(path) -> list:
    return [ln for ln in (path / "dns.out").read_text().splitlines()
            if not ln.startswith("#")]


@pytest.mark.parametrize("command", _jax_commands())
def test_parser_takes_the_flag_for_every_command(command):
    """--debug-nans parses with every command of tlab_tpu's parser."""
    assert cli._parser().parse_args([command, "--debug-nans"]).debug_nans
    assert not cli._parser().parse_args([command]).debug_nans


@pytest.mark.parametrize("how", ["flag", "key", "neither"])
@pytest.mark.parametrize("command", _jax_commands())
def test_every_command_runs_under_the_trap(tmp_path, monkeypatch, command,
                                           how):
    """The trap is on while each command works: from the flag for every
    command (before the command branches, as tlab_tpu), from the case's
    [Main] DebugNans=yes for every command that reads the case file."""
    seen = []

    def record(*_args, **_kw):
        seen.append(nantrap.active())
        return 0

    for name in ("_transgrid", "_cloud_tool", "_case_command"):
        monkeypatch.setattr(cli, name, record)
    argv = _case_dir(tmp_path, BLOW_UP, debug_key=how == "key")
    cli.main([command, *argv] + (["--debug-nans"] if how == "flag" else []))
    reads_case = command not in ("transgrid", *cli.CLOUD_TOOLS)
    assert seen == [how == "flag" or (how == "key" and reads_case)]
    assert not nantrap.active()


@pytest.fixture(scope="module")
def blow_up(tmp_path_factory):
    """The blow-up case's grid and initial fields, and the untrapped run."""
    top = tmp_path_factory.mktemp("blow_up")
    start = top / "start"
    argv = _case_dir(start, BLOW_UP)
    assert _torch("inigrid", *argv) == 0
    assert _torch("ini", *argv) == 0
    plain = top / "plain"
    shutil.copytree(start, plain)
    assert _torch("dns", *_case_dir(plain, BLOW_UP)) == 0
    return start, _log_rows(plain)


def test_untrapped_blow_up_ends_with_its_nan_row(blow_up):
    """Without the trap the run writes its NaN row with status 1 at the
    third step and stops (the nan_abort, as tlab_tpu's)."""
    _, rows = blow_up
    assert len(rows) == 4
    assert rows[-1].split()[:2] == ["1", "3"] and "NaN" in rows[-1]
    assert all(r.split()[0] == "0" for r in rows[:-1])


@pytest.mark.parametrize("how", ["flag", "key"])
def test_blow_up_traps_as_tlab_tpu(tmp_path, blow_up, how):
    """--debug-nans, or [Main] DebugNans=yes: both command lines raise
    FloatingPointError at the step that makes the NaN, after the rows of
    the untrapped run before it, the same rows in both."""
    start, plain = blow_up
    runs = {}
    for name in ("torch", "jax"):
        out = tmp_path / name
        shutil.copytree(start, out)
        argv = _case_dir(out, BLOW_UP, debug_key=how == "key") \
            + (["--debug-nans"] if how == "flag" else [])
        if name == "torch":
            with pytest.raises(FloatingPointError, match=re.escape(NAN_MSG + "aten")):
                _torch("dns", *argv)
        else:
            r = _jax("dns", *argv)
            assert r.returncode != 0
            assert "FloatingPointError: " + NAN_MSG in r.stderr
        runs[name] = _log_rows(out)
    assert runs["torch"] == runs["jax"] == plain[:-1]
    assert not nantrap.active()


@pytest.fixture(scope="module")
def sane(tmp_path_factory):
    """Each sane case's start (inigrid, ini and, with particles, inipart)
    and the port's dns with the trap off and on."""
    top = tmp_path_factory.mktemp("sane")
    out = {}
    for name, text in SANE.items():
        start = top / name / "start"
        argv = _case_dir(start, text)
        for command in ("inigrid", "ini") + (
                ("inipart",) if name == "particles" else ()):
            assert _torch(command, *argv) == 0
        runs = {}
        for trap in (False, True):
            d = top / name / f"trap{int(trap)}"
            shutil.copytree(start, d)
            assert _torch("dns", *_case_dir(d, text),
                          *(["--debug-nans"] if trap else [])) == 0
            runs[trap] = d
        out[name] = start, runs
    return out


@pytest.mark.parametrize("case", list(SANE))
def test_sane_run_is_the_same_with_the_trap(sane, case):
    """dns.out, the restarts, the avg tables and the particle files of the
    run with the trap on equal those without it, byte for byte."""
    _, runs = sane[case]
    off, on = _files(runs[False]), _files(runs[True])
    assert sorted(off) == sorted(on)
    assert any(n.startswith("avg") for n in on)
    assert any(n.startswith("flow.3") for n in on)
    if case == "particles":
        assert "part.3" in on
    if case == "statistics":
        assert {"pdf3.u", "xsp3.Euu", "phavg3.npz", "planesJ.3"} <= set(on)
        assert any(n.startswith("tower") for n in on)
    for name in off:
        assert on[name] == off[name], name


@pytest.mark.parametrize("case", list(SANE))
def test_sane_run_equals_tlab_tpu_with_the_trap(tmp_path, sane, case):
    """tlab_tpu --debug-nans runs the same start to the end without
    trapping, and its dns.out equals the port's in every printed digit."""
    start, runs = sane[case]
    out = tmp_path / "jax"
    shutil.copytree(start, out)
    r = _jax("dns", *_case_dir(out, SANE[case]), "--debug-nans")
    assert r.returncode == 0, r.stderr[-2000:]
    assert _log_rows(out) == _log_rows(runs[True])


POST = {"averages": ["--gate-scalar", "1"], "pdfs": [], "spectra": [],
        "superlayer": [], "visuals": ["--fields", "Enstrophy,Pressure"],
        "apriori": []}


@pytest.mark.parametrize("command", list(POST))
def test_post_processing_is_the_same_with_the_trap(tmp_path, sane,
                                                   command):
    """Each post-processing command on the sane run's restart writes the
    same files with the trap on as without it, byte for byte."""
    _, runs = sane["incompressible"]
    got = {}
    for trap in (False, True):
        d = tmp_path / f"trap{int(trap)}"
        shutil.copytree(runs[False], d)
        before = set(os.listdir(d))
        assert _torch(command, *_case_dir(d, SANE["incompressible"]),
                      "--files", "3", *POST[command],
                      *(["--debug-nans"] if trap else [])) == 0
        got[trap] = {n: (d / n).read_bytes()
                     for n in sorted(set(os.listdir(d)) - before)
                     if n != "tlab.log"}
    assert got[True] and got[True] == got[False]


def test_masked_division_in_a_region_does_not_trap():
    """A region whose intermediate is a masked 0/0 and whose output is
    finite does not trap (jax_debug_nans checks a jit's outputs); the same
    ops outside a region trap at the division."""
    def masked(a, b):
        return torch.where(b != 0, a / b, torch.zeros_like(a))

    a = torch.tensor([1.0, 0.0, 2.0], dtype=F64)
    b = torch.tensor([2.0, 0.0, 4.0], dtype=F64)
    with nantrap.trap():
        out = nantrap.region("masked", masked)(a, b)
        assert torch.equal(out, torch.tensor([0.5, 0.0, 0.5], dtype=F64))
        with pytest.raises(FloatingPointError,
                           match=re.escape(NAN_MSG + "aten.div.Tensor")):
            masked(a, b)


def test_region_names_the_op_that_made_the_nan():
    """A region whose output holds a NaN raises naming the aten op that
    made it in the op-by-op re-run, from the inputs as they were at entry
    (the region writes into one of them)."""
    def body(x, y):
        x.mul_(0.0)
        z = torch.sqrt(y - 2.0)
        return x + torch.log(z * 0.0 + 1.0)

    x = torch.ones(4, dtype=F64)
    y = torch.tensor([3.0, 4.0, 1.0, 5.0], dtype=F64)
    with nantrap.trap():
        with pytest.raises(FloatingPointError,
                           match=re.escape(NAN_MSG + "aten.sqrt.default") + "$"):
            nantrap.region("body", body)(x, y)
    assert not nantrap.active() and not nantrap.checking()
    # the trap off: the same call returns its NaN
    assert torch.isnan(nantrap.region("body", body)(x, y)).any()


def test_inf_does_not_trap():
    """The trap is jax_debug_nans, not jax_debug_infs: an Inf passes."""
    with nantrap.trap():
        out = torch.tensor([1.0, 0.0], dtype=F64)
        inf = 1.0 / out
        assert torch.isinf(inf).any()
        assert not nantrap.nan_flag(inf)


def test_factories_and_in_place_writes():
    """empty is not a result (its memory may hold NaN bit patterns); an
    in-place op and an out= op are checked by what they wrote."""
    with nantrap.trap():
        buf = torch.empty(8, dtype=F64)
        buf.view(torch.int64).fill_(-1)          # a NaN bit pattern
        buf.fill_(1.0)
        zero = torch.zeros(8, dtype=F64)
        with pytest.raises(FloatingPointError, match=re.escape("aten.div_.Tensor")):
            buf.mul_(0.0).div_(zero)
        with pytest.raises(FloatingPointError, match=re.escape("aten.div.out")):
            torch.div(zero, zero, out=torch.empty(8, dtype=F64))


def _overflowing(axis: int, n: int = 16):
    """A finite float32 Burgers input whose products overflow: x ~ 1e38,
    so the [D1; D2] product holds inf and the combine inf - inf."""
    _, P, _ = entry.build(n, n, n, torch.float32, "cpu")
    d12 = P["d12" + "xyz"[axis]].contiguous()
    rng = np.random.default_rng(4)
    x = torch.as_tensor(3e38 * rng.uniform(-1, 1, (2, n, n, n)),
                        dtype=torch.float32)
    conv = torch.as_tensor(rng.uniform(0.5, 1.0, (n, n, n)),
                           dtype=torch.float32)
    nu = torch.tensor([1e-3, 2e-3], dtype=torch.float32)
    return d12, x, conv, nu


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_burgers_entry_point_is_named(axis):
    """fused_burgers (the plain version on the CPU, the kernel on the card)
    is one op to the per-op check: a NaN in its output names its entry
    point; without the trap the same call returns its NaN."""
    d12, x, conv, nu = _overflowing(axis)
    assert torch.isfinite(x).all()
    out = burgers.fused_burgers(d12, x, conv, nu, axis)
    assert torch.isnan(out).any()
    with nantrap.trap():
        with pytest.raises(FloatingPointError,
                           match=re.escape(NAN_MSG + burgers.ENTRY_POINTS[axis]) + "$"):
            burgers.fused_burgers(d12, x, conv, nu, axis)
        # the plain version alone: its own aten ops are checked
        with pytest.raises(FloatingPointError, match=re.escape(NAN_MSG + "aten")):
            burgers.fused_burgers_plain(d12, x, conv, nu, axis)


def test_nan_flag_and_region_on_two_ranks(tmp_path):
    """On a 2x1 gloo mesh, rank 1 alone makes the NaN: nan_flag reads True
    on both ranks, and both raise naming rank 1's division (rank 0's NaN
    came through the all-reduce)."""
    got = pmesh.spawn(workers.nan_trap_ranks, 2, 1, "cpu",
                      store_dir=str(tmp_path))
    for flag, msg in got:
        assert flag is True
        assert msg == (NAN_MSG + "aten.div.Tensor (rank 1 of the 2x1 "
                       "mesh, in body)")


def test_mesh_run_traps_on_every_rank(tmp_path, blow_up):
    """dns --mesh 2,1 of the blow-up case with the trap fails at once with
    the FloatingPointError and its op in the message, never after a
    collective's timeout (TIMEOUT_S)."""
    start, _ = blow_up
    out = tmp_path / "mesh"
    shutil.copytree(start, out)
    t0 = time.monotonic()
    with pytest.raises(SystemExit) as e:
        _torch("dns", *_case_dir(out, BLOW_UP), "--mesh", "2,1",
               "--debug-nans")
    assert time.monotonic() - t0 < pmesh.TIMEOUT_S / 4
    assert "FloatingPointError: " + NAN_MSG + "aten" in str(e.value)
    assert "of the 2x1 mesh" in str(e.value)
    assert len(_log_rows(out)) == 3
