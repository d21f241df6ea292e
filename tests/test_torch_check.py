"""The startup operator self-test (ops/check.py, the reference OPR_CHECK)
and dns.run(opr_check=True) against tlab_tpu, float64 on the CPU.

The port reports tlab_tpu's keys but its rdft_* pair (the matmul DFT of
ops/rdft.py, the TPU's f32 transform, which the port does not have); its
random field comes from a torch.Generator, so the FFT round trip's residual
is held by its size (1e-14 of max|u| in float64), not to tlab_tpu's number.
Limits: d1x_mode1_error and poisson_error within 1e-8 of tlab_tpu's value
and 1e-15 for round-off (they differ by ~2e-16), and as printed in dns.out
within half a unit of the report's last digit more; dns.out equal line for
line but for the report's timing, rdft_* and residual lines and the digits
of those two errors.  Neither package checks the compressible set, whose
step has no Poisson plan."""
import os

import numpy as np
import pytest
import torch

from tlab_tpu.config import Ini as JIni, load_case as jload_case
from tlab_tpu.dycore.state import State as JState
from tlab_tpu.ops import check as jcheck
from tlab_tpu.runtime import Simulation as JSimulation
from tlab_tpu.tools import dns as jdns
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.convert import state_from_numpy
from tlab_tpu_torch.ops import check as tcheck
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.tools import dns as tdns

DATA = os.path.join(os.path.dirname(__file__), "data")
F64 = torch.float64
DETERMINISTIC = ("d1x_mode1_error", "poisson_error")
TIMINGS = ("fft_time_s", "poisson_time_s")
REL_TOL, ROUND_OFF = 1e-8, 1e-15
PRINTED = 5e-7           # half a unit of the report's 6th decimal, relative

torch.set_num_threads(2)


def _text(name, edits=()):
    with open(os.path.join(DATA, name)) as fh:
        text = fh.read()
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new, 1)
    return text


def shear_small_text() -> str:
    """examples/shear3d/tlab.ini at 128x64x64, the shape of chip_smoke.py's
    fp64 run of 16c."""
    root = os.path.join(os.path.dirname(__file__), os.pardir)
    with open(os.path.join(root, "examples", "shear3d", "tlab.ini")) as fh:
        text = fh.read()
    for old, new in (("Imax=512", "Imax=128"), ("Jmax=256", "Jmax=64"),
                     ("Kmax=256", "Kmax=64"), ("points_1=513", "points_1=129"),
                     ("points_1=256", "points_1=64"),
                     ("points_1=257", "points_1=65")):
        assert old in text, old
        text = text.replace(old, new, 1)
    return text


SMALL = [("Imax=128", "Imax=32"), ("Jmax=64", "Jmax=24"),
         ("points_1=129", "points_1=33"), ("points_1=64", "points_1=24")]
CASES = {"shear": _text("case01_small3d.ini", SMALL),
         "ibm": _text("case93_small3d.ini"),
         "smoke": shear_small_text()}
# the FFT round trip of a standard normal field (max|u| < 5 at these
# sizes): 1e-14 of max|u|
FFT_RESIDUAL = 5e-14


def close(got: float, want: float, printed: bool = False) -> bool:
    """got within REL_TOL of tlab_tpu's value and ROUND_OFF; a value read
    from the report's text also within its last printed digit."""
    rel = REL_TOL + (PRINTED if printed else 0.0)
    return abs(got - want) <= rel * abs(want) + ROUND_OFF


def _sims(text):
    return (Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                                 device="cpu"),
            JSimulation.from_case(jload_case(JIni(text=text))))


@pytest.mark.parametrize("case", list(CASES))
def test_opr_check_matches(case):
    tsim, jsim = _sims(CASES[case])
    got, want = tcheck.opr_check(tsim), jcheck.opr_check(jsim)
    assert list(got) == [k for k in want if not k.startswith("rdft_")]
    for k in DETERMINISTIC:
        assert close(got[k], want[k]), (k, got[k], want[k])
    assert got["poisson_error"] < 1e-3 and got["d1x_mode1_error"] < 1e-6
    assert 0.0 < got["fft_roundtrip_residual"] <= FFT_RESIDUAL
    for k in TIMINGS:
        assert got[k] > 0.0


def test_opr_check_of_the_compressible_set():
    """Both packages' opr_check read the step's Poisson plan, which the
    compressible set does not build: both raise."""
    text = _text("case02_small3d.ini", SMALL)
    comp = Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                                device="cpu")
    assert comp.comp is not None
    with pytest.raises(KeyError, match="ell"):
        tcheck.opr_check(comp)
    with pytest.raises(KeyError, match="ell"):
        jcheck.opr_check(JSimulation.from_case(jload_case(JIni(text=text))))


def test_generator_draws_the_field():
    tsim, _ = _sims(CASES["shear"])
    a = tcheck.opr_check(tsim, torch.Generator().manual_seed(3))
    b = tcheck.opr_check(tsim, torch.Generator().manual_seed(3))
    assert a["fft_roundtrip_residual"] == b["fft_roundtrip_residual"]


def test_format_report_matches():
    res = {"a": 1.5e-3, "b": 2, "c": "x"}
    assert tcheck.format_report(res) == jcheck.format_report(res)


def _report(lines):
    """{key: value text} of the report's lines, and the other lines."""
    rep, rest = {}, []
    for ln in lines:
        if ln.startswith("#   "):
            k, v = ln[4:].split(": ")
            rep[k] = v
        else:
            rest.append(ln)
    return rep, rest


def _start(sim):
    rng = np.random.default_rng(2)
    shape = sim.grid.shape
    u, v, w = (0.1 * rng.standard_normal(shape) for _ in range(3))
    s = 0.5 + 0.1 * rng.standard_normal((1,) + shape)
    return u, v, w, s


def test_dns_log_matches(tmp_path):
    """dns.run(opr_check=True), 2 steps of the 32x24x16 shear layer in both
    packages: the report before the header, dns.out equal but for the
    lines the module docstring names."""
    tsim, jsim = _sims(CASES["shear"])
    u, v, w, s = _start(tsim)
    import jax.numpy as jnp
    logs = {}
    for name, pkg, sim, state in (
            ("t", tdns, tsim, state_from_numpy(u, v, w, s, "cpu", F64)),
            ("j", jdns, jsim, JState(u=jnp.asarray(u), v=jnp.asarray(v),
                                     w=jnp.asarray(w), s=jnp.asarray(s)))):
        d = tmp_path / name
        d.mkdir()
        pkg.run(sim, state, outdir=str(d), n_steps=2, checkpoint=False,
                opr_check=True, log_path=str(d / "dns.out"))
        logs[name] = (d / "dns.out").read_text().splitlines()
    t, j = logs["t"], logs["j"]
    assert t[0] == j[0] == "# OPR_CHECK startup self-test"
    (rt, t_rest), (rj, j_rest) = _report(t), _report(j)
    assert t_rest == j_rest
    assert list(rt) == [k for k in rj if not k.startswith("rdft_")]
    for k in DETERMINISTIC:
        assert close(float(rt[k]), float(rj[k]), printed=True), k
    assert float(rt["fft_roundtrip_residual"]) <= FFT_RESIDUAL
    # the report comes before the log's header, the header before the rows
    assert t.index("#   " + "poisson_error: " + rt["poisson_error"]) < \
        min(i for i, ln in enumerate(t) if ln.startswith("#####"))


def test_compressible_dns_refuses_opr_check(tmp_path):
    """dns.run(opr_check=True) of the compressible set raises before its
    first step, and writes no log."""
    sim = Simulation.from_case(load_case(Ini(text=_text(
        "case02_small3d.ini", SMALL))), dtype=F64, device="cpu")
    from tlab_tpu_torch.tools.initialize import compressible_initial_state
    U = compressible_initial_state(sim)
    with pytest.raises(ValueError, match="opr_check"):
        tdns.run(sim, U, outdir=str(tmp_path), n_steps=1, checkpoint=False,
                 opr_check=True, log_path=str(tmp_path / "dns.out"))
    assert not (tmp_path / "dns.out").exists()


if __name__ == "__main__":
    # tlab_tpu's float64 values of the deterministic keys at 128x64x64
    # (chip_smoke.py's OPR_CHECK_FP64): PYTHONPATH=. python
    # tests/test_torch_check.py
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    res = jcheck.opr_check(JSimulation.from_case(jload_case(JIni(
        text=shear_small_text()))))
    print({k: res[k] for k in DETERMINISTIC})
