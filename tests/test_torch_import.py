"""The port imports no JAX and nothing of tlab_tpu: the machine with the
CUDA card has no JAX, and the port keeps its own copies of the NumPy
modules it needs.

Checked in a fresh interpreter, because this test process (conftest.py)
has imported JAX already."""
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

_CLEAN = """
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "tlab_tpu")]
assert not bad, bad
"""

_PROBE = """
import pkgutil, importlib, sys
import tlab_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tlab_tpu_torch.__path__,
                                               "tlab_tpu_torch.")]
for name in names:
    importlib.import_module(name)
""" + _CLEAN + """
print(len(names))
"""

_SMOKE_PROBE = """
import sys, runpy
runpy.run_path('chip_smoke.py', run_name='chip_smoke')
""" + _CLEAN

# a Simulation from a case file through the port alone, with JAX and
# tlab_tpu made unimportable as they are on the card's machine
_CASE_PROBE = """
import sys
for name in ("jax", "jaxlib", "tlab_tpu"):
    sys.modules[name] = None
import torch
from tlab_tpu_torch.config import load_case
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.convert import state_from_numpy
from tlab_tpu_torch.dycore import incompressible as dyn
from tlab_tpu_torch import entry
sim = Simulation.from_case(sys.argv[1], dtype=torch.float64, device="cpu")
assert tuple(sim.P["sizes"]) == tuple(sim.grid.shape)
state = state_from_numpy(
    *entry.initial_fields(sim.grid, 0, len(sim.case.schmidt)),
    device="cpu", dtype=torch.float64)
state, _ = dyn.rk_step(sim.P, state, 1e-3)
assert bool(torch.isfinite(state.u).all())
try:
    Simulation.from_case(sys.argv[1])
except RuntimeError as e:
    assert "CUDA is not available" in str(e), e
else:
    assert torch.cuda.is_available()
print(*sim.grid.shape)
"""


def _run(probe, *args):
    return subprocess.run([sys.executable, "-c", probe, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    proc = _run(_PROBE)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 24     # every module was imported


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py's imports (its body runs only on a CUDA card)."""
    proc = _run(_SMOKE_PROBE)
    assert proc.returncode == 0, proc.stderr


def test_simulation_from_case_file_without_jax(tmp_path):
    """load_case and Simulation.from_case on a case file of the ported path
    (the golden slice's INI), one RK step, where neither JAX nor tlab_tpu
    can be imported; and the default device is the card, which raises
    where there is none."""
    sys.path.insert(0, str(REPO / "tests"))
    try:
        from test_golden import INI
    finally:
        sys.path.pop(0)
    path = tmp_path / "tlab.ini"
    path.write_text(INI)
    proc = _run(_CASE_PROBE, str(path))
    assert proc.returncode == 0, proc.stderr
    assert len(proc.stdout.split()) == 3
