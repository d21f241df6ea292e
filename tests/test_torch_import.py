"""The port imports no JAX: the machine with the CUDA card has none.

Checked in a fresh interpreter, because this test process (conftest.py)
has imported JAX already."""
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

_PROBE = """
import pkgutil, importlib, sys
import tlab_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tlab_tpu_torch.__path__,
                                               "tlab_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert "jax" not in sys.modules, [m for m in sys.modules if "jax" in m]
print(len(names))
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 12     # every module was imported


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py's imports (its body runs only on a CUDA card)."""
    probe = ("import sys, runpy; "
             "runpy.run_path('chip_smoke.py', run_name='chip_smoke'); "
             "assert 'jax' not in sys.modules")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
