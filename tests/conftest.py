"""Test configuration: CPU backend with a virtual 8-device mesh, float64 on.

Mirrors the reference's validation strategy (SURVEY.md section 4): operator
tests against analytic solutions run in float64; sharding tests use the
virtual CPU mesh. The TPU-attached environment registers its backend at
interpreter start, so the platform must be forced via jax.config (env vars
are too late / overridden).
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Build the native extensions once per session so the suite exercises the
# C paths (tlabio threaded I/O, reference-exact NR RNG); the Python
# fallbacks cover environments without a toolchain.
import glob  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

_repo = pathlib.Path(__file__).resolve().parent.parent
if not glob.glob(str(_repo / "tlab_tpu" / "_nrrand*.so")) \
        or not glob.glob(str(_repo / "tlab_tpu" / "_tlabio*.so")):
    try:
        subprocess.run([sys.executable, str(_repo / "native" / "build.py")],
                       check=False, capture_output=True, timeout=120)
    except Exception:
        pass


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long end-to-end reference-case subprocess runs; "
        "deselect with -m 'not slow' for the quick gate (~5 min)")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's hand-written "
        "kernels have no CPU mode); skips where there is none")
