"""Build the port's CUDA sources into shared libraries loaded with ctypes.

Each library is compiled from ``tlab_tpu_torch/csrc/<name>.cu`` by nvcc for
sm_90a (Hopper) on its first use in a process, into
``tlab_tpu_torch/_build/``, under a file name keyed by a hash of the
sources and flags: an unchanged source loads the existing library, a
changed one builds anew.  Importing this module builds nothing.  A failed
build raises with nvcc's stderr.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # ptxas reports registers, shared memory and spills per kernel
              "-Xptxas", "-v")

_loaded: dict = {}
# name -> {"path", "seconds", "log"} for each build made in this process
builds: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME/bin; "
                       "the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from csrc/<name>.cu (built if needed)."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    so = BUILD_DIR / f"lib{name}-{_digest()}.so"
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {src.name} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
        builds[name] = {"path": str(so),
                        "seconds": time.perf_counter() - t0,
                        "log": proc.stderr}
    lib = ctypes.CDLL(str(so))
    _loaded[name] = lib
    return lib
