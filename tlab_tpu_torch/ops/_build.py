"""Build the port's native sources into shared libraries loaded with ctypes.

Each library is compiled from ``tlab_tpu_torch/csrc/<name>.cu`` by nvcc for
sm_90a (Hopper) on its first use in a process, into
``tlab_tpu_torch/_build/``, under a file name keyed by a hash of the
sources and flags: an unchanged source loads the existing library, a
changed one builds anew.  ``host_library`` does the same for a plain C
source with the host compiler alone (native/nrrand.c, the reference's random
stream), and ``host_extension`` for a CPython extension in C++
(native/tlabio.cpp, the threaded restart-file engine), compiled with g++
against this interpreter's headers and imported as a module.  Importing this
module builds nothing.  A failed build raises with the compiler's stderr.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import pathlib
import shutil
import subprocess
import sysconfig
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


def _compile(key: str, so: pathlib.Path, compiler: str, flags, src,
             libs=()) -> None:
    """Compile `src` into `so` where it is not there yet (atomically: a
    concurrent build of the same key leaves one whole file)."""
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [compiler, *flags, "-o", str(tmp), str(src), *libs],
            capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{compiler} failed to build {src.name} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
        builds[key] = {"path": str(so),
                       "seconds": time.perf_counter() - t0,
                       "log": proc.stderr}


def _load(key: str, so: pathlib.Path, compiler: str, flags, src, libs=()):
    """The library `so`, compiled from `src` first where it is not there
    yet; loaded once a process under `key`."""
    lib = _loaded.get(key)
    if lib is not None:
        return lib
    _compile(key, so, compiler, flags, src, libs)
    lib = _loaded[key] = ctypes.CDLL(str(so))
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from csrc/<name>.cu (built if needed)."""
    if name in _loaded:
        return _loaded[name]
    return _load(name, BUILD_DIR / f"lib{name}-{_digest()}.so", nvcc_path(),
                 NVCC_FLAGS, CSRC / f"{name}.cu")


NATIVE = _PKG.parent / "native"
CC_FLAGS = ("-O2", "-shared", "-fPIC")


def cc_path() -> str:
    for name in (os.environ.get("CC"), "cc", "gcc"):
        found = shutil.which(name) if name else None
        if found:
            return found
    raise RuntimeError("no host C compiler (CC, cc, gcc) found; "
                       "the native library cannot be built")


def host_library(name: str) -> ctypes.CDLL:
    """The loaded library built from native/<name>.c with the host C
    compiler (built if needed), keyed by the hash of source and flags."""
    key = f"host:{name}"
    if key in _loaded:
        return _loaded[key]
    src = NATIVE / f"{name}.c"
    if not src.exists():
        raise RuntimeError(f"{src} not found; the native library cannot be "
                           "built")
    h = hashlib.sha256(" ".join(CC_FLAGS).encode())
    h.update(src.read_bytes())
    return _load(key, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so",
                 cc_path(), CC_FLAGS, src, libs=("-lm",))


CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def cxx_path() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (g++, c++) found; the native "
                       "extension cannot be built")


def host_extension(name: str):
    """The CPython extension module built from native/<name>.cpp with g++
    against this interpreter's headers (built if needed), keyed by the hash
    of source, flags, include path and extension suffix; imported once a
    process as the module _<name>, as native/build.py names it (the
    source's init function is PyInit__<name>)."""
    key = f"ext:{name}"
    if key in _loaded:
        return _loaded[key]
    src = NATIVE / f"{name}.cpp"
    if not src.exists():
        raise RuntimeError(f"{src} not found; the native extension cannot "
                           "be built")
    include = sysconfig.get_paths()["include"]
    flags = (*CXX_FLAGS, f"-I{include}")
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(str(sysconfig.get_config_var("EXT_SUFFIX")).encode())
    h.update(src.read_bytes())
    so = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    _compile(key, so, cxx_path(), flags, src)
    spec = importlib.util.spec_from_file_location(f"_{name}", so)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    _loaded[key] = module
    return module
