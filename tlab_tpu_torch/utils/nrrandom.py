"""Numerical Recipes ran0/rang -- the reference's RNG, bit exact (port of
tlab_tpu/utils/nrrandom.py).

The reference initial-condition generator inirand draws every random
number from RAN0, the Park-Miller minimal-standard LCG with a 32-slot
Bays-Durham shuffle table, and RANG, a rejection-sampled Box-Muller
transform on top of it (reference src/utils/random.f90; seeding in
src/tools/initialize/rand/rand_local.f90:53 `seed = -abs(seed + rank)`).

`uniform` and `gaussian` fill their batch through native/nrrand.c, built at
first use by ops/_build.host_library; a failed build raises (a full-size
initial condition draws ~1e8 numbers, which a Python loop cannot deliver).
`uniform_py` and `gaussian_py` are the same arithmetic in pure Python (all
intermediates fit in float64/int64 exactly): the plain version that the
tests hold the library against.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np

from tlab_tpu_torch.ops import _build

_IA, _IM, _IQ, _IR, _NTAB = 16807, 2147483647, 127773, 2836, 32
_NDIV = 1 + (_IM - 1) // _NTAB
_AM = 1.0 / _IM
_RNMX = 1.0 - 1.2e-7

_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)


def _library() -> ctypes.CDLL:
    lib = _build.host_library("nrrand")
    lib.nr_fill_uniform.argtypes = [_I64P, _F64P, ctypes.c_int64]
    lib.nr_fill_uniform.restype = None
    lib.nr_fill_gaussian.argtypes = [_I64P, _F64P, ctypes.c_int64,
                                     ctypes.c_double, ctypes.c_double]
    lib.nr_fill_gaussian.restype = None
    return lib


class NRStream:
    """Sequential RAN0/RANG stream with the reference's state semantics.

    `seed` is the raw IDUM as the reference passes it on first call
    (negative triggers (re)initialization of the shuffle table)."""

    def __init__(self, seed: int):
        self._state = np.zeros(34, dtype=np.int64)   # idum, iv[32], iy
        self._state[0] = int(seed)

    # -- pure-python plain version ---------------------------------------
    def _ran0_py(self) -> float:
        st = self._state
        idum = int(st[0])
        iy = int(st[33])
        if idum <= 0 or iy == 0:
            idum = max(-idum, 1)
            for j in range(_NTAB + 8, 0, -1):
                k = idum // _IQ
                idum = _IA * (idum - k * _IQ) - _IR * k
                if idum < 0:
                    idum += _IM
                if j <= _NTAB:
                    st[j] = idum
            iy = int(st[1])
        k = idum // _IQ
        idum = _IA * (idum - k * _IQ) - _IR * k
        if idum < 0:
            idum += _IM
        j = 1 + iy // _NDIV
        iy = int(st[j])
        st[j] = idum
        st[0] = idum
        st[33] = iy
        return min(_AM * iy, _RNMX)

    def _rang_py(self, mean: float, sigma: float) -> float:
        while True:
            v1 = 2.0 * self._ran0_py() - 1.0
            v2 = 2.0 * self._ran0_py() - 1.0
            r = v1 * v1 + v2 * v2
            if r < 1.0:
                break
        v2 = v1 * math.sqrt(-2.0 * math.log(r) / r)
        return mean + v2 * sigma

    def uniform_py(self, n: int) -> np.ndarray:
        """uniform(n) through the Python loop."""
        return np.array([self._ran0_py() for _ in range(n)], np.float64)

    def gaussian_py(self, n: int, mean: float = 0.0,
                    sigma: float = 1.0) -> np.ndarray:
        """gaussian(n) through the Python loop."""
        return np.array([self._rang_py(mean, sigma) for _ in range(n)],
                        np.float64)

    # -- batch API (native/nrrand.c) -------------------------------------
    def uniform(self, n: int) -> np.ndarray:
        """n consecutive RAN0 values in [0, 1)."""
        out = np.empty(n, dtype=np.float64)
        _library().nr_fill_uniform(self._state.ctypes.data_as(_I64P),
                                   out.ctypes.data_as(_F64P),
                                   ctypes.c_int64(n))
        return out

    def gaussian(self, n: int, mean: float = 0.0,
                 sigma: float = 1.0) -> np.ndarray:
        """n consecutive RANG deviates."""
        out = np.empty(n, dtype=np.float64)
        _library().nr_fill_gaussian(self._state.ctypes.data_as(_I64P),
                                    out.ctypes.data_as(_F64P),
                                    ctypes.c_int64(n), ctypes.c_double(mean),
                                    ctypes.c_double(sigma))
        return out
