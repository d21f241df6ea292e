"""Horizontally staggered pressure grid: compact midpoint interpolation and
midpoint-derivative operators on periodic uniform axes.

TPU-native equivalent of the reference's staggered-pressure machinery
(src/fdm/fdm_interpolate.f90, fdm_com0_jacobian.f90 FDM_C0INT6P/C1INT6P
families; used by src/tools/dns/rhs_global_incompressible_1.f90:216-320
when stagger_on): pressure lives at horizontal cell centers x_{i+1/2}.
Four dense circulant operators per axis, applied as einsums like every
other operator in this framework:

  I_vp : velocity nodes  -> pressure nodes  (midpoint interpolation)
  I_pv : pressure nodes  -> velocity nodes
  D_vp : d/dx at pressure nodes from velocity-node values
  D_pv : d/dx at velocity nodes from pressure-node values

The compact 6th-order coefficients are DERIVED here from polynomial
exactness (not transcribed): interpolation
  alpha v_{i-1} + v_i + alpha v_{i+1} = a (u_{i+1/2}+u_{i-1/2})
                                      + b (u_{i+3/2}+u_{i-3/2})
exact for even degrees 0,2,4; derivative
  alpha v'_{i-1} + v'_i + alpha v'_{i+1} = [a (u_{i+1/2}-u_{i-1/2})
                                         +  b (u_{i+3/2}-u_{i-3/2})]/h
exact for odd degrees 1,3,5.  The associated modified wavenumber
  wn(w) = 2 (a sin(w/2) + b sin(3w/2)) / (1 + 2 alpha cos(w)) / h
vanishes only at w = 0 (single singular Poisson mode; reference
opr_elliptic.f90:144-147).
"""
from __future__ import annotations

import numpy as np


def interp_coefs():
    """(alpha, a, b) of the 6th-order compact midpoint interpolation."""
    # exactness on x^k, k = 0, 2, 4 (stencil symmetric, h = 1)
    M = np.array([[2.0, 2.0, -2.0],
                  [2 * 0.5 ** 2, 2 * 1.5 ** 2, -2.0],
                  [2 * 0.5 ** 4, 2 * 1.5 ** 4, -2.0]])
    rhs = np.array([1.0, 0.0, 0.0])
    a, b, alpha = np.linalg.solve(M, rhs)
    return alpha, a, b


def deriv_coefs():
    """(alpha, a, b) of the 6th-order compact midpoint first derivative."""
    # exactness on x^k, k = 1, 3, 5
    M = np.array([[1.0, 3.0, -2.0],
                  [2 * 0.5 ** 3, 2 * 1.5 ** 3, -6.0],
                  [2 * 0.5 ** 5, 2 * 1.5 ** 5, -10.0]])
    rhs = np.array([1.0, 0.0, 0.0])
    a, b, alpha = np.linalg.solve(M, rhs)
    return alpha, a, b


def _circulant(n, offsets, coefs):
    row = np.zeros(n)
    for off, c in zip(offsets, coefs):
        row[off % n] += c
    M = np.empty((n, n))
    for i in range(n):
        M[i] = np.roll(row, i)
    return M


def _lhs(n, alpha):
    return _circulant(n, (-1, 0, 1), (alpha, 1.0, alpha))


def build_stagger_ops(n: int, h: float):
    """Dense (n, n) operators {ivp, ipv, dvp, dpv} for one periodic axis."""
    al0, a0, b0 = interp_coefs()
    al1, a1, b1 = deriv_coefs()
    A0inv = np.linalg.inv(_lhs(n, al0))
    A1inv = np.linalg.inv(_lhs(n, al1))
    # pressure row i sits at x_{i+1/2}: velocity stencil offsets i-1..i+2
    ivp = A0inv @ _circulant(n, (-1, 0, 1, 2), (b0, a0, a0, b0))
    dvp = A1inv @ _circulant(n, (-1, 0, 1, 2),
                             (-b1 / h, -a1 / h, a1 / h, b1 / h))
    # velocity row i at x_i: pressure stencil offsets i-2..i+1 (each p_j at
    # x_{j+1/2}, so p_{i-1} and p_i bracket the node)
    ipv = A0inv @ _circulant(n, (-2, -1, 0, 1), (b0, a0, a0, b0))
    dpv = A1inv @ _circulant(n, (-2, -1, 0, 1),
                             (-b1 / h, -a1 / h, a1 / h, b1 / h))
    return {"ivp": ivp, "ipv": ipv, "dvp": dvp, "dpv": dpv}


def modified_wavenumber(n: int, length: float):
    """Staggered first-derivative modified wavenumbers (n//2+1,) for the
    rfft modes (reference fdm_interpolate.f90:75-93)."""
    al1, a1, b1 = deriv_coefs()
    h = length / n
    w = 2.0 * np.pi * np.arange(n // 2 + 1) / n
    return 2.0 * (a1 * np.sin(w / 2) + b1 * np.sin(3 * w / 2)) \
        / (1.0 + 2.0 * al1 * np.cos(w)) / h
