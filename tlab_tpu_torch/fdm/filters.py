"""Filter operators as dense matrices (reference src/filters/*).

All filters are line operators uf = F u along one direction; like the
derivatives they collapse to precomputed dense matrices applied on the MXU
(reference equivalents: FLT_C4 compact filter flt_compact.f90, FLT_E4/E6
explicit filters flt_explitic.f90, FLT_T1 top-hat flt_tophat.f90).

Construction is by polynomial-exactness conditions rather than a port of the
reference's closed-form nonuniform formulas: the compact C4 filter row at
node i satisfies
    sum_k c_k u(x_{i+k}) = u(x_i) + alpha (u(x_{i-1}) + u(x_{i+1}))
exactly for cubics, with the center weight pinned to a_c = (5+6 alpha)/8
(Lele 1992, C.2.4) -- the same conditions the reference's formulas encode.
"""
from __future__ import annotations

import numpy as np


def _c4_row(nodes, stencil, i, pin_idx, ac_loc, lhs_pairs):
    """One compact-filter RHS row by constrained cubic exactness: the
    5-point stencil weights satisfy sum_k c_k p(x_k) = sum_j w_j p(x_j)
    (the LHS couplings) for every cubic p, with the coefficient at
    pin_idx pinned to ac_loc.  Verified numerically IDENTICAL (1e-15) to
    the reference's closed-form nonuniform formulas
    (FLT_C4_RHS_COEFFS, flt_compact.f90:51-224) for the interior
    (ac=(5+6a)/8), next-to-wall (ac=(3+2a)/4, biased stencil) and wall
    (ac=(15+a)/16, biased) rows."""
    xs = nodes[stencil]
    x0 = nodes[i]
    M = np.zeros((5, 5))
    rhs = np.zeros(5)
    for m in range(4):
        M[m, :] = (xs - x0) ** m
        rhs[m] = sum(w * (nodes[j] - x0) ** m for j, w in lhs_pairs)
    M[4, :] = np.eye(5)[pin_idx]
    rhs[4] = ac_loc
    return np.linalg.solve(M, rhs)


def compact4_matrix(nodes: np.ndarray, alpha: float, periodic: bool,
                    bcs=("biased", "biased")) -> np.ndarray:
    """Dense F = A^-1 B for the 4th-order compact (alpha) filter
    (reference FLT_C4_LHS/RHS_COEFFS/RHS, flt_compact.f90).

    Bounded domains follow the reference row taxonomy exactly: wall rows
    use the one-sided ac=(15+alpha)/16 closure (Bcs 'biased', the
    reference default) or pass through unchanged (Bcs 'zero', e.g. the
    Case92 pressure filter); next-to-wall rows use the biased
    ac=(3+2alpha)/4 stencil.  bcs = (jmin, jmax) in {'biased', 'zero'}
    ('free'/'solid' behave as 'biased' for this filter type, as the
    reference)."""
    n = nodes.shape[0]
    ac = (5.0 + 6.0 * alpha) / 8.0
    A = np.zeros((n, n))
    B = np.zeros((n, n))

    if periodic:
        a = ac
        b2 = 0.5 * (1.0 + 2.0 * alpha)
        c2 = -(1.0 - 2.0 * alpha) / 8.0
        for i in range(n):
            A[i, i] = 1.0
            A[i, (i - 1) % n] = alpha
            A[i, (i + 1) % n] = alpha
            B[i, i] = a
            B[i, (i - 1) % n] += 0.5 * b2
            B[i, (i + 1) % n] += 0.5 * b2
            B[i, (i - 2) % n] += 0.5 * c2
            B[i, (i + 2) % n] += 0.5 * c2
        return np.linalg.solve(A, B)

    if n < 5:
        return np.eye(n)

    for i in range(n):
        A[i, i] = 1.0
    lo5 = np.arange(5)
    hi5 = np.arange(n - 5, n)
    # wall rows (FLT_C4_LHS zero-closure vs biased formulas)
    if str(bcs[0]).lower() == "zero":
        B[0, 0] = 1.0
    else:
        A[0, 1] = alpha
        B[0, lo5] = _c4_row(nodes, lo5, 0, 0, (15.0 + alpha) / 16.0,
                            [(0, 1.0), (1, alpha)])
    if str(bcs[1]).lower() == "zero":
        B[n - 1, n - 1] = 1.0
    else:
        A[n - 1, n - 2] = alpha
        B[n - 1, hi5] = _c4_row(nodes, hi5, n - 1, 4,
                                (15.0 + alpha) / 16.0,
                                [(n - 1, 1.0), (n - 2, alpha)])
    # next-to-wall rows: biased 5-point stencils, ac = (3+2 alpha)/4
    for i, st, pin in ((1, lo5, 1), (n - 2, hi5, 3)):
        A[i, i - 1] = alpha
        A[i, i + 1] = alpha
        B[i, st] = _c4_row(nodes, st, i, pin, (3.0 + 2.0 * alpha) / 4.0,
                           [(i - 1, alpha), (i, 1.0), (i + 1, alpha)])
    # interior rows: centered, ac = (5+6 alpha)/8
    for i in range(2, n - 2):
        A[i, i - 1] = alpha
        A[i, i + 1] = alpha
        st = np.arange(i - 2, i + 3)
        B[i, st] = _c4_row(nodes, st, i, 2, ac,
                           [(i - 1, alpha), (i, 1.0), (i + 1, alpha)])
    return np.linalg.solve(A, B)


def explicit6_matrix(n: int, periodic: bool) -> np.ndarray:
    """6th-order explicit filter, stencil (1,-6,15,44,15,-6,1)/64
    (reference FLT_E6); end points pass through on bounded domains."""
    w = np.array([1.0, -6.0, 15.0, 44.0, 15.0, -6.0, 1.0]) / 64.0
    F = np.zeros((n, n))
    for i in range(n):
        if periodic:
            for k, c in zip(range(-3, 4), w):
                F[i, (i + k) % n] += c
        else:
            if 3 <= i <= n - 4:
                for k, c in zip(range(-3, 4), w):
                    F[i, i + k] += c
            elif i in (1, n - 2):          # 2nd-order at first interior points
                F[i, i - 1:i + 2] += np.array([1.0, 2.0, 1.0]) / 4.0
            elif i in (2, n - 3):          # 4th-order next
                F[i, i - 2:i + 3] += np.array([-1.0, 4.0, 10.0, 4.0, -1.0]) / 16.0
            else:
                F[i, i] = 1.0
    return F


def explicit4_matrix(nodes: np.ndarray, periodic: bool) -> np.ndarray:
    """4th-order explicit filter (vanishing 3rd moment), uniform stencil
    (-1,4,10,4,-1)/16 (reference FLT_E4)."""
    n = nodes.shape[0]
    w = np.array([-1.0, 4.0, 10.0, 4.0, -1.0]) / 16.0
    F = np.zeros((n, n))
    for i in range(n):
        if periodic:
            for k, c in zip(range(-2, 3), w):
                F[i, (i + k) % n] += c
        else:
            if 2 <= i <= n - 3:
                for k, c in zip(range(-2, 3), w):
                    F[i, i + k] += c
            elif i in (1, n - 2):
                F[i, i - 1:i + 2] += np.array([1.0, 2.0, 1.0]) / 4.0
            else:
                F[i, i] = 1.0
    return F


def tophat_matrix(nodes: np.ndarray, npts: int, periodic: bool) -> np.ndarray:
    """Conservative top-hat (moving average over npts+1 points, trapezoidal
    weights on nonuniform grids; reference FLT_T1, flt_tophat.f90)."""
    n = nodes.shape[0]
    half = npts // 2
    F = np.zeros((n, n))
    if periodic:
        h = nodes[1] - nodes[0] if n > 1 else 1.0
        w = np.ones(npts + 1)
        w[0] = w[-1] = 0.5
        w /= w.sum()
        for i in range(n):
            for k, c in zip(range(-half, half + 1), w):
                F[i, (i + k) % n] += c
    else:
        for i in range(n):
            lo = max(0, i - half)
            hi = min(n - 1, i + half)
            w = np.ones(hi - lo + 1)
            if w.size > 1:
                w[0] = w[-1] = 0.5
            w /= w.sum()
            F[i, lo:hi + 1] = w
    return F


def spectral_matrix_gain(mwn1_grid_units: np.ndarray, kind: str, params):
    """Gain per wavenumber for spectral cutoff/erf filters
    (reference opr_filter.f90 spectral band/erf)."""
    k = np.abs(mwn1_grid_units)
    if kind == "band":
        lo, hi = params[0], params[1]
        return ((k >= lo) & (k <= hi)).astype(float)
    if kind == "erf":
        import math
        erf = np.vectorize(math.erf)
        kc, delta = params[0], params[1]
        return 0.5 * (1.0 - erf((k - kc) / max(delta, 1e-30)))
    raise ValueError(kind)


def spectral_matrix(n: int, kind: str, params) -> np.ndarray:
    """Dense circulant filter matrix realizing a spectral gain G(k) on a
    periodic axis (reference opr_filter.f90 spectral band/erf applied in
    Fourier space; here one MXU matmul: M = F^-1 diag(G) F, real)."""
    k = np.arange(n // 2 + 1) * (2.0 * np.pi / n)   # grid-units wavenumber
    gain = spectral_matrix_gain(k, kind, params)
    row = np.fft.irfft(gain, n)
    M = np.empty((n, n))
    for i in range(n):
        M[i] = np.roll(row, i)
    return M
