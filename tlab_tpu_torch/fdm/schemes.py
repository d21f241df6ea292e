"""Compact finite-difference scheme constructors (dense-matrix form).

Lele-type compact schemes (Lele, JCP 1992) on uniform/nonuniform grids using
the Jacobian formulation, built here as *dense* NumPy matrices A (implicit
left-hand side) and B (explicit right-hand side) of the linear relation

    A f' = B f        (1st derivative)
    A f'' = B f + C f'  (2nd derivative; C is the nonuniform-grid Jacobian
                         correction, zero on uniform grids)

The dense form is the TPU-native choice: the derivative operator collapses to
a single precomputed matrix D = A^-1 B applied on the MXU as a batched matmul,
instead of the reference's banded LU sweeps (cf. reference
src/fdm/fdm_com1_jacobian.f90, fdm_com2_jacobian.f90, which define the same
schemes as diagonal arrays for Thomas solves).

Interior stencils (first derivative, antisymmetric):
    f'_i + a1(f'_{i-1}+f'_{i+1}) + a2(f'_{i-2}+f'_{i+2})
        = b1(f_{i+1}-f_{i-1}) + b2(f_{i+2}-f_{i-2}) + b3(f_{i+3}-f_{i-3})
Boundary-biased rows close the system on non-periodic grids (Carpenter et al.
JCP 1993 boundary schemes; see coefficient tables below).

All construction is float64 NumPy at plan time; nothing here runs per step.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# ---------------------------------------------------------------------------
# Interior + boundary coefficient tables.
# Layout: interior = (a1, a2, b1, b2, b3);
#         bc rows  = (a1, a2, b1, b2, b3, b4[, b5, b6])
# Sources (same published schemes as the reference uses):
#   C1N4: Lele Eq. 2.1.6 with alpha=1/4 (4th order, tridiagonal)
#   C1N6: Lele Eq. 2.1.7 with alpha=1/3 (6th order, tridiagonal)
#   C1N6P: Lele Eq. 2.1.10 pentadiagonal, alpha=0.56 family
#   boundary row 1: Lele Eq. 4.1.3 alpha=2 (3rd order)
#   boundary row 2: Carpenter et al. 1993 Eq. 95 (5th order)
#   C2N4/C2N6: Lele Eqs. 2.2.6/2.2.7; C2N6H: Lamballais et al. 2011 hyper.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SchemeDef:
    """One compact scheme: interior coefficients + boundary row closures."""

    interior: tuple  # (a1, a2, b1, b2, b3)
    bc_rows: tuple   # tuple of bc-row coefficient tuples, ordered row 0, 1, 2
    nb_lhs: int      # number of lhs diagonals (3 tri / 5 penta)
    nb_rhs: int      # number of rhs diagonals (3/5/7)


def _c1n6penta_interior() -> tuple:
    a1 = 0.56
    a2 = 0.4 * (-1.0 / 3.0 + a1)
    b1 = 0.5 * (1.0 / 6.0) * (9.0 + a1 - 20.0 * a2)
    b2 = 0.25 * (1.0 / 15.0) * (-9.0 + 32.0 * a1 + 62.0 * a2)
    b3 = (1.0 / 6.0) * (1.0 / 10.0) * (1.0 - 3.0 * a1 + 12.0 * a2)
    return (a1, a2, b1, b2, b3)


def _c2n6hyper_interior() -> tuple:
    kc = np.pi ** 2
    a1 = (272.0 - 45.0 * kc) / (416.0 - 90.0 * kc)
    b1 = (48.0 - 135.0 * kc) / (1664.0 - 360.0 * kc)
    b2 = (528.0 - 81.0 * kc) / (208.0 - 45.0 * kc) / 4.0
    b3 = -(432.0 - 63.0 * kc) / (1664.0 - 360.0 * kc) / 9.0
    return (a1, 0.0, b1, b2, b3)


_BC1_D1 = (2.0, 0.0, -2.5, 2.0, 0.5, 0.0)                    # 3rd order, Lele 4.1.3
_BC2_D1 = (1.0 / 6.0, 0.5, -5.0 / 9.0, -0.5, 1.0, 1.0 / 18.0)  # 5th order, Carpenter Eq. 95
_BC3_D1 = (1.0 / 3.0, 1.0 / 3.0,
           -1.0 / 36.0, -7.0 / 9.0, 0.0, 7.0 / 9.0, 1.0 / 36.0, 0.0)  # 6th-order centered

_BC1_D2 = (11.0, 0.0, 13.0, -27.0, 15.0, -1.0)               # 3rd order, Lele 4.3.1
_BC2_D2 = (0.1, 0.1, 1.2, -2.4, 1.2, 0.0)                     # 4th order, Lele 2.2.6
_BC3_D2 = (2.0 / 11.0, 2.0 / 11.0,
           3.0 / 44.0, 12.0 / 11.0, -51.0 / 22.0, 12.0 / 11.0, 3.0 / 44.0, 0.0)

C1N4 = SchemeDef((0.25, 0.0, 0.75, 0.0, 0.0), (_BC1_D1,), 3, 3)
C1N6 = SchemeDef((1.0 / 3.0, 0.0, 7.0 / 9.0, 1.0 / 36.0, 0.0), (_BC1_D1, _BC2_D1), 3, 5)
C1N6_PENTA = SchemeDef(_c1n6penta_interior(), (_BC1_D1, _BC2_D1, _BC3_D1), 5, 7)

C2N4 = SchemeDef((0.1, 0.0, 1.2, 0.0, 0.0), (_BC1_D2,), 3, 5)
C2N6 = SchemeDef((2.0 / 11.0, 0.0, 12.0 / 11.0, 3.0 / 44.0, 0.0), (_BC1_D2, _BC2_D2), 3, 5)
C2N6_HYPER = SchemeDef(_c2n6hyper_interior(), (_BC1_D2, _BC2_D2, _BC3_D2), 3, 7)


# ---------------------------------------------------------------------------
# Dense system construction
# ---------------------------------------------------------------------------

def _fill_interior_1der(A: np.ndarray, B: np.ndarray, coef: tuple,
                        rows, periodic: bool) -> None:
    n = A.shape[0]
    a1, a2, b1, b2, b3 = coef
    a_off = {1: a1, 2: a2}
    b_off = {1: b1, 2: b2, 3: b3}
    for i in rows:
        A[i, i] = 1.0
        for k, a in a_off.items():
            if a != 0.0 or k == 1:
                A[i, (i - k) % n if periodic else i - k] += a
                A[i, (i + k) % n if periodic else i + k] += a
        for k, b in b_off.items():
            if b != 0.0:
                B[i, (i + k) % n if periodic else i + k] += b
                B[i, (i - k) % n if periodic else i - k] -= b


def _fill_interior_2der(A: np.ndarray, B: np.ndarray, coef: tuple,
                        rows, periodic: bool) -> None:
    n = A.shape[0]
    a1, a2, b1, b2, b3 = coef
    for i in rows:
        A[i, i] = 1.0
        for k, a in ((1, a1), (2, a2)):
            if a != 0.0:
                A[i, (i - k) % n if periodic else i - k] += a
                A[i, (i + k) % n if periodic else i + k] += a
        for k, b in ((1, b1), (2, b2), (3, b3)):
            if b != 0.0:
                B[i, (i + k) % n if periodic else i + k] += b
                B[i, (i - k) % n if periodic else i - k] += b
                B[i, i] -= 2.0 * b
    return


def _apply_bc_rows(A: np.ndarray, B: np.ndarray, scheme: SchemeDef,
                   antisym: bool) -> None:
    """Overwrite boundary-biased rows at both ends (mirror symmetry).

    Row r at the bottom has lhs (1 at diagonal, a1/a2 to the right for r=0;
    centered for r>=1) and an explicit rhs stencil starting at column 0
    (cf. reference fdm_com1_jacobian.f90:227-277 banded equivalent).
    """
    n = A.shape[0]
    sgn = -1.0 if antisym else 1.0
    for r, row in enumerate(scheme.bc_rows):
        a1, a2 = row[0], row[1]
        bs = row[2:]
        A[r, :] = 0.0
        B[r, :] = 0.0
        if r == 0:
            A[r, 0] = 1.0
            A[r, 1] = a1
            if scheme.nb_lhs >= 5:
                A[r, 2] = a2
            else:
                assert a2 == 0.0
        else:
            A[r, r - 1] = a1
            A[r, r] = 1.0
            A[r, r + 1] = a2
        for j, b in enumerate(bs):
            if r == 2:
                B[r, j] = b           # 6-point stencil starting at col 0
            else:
                B[r, j] = b           # 4-point stencil starting at col 0
        # mirrored top rows
        rt = n - 1 - r
        A[rt, :] = 0.0
        B[rt, :] = 0.0
        A[rt, ::-1] = A[r, :]
        B[rt, ::-1] = sgn * B[r, :]


def build_1der_system(scheme: SchemeDef, dx: np.ndarray, periodic: bool):
    """Dense (A, B) with A f' = B f; Jacobian dx folded into A columns.

    Equivalent system to reference Create_System_1der
    (fdm_com1_jacobian.f90:195-291) without the normalization (irrelevant
    for the dense inverse).
    """
    n = dx.shape[0]
    A = np.zeros((n, n))
    B = np.zeros((n, n))
    if periodic:
        _fill_interior_1der(A, B, scheme.interior, range(n), True)
    else:
        nbc = len(scheme.bc_rows)
        _fill_interior_1der(A, B, scheme.interior, range(nbc, n - nbc), False)
        _apply_bc_rows(A, B, scheme, antisym=True)
    A = A * dx[None, :]
    return A, B


def build_2der_system(scheme: SchemeDef, dx: np.ndarray, d2x: np.ndarray,
                      periodic: bool):
    """Dense (A, B, C) with A f'' = B f + C f'.

    C is the Jacobian correction for nonuniform grids (zero when d2x == 0);
    cf. reference Create_System_2der (fdm_com2_jacobian.f90:179-282).
    """
    n = dx.shape[0]
    A = np.zeros((n, n))
    B = np.zeros((n, n))
    if periodic:
        _fill_interior_2der(A, B, scheme.interior, range(n), True)
    else:
        nbc = len(scheme.bc_rows)
        _fill_interior_2der(A, B, scheme.interior, range(nbc, n - nbc), False)
        _apply_bc_rows(A, B, scheme, antisym=False)
    C = -A * d2x[None, :]
    A = A * (dx ** 2)[None, :]
    return A, B, C


# ---------------------------------------------------------------------------
# Modified wavenumbers (periodic): exact transfer functions of the schemes.
# ---------------------------------------------------------------------------

def modified_wavenumber_1(scheme: SchemeDef, n: int) -> np.ndarray:
    """k' such that the compact D1 of e^{ikx} is i k' e^{ikx} (grid units).

    Same quantity as reference fdm_derivative.f90:193-209, using the exact
    denominator cos(2w) for the a2 term (the pentadiagonal scheme's transfer
    function), which is required for the Poisson eigenvalues to be consistent
    with the derivative operator.
    """
    a1, a2, b1, b2, b3 = scheme.interior
    i = np.arange(n)
    w = 2.0 * np.pi * np.where(i <= n // 2, i, i - n) / n
    num = 2.0 * (b1 * np.sin(w) + b2 * np.sin(2 * w) + b3 * np.sin(3 * w))
    den = 1.0 + 2.0 * a1 * np.cos(w) + 2.0 * a2 * np.cos(2 * w)
    return num / den


def modified_wavenumber_2(scheme: SchemeDef, n: int) -> np.ndarray:
    """k'' such that compact D2 of e^{ikx} is -k'' e^{ikx} (grid units, >= 0).

    cf. reference fdm_derivative.f90:389-406.
    """
    a1, a2, b1, b2, b3 = scheme.interior
    i = np.arange(n)
    w = 2.0 * np.pi * np.where(i <= n // 2, i, i - n) / n
    num = 2.0 * (b1 * (1 - np.cos(w)) + b2 * (1 - np.cos(2 * w))
                 + b3 * (1 - np.cos(3 * w)))
    den = 1.0 + 2.0 * a1 * np.cos(w) + 2.0 * a2 * np.cos(2 * w)
    return num / den


# ---------------------------------------------------------------------------
# Neumann elimination for the first-derivative operator.
# ---------------------------------------------------------------------------

def reduce_neumann(A: np.ndarray, B: np.ndarray, at_min: bool, at_max: bool):
    """Impose homogeneous Neumann (f' = 0) at one/both ends of A f' = B f.

    Returns the dense derivative matrix D with the boundary rows identically
    zero and the boundary *value* of f eliminated through the boundary
    equation, mathematically equivalent to the reference's banded reduction
    FDM_Bcs_Neumann (src/fdm/fdm_base.f90:194-300).

    Derivation (min end): with f'_0 = 0 known, row 0 of the system reads
        sum_c A[0,c] f'_c = B[0,0] f_0 + sum_c B[0,c] f_c
    which determines the boundary value f_0; substituting into rows 1..N-1
    yields a reduced system in f'_{1..N-1} independent of f_0.
    """
    n = A.shape[0]
    Ar = A.copy()
    Br = B.copy()
    keep = np.ones(n, dtype=bool)
    if at_min:
        keep[0] = False
        # eliminate f_0 using row 0
        Ar[1:, :] -= np.outer(Br[1:, 0] / Br[0, 0], Ar[0, :])
        Br[1:, :] -= np.outer(Br[1:, 0] / Br[0, 0], Br[0, :])
    if at_max:
        keep[-1] = False
        Ar[:-1, :] -= np.outer(Br[:-1, -1] / Br[-1, -1], Ar[-1, :])
        Br[:-1, :] -= np.outer(Br[:-1, -1] / Br[-1, -1], Br[-1, :])
    idx = np.where(keep)[0]
    D = np.zeros((n, n))
    D[np.ix_(idx, idx)] = np.linalg.solve(Ar[np.ix_(idx, idx)],
                                          Br[np.ix_(idx, idx)])
    return D


_D1_SCHEMES = {
    "CompactJacobian4": C1N4,
    "CompactJacobian6": C1N6,
    "CompactJacobian6Hyper": C1N6,      # der1 falls back to C1N6 (ref fdm_derivative.f90:177)
    "CompactJacobian6Penta": C1N6_PENTA,
    "CompactDirect4": C1N4,
    "CompactDirect6": C1N6,
}

_D2_SCHEMES = {
    "CompactJacobian4": C2N4,
    "CompactJacobian6": C2N6,
    "CompactJacobian6Penta": C2N6,      # der2 falls back to C2N6 (ref fdm_derivative.f90:369)
    "CompactJacobian6Hyper": C2N6_HYPER,
    # nonuniform-native direct schemes: uniform/periodic axes fall back to
    # these Jacobian coefficients, stretched axes use the direct constructors
    # (build_2der_direct_system) in plan.py
    "CompactDirect4": C2N4,
    "CompactDirect6": C2N6,
}


def d1_scheme(name: str) -> SchemeDef:
    return _D1_SCHEMES[name]


def d2_scheme(name: str) -> SchemeDef:
    return _D2_SCHEMES[name]


# ---------------------------------------------------------------------------
# Direct (nonuniform-native) compact schemes: coefficients from local
# polynomial exactness on the actual nodes (reference FDM_ComX_Direct,
# src/fdm/fdm_comx_direct.f90, which derives the same class of schemes via
# Lagrange-polynomial algebra). No Jacobian correction: C = 0.
# ---------------------------------------------------------------------------

def _solve_compact_row(x, i, lhs_idx, rhs_idx, deriv_order):
    """Row coefficients (alphas for lhs_idx (excluding i), betas for rhs_idx)
    with  f^(m)_i + sum alpha_k f^(m)_k = sum beta_j f_j  exact for
    polynomials of degree <= len(lhs_idx)-1 + len(rhs_idx) - 1."""
    xi = x[i]
    h = np.max(np.abs(x[rhs_idx] - xi)) or 1.0
    n_a = len(lhs_idx)
    n_b = len(rhs_idx)
    n_cond = n_a + n_b
    M = np.zeros((n_cond, n_a + n_b))
    rhs = np.zeros(n_cond)

    def dmono(m, xx):       # d^deriv_order/dx^deriv_order of ((xx-xi)/h)^m
        c = 1.0
        for q in range(deriv_order):
            c *= (m - q)
        if m - deriv_order < 0:
            return 0.0
        return c * ((xx - xi) / h) ** (m - deriv_order) / h ** deriv_order

    for m in range(n_cond):
        for a, k in enumerate(lhs_idx):
            M[m, a] = dmono(m, x[k])
        for b, j in enumerate(rhs_idx):
            M[m, n_a + b] = -((x[j] - xi) / h) ** m
        rhs[m] = -dmono(m, xi)
    sol = np.linalg.solve(M, rhs)
    return sol[:n_a], sol[n_a:]


def build_2der_direct_system(nodes: np.ndarray):
    """Dense (A, B) with A f'' = B f on a nonuniform grid, 6th-order
    interior (tridiagonal lhs, 5-point rhs), one-sided boundary closures.
    Equivalent role to reference FDM_C2N6_Direct."""
    n = nodes.shape[0]
    A = np.zeros((n, n))
    B = np.zeros((n, n))
    for i in range(n):
        A[i, i] = 1.0
        if i == 0:
            lhs, rhs = [1], list(range(0, 4))
        elif i == n - 1:
            lhs, rhs = [n - 2], list(range(n - 4, n))
        elif i == 1:
            lhs, rhs = [0, 2], list(range(0, 4))
        elif i == n - 2:
            lhs, rhs = [n - 3, n - 1], list(range(n - 4, n))
        else:
            lhs, rhs = [i - 1, i + 1], list(range(i - 2, i + 3))
        alphas, betas = _solve_compact_row(nodes, i, lhs, rhs, 2)
        for a, k in zip(alphas, lhs):
            A[i, k] = a
        for b, j in zip(betas, rhs):
            B[i, j] = b
    return A, B


def build_1der_direct_system(nodes: np.ndarray):
    """Dense (A, B) with A f' = B f, 6th-order interior, nonuniform-native
    (reference FDM_C1N6_Direct equivalent)."""
    n = nodes.shape[0]
    A = np.zeros((n, n))
    B = np.zeros((n, n))
    for i in range(n):
        A[i, i] = 1.0
        if i == 0:
            lhs, rhs = [1], list(range(0, 3))
        elif i == n - 1:
            lhs, rhs = [n - 2], list(range(n - 3, n))
        elif i == 1:
            lhs, rhs = [0, 2], list(range(0, 4))
        elif i == n - 2:
            lhs, rhs = [n - 3, n - 1], list(range(n - 4, n))
        else:
            lhs, rhs = [i - 1, i + 1], list(range(i - 2, i + 3))
        alphas, betas = _solve_compact_row(nodes, i, lhs, rhs, 1)
        for a, k in zip(alphas, lhs):
            A[i, k] = a
        for b, j in zip(betas, rhs):
            B[i, j] = b
    return A, B
