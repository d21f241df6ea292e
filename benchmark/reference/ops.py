"""Plain float64 compact-scheme operators of a uniform tlab grid.

A frozen copy of the published schemes the program uses: the sixth-order
compact first derivative (Lele 1992, Eq. 2.1.7, tridiagonal) with the
third- and fifth-order biased closures (Lele Eq. 4.1.3; Carpenter et al.
1993, Eq. 95), and the sixth-order hyperviscous second derivative
(Lamballais et al. 2011) with its closures, in the Jacobian formulation of
tlab's FDM_CreatePlan.  Each operator is the dense matrix A^-1 B, built on
the host in float64 and applied as one product along an axis.

Only uniform axes are built (the configurations' grids are uniform); a
stretched axis raises.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# interior (a1, a2, b1, b2, b3) and boundary rows (a1, a2, b...) of the
# first derivative C1N6 and of the second derivative C2N6H
_BC1_D1 = (2.0, 0.0, -2.5, 2.0, 0.5, 0.0)
_BC2_D1 = (1.0 / 6.0, 0.5, -5.0 / 9.0, -0.5, 1.0, 1.0 / 18.0)
C1N6 = {"interior": (1.0 / 3.0, 0.0, 7.0 / 9.0, 1.0 / 36.0, 0.0),
        "bc": (_BC1_D1, _BC2_D1)}

_KC = math.pi ** 2
_BC1_D2 = (11.0, 0.0, 13.0, -27.0, 15.0, -1.0)
_BC2_D2 = (0.1, 0.1, 1.2, -2.4, 1.2, 0.0)
_BC3_D2 = (2.0 / 11.0, 2.0 / 11.0, 3.0 / 44.0, 12.0 / 11.0, -51.0 / 22.0,
           12.0 / 11.0, 3.0 / 44.0, 0.0)
C2N6H = {"interior": ((272.0 - 45.0 * _KC) / (416.0 - 90.0 * _KC), 0.0,
                      (48.0 - 135.0 * _KC) / (1664.0 - 360.0 * _KC),
                      (528.0 - 81.0 * _KC) / (208.0 - 45.0 * _KC) / 4.0,
                      -(432.0 - 63.0 * _KC) / (1664.0 - 360.0 * _KC) / 9.0),
         "bc": (_BC1_D2, _BC2_D2, _BC3_D2)}

SCHEMES = {"compactjacobian6": C1N6, "compactjacobian6hyper": C2N6H}


def _interior(A, B, coef, rows, periodic, second):
    n = A.shape[0]
    a1, a2, b1, b2, b3 = coef
    for i in rows:
        A[i, i] = 1.0
        for k, a in ((1, a1), (2, a2)):
            if a != 0.0:
                A[i, (i - k) % n if periodic else i - k] += a
                A[i, (i + k) % n if periodic else i + k] += a
        for k, b in ((1, b1), (2, b2), (3, b3)):
            if b == 0.0:
                continue
            B[i, (i + k) % n if periodic else i + k] += b
            if second:
                B[i, (i - k) % n if periodic else i - k] += b
                B[i, i] -= 2.0 * b
            else:
                B[i, (i - k) % n if periodic else i - k] -= b


def _closures(A, B, scheme, antisym):
    n = A.shape[0]
    sgn = -1.0 if antisym else 1.0
    for r, row in enumerate(scheme["bc"]):
        a1, a2 = row[0], row[1]
        A[r, :] = 0.0
        B[r, :] = 0.0
        if r == 0:
            A[0, 0], A[0, 1] = 1.0, a1       # both schemes: a2 = 0 here
        else:
            A[r, r - 1], A[r, r], A[r, r + 1] = a1, 1.0, a2
        for j, b in enumerate(row[2:]):
            B[r, j] = b
        rt = n - 1 - r
        A[rt, :] = 0.0
        B[rt, :] = 0.0
        A[rt, ::-1] = A[r, :]
        B[rt, ::-1] = sgn * B[r, :]


def system(scheme, n, periodic, second):
    """(A, B) of the unit-spaced scheme: A f' = B f (or A f'' = B f)."""
    A = np.zeros((n, n))
    B = np.zeros((n, n))
    if periodic:
        _interior(A, B, scheme["interior"], range(n), True, second)
    else:
        nbc = len(scheme["bc"])
        _interior(A, B, scheme["interior"], range(nbc, n - nbc), False,
                  second)
        _closures(A, B, scheme, antisym=not second)
    return A, B


def reduce_neumann(A, B):
    """D1 with f' = 0 at both ends, the wall values eliminated through the
    wall rows of A f' = B f (tlab's FDM_Bcs_Neumann)."""
    n = A.shape[0]
    Ar, Br = A.copy(), B.copy()
    Ar[1:, :] -= np.outer(Br[1:, 0] / Br[0, 0], Ar[0, :])
    Br[1:, :] -= np.outer(Br[1:, 0] / Br[0, 0], Br[0, :])
    Ar[:-1, :] -= np.outer(Br[:-1, -1] / Br[-1, -1], Ar[-1, :])
    Br[:-1, :] -= np.outer(Br[:-1, -1] / Br[-1, -1], Br[-1, :])
    D = np.zeros((n, n))
    D[1:-1, 1:-1] = np.linalg.solve(Ar[1:-1, 1:-1], Br[1:-1, 1:-1])
    return D


def modified_wavenumber(scheme, n):
    """k' of the periodic first derivative of e^{ikx}, grid units."""
    a1, a2, b1, b2, b3 = scheme["interior"]
    i = np.arange(n)
    w = 2.0 * np.pi * np.where(i <= n // 2, i, i - n) / n
    num = 2.0 * (b1 * np.sin(w) + b2 * np.sin(2 * w) + b3 * np.sin(3 * w))
    return num / (1.0 + 2.0 * a1 * np.cos(w) + 2.0 * a2 * np.cos(2 * w))


class Axis:
    """The dense operators of one uniform direction (float64, host)."""

    def __init__(self, points: int, end: float, periodic: bool,
                 scheme1: str, scheme2: str):
        nodes = np.linspace(0.0, end, points)
        if periodic:
            nodes = nodes[:-1]
        self.n = n = nodes.shape[0]
        self.periodic = periodic
        self.nodes = nodes
        s1 = SCHEMES[scheme1.lower()]
        s2 = SCHEMES[scheme2.lower()]
        d = np.diff(nodes)
        if np.max(np.abs(d - d[0])) > 1e-10 * abs(d[0]):
            raise NotImplementedError("a stretched axis")
        # dx/ds as tlab bootstraps it: the non-periodic compact derivative
        # of the nodes on a unit-spaced grid
        Au, Bu = system(s1, n, False, False)
        jac = np.linalg.solve(Au, Bu @ nodes)
        self.jac = jac
        A1, B1 = system(s1, n, periodic, False)
        A1 = A1 * jac[None, :]
        A2, B2 = system(s2, n, periodic, True)
        A2 = A2 * (jac ** 2)[None, :]
        self.A1, self.B1 = A1, B1
        self.d1 = np.linalg.solve(A1, B1)
        self.d2 = np.linalg.solve(A2, B2)
        self.scheme1 = s1
        if periodic:
            self.mwn1 = modified_wavenumber(s1, n) / jac[0]
        else:
            self.d1nn = reduce_neumann(A1, B1)


def neumann_rows(ax: Axis):
    """(nb, nt): the wall value with zero wall-normal derivative, as a row
    of weights on the column (the wall rows of the compact system)."""
    D = ax.d1nn
    nb = (ax.A1[0, :] @ D - ax.B1[0, :]) / ax.B1[0, 0]
    nb[0] += 1.0
    nt = (ax.A1[-1, :] @ D - ax.B1[-1, :]) / ax.B1[-1, -1]
    nt[-1] += 1.0
    return nb, nt


def tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 `a` rounded to TF32's 10-bit mantissa, to nearest (the
    operands of a TF32 product; the sum stays float32)."""
    bits = a.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def along(M: torch.Tensor, a: torch.Tensor, axis: int,
          tf32_products: bool = False) -> torch.Tensor:
    """M applied along `axis` of `a` (any leading axes); with
    tf32_products, float32 operands rounded to TF32 first."""
    if tf32_products:
        M, a = tf32(M), tf32(a)
    return torch.movedim(torch.tensordot(M, a, dims=([1], [axis])), 0, axis)
