"""Poisson / Helmholtz solvers: Fourier in x,z + compact BVP in y.  Port of
tlab_tpu/ops/elliptic.py (the direct eigen formulation, [Main]
EllipticOrder=compactdirect*).

Solves  Lap p = f  (or Lap a + alpha a = f) on domains periodic in x and z,
general (nonuniform, bounded) in y, as the reference does
(src/operators/opr_elliptic.f90): Fourier-diagonalize the horizontal
directions with the *modified* wavenumbers of the compact schemes, then for
each horizontal mode solve the two-point boundary-value problem

    p_hat'' - lambda p_hat = f_hat,   lambda = k'x^2-like modified eigenvalue

Instead of per-mode banded LU sweeps (reference FDM_Int2_Solve), the
lambda-affine pencil (M0 - lambda*M1) u = R f is diagonalized ONCE at plan
time,

    u = V diag(1 / (1 - (lambda - ls) Lam)) V^-1 Ms^-1 R f,

so the whole field solve is two dense (ny x ny) products plus an elementwise
scale, for every horizontal mode at once.  The transforms are torch.fft
(rfft along x, fft along z).  A float64 per-mode dense solve
(solve_modal_dense) provides the validation path.

The pencil rows implement the reference's "direct" formulation
(FDM_Int2_CreateSystem, src/fdm/fdm_integral.f90:334-549): N-2 compact
interior equations (B2 - lambda A2) p = A2 f plus two boundary rows;
Neumann rows use the 4th-order one-sided relation
p'_b = sum_m b_m p_m + a2 p''_adj  with p''_adj = lambda p_adj + f_adj
(coef_c1n4_biased equivalent, derived here by polynomial exactness).

The plan-time part (float64 NumPy) is tlab_tpu's, unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tlab_tpu_torch import device as _device
from tlab_tpu_torch.constants import BC
from tlab_tpu_torch.fdm.plan import DerivPlan, FdmPlan
from tlab_tpu_torch.ops.derivative import der1


# ---------------------------------------------------------------------------
# Plan-time construction (float64 NumPy)
# ---------------------------------------------------------------------------

def neumann_row_coefs(y: np.ndarray, at_max: bool):
    """(b0..b3, a2) with p'_edge = sum b_m p_m + a2 p''_adjacent, 4th order.

    Exact for polynomials of degree <= 4 (Hermite-Birkhoff fit on 4 nodes +
    one second-derivative value at the adjacent node). Equivalent to the
    reference's coef_c1n4_biased (fdm_integral.f90:560-619); on a uniform
    grid b = (-29/6, 9, -9/2, 1/3)/h, a2 = 3h.
    """
    n = y.shape[0]
    if at_max:
        idx = [n - 1, n - 2, n - 3, n - 4]
    else:
        idx = [0, 1, 2, 3]
    y0 = y[idx[0]]
    dy = y[idx] - y0
    dya = dy[1]           # adjacent node (where p'' is used)
    # exactness on monomials (y-y0)^m, m=0..4: p'(y0)=m*0^(m-1) -> only m=1
    Mt = np.zeros((5, 5))
    rhs = np.zeros(5)
    rhs[1] = 1.0
    for m in range(5):
        Mt[m, :4] = dy ** m
        Mt[m, 4] = m * (m - 1) * dya ** (m - 2) if m >= 2 else 0.0
    coef = np.linalg.solve(Mt, rhs)
    return coef[:4], coef[4], idx


def build_pencil(plan_y: DerivPlan, ibc: BC):
    """(M0, M1, R) with (M0 - lambda M1) p = R f; bc values ride in f rows.

    On nonuniform grids the Jacobian-form D2 needs p' (C2 != 0), so the
    pencil is built from the direct (nonuniform-native) compact system
    instead, as the reference's elliptic solver does with its
    CompactDirect schemes (opr_elliptic.f90:113-121).
    """
    n = plan_y.size
    if not plan_y.uniform and np.max(np.abs(plan_y.C2)) > 1e-12:
        from tlab_tpu_torch.fdm.schemes import build_2der_direct_system
        A2, B2 = build_2der_direct_system(plan_y.nodes)
    else:
        A2, B2 = plan_y.A2.copy(), plan_y.B2.copy()

    # The wall rows of f are repurposed to carry boundary-condition values,
    # so interior equations must not reference the wall forcing. Eliminate
    # the f_0 / f_{n-1} couplings (columns 0, n-1 of the A-side) using the
    # otherwise-dropped biased boundary rows -- the same row operations as
    # the reference's FDM_Bcs_Reduce (src/fdm/fdm_base.f90:304-391), kept
    # lambda-affine because the multipliers depend only on A.
    Bi, Ai, Ri = B2.copy(), A2.copy(), A2.copy()
    c = Ai[1:-1, 0] / A2[0, 0]
    Bi[1:-1] -= np.outer(c, B2[0])
    Ri[1:-1] -= np.outer(c, A2[0])
    Ai[1:-1] -= np.outer(c, A2[0])
    d = Ri[1:-1, -1] / A2[-1, -1]
    Bi[1:-1] -= np.outer(d, B2[-1])
    Ri[1:-1] -= np.outer(d, A2[-1])
    Ai[1:-1] -= np.outer(d, A2[-1])

    M0 = np.zeros((n, n))
    M1 = np.zeros((n, n))
    R = np.zeros((n, n))
    M0[1:-1] = Bi[1:-1]
    M1[1:-1] = Ai[1:-1]
    R[1:-1] = Ri[1:-1]
    R[1:-1, 0] = 0.0
    R[1:-1, -1] = 0.0

    y = plan_y.nodes
    if ibc in (BC.ND, BC.NN):      # Neumann at min
        b, a2, idx = neumann_row_coefs(y, at_max=False)
        M0[0, idx] = b
        M1[0, idx[1]] = -a2
        R[0, 0] = 1.0
        R[0, idx[1]] = -a2
    else:                          # Dirichlet at min
        M0[0, 0] = 1.0
        R[0, 0] = 1.0
    if ibc in (BC.DN, BC.NN):      # Neumann at max
        b, a2, idx = neumann_row_coefs(y, at_max=True)
        M0[-1, idx] = b
        M1[-1, idx[1]] = -a2
        R[-1, -1] = 1.0
        R[-1, idx[1]] = -a2
    else:
        M0[-1, -1] = 1.0
        R[-1, -1] = 1.0
    return M0, M1, R


@dataclasses.dataclass(frozen=True)
class EllipticPlan:
    """Eigendecomposition-based modal vertical solver + horizontal lambdas."""

    ny: int
    ibc: BC
    shift: float                 # ls in the resolvent formula
    V: np.ndarray                # (ny, ny)
    W: np.ndarray                # (ny, ny) = V^-1 Ms^-1 R
    lam_eig: np.ndarray          # (ny,)
    lam_x: np.ndarray            # (nkx,) modified eigenvalues along x
    lam_z: np.ndarray            # (nz,)  modified eigenvalues along z
    S_sing: Optional[np.ndarray]  # (ny, ny) dense solve for the singular mode
    M0: np.ndarray = dataclasses.field(repr=False, default=None)
    M1: np.ndarray = dataclasses.field(repr=False, default=None)
    R: np.ndarray = dataclasses.field(repr=False, default=None)
    eig_condition: float = 0.0


def _reflection_basis(n: int):
    """Orthogonal (n, n) map to the even/odd subspaces of the index flip
    J: i -> n-1-i (even rows first)."""
    m = n // 2
    T = np.zeros((n, n))
    r = 1.0 / np.sqrt(2.0)
    for i in range(m):
        T[i, i] = r
        T[i, n - 1 - i] = r
    if n % 2:
        T[m, m] = 1.0
    off = m + (n % 2)
    for i in range(m):
        T[off + i, i] = r
        T[off + i, n - 1 - i] = -r
    return T, m + (n % 2)


def _pencil_eig(K: np.ndarray):
    """(lam, V, Vinv, cond) of K, exploiting reflection symmetry.

    On mirrored (symmetric) grids with symmetric BC pairs (NN, DD) the
    pencil commutes with the index flip J, so even and odd eigenmodes are
    (near-)degenerate pairs and the raw eigenbasis is numerically
    DEFECTIVE (measured cond(V) ~ 1e32 on the reference's mirrored tanh
    channel grid). Block-diagonalizing by parity first splits the pairs;
    each block is then well-conditioned."""
    n = K.shape[0]
    # K J - J K with J the index flip: the products permute columns and
    # rows exactly, so they are taken as such (a product with the flipped
    # identity's negative-stride view misses BLAS and runs as an unblocked
    # O(n^3) loop: minutes at a long line's n)
    use_sym = np.linalg.norm(K[:, ::-1] - K[::-1, :]) \
        <= 1e-10 * np.linalg.norm(K)
    if use_sym:
        T, ne = _reflection_basis(n)
        Ks = T @ K @ T.T
        blocks = [Ks[:ne, :ne], Ks[ne:, ne:]]
        lams, Vs, Vinvs, conds = [], [], [], []
        for Kb in blocks:
            lam_b, V_b = np.linalg.eig(Kb)
            if np.max(np.abs(lam_b.imag)) > 1e-8 * np.max(np.abs(lam_b)):
                use_sym = False
                break
            lams.append(lam_b.real)
            Vs.append(V_b.real)
            Vinvs.append(np.linalg.inv(V_b.real))
            conds.append(np.linalg.cond(V_b.real))
        if use_sym:
            lam = np.concatenate(lams)
            Vblk = np.zeros((n, n))
            Vblk[:ne, :ne] = Vs[0]
            Vblk[ne:, ne:] = Vs[1]
            Viblk = np.zeros((n, n))
            Viblk[:ne, :ne] = Vinvs[0]
            Viblk[ne:, ne:] = Vinvs[1]
            return lam, T.T @ Vblk, Viblk @ T, float(max(conds))
    lam, V = np.linalg.eig(K)
    if np.max(np.abs(lam.imag)) > 1e-8 * np.max(np.abs(lam)):
        raise RuntimeError("complex eigenvalues in elliptic pencil; "
                           "use the dense fallback solver")
    lam = lam.real
    V = V.real
    return lam, V, np.linalg.inv(V), float(np.linalg.cond(V))


def build_elliptic_plan(fdm: FdmPlan, ibc: BC = BC.NN,
                        shift: float = 1.0,
                        lam_x=None, lam_z=None) -> EllipticPlan:
    """lam_x/lam_z override the horizontal modal eigenvalues (staggered
    pressure grid uses the squared staggered-derivative wavenumbers,
    reference opr_elliptic.f90:144-147)."""
    plan_y = fdm.y
    n = plan_y.size
    M0, M1, R = build_pencil(plan_y, ibc)

    Ms = M0 - shift * M1
    K = np.linalg.solve(Ms, M1)
    lam_eig, V, Vinv, cond = _pencil_eig(K)
    W = Vinv @ np.linalg.solve(Ms, R)

    # horizontal modal eigenvalues from der2 modified wavenumbers
    # (cf. reference opr_elliptic.f90:225-231, TYPE_DIRECT)
    nx = fdm.x.size
    if lam_x is None:
        lam_x = fdm.x.mwn2[: nx // 2 + 1] if fdm.x.periodic else np.zeros(1)
    if lam_z is None:
        lam_z = fdm.z.mwn2 if fdm.z.size > 1 else np.zeros(1)

    # singular (mean) mode: Dirichlet-bottom/Neumann-top with lambda = 0
    # (compatibility constraint; reference opr_elliptic.f90:233-238,419-421)
    S_sing = None
    if ibc == BC.NN:
        M0s, M1s, Rs = build_pencil(plan_y, BC.DN)
        S_sing = np.linalg.solve(M0s - 0.0 * M1s, Rs)

    return EllipticPlan(ny=n, ibc=ibc, shift=shift, V=V, W=W,
                        lam_eig=lam_eig, lam_x=lam_x, lam_z=lam_z,
                        S_sing=S_sing, M0=M0, M1=M1, R=R,
                        eig_condition=cond)


# ---------------------------------------------------------------------------
# Device-side application
# ---------------------------------------------------------------------------

def device_elliptic_plan(plan: EllipticPlan, dtype=torch.float32,
                         device="cuda") -> dict:
    """The plan's eigen data and the (nkx, nz) modal eigenvalues as real
    tensors on `device`.  The products with V and W run in full float32
    (cond(V) amplifies TF32 round-off)."""
    dev = _device.resolve(device)
    _device.full_fp32_matmul()

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(dev, dtype)

    d = {
        "V": t(plan.V),
        "W": t(plan.W),
        "lam_eig": t(plan.lam_eig),
        "lam_xz": t(plan.lam_x[:, None] + plan.lam_z[None, :]),
        "shift": float(plan.shift),
    }
    if plan.S_sing is not None:
        d["S_sing"] = t(plan.S_sing)
    return d


def _lmul_real(M, z):
    """M @ z along axis 1 of the complex (nkx, ny, nz) tensor z for a REAL
    (ny, ny) matrix M: one real product on the interleaved (re, im) view,
    half the work of a complex one."""
    nkx, ny, nz = z.shape
    zr = torch.view_as_real(z.contiguous()).reshape(nkx, ny, 2 * nz)
    out = torch.matmul(M, zr).reshape(nkx, M.shape[0], nz, 2)
    return torch.view_as_complex(out)


def solve_modal(plan_dev: dict, f_hat, alpha=0.0, singular_fix: bool = True):
    """Vertical solve for all horizontal modes.

    f_hat: complex (nkx, ny, nz) spectral forcing with bc values in y-rows
    0 and ny-1. Returns u_hat of the same shape solving
    u'' - (lambda - alpha) u = f per mode.
    """
    V, W, lam_eig = plan_dev["V"], plan_dev["W"], plan_dev["lam_eig"]
    lam_eff = plan_dev["lam_xz"] - alpha                  # (nkx, nz)
    G = _lmul_real(W, f_hat)
    denom = 1.0 - (lam_eff[:, None, :] - plan_dev["shift"]) \
        * lam_eig[None, :, None]
    u_hat = _lmul_real(V, G / denom)

    S_sing = plan_dev.get("S_sing") if singular_fix else None
    if S_sing is not None:
        # overwrite the (kx=0, kz=0) singular column with the compatible
        # Dirichlet-bottom solve (mean pressure pinned to 0 at the wall)
        f0 = f_hat[0, :, 0].clone()
        f0[0] = 0.0                                # zero bottom bc value
        u_hat[0, :, 0] = torch.matmul(S_sing.to(f_hat.dtype), f0)
    return u_hat


def _forward_fft(f):
    f_hat = torch.fft.rfft(f, dim=0)
    if f.shape[2] > 1:
        f_hat = torch.fft.fft(f_hat, dim=2)
    return f_hat


def _backward_fft(u_hat, nx, nz):
    if nz > 1:
        u_hat = torch.fft.ifft(u_hat, dim=2)
    return torch.fft.irfft(u_hat, n=nx, dim=0)


def _with_wall_rows(f, bcs_b, bcs_t):
    """A copy of f whose y-rows 0 and ny-1 carry the boundary values."""
    f = f.clone()
    f[:, 0, :] = 0.0 if bcs_b is None else bcs_b
    f[:, -1, :] = 0.0 if bcs_t is None else bcs_t
    return f


def poisson(plan_dev: dict, f, bcs_b=None, bcs_t=None, d1y=None):
    """Solve Lap p = f with the plan's BCs; returns (p[, dpdy]).

    f: (nx, ny, nz) real. bcs_b/bcs_t: (nx, nz) boundary-condition fields
    (Dirichlet values or Neumann derivative values per the plan's ibc),
    default zero. If d1y (dense y-derivative matrix) is given, also returns
    dpdy computed as in the reference's direct method
    (opr_elliptic.f90:446-448).
    """
    nx, _, nz = f.shape
    f_hat = _forward_fft(_with_wall_rows(f, bcs_b, bcs_t))
    u_hat = solve_modal(plan_dev, f_hat)
    p = _backward_fft(u_hat, nx, nz)
    if d1y is not None:
        return p, der1(d1y, p, 1)
    return p


def poisson_residual(fdm: FdmPlan, p, f, bcs_b=None, bcs_t=None) -> float:
    """How far `p` is from solving the discrete problem poisson() inverts
    with the Neumann (NN) plan of `fdm`: max over the horizontal modes of
    |(M0 - lambda M1) p_hat - R f_hat| (the mean mode against its
    Dirichlet-bottom system, as solve_modal pins it), over the largest sum
    of the three terms' magnitudes |M0 p_hat| + lambda |M1 p_hat| +
    |R f_hat| (their cancellation's round-off); in float64 on p's device.
    A float64 solve reads round-off; a wrong sign, scale or boundary value
    O(1)."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=p.device)

    nx, _, nz = p.shape
    M0, M1, R = (t(m) for m in build_pencil(fdm.y, BC.NN))
    M0s, _, Rs = (t(m) for m in build_pencil(fdm.y, BC.DN))
    lam_z = fdm.z.mwn2 if nz > 1 else np.zeros(1)
    lam = t(fdm.x.mwn2[: nx // 2 + 1][:, None] + lam_z[None, :])
    u_hat = _forward_fft(p.to(torch.float64))
    f_hat = _forward_fft(_with_wall_rows(f.to(torch.float64), bcs_b, bcs_t))
    rf = _lmul_real(R, f_hat)
    m0 = _lmul_real(M0, u_hat)
    m1 = lam[:, None, :] * _lmul_real(M1, u_hat)
    res = m0 - m1 - rf
    size = torch.abs(m0) + torch.abs(m1) + torch.abs(rf)
    f0 = f_hat[0, :, 0].clone()
    f0[0] = 0.0
    rf0 = torch.matmul(Rs.to(f0.dtype), f0)
    m00 = torch.matmul(M0s.to(f0.dtype), u_hat[0, :, 0])
    res[0, :, 0] = m00 - rf0
    size[0, :, 0] = torch.abs(m00) + torch.abs(rf0)
    return float(torch.amax(torch.abs(res)) / torch.amax(size))


def helmholtz(plan_dev: dict, f, alpha, bcs_b=None, bcs_t=None):
    """Solve Lap a + alpha a = f; modal system u'' - (lambda - alpha) u = f."""
    nx, _, nz = f.shape
    f_hat = _forward_fft(_with_wall_rows(f, bcs_b, bcs_t))
    u_hat = solve_modal(plan_dev, f_hat, alpha=alpha, singular_fix=False)
    return _backward_fft(u_hat, nx, nz)


# ---------------------------------------------------------------------------
# Dense float64 validation path
# ---------------------------------------------------------------------------

def solve_modal_dense(plan: EllipticPlan, f_hat: np.ndarray,
                      alpha: float = 0.0) -> np.ndarray:
    """NumPy reference solve: per-mode dense (M0 - lambda M1) \\ (R f)."""
    nkx, ny, nz = f_hat.shape
    lam = plan.lam_x[:, None] + plan.lam_z[None, :] - alpha
    out = np.zeros_like(f_hat)
    for i in range(nkx):
        for k in range(nz):
            if plan.S_sing is not None and i == 0 and k == 0:
                f0 = f_hat[0, :, 0].copy()
                f0[0] = 0.0
                out[0, :, 0] = plan.S_sing @ f0
                continue
            M = plan.M0 - lam[i, k] * plan.M1
            out[i, :, k] = np.linalg.solve(M, plan.R @ f_hat[i, :, k])
    return out
