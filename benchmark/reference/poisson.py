"""Plain float64 pressure Poisson solve with Neumann walls: tlab's
factorized formulation (Mellado & Ansorge 2012, ZAMM; the reference's
OPR_Poisson TYPE_FACTORIZE and OPR_ODE2_Factorize_NN).

p'' - kappa^2 p = f per horizontal Fourier mode is factorized as two
first-order compact integrals, (d/dy + kappa) q = f upwards and
(d/dy - kappa) p = q downwards, each the compact first-derivative system
of the y axis with its boundary row replaced by the boundary value; three
free constants close the wall conditions and the free boundary forcing.
The returned dp/dy is q + kappa p, the derivative the substep consumes.
A frozen plain version of the method, written for float64 on any device:
each integral is solved through the eigen decomposition of its pencil, as
in the reference, but with the host's float64 eigenvectors.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from reference.ops import Axis

# the blocks of kx rows a solve takes at a time
CHUNKS = 8


def _pencil(A, B, end):
    """(M0, M1, R) of u' + t u = f with u given at `end`."""
    n = A.shape[0]
    Bi, Ai, Ri = B.copy(), A.copy(), A.copy()
    M0, M1, R = (np.zeros((n, n)) for _ in range(3))
    if end == "min":
        c = Ai[1:, 0] / A[0, 0]
        Bi[1:] -= np.outer(c, B[0])
        Ri[1:] -= np.outer(c, A[0])
        Ai[1:] -= np.outer(c, A[0])
        M0[1:], M1[1:], R[1:] = Bi[1:], Ai[1:], Ri[1:]
        R[1:, 0] = 0.0
        M0[0, 0] = R[0, 0] = 1.0
    else:
        c = Ai[:-1, -1] / A[-1, -1]
        Bi[:-1] -= np.outer(c, B[-1])
        Ri[:-1] -= np.outer(c, A[-1])
        Ai[:-1] -= np.outer(c, A[-1])
        M0[:-1], M1[:-1], R[:-1] = Bi[:-1], Ai[:-1], Ri[:-1]
        R[:-1, -1] = 0.0
        M0[-1, -1] = R[-1, -1] = 1.0
    return M0, M1, R


def _eigen(M0, M1, R, shift):
    Ms = M0 + shift * M1
    lam, V = np.linalg.eig(np.linalg.solve(Ms, M1))
    return V, np.linalg.inv(V) @ np.linalg.solve(Ms, R), lam


class Poisson:
    """The Neumann solve of a grid (x and z periodic, y between walls)."""

    def __init__(self, x: Axis, y: Axis, z: Axis, device, shift=1.0):
        cd = torch.complex128
        self.device, self.ny, self.shift = device, y.n, shift
        A, B = y.A1, y.B1

        def c(a):
            return torch.as_tensor(np.asarray(a, np.complex128)).to(device)

        self.Vmin, self.Wmin, lmin = (c(a) for a in _eigen(
            *_pencil(A, B, "min"), shift))
        self.Vmax, self.Wmax, lmax = (c(a) for a in _eigen(
            *_pencil(A, B, "max"), -shift))
        self.lmin, self.lmax = lmin, lmax
        # recovery of the free boundary forcing from the bc-end scheme row
        for end, b in (("min", 0), ("max", y.n - 1)):
            rAf = A[b].copy()
            rAf[b] = 0.0
            setattr(self, f"rB_{end}", c(B[b] / A[b, b]))
            setattr(self, f"rA_{end}", c(A[b] / A[b, b]))
            setattr(self, f"rAf_{end}", c(rAf / A[b, b]))
        nx, nz = x.n, z.n
        kx = x.mwn1[: nx // 2 + 1]
        kap = np.sqrt(kx[:, None] ** 2 + z.mwn1[None, :] ** 2)
        tol = 1e-8 * max(kap.max(), 1.0)
        self.sing = tuple((i, k) for i in (0, nx // 2) for k in (0, nz // 2)
                          if kap[i, k] < tol)
        self.kap = torch.as_tensor(kap).to(device, cd)
        self._tables()

    def single(self):
        """A copy of this solve with its tables in complex64: the same
        method in single precision (a witness of what float32 reads; the
        reference itself stays in float64)."""
        out = copy.copy(self)
        for k, v in vars(self).items():
            if torch.is_tensor(v) and v.dtype == torch.complex128:
                setattr(out, k, v.to(torch.complex64))
            elif torch.is_tensor(v) and v.dtype == torch.float64:
                setattr(out, k, v.to(torch.float32))
            elif isinstance(v, np.ndarray):
                setattr(out, k, v.astype(np.complex64))
        return out

    def _msolve(self, V, W, dnm, rhs):
        return torch.matmul(V, torch.matmul(W, rhs) / dnm)

    def _chunks(self, nk=None):
        """The kx rows in blocks of about an eighth: the per-mode work of
        a block at a time, so that its temporaries stay a fraction of a
        field at a grid of a card's size (the modes are independent)."""
        nk = self.kap.shape[0] if nk is None else nk
        step = -(-nk // CHUNKS)
        return [slice(a, min(a + step, nk)) for a in range(0, nk, step)]

    def _dnm(self, kl):
        """The sweeps' per-mode denominators (rows, ny, nz) of the kappa
        rows kl (1, rows, nz)."""
        dmin = (1.0 + (kl - self.shift) * self.lmin_t[:, None, None]
                ).movedim(0, 1)
        dmax = (1.0 + (-kl + self.shift) * self.lmax_t[:, None, None]
                ).movedim(0, 1)
        return dmin.contiguous(), dmax.contiguous()

    def _tables(self):
        """The homogeneous responses of the composition (tlab's
        opr_odes.f90): em, v1 of the min sweep to a unit bc and a unit
        top forcing, ep of the max sweep to a unit bc, u1 and sp of the
        max sweep to v1 and em; their real parts, as the reference keeps
        (held real: half the memory, the same products).  Built a block
        of kx rows at a time."""
        n = self.ny
        nk, nz = self.kap.shape
        self.lmin_t = torch.as_tensor(self.lmin).to(self.device)
        self.lmax_t = torch.as_tensor(self.lmax).to(self.device)
        real = self.kap.real.dtype
        for name in ("em", "v1", "u1", "sp", "ep"):
            setattr(self, name, torch.empty((nk, n, nz), dtype=real,
                                            device=self.device))
        for name in ("du1_n", "dsp_n", "dep_n"):
            setattr(self, name, torch.empty((nk, nz), dtype=real,
                                            device=self.device))

        def col(V, W, dnm, j):
            return torch.matmul(V, W[:, j][None, :, None] / dnm)

        def through_max(src, dmax):
            v = src.clone()
            v[:, n - 1, :] = 0.0
            return self._msolve(self.Vmax, self.Wmax, dmax, v), v

        for sl in self._chunks():
            kap = self.kap[sl]
            dmin, dmax = self._dnm(kap[None])
            em = col(self.Vmin, self.Wmin, dmin, 0)
            v1 = col(self.Vmin, self.Wmin, dmin, n - 1)
            ep = col(self.Vmax, self.Wmax, dmax, n - 1)
            u1, v1f = through_max(v1, dmax)
            sp, emf = through_max(em, dmax)
            self.du1_n[sl] = self._ft_max(u1, v1f, kap)
            self.dsp_n[sl] = self._ft_max(sp, emf, kap)
            self.dep_n[sl] = self._ft_max(ep, torch.zeros_like(em),
                                          kap) + kap.real
            for name, t in (("em", em), ("v1", v1), ("u1", u1),
                            ("sp", sp), ("ep", ep)):
                getattr(self, name)[sl] = t.real
            del em, v1, ep, u1, v1f, sp, emf, dmin, dmax

    def _ft_max(self, u, f, kap):
        """u'_N of a max-sweep solution u of forcing f (bc-end row)."""
        return (torch.einsum("a,kaz->kz", self.rB_max, u)
                - kap * torch.einsum("a,kaz->kz", self.rA_max, u)
                - torch.einsum("a,kaz->kz", self.rAf_max, f)).real

    def _sing(self, f, gt):
        """A kappa = 0 column: q' = f with q_N = gt, then p' = q with
        p_1 = 0; the free bottom forcing of the first sweep is set by the
        constraint (the reference's DN_Sing with gb = 0)."""
        n = self.ny
        d0min = (1.0 - self.shift * self.lmin)[:, None]
        d0max = (1.0 + self.shift * self.lmax)[:, None]

        def smin(fv, bc):
            r = fv.clone()
            r[0] = bc
            return self._msolve(self.Vmin, self.Wmin, d0min, r[:, None])[
                :, 0], r

        def smax(fv, bc):
            r = fv.clone()
            r[n - 1] = bc
            return self._msolve(self.Vmax, self.Wmax, d0max, r[:, None])[
                :, 0], r

        f0 = f.clone()
        f0[0] = 0.0
        e0 = torch.zeros_like(f)
        e0[0] = 1.0
        zero = torch.zeros((), dtype=f.dtype, device=f.device)
        q0, _ = smax(f0, gt)
        q1, _ = smax(e0, zero)
        p0, r0 = smin(q0, zero)
        p1, r1 = smin(q1, zero)
        dp0 = torch.sum(self.rB_min * p0) - torch.sum(self.rAf_min * r0)
        dp1 = torch.sum(self.rB_min * p1) - torch.sum(self.rAf_min * r1)
        c = (q0[0] - dp0) / (dp1 - q1[0])
        return p0 + c * p1, q0 + c * q1

    def forward(self, a):
        """The modes (nx/2+1, ny, nz) of a field (nx, ny, nz): the
        transform along z a block of kx rows at a time, in place."""
        ah = torch.fft.rfft(a, dim=0)
        for sl in self._chunks(ah.shape[0]):
            ah[sl] = torch.fft.fft(ah[sl], dim=-1)
        return ah

    def solve(self, f, bcs_b, bcs_t):
        """(p, dp/dy) of p_xx + p_yy + p_zz = f, dp/dy = bcs at the walls;
        f (nx, ny, nz), bcs (nx, nz), float64."""
        return self.solve_modes(self.forward(f), f.shape[0], bcs_b, bcs_t)

    def solve_modes(self, fh, nx, bcs_b, bcs_t):
        """solve() from the modes fh = forward(f) of f, a block of kx rows
        at a time; fh is overwritten."""
        n = self.ny
        gb, gt = (torch.fft.fft(torch.fft.rfft(b, dim=0), dim=-1)
                  for b in (bcs_b, bcs_t))
        q_hat = torch.empty_like(fh)
        for sl in self._chunks():
            kap = self.kap[sl]
            dmin, dmax = self._dnm(kap[None])
            em, v1, u1, sp, ep = (t[sl] for t in (self.em, self.v1,
                                                  self.u1, self.sp,
                                                  self.ep))
            r1 = fh[sl].clone()
            r1[:, 0, :] = 0.0
            r1[:, n - 1, :] = 0.0
            v0 = self._msolve(self.Vmin, self.Wmin, dmin, r1)
            del r1
            r2 = v0.clone()
            r2[:, n - 1, :] = 0.0
            u0 = self._msolve(self.Vmax, self.Wmax, dmax, r2)
            du0_n = (torch.matmul(self.rB_max, u0)
                     - kap * torch.matmul(self.rA_max, u0)
                     - torch.matmul(self.rAf_max, r2))
            del r2, dmin, dmax
            sing = kap.real <= 0.0

            def safe(a):
                return torch.where(sing, torch.ones_like(a), a)

            a11 = 1.0 + kap * sp[:, 0, :]
            a21 = em[:, n - 1, :]
            a31 = self.dsp_n[sl]
            a12 = kap * ep[:, 0, :] / safe(a11)
            a22 = kap - a21 * a12
            a32 = self.dep_n[sl] - a31 * a12
            a13 = kap * u1[:, 0, :] / safe(a11)
            a23 = (v1[:, n - 1, :] - a21 * a13) / safe(a22)
            a33 = self.du1_n[sl] - a31 * a13 - a32 * a23
            q1 = (gb[sl] - kap * u0[:, 0, :]) / safe(a11)
            uN = (gt[sl] - v0[:, n - 1, :] - a21 * q1) / safe(a22)
            fn = (gt[sl] - du0_n - a31 * q1 - a32 * uN) / safe(a33)
            uN = uN - a23 * fn
            q1 = q1 - a12 * uN - a13 * fn
            p = u0 + fn[:, None, :] * u1 + q1[:, None, :] * sp \
                + uN[:, None, :] * ep
            del u0
            q_hat[sl] = v0 + fn[:, None, :] * v1 + q1[:, None, :] * em \
                + kap[:, None, :] * p
            del v0
            for (i, k) in self.sing:
                if sl.start <= i < sl.stop:
                    p[i - sl.start, :, k], q_hat[i, :, k] = self._sing(
                        fh[i, :, k], gt[i, k])
            # the block's modes are used up: its inverse along z in place
            fh[sl] = torch.fft.ifft(p, dim=-1)
            q_hat[sl] = torch.fft.ifft(q_hat[sl], dim=-1)
            del p
        p = torch.fft.irfft(fh, n=nx, dim=0)
        del fh
        return p, torch.fft.irfft(q_hat, n=nx, dim=0)
