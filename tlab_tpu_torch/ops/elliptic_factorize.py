"""Factorized Poisson solver: two first-order compact integrals per mode
(the reference's default TYPE_FACTORIZE, opr_elliptic.f90:263-364;
Mellado & Ansorge 2012, ZAMM), reference-exact.  Port of
tlab_tpu/ops/elliptic_factorize.py; its module docstring derives the
method.

The NumPy plan half (build_int1_pencil .. build_factorize_plan) is a
verbatim copy: the JAX module imports JAX at module level.  The device half
keeps complex tensors on the device, builds the per-mode tables once per
plan, and runs the horizontal transforms with torch.fft.  The modal sweeps
recombine eigenvectors with cond(V) up to ~1e7, so their float32 products
must stay in full complex64 (device.full_fp32_matmul, never TF32).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from tlab_tpu_torch.fdm.plan import DerivPlan, FdmPlan
from tlab_tpu_torch import device as _device
from tlab_tpu_torch.utils import trace as _trace


# ---------------------------------------------------------------------------
# NumPy plan (copied from tlab_tpu/ops/elliptic_factorize.py:61-179)
# ---------------------------------------------------------------------------

def build_int1_pencil(plan_y: DerivPlan, end: str):
    """(M0, M1, R) for u' + kappa u = f with u given at `end` ('min'/'max');
    wall-forcing column eliminated with the dropped biased row."""
    A, B = plan_y.A1, plan_y.B1
    n = plan_y.size
    Bi, Ai, Ri = B.copy(), A.copy(), A.copy()
    M0 = np.zeros((n, n))
    M1 = np.zeros((n, n))
    R = np.zeros((n, n))
    if end == "min":
        c = Ai[1:, 0] / A[0, 0]
        Bi[1:] -= np.outer(c, B[0])
        Ri[1:] -= np.outer(c, A[0])
        Ai[1:] -= np.outer(c, A[0])
        M0[1:] = Bi[1:]
        M1[1:] = Ai[1:]
        R[1:] = Ri[1:]
        R[1:, 0] = 0.0
        M0[0, 0] = 1.0
        R[0, 0] = 1.0
    else:
        c = Ai[:-1, -1] / A[-1, -1]
        Bi[:-1] -= np.outer(c, B[-1])
        Ri[:-1] -= np.outer(c, A[-1])
        Ai[:-1] -= np.outer(c, A[-1])
        M0[:-1] = Bi[:-1]
        M1[:-1] = Ai[:-1]
        R[:-1] = Ri[:-1]
        R[:-1, -1] = 0.0
        M0[-1, -1] = 1.0
        R[-1, -1] = 1.0
    return M0, M1, R


def _ft_rows(plan_y: DerivPlan, end: str):
    """Recovery data for the sweep's free boundary forcing ft.

    The bc-end scheme row of (B + t A) u = A f~ DEFINES the boundary
    forcing (fdm_integral.f90 keeps that row out of the solve); given the
    solved u and the supplied interior f,
        ft = (B_b . u + t (A_b . u) - sum_{j!=b} A_bj f_j) / A_bb,
    which yields the reference's du_boundary: u'_b = ft - t u_b."""
    A, B = plan_y.A1, plan_y.B1
    n = plan_y.size
    b = 0 if end == "min" else n - 1
    rAf = A[b].copy()
    rAf[b] = 0.0
    return {"rB": B[b] / A[b, b], "rA": A[b] / A[b, b],
            "rAf": rAf / A[b, b]}


def _eigen(M0, M1, R, shift):
    """Eigen data for x = V [(W r)/(1 + (t - shift) lam)] solving
    (M0 + t M1) x = R r -- spectra are genuinely complex (D1 pencil)."""
    Ms = M0 + shift * M1
    K = np.linalg.solve(Ms, M1)
    lam, V = np.linalg.eig(K)
    return {"V": V, "W": np.linalg.inv(V) @ np.linalg.solve(Ms, R),
            "lam": lam, "cond": float(np.linalg.cond(V))}


@dataclasses.dataclass(frozen=True)
class FactorizePlan:
    ny: int
    shift: float
    emin: dict                  # eigen data, 'min' sweep (t = +kappa)
    emax: dict                  # eigen data, 'max' sweep (t = -kappa)
    kappa: np.ndarray           # (nkx, nz) per-mode sqrt(lambda)
    sing: np.ndarray            # (nkx, nz) bool: reference singular modes
    sing_idx: tuple             # static ((i,k), ...) of singular modes


def build_factorize_plan(fdm: FdmPlan, shift: float = 1.0,
                         mwn_x=None, mwn_z=None,
                         sing_idx=None) -> FactorizePlan:
    """mwn_x/mwn_z override the horizontal modified wavenumbers (rfft
    ordering for x, full-fft ordering for z).  Singular modes follow the
    reference's INDEX sets i_sing = {0, nx/2} x k_sing = {0, nz/2}
    (opr_elliptic.f90:204-208); the staggered pressure grid passes
    sing_idx=((0,0),) (only one singular mode, :144-147)."""
    plan_y = fdm.y
    emin = _eigen(*build_int1_pencil(plan_y, "min"), shift)
    emax = _eigen(*build_int1_pencil(plan_y, "max"), -shift)
    emin.update({k + "_ft": v for k, v in _ft_rows(plan_y, "min").items()})
    emax.update({k + "_ft": v for k, v in _ft_rows(plan_y, "max").items()})

    nx = fdm.x.size
    nz = fdm.z.size
    custom = mwn_x is not None or mwn_z is not None
    if mwn_x is None:
        mwn_x = fdm.x.mwn1[: nx // 2 + 1] if fdm.x.periodic else np.zeros(1)
    if mwn_z is None:
        mwn_z = fdm.z.mwn1 if nz > 1 else np.zeros(1)
    lam = mwn_x[:, None] ** 2 + mwn_z[None, :] ** 2
    kappa = np.sqrt(lam)
    nkx, nzm = kappa.shape
    if sing_idx is None:
        if custom:
            sing_idx = ((0, 0),)
        else:
            i_sing = [0] + ([nx // 2] if nkx > nx // 2 else [])
            k_sing = [0] + ([nz // 2] if nz > 1 else [])
            # the reference index set {0, n/2} assumes EVEN grids, where
            # the compact scheme's modified wavenumber vanishes exactly
            # at Nyquist; on odd axes n//2 is a regular mode and the
            # singular override would corrupt (then blow up) the
            # projection -- keep only modes whose kappa is truly ~0
            tol = 1e-8 * max(kappa.max(), 1.0)
            sing_idx = tuple((i, k) for i in i_sing for k in k_sing
                             if kappa[i, k] < tol)
    sing = np.zeros((nkx, nzm), bool)
    for (i, k) in sing_idx:
        sing[i, k] = True
    return FactorizePlan(ny=plan_y.size, shift=shift, emin=emin, emax=emax,
                         kappa=kappa, sing=sing, sing_idx=tuple(sing_idx))


# ---------------------------------------------------------------------------
# Device plan
# ---------------------------------------------------------------------------

# complex64 carries 24 bits: past cond(V) = 2^24 the float32 sweeps'
# round-off is as large as the solution (a white-noise forcing's solve is
# off by ~1e-8 cond(V) of its max in float32).  The shear layer's y line
# reaches it at ny = 512 (2.0e7); at ny = 2304 (3.0e9) one RK4 step of the
# factorized projection takes max|v| to 1e10
FP32_COND_MAX = 2.0 ** 24


def device_factorize_plan(plan: FactorizePlan, dtype=torch.float32,
                          device="cuda") -> dict:
    """Device plan dict: the eigen data as complex tensors plus the per-mode
    tables (built here, once), on the card unless the caller names another
    device.  Below float64, a plan whose eigenbases' cond(V) passes
    FP32_COND_MAX is refused (ValueError): its solve would be noise."""
    cond = max(plan.emin["cond"], plan.emax["cond"])
    if dtype != torch.float64 and cond > FP32_COND_MAX:
        raise ValueError(
            f"the factorized Poisson plan at ny = {plan.ny} has eigenbases "
            f"of cond(V) {cond:.3e}, past the 2^24 that {dtype}'s complex "
            "sweeps carry: its solve would be noise.  Run in float64 "
            "(--x64) or with the direct eigen solve ([Main] "
            "EllipticOrder=compactdirect6)")
    arrays = {
        "Vmin": plan.emin["V"], "Wmin": plan.emin["W"],
        "Vmax": plan.emax["V"], "Wmax": plan.emax["W"],
        "lam_min": plan.emin["lam"], "lam_max": plan.emax["lam"],
        "shift": plan.shift, "kappa": plan.kappa,
        "sing_idx": plan.sing_idx, "ny": plan.ny,
    }
    for side, e in (("min", plan.emin), ("max", plan.emax)):
        for r in ("rB_ft", "rA_ft", "rAf_ft"):
            arrays[f"{r}_{side}"] = e[r]
    return device_plan_from_arrays(arrays, dtype, device)


def device_plan_from_arrays(arrays: dict, dtype, device) -> dict:
    """The device plan from NumPy arrays under the key names of
    tlab_tpu's device_factorize_plan (so a JAX plan converts directly)."""
    dev = _device.resolve(device)
    cd = _device.complex_dtype(dtype)

    def c(a):
        return torch.as_tensor(np.asarray(a, np.complex128)).to(dev, cd)

    d = {k: c(arrays[k]) for k in
         ("Vmin", "Wmin", "Vmax", "Wmax", "lam_min", "lam_max")}
    for side in ("min", "max"):
        for r in ("rB_ft", "rA_ft", "rAf_ft"):
            d[f"{r}_{side}"] = c(arrays[f"{r}_{side}"])
    d["kappa"] = torch.as_tensor(
        np.asarray(arrays["kappa"], np.float64)).to(dev, dtype)
    d["shift"] = float(arrays["shift"])
    d["sing_idx"] = tuple(tuple(int(i) for i in ik)
                          for ik in arrays["sing_idx"])
    d["ny"] = int(arrays["ny"])
    d["tables"] = build_tables(d)
    return d


# ---------------------------------------------------------------------------
# Modal sweeps
# ---------------------------------------------------------------------------

def _lmul(M, X):
    """M @ X over the leading axis of X ("ab,b...->a...")."""
    _trace.count("library.cublas")
    return (M @ X.reshape(X.shape[0], -1)).reshape(M.shape[0], *X.shape[1:])


def _modal_solve(V, W, dnm, rhs):
    """x = V [(W rhs) / dnm]: batched over modes with rhs and dnm (nkx, n,
    nz), or one (n, c) block of columns with dnm (n, 1)."""
    _trace.count("library.cublas", 2)
    return torch.matmul(V, torch.matmul(W, rhs) / dnm)


def build_tables(dev: dict) -> dict:
    """Per-mode denominators + the five homogeneous responses of the
    ODE2 composition (opr_odes.f90:266-380):
      em : 'min' response to bc = 1 (the discrete e^-)
      v1 : 'min' response to f_N = 1 (free-top-forcing route)
      u1 : 'max' response to rhs = v1, bc = 0
      sp : 'max' response to rhs = em, bc = 0 (the discrete s^+)
      ep : 'max' response to bc = 1 (the discrete e^+)
    plus the max-sweep boundary derivatives du1_n/dsp_n/dep_n recovered
    from the bc-end scheme row.  All are stored complex in the modal
    layout (nkx, ny, nz) that the solve reads.  The responses are real for
    real kappa; like the reference implementation the tables keep only
    their real part (the imaginary part is eigen-decomposition round-off).

    And what the singular modes' solve (sing_column) reads: the indices of
    dev["sing_idx"] as device tensors sing_i, sing_k; the kappa = 0 sweep
    denominators dmin0, dmax0 (ny, 1), the same for every mode; the wall
    slots as masks wall0, wallN (ny, 1); sps, the 'max' response to a
    column of ones with bc = 0 (DD_Sing's s^+)."""
    cd = dev["Vmin"].dtype
    kap = dev["kappa"].to(cd)                              # (nkx, nz)
    kl = kap[None]                                         # (1, nkx, nz)
    shift = dev["shift"]
    dmin = 1.0 + (kl - shift) * dev["lam_min"][:, None, None]
    dmax = 1.0 + (-kl + shift) * dev["lam_max"][:, None, None]
    Vmin, Wmin, Vmax, Wmax = (dev[k] for k in ("Vmin", "Wmin", "Vmax",
                                               "Wmax"))
    ny = dev["ny"]

    def s_col(V, W, dnm, col):
        return _lmul(V, W[:, col][:, None, None] / dnm)

    def s_of(V, W, dnm, vec, bslot):
        v = vec.clone()
        v[bslot] = 0.0                         # bc = 0 on the forcing route
        return _lmul(V, _lmul(W, v) / dnm), v

    em = s_col(Vmin, Wmin, dmin, 0)            # bc = 1 ('min' slot 0)
    v1 = s_col(Vmin, Wmin, dmin, ny - 1)       # f_N = 1
    ep = s_col(Vmax, Wmax, dmax, ny - 1)       # bc = 1 ('max' slot N)
    u1, v1f = s_of(Vmax, Wmax, dmax, v1, ny - 1)
    sp, emf = s_of(Vmax, Wmax, dmax, em, ny - 1)

    # max-sweep boundary forcing ft -> u'_N = ft - t u_N with t = -kappa
    rB, rA, rAf = dev["rB_ft_max"], dev["rA_ft_max"], dev["rAf_ft_max"]

    def ft_max(u, f):
        _trace.count("library.cublas", 3)
        return (torch.einsum("a,akz->kz", rB, u)
                - kap * torch.einsum("a,akz->kz", rA, u)
                - torch.einsum("a,akz->kz", rAf, f))

    du1_n = ft_max(u1, v1f)                    # u1_N = 0 (bc)
    dsp_n = ft_max(sp, emf)
    dep_n = ft_max(ep, torch.zeros_like(em)) + kap   # ep_N = 1 (bc)

    def real_part(t):
        return t.real.to(cd)

    out = {"dmin": dmin.movedim(0, 1).contiguous(),
           "dmax": dmax.movedim(0, 1).contiguous()}
    for name, t in (("em", em), ("v1", v1), ("u1", u1), ("sp", sp),
                    ("ep", ep)):
        out[name] = real_part(t).movedim(0, 1).contiguous()
    for name, t in (("du1_n", du1_n), ("dsp_n", dsp_n), ("dep_n", dep_n)):
        out[name] = real_part(t)

    device = Vmin.device
    idx = torch.tensor(dev["sing_idx"], dtype=torch.long).reshape(-1, 2)
    out["sing_i"] = idx[:, 0].contiguous().to(device)
    out["sing_k"] = idx[:, 1].contiguous().to(device)
    out["dmin0"] = (1.0 - shift * dev["lam_min"])[:, None]
    out["dmax0"] = (1.0 + shift * dev["lam_max"])[:, None]
    rows = torch.arange(ny, device=device)[:, None]
    out["wall0"] = rows == 0
    out["wallN"] = rows == ny - 1
    ones = torch.ones((ny, 1), dtype=cd, device=device)
    out["sps"] = _modal_solve(Vmax, Wmax, out["dmax0"],
                              torch.where(out["wallN"], 0.0, ones))
    return out


def sing_column(dev: dict, f, gbs, gts, ibc: str = "nn"):
    """Reference singular-mode (kappa = 0) column solve, for m modes at
    once: NN via DN_Sing(gb=0), DD via DD_Sing (opr_odes.f90:37-100,
    170-185,188-260).  TLAB_TPU_SING_MODE=legacy (read at each call, as
    tlab_tpu reads it at each trace: tlab_tpu/ops/elliptic_factorize.py:
    344-361) takes tlab_tpu's older upward-integration convention for NN
    instead; unset or "reference", the reference's.

    f: (ny, m) complex forcing columns; gbs/gts: (m,) wall values (gbs is
    read by 'dd' only).  Returns (u, v), (ny, m).  Each sweep solves all
    the modes' right-hand sides as the columns of one (ny, c) block, and
    tlab_tpu's per-mode solve of a column is one column of the batch; the
    kappa = 0 denominators, the wall slots and s^+ are the same for every
    mode and come from the plan's tables.  The wall slots are set by
    masks, never by a host write, so the solve does not synchronise."""
    tb = dev["tables"]
    ny, m = f.shape
    w0, wN = tb["wall0"], tb["wallN"]

    def smin0(rhs):
        return _modal_solve(dev["Vmin"], dev["Wmin"], tb["dmin0"], rhs)

    def smax0(rhs):
        return _modal_solve(dev["Vmax"], dev["Wmax"], tb["dmax0"], rhs)

    def ft(rB, rAf, x, rhs):
        """each column's bc-end forcing ft (u' there) from the scheme row"""
        return (rB[:, None] * x).sum(0) - (rAf[:, None] * rhs).sum(0)

    if ibc == "nn" and os.environ.get("TLAB_TPU_SING_MODE",
                                      "reference") == "legacy":
        # upward-integration convention: v0 from the MIN sweep (v(0) = 0),
        # shifted by the constant homogeneous mode to hit v(N) = gts, then
        # u integrated down with u(N) = 0.  It leaves the singular mode's
        # compatibility defect at the bottom slot (tlab_tpu keeps it for
        # the cloud-top-forced stratocumulus family)
        v0s = smin0(torch.where(w0 | wN, 0.0, f))
        vs = v0s + (gts - v0s[ny - 1])
        return smax0(torch.where(wN, 0.0, vs)), vs
    if ibc == "nn":
        # literal reference NN_Sing -> DN_Sing(gb=0): v' = f with v_N = gts
        # (max sweep), then u' = v with u_1 = 0 (min sweep); the constraint
        # adjusts the free bottom forcing f_1 of the max sweep.  Columns
        # [f0 | e0] give [v0s | v1s], then [u0s | u1s]
        r1 = torch.cat([torch.where(wN, gts, torch.where(w0, 0.0, f)),
                        w0.to(f.dtype).expand(ny, m)], 1)
        v = smax0(r1)
        r2 = torch.where(w0, 0.0, v)
        u = smin0(r2)
        du = ft(dev["rB_ft_min"], dev["rAf_ft_min"], u, r2)   # u'_1 = ft
        coef = (v[0, :m] - du[:m]) / (du[m:] - v[0, m:])
        return u[:, :m] + coef * u[:, m:], v[:, :m] + coef * v[:, m:]
    # DD_Sing: v' = f with v_1 = 0 (min sweep), u' = v with u_N = gts
    # (max sweep) + s^+ correction for u_1 = gbs; columns [f0 | eN]
    r1 = torch.cat([torch.where(w0 | wN, 0.0, f),
                    wN.to(f.dtype).expand(ny, m)], 1)
    v = smin0(r1)
    r2 = torch.where(wN, torch.cat([gts, torch.zeros_like(gts)]), v)
    u = smax0(r2)
    du = ft(dev["rB_ft_max"], dev["rAf_ft_max"], u, r2)       # u'_N = ft
    coef = (v[ny - 1, :m] - du[:m]) / (du[m:] - v[ny - 1, m:])
    sps = tb["sps"]
    us = u[:, :m] + coef * u[:, m:]
    q1s = (gbs - us[0]) / sps[0]
    us = torch.where(w0, gbs, us + q1s * sps)
    return us, v[:, :m] + coef * v[:, m:] + q1s


def solve_modal_factorize(dev: dict, f_hat, gb, gt, ibc: str = "nn"):
    """p and dpdy per mode for p'' - kappa^2 p = f (reference
    OPR_ODE2_Factorize_NN/DD + _Sing, opr_odes.f90).

    f_hat: (nkx, ny, nz) complex; gb/gt: (nkx, nz) complex wall values
    (Neumann p' for 'nn', Dirichlet p for 'dd').  Returns (p_hat,
    dpdy_hat); dpdy is the composition's v + kappa*p -- the stage
    derivative the reference's RK substep consumes."""
    if ibc not in ("nn", "dd"):
        raise ValueError(f"ibc must be 'nn' or 'dd', got {ibc!r}")
    cd = f_hat.dtype
    ny = dev["ny"]
    tb = dev["tables"]
    kap = dev["kappa"].to(cd)                              # (nkx, nz)
    kap3 = kap[:, None, :]                                 # (nkx, 1, nz)
    em, v1, u1, sp, ep = (tb[k] for k in ("em", "v1", "u1", "sp", "ep"))
    du1_n, dsp_n, dep_n = tb["du1_n"], tb["dsp_n"], tb["dep_n"]
    rB, rA, rAf = dev["rB_ft_max"], dev["rA_ft_max"], dev["rAf_ft_max"]

    # stage 1 (min sweep): v0 with f_N <- 0, bc v_1 = 0
    rhs1 = f_hat.clone()
    rhs1[:, ny - 1, :] = 0.0
    rhs1[:, 0, :] = 0.0
    v0 = _modal_solve(dev["Vmin"], dev["Wmin"], tb["dmin"], rhs1)

    # stage 2 (max sweep): u0 with bc u_N = 0 ('nn') or gt ('dd')
    rhs2s = v0.clone()
    rhs2s[:, ny - 1, :] = 0.0 if ibc == "nn" else gt
    u0 = _modal_solve(dev["Vmax"], dev["Wmax"], tb["dmax"], rhs2s)

    # u'_N of stage 2 from the bc-end scheme row (du_boundary)
    _trace.count("library.cublas", 3)
    du0_n = (torch.matmul(rB, u0) - kap * torch.matmul(rA, u0)
             - torch.matmul(rAf, rhs2s))
    if ibc == "dd":
        du0_n = du0_n + kap * gt

    # the kappa = 0 modes (exactly the reference's singular index set for
    # mwn-based kappa) are guarded against 0/0 here and overwritten by
    # sing_column below
    sing = kap.real <= 0.0

    def safe(x):
        return torch.where(sing, torch.ones_like(x), x)

    if ibc == "nn":
        # reference 3x3 closure over (q1 = v_1, uN, fn) -- exact LU order
        # (opr_odes.f90:330-358)
        a11 = 1.0 + kap * sp[:, 0, :]
        a21 = em[:, ny - 1, :]
        a31 = dsp_n
        a12 = kap * ep[:, 0, :]
        a22 = kap
        a32 = dep_n
        a13 = kap * u1[:, 0, :]
        a23 = v1[:, ny - 1, :]
        a33 = du1_n

        a12 = a12 / safe(a11)
        a22 = a22 - a21 * a12
        a32 = a32 - a31 * a12
        a13 = a13 / safe(a11)
        a23 = (a23 - a21 * a13) / safe(a22)
        a33 = a33 - a31 * a13 - a32 * a23

        q1 = (gb - kap * u0[:, 0, :]) / safe(a11)
        uN = (gt - v0[:, ny - 1, :] - a21 * q1) / safe(a22)
        fn = (gt - du0_n - a31 * q1 - a32 * uN) / safe(a33)
        uN = uN - a23 * fn
        q1 = q1 - a12 * uN - a13 * fn

        # uniform superposition: u0_N = u1_N = sp_N = 0 (bc rows) and
        # ep_N = 1, so row N reduces to the solved uN, matching the
        # reference's explicit i = nx handling
        u = u0 + fn[:, None, :] * u1 + q1[:, None, :] * sp \
            + uN[:, None, :] * ep
    else:
        # reference DD closure over (q1 = v_1, fn) (opr_odes.f90:452-466)
        aa = du1_n - v1[:, ny - 1, :]
        bb = dsp_n - em[:, ny - 1, :]
        det = safe(aa * sp[:, 0, :] - bb * u1[:, 0, :])
        rhs_c = kap * gt - du0_n + v0[:, ny - 1, :]
        q1 = (aa * (gb - u0[:, 0, :]) - u1[:, 0, :] * rhs_c) / det
        fn = (sp[:, 0, :] * rhs_c - bb * (gb - u0[:, 0, :])) / det

        u = u0 + fn[:, None, :] * u1 + q1[:, None, :] * sp
        u[:, 0, :] = gb
    v = v0 + fn[:, None, :] * v1 + q1[:, None, :] * em + kap3 * u

    # ---- reference singular modes (kappa = 0 at {0,Nyq} x {0,Nyq}) ----
    # m of them (0 on a pencil rank that holds none), one gather, one
    # batched solve and one scatter
    si, sk = tb["sing_i"], tb["sing_k"]
    m = si.numel()
    _trace.count("ops.poisson.sing_columns", m)
    if m:
        us, vs = sing_column(dev, f_hat[si, :, sk].T, gb[si, sk],
                             gt[si, sk], ibc)
        u[si, :, sk] = us.T
        v[si, :, sk] = vs.T
    return u, v


@_trace.span("ops.poisson")
def poisson_factorize(dev: dict, f, bcs_b=None, bcs_t=None,
                      ibc: str = "nn"):
    """Physical-space Poisson via the factorized modal solver; bcs_b/bcs_t
    (nx, nz) are the wall values of dp/dy for ibc 'nn' (Neumann walls, the
    dycore's call) and of p for 'dd' (Dirichlet walls, the initial
    conditions' call).

    Returns (p, dpdy); dpdy is the stage-consistent first derivative --
    the reference's OPR_Poisson dpdy output (opr_elliptic.f90:336)."""
    nx, ny, nz = f.shape
    zero = torch.zeros((nx, nz), dtype=f.dtype, device=f.device)
    gb_phys = zero if bcs_b is None else bcs_b
    gt_phys = zero if bcs_t is None else bcs_t

    def fwd(a):
        _trace.count("library.cufft", 2 if nz > 1 else 1)
        ah = torch.fft.rfft(a, dim=0)
        return torch.fft.fft(ah, dim=-1) if nz > 1 else ah

    def bwd(ah):
        _trace.count("library.cufft", 2 if nz > 1 else 1)
        if nz > 1:
            ah = torch.fft.ifft(ah, dim=-1)
        return torch.fft.irfft(ah, n=nx, dim=0)

    f_hat = fwd(f)
    gb = fwd(gb_phys[:, None, :])[:, 0, :]
    gt = fwd(gt_phys[:, None, :])[:, 0, :]
    p_hat, dpdy_hat = solve_modal_factorize(dev, f_hat, gb, gt, ibc)
    return bwd(p_hat), bwd(dpdy_hat)
