"""Compressible dynamical core (port of tlab_tpu/dycore/compressible.py;
reference rhs_flow_euler_*, rhs_flow_viscous_*, rhs_flow_global_2, time.f90
TIME_SUBSTEP_COMPRESSIBLE).

Conservative formulation U = (rho, rho u, rho v, rho w, rho E) advanced with
the same low-storage RK schemes; every spatial term is a compact-FD product:
the Euler fluxes in divergence or skew-symmetric form through the first
derivative (the substructured solve of ops/thomas.py on a long line, else
the dense D1), the viscous and conduction terms through the dense [D1;D2]
operator, as tlab_tpu's einsums.  No Poisson solve: the acoustics are
integrated (acoustic CFL), and y may be periodic.  In float32 on a card,
the internal-energy set's pointwise algebra at constant viscosity runs in
the fused kernels of ops/comp_rhs.py around the same products (_fused).

Nondimensionalization: velocities by U0, temperature by T0, density by rho0;
ideal gas
    p = rho T / (gamma M^2),    e = T / (gamma (gamma-1) M^2)
with gamma = cp/cv and M the Mach number.  Viscous stress with constant
viscosity mu = 1/Re (or a transport law mu(T), physics/eos.py), Stokes
hypothesis; heat conduction with Prandtl.  `energy` selects what the fifth
field holds: rho(e + |u|^2/2) ('total', reference DNS_EQNS_TOTAL) or rho e
('internal', DNS_EQNS_INTERNAL).

Boundary conditions: periodic x/z; y walls free-slip adiabatic (v=0,
d(tangential)/dy=0, dT/dy=0) imposed on the tendencies, a periodic y, or
characteristic (NSCBC) open boundaries (dycore/nscbc.py) via the nscbc
argument.  A [BufferZone] relaxes the conservative fields toward their
plane-mean initial profiles (the buffer argument).

Mixtures: a combustion table (physics/mixtures.py; `mix`) gives T, p and
cp from the caloric table by a fixed-count Newton; the moist AirWater set
(primitive_airwater .. acoustic_cfl_max_airwater) carries rho e in the
reference's thermal units with rhos[0] = rho qt, its saturation adjustment
in float64 (physics/thermo.py).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tlab_tpu_torch.dycore import incompressible as dyn
from tlab_tpu_torch.dycore.state import State
from tlab_tpu_torch.ops import burgers, comp_rhs
from tlab_tpu_torch.physics import eos
from tlab_tpu_torch.physics import mixtures as mx
from tlab_tpu_torch.physics import thermo as th
from tlab_tpu_torch.utils import trace as _trace


class CompState(NamedTuple):
    rho: torch.Tensor
    rhou: torch.Tensor
    rhov: torch.Tensor
    rhow: torch.Tensor
    rhoE: torch.Tensor       # total energy rho (e + |u|^2/2), or rho e
    rhos: Optional[torch.Tensor] = None   # scalars (ns, nx, ny, nz) as rho*s


def primitive(P, U: CompState, gamma: float, mach: float, mix=None):
    rho = U.rho
    u = U.rhou / rho
    v = U.rhov / rho
    w = U.rhow / rho
    ke = 0.5 * (u * u + v * v + w * w)
    e = U.rhoE / rho - ke
    if mix is not None and U.rhos is not None:
        T, p, _ = mixture_thermal(U, e, mach, mix)
        return u, v, w, T, p
    T = e * gamma * (gamma - 1.0) * mach ** 2
    p = rho * T / (gamma * mach ** 2)
    return u, v, w, T, p


def mass_fractions(U: CompState):
    """(nsp, ...) species mass fractions from the transported rho*Y_i
    scalars, appending the balance species Y_n = 1 - sum (the reference
    carries nsp-1 scalars and derives the last, thermodynamics.f90
    inb_scal vs NSP)."""
    Y = U.rhos / U.rho[None]
    return torch.cat([Y, (1.0 - torch.sum(Y, dim=0))[None]], dim=0)


@_trace.span("dycore.mixture")
def mixture_thermal(U: CompState, e, mach: float, mix, n_newton: int = 8):
    """(T, p, cp) from nondimensional internal energy via the mixture
    caloric table (reference THERMO_CALORIC_TEMPERATURE Newton +
    THERMO_THERMAL_PRESSURE, thermo_caloric.f90/thermo_thermal.f90).

    Units follow the reference convention: e_code scaled by U0^2 with
    U0^2 = M^2 gama0 Rref T0, so e_nd (by cpref*T0) = e_code*(gama0-1)*M^2
    and e_nd = h_nd(T,Y) - (1-1/gama0) R_nd(Y) T.  A fixed-count Newton
    (the reference iterates to a tolerance): no host sync."""
    Y = mass_fractions(U)
    if Y.shape[0] != mix.nsp:
        raise ValueError(f"mixture {mix.name!r} expects {mix.nsp - 1} "
                         f"transported scalars, got {Y.shape[0] - 1}")
    g0 = mix.gama0
    e_nd = e * (g0 - 1.0) * mach ** 2
    R = mx.gas_constant(mix, Y)
    rfac = (g0 - 1.0) / g0          # rref/cpref
    # initial guess from the leading (constant-cp) caloric term so flame
    # temperatures T/TREF ~ 5-8 start near the root; the fixed-count
    # Newton then converges quadratically
    cp0 = torch.sum(mx._coef(mix.ai[0], e_nd) * Y, dim=0)
    h0 = torch.sum(mx._coef(mix.ai[5], e_nd) * Y, dim=0)
    T = torch.clamp((e_nd - h0) / torch.clamp(cp0 - rfac * R, min=1e-12),
                    min=0.05)
    for _ in range(n_newton):
        res = mx.h_mixture(mix, T, Y) - rfac * R * T - e_nd
        cv = mx.cp_mixture(mix, T, Y) - rfac * R
        T = T - res / cv
    cp = mx.cp_mixture(mix, T, Y)
    p = U.rho * R * T / (g0 * mach ** 2)
    return T, p, cp


def primitive_view(U: CompState) -> State:
    """Primitive velocities/scalars of a conservative state as a dycore
    State -- the shared shape for the statistics."""
    rho = U.rho
    ns = U.rhos.shape[0] if U.rhos is not None else 0
    s = (U.rhos / rho[None]) if ns else rho.new_zeros((0,) + rho.shape)
    return State(u=U.rhou / rho, v=U.rhov / rho, w=U.rhow / rho, s=s)


def _tensor_cores(P, axis_name: str, a) -> bool:
    """Whether the dense products along a direction run in the 3xTF32
    kernels (ops/burgers.py deriv1, deriv12): a float32 CUDA tensor and no
    banded plan for the direction.  Elsewhere (float64, the CPU, a long
    line) the incompressible set's dense or banded products run.  There is
    no switch: where it holds, the kernel runs or the step raises."""
    return (a.is_cuda and a.dtype == torch.float32
            and P.get(f"d1{axis_name}_banded") is None)


def _d1(P, axis_name: str, axis: int, a):
    """First derivative along one direction, as dyn._d1 (`axis` valid for
    `a` itself); a dense float32 CUDA line through the kernel deriv1, which
    reads the D1 rows of the plan's [D1;D2]."""
    d12 = P.get(f"d12{axis_name}")
    if d12 is None or not _tensor_cores(P, axis_name, a):
        return dyn._d1(P, axis_name, axis, a)
    with _trace.span("dycore.d1"):
        return dyn._gathered_apply(P, axis_name, a,
                                   lambda g: burgers.deriv1(d12, g, axis))


def _div(P, fx, fy, fz):
    return _d1(P, "x", 0, fx) + _d1(P, "y", 1, fy) + _d1(P, "z", 2, fz)


def _grad(P, a):
    return _d1(P, "x", 0, a), _d1(P, "y", 1, a), _d1(P, "z", 2, a)


@_trace.span("dycore.d12")
def _d12_lines(P, axis_name: str, axis: int, stack):
    """(d1, d2) of a stack along axis+1 on whole lines: the kernel
    deriv12 (two tensors) on a dense float32 CUDA line, else
    dyn._d12_apply."""
    if _tensor_cores(P, axis_name, stack):
        return burgers.deriv12(P[f"d12{axis_name}"], stack, axis + 1)
    return dyn._d12_apply(P, axis_name, axis, stack)


def _d12_stack(P, axis_name: str, axis: int, stack):
    """(d1, d2) of (F, nx, ny, nz) stacked fields along one direction via
    the dense [D1;D2] product (the same compact-D2-with-Jacobian operator
    Burgers uses) -- replaces D1(D1(.)) for viscous/conduction terms,
    which loses the odd-even (grid-scale) modes (reference uses OPR_P2,
    fdm_derivative.f90:413).  A periodic long line takes its substructured
    plans, as the incompressible set's (dyn._d12_apply).  On a mesh a
    split direction gathers the stack once, applies the operator to the
    full lines and scatters both halves back in one transpose, joined for
    it."""
    if P.get(f"d12{axis_name}") is None:
        z = torch.zeros_like(stack)
        return z, z
    if dyn._axis_comm(P, axis_name) is None:
        return _d12_lines(P, axis_name, axis, stack)
    F = stack.shape[0]
    both = dyn._gathered_apply(
        P, axis_name, stack,
        lambda g: torch.cat(_d12_lines(P, axis_name, axis, g)))
    return both[:F], both[F:]


def _apply_visc_bc(P, dx2, dy2, dz2):
    """[BoundaryConditions] ViscousI/J/K row zeroing.  In the current
    reference this flag is a legacy NO-OP (dns_read_local.f90 writes column
    2 of bcs_inf/bcs_out but opr_partial.f90:91 only reads column 1, and
    FDM_Der2_Solve takes no bc flag), so the runtime never populates
    P['visc_bc'] and this returns unchanged; kept, as tlab_tpu keeps it, for
    the older reference's semantics behind an explicit plan entry."""
    vb = P.get("visc_bc")
    if not vb:
        return dx2, dy2, dz2
    out = []
    for axn, d2, axis, normal in (("x", dx2, 1, 0), ("y", dy2, 2, 1),
                                  ("z", dz2, 3, 2)):
        kind = vb.get(axn)
        if kind is None:
            out.append(d2)
            continue
        tang = [i for i in range(d2.shape[0]) if i != normal]
        d2 = d2.clone()
        # on a mesh a block's first/last row is the domain's only on the
        # first/last rank along a split direction
        comm = dyn._axis_comm(P, axn)
        lo = hi = True
        if comm is not None:
            i = comm["mesh"].ix if axn == "x" else comm["mesh"].iz
            lo, hi = i == 0, i == comm[f"p{axn}"] - 1
        if kind == "outflow":
            if lo:
                d2.narrow(axis, 0, 1)[tang] = 0.0
            if hi:
                d2.narrow(axis, d2.shape[axis] - 1, 1)[tang] = 0.0
        else:   # inflow
            if hi:
                d2.narrow(axis, d2.shape[axis] - 1, 1)[tang] = 0.0
            if lo:
                d2.narrow(axis, 0, 1)[normal] = 0.0
        out.append(d2)
    return tuple(out)


def _visc_terms(P, u, v, w, T, mu, cond, variable_mu: bool):
    """(divtau_x, divtau_y, divtau_z, conduction, grads, Phi, stresses).

    Constant mu: div(tau)_i = mu [lap(u_i) + 1/3 d_i(div u)] and
    conduction = cond lap(T), all second derivatives from the compact D2
    (reference RHS_FLOW_VISCOUS_EXPLICIT / RHS_FLOW_CONDUCTION).
    Variable mu(T): stress divergence in conservative form (first
    derivatives of the stress, reference RHS_FLOW_VISCOUS_DIVERGENCE).
    Returns the velocity gradient tensor and dissipation Phi for the
    energy equations."""
    stack = torch.stack([u, v, w, T])
    dx1, dx2 = _d12_stack(P, "x", 0, stack)
    dy1, dy2 = _d12_stack(P, "y", 1, stack)
    dz1, dz2 = _d12_stack(P, "z", 2, stack)
    dx2, dy2, dz2 = _apply_visc_bc(P, dx2, dy2, dz2)
    ux, vx, wx, Tx = dx1
    uy, vy, wy, Ty = dy1
    uz, vz, wz, Tz = dz1
    divu = ux + vy + wz
    lam = -2.0 / 3.0
    txx = mu * (2.0 * ux + lam * divu)
    tyy = mu * (2.0 * vy + lam * divu)
    tzz = mu * (2.0 * wz + lam * divu)
    txy = mu * (uy + vx)
    txz = mu * (uz + wx)
    tyz = mu * (vz + wy)
    phi = (txx * ux + tyy * vy + tzz * wz
           + txy * (uy + vx) + txz * (uz + wx) + tyz * (vz + wy))
    grads = (ux, uy, uz, vx, vy, vz, wx, wy, wz, Tx, Ty, Tz, divu)
    if variable_mu:
        dtx = _div(P, txx, txy, txz)
        dty = _div(P, txy, tyy, tyz)
        dtz = _div(P, txz, tyz, tzz)
        qx = cond * Tx
        qy = cond * Ty
        qz = cond * Tz
        conduction = _div(P, qx, qy, qz)
    else:
        lap_u = dx2[0] + dy2[0] + dz2[0]
        lap_v = dx2[1] + dy2[1] + dz2[1]
        lap_w = dx2[2] + dy2[2] + dz2[2]
        lap_T = dx2[3] + dy2[3] + dz2[3]
        gdx, gdy, gdz = _grad(P, divu)
        third = 1.0 / 3.0
        dtx = mu * (lap_u + third * gdx)
        dty = mu * (lap_v + third * gdy)
        dtz = mu * (lap_w + third * gdz)
        conduction = cond * lap_T
    stresses = (txx, tyy, tzz, txy, txz, tyz)
    return dtx, dty, dtz, conduction, grads, phi, stresses


def _mu(gas, visc: float, T):
    """(mu, variable): the viscosity, a field under a transport law."""
    variable_mu = gas is not None and gas.transport != "none"
    return (visc * eos.viscosity(gas, T) if variable_mu else visc), \
        variable_mu


def rhs_compressible(P, U: CompState, gamma: float, mach: float,
                     visc: float, prandtl: float, gas=None,
                     form: str = "divergence", mix=None):
    """Tendency of the conservative state (total energy).

    form: 'divergence' (reference RHS_FLOW_EULER_DIVERGENCE) or
    'skewsymmetric' (RHS_FLOW_EULER_SKEWSYMMETRIC: the advective terms are
    the average of divergence and convective forms, which conserves
    discrete kinetic energy in the inviscid limit).
    gas: optional physics.eos.GasParams enabling a variable transport law
    mu(T) (reference THERMO_VISCOSITY powerlaw/sutherland); the stress and
    conduction coefficients then vary pointwise with temperature.
    """
    rho = U.rho
    u, v, w, T, p = primitive(P, U, gamma, mach, mix=mix)

    h_rho = -_div(P, U.rhou, U.rhov, U.rhow)
    if form == "skewsymmetric":
        # 0.5 [ div(rho u phi) + rho u . grad phi + phi div(rho u) ]
        px_, py_, pz_ = _grad(P, p)

        def skew(phi, rphi):
            dv = _div(P, rphi * u, rphi * v, rphi * w)
            gx, gy, gz = _grad(P, phi)
            conv = U.rhou * gx + U.rhov * gy + U.rhow * gz
            return -0.5 * (dv + conv - phi * h_rho)
        h_ru = skew(u, rho * u) - px_
        h_rv = skew(v, rho * v) - py_
        h_rw = skew(w, rho * w) - pz_
        E_sp = U.rhoE / rho
        h_rE = skew(E_sp, U.rhoE) - _div(P, p * u, p * v, p * w)
    else:
        # Euler fluxes, divergence form
        h_ru = -_div(P, U.rhou * u + p, U.rhou * v, U.rhou * w)
        h_rv = -_div(P, U.rhov * u, U.rhov * v + p, U.rhov * w)
        h_rw = -_div(P, U.rhow * u, U.rhow * v, U.rhow * w + p)
        h_rE = -_div(P, (U.rhoE + p) * u, (U.rhoE + p) * v,
                     (U.rhoE + p) * w)

    # viscous stress + conduction via compact D2 for constant mu
    # (reference RHS_FLOW_VISCOUS_EXPLICIT + RHS_FLOW_CONDUCTION);
    # variable mu(T) falls back to the stress-divergence form
    mu, variable_mu = _mu(gas, visc, T)
    cond = _conduction_coef(U, T, mu, prandtl, gamma, mach, mix)
    dtx, dty, dtz, conduction, grads, phi, _ = _visc_terms(
        P, u, v, w, T, mu, cond, variable_mu or mix is not None)

    h_ru = h_ru + dtx
    h_rv = h_rv + dty
    h_rw = h_rw + dtz

    # viscous work div(u . tau) = u . div(tau) + Phi (avoids another
    # round of first derivatives of products), + conduction
    h_rE = h_rE + u * dtx + v * dty + w * dtz + phi + conduction

    h_rs = _rhs_scalars(P, U, u, v, w, visc) if U.rhos is not None else None
    return CompState(h_rho, h_ru, h_rv, h_rw, h_rE, h_rs)


def _conduction_coef(U: CompState, T, mu, prandtl: float, gamma: float,
                     mach: float, mix):
    """Heat-conduction coefficient k/(Re Pr): mu cp_nd/(Pr (g0-1) M^2);
    cp_nd = 1 for the single-species gas, a field for mixtures (the
    reference's k = cp mu/Pr weighting)."""
    if mix is None or U.rhos is None:
        return mu / (prandtl * (gamma - 1.0) * mach ** 2)
    cp = mx.cp_mixture(mix, T, mass_fractions(U))
    return mu * cp / (prandtl * (mix.gama0 - 1.0) * mach ** 2)


def primitive_internal(P, U: CompState, gamma: float, mach: float,
                       mix=None):
    """Primitive recovery when rhoE carries INTERNAL energy rho e
    (reference DNS_EQNS_INTERNAL formulation)."""
    rho = U.rho
    u = U.rhou / rho
    v = U.rhov / rho
    w = U.rhow / rho
    e = U.rhoE / rho
    if mix is not None and U.rhos is not None:
        T, p, _ = mixture_thermal(U, e, mach, mix)
        return u, v, w, T, p
    T = e * gamma * (gamma - 1.0) * mach ** 2
    p = rho * T / (gamma * mach ** 2)
    return u, v, w, T, p


def rhs_compressible_internal(P, U: CompState, gamma: float, mach: float,
                              visc: float, prandtl: float, gas=None,
                              mix=None):
    """Internal-energy formulation (reference rhs_flow_global_2.f90 /
    DNS_EQNS_INTERNAL): d(rho e)/dt = -div(rho e u) - p div u + Phi +
    div(k grad T), with Phi = tau : grad u the viscous dissipation.  Where
    _fused holds, the pointwise algebra runs in the fused kernels
    (_rhs_internal_fused)."""
    if _fused(P, U, gas, mix):
        return _rhs_internal_fused(P, U, gamma, mach, visc, prandtl)
    u, v, w, T, p = primitive_internal(P, U, gamma, mach, mix=mix)

    h_rho = -_div(P, U.rhou, U.rhov, U.rhow)
    h_ru = -_div(P, U.rhou * u + p, U.rhou * v, U.rhou * w)
    h_rv = -_div(P, U.rhov * u, U.rhov * v + p, U.rhov * w)
    h_rw = -_div(P, U.rhow * u, U.rhow * v, U.rhow * w + p)

    mu, variable_mu = _mu(gas, visc, T)
    cond = _conduction_coef(U, T, mu, prandtl, gamma, mach, mix)
    dtx, dty, dtz, conduction, grads, phi, _ = _visc_terms(
        P, u, v, w, T, mu, cond, variable_mu or mix is not None)
    divu = grads[-1]
    h_ru = h_ru + dtx
    h_rv = h_rv + dty
    h_rw = h_rw + dtz

    h_re = (-_div(P, U.rhoE * u, U.rhoE * v, U.rhoE * w)
            - p * divu + phi + conduction)
    h_rs = _rhs_scalars(P, U, u, v, w, visc) if U.rhos is not None else None
    return CompState(h_rho, h_ru, h_rv, h_rw, h_re, h_rs)


def _fused(P, U: CompState, gas, mix) -> bool:
    """Whether rhs_compressible_internal runs its pointwise algebra in the
    fused kernels of ops/comp_rhs.py: a float32 CUDA state, a constant
    viscosity (no transport law), no mixture and no ViscousI/J/K rows
    (P["visc_bc"], _apply_visc_bc).  Elsewhere (float64, the CPU, mu(T),
    mixtures) the PyTorch algebra runs.  There is no switch: where it
    holds, the kernels run or the step raises (more scalars than
    comp_rhs.MAX_SCALARS)."""
    return (U.rho.is_cuda and U.rho.dtype == torch.float32
            and (gas is None or gas.transport == "none") and mix is None
            and not P.get("visc_bc"))


def _rhs_internal_fused(P, U: CompState, gamma: float, mach: float,
                        visc: float, prandtl: float) -> CompState:
    """rhs_compressible_internal at constant viscosity without a mixture,
    its pointwise algebra in the kernels of ops/comp_rhs.py around the same
    d1 and [D1;D2] products: for each direction with points in turn, its
    fluxes (with the first, the stack [u, v, w, T] and s), its products,
    and its terms added into the tendencies; then d(div u) and its term.
    One direction's derivatives are alive at a time, beside the velocity
    gradients of the directions before it."""
    U = CompState(*(None if a is None else a.contiguous() for a in U))
    ns = 0 if U.rhos is None else U.rhos.shape[0]
    cT = gamma * (gamma - 1.0) * mach ** 2
    cP = 1.0 / (gamma * mach ** 2)
    cond = _conduction_coef(U, None, visc, prandtl, gamma, mach, None)
    diff = tuple(P["diff"]) if ns else ()
    axes = [(i, ax) for i, ax in enumerate("xyz")
            if P.get(f"d12{ax}") is not None]
    mass = (U.rhou, U.rhov, U.rhow)
    h = prim = s = divu = None
    grads = {}
    for k, (axis, ax) in enumerate(axes):
        first, last = k == 0, k == len(axes) - 1
        fl, st, ss = comp_rhs.flux(axis, U, cT, cP, prim is None)
        if prim is None:
            prim, s = st, ss
        dfl = tuple(_d1(P, ax, axis, fl[c]) for c in range(4))
        if ns:
            dfl += (_d1(P, ax, axis + 1, fl[4:]),)
        del fl, st, ss
        d1, d2 = _d12_stack(P, ax, axis, prim)
        s1, s2 = _d12_stack(P, ax, axis, s) if ns else (None, None)
        der = comp_rhs.Derivs(_d1(P, ax, axis, mass[axis]), dfl, d1, d2,
                              s1, s2, _d1(P, ax, axis, U.rho) if ns else None)
        del dfl, d1, d2, s1, s2
        if last:
            prim = s = None
        h, g, divu = comp_rhs.assemble(axis, der, U, h, grads, first, last,
                                       visc, cond, cT, cP, diff)
        del der
        grads[axis] = g
    grads.clear()
    dd = [None] * 3
    for axis, ax in axes:
        dd[axis] = _d1(P, ax, axis, divu)
    del divu
    comp_rhs.final(h, dd, visc)
    return CompState(h[0], h[1], h[2], h[3], h[4], h[5:] if ns else None)


def _rhs_scalars(P, U: CompState, u, v, w, visc: float):
    """Compressible scalar transport d(rho s)/dt = -div(rho s u) +
    div(rho D grad s) (reference rhs_scal_* divergence form). The
    diffusion expands to D [rho lap(s) + grad rho . grad s] so the
    Laplacian uses the compact D2 (no odd-even loss)."""
    rhos = U.rhos
    rho = U.rho
    s = rhos / rho[None]
    h = -(_d1(P, "x", 1, rhos * u[None])
          + _d1(P, "y", 2, rhos * v[None])
          + _d1(P, "z", 3, rhos * w[None]))
    diff = torch.tensor(P["diff"], dtype=rhos.dtype,
                        device=rhos.device)[:, None, None, None]
    sx1, sx2 = _d12_stack(P, "x", 0, s)
    sy1, sy2 = _d12_stack(P, "y", 1, s)
    sz1, sz2 = _d12_stack(P, "z", 2, s)
    rx, ry, rz = _grad(P, rho)
    lap_s = sx2 + sy2 + sz2
    h = h + diff * (rho[None] * lap_s
                    + rx[None] * sx1 + ry[None] * sy1 + rz[None] * sz1)
    return h


def diffusion_number_max(P, U: CompState, schmidt_factor: float):
    """Compressible diffusion-number density: schmidtfactor *
    max((1/dx^2 + 1/dy^2 + 1/dz^2)/rho) (TIME_COURANT, time.f90:493).
    schmidt_factor = visc * max(1, 1/Pr, 1/min(Sc))."""
    acc = 0.0
    if "iodx" in P:
        acc = acc + P["iodx"][:, None, None] ** 2
    if "iody" in P:
        acc = acc + P["iody"][None, :, None] ** 2
    if "iodz" in P:
        acc = acc + P["iodz"][None, None, :] ** 2
    return schmidt_factor * torch.max(acc / U.rho)


def _clip_scalars(P, U: CompState) -> CompState:
    """Per-substep scalar bounds on the transported mass fractions
    (DNS_BOUNDS_LIMIT, dns_local.f90:67-90, [Control] ScalLimit)."""
    bounds = P.get("scal_bounds")
    if bounds is None or U.rhos is None:
        return U
    lo, hi = bounds                     # (ns, 1, 1, 1) each
    s = torch.clamp(U.rhos / U.rho[None], min=lo, max=hi)
    return U._replace(rhos=s * U.rho[None])


def _apply_wall_rows(h, rows):
    """The j=0 / j=ny-1 rows of a tendency per its BC type: Dirichlet rows
    0, Neumann rows the value with zero wall-normal derivative (the nt row
    sees the updated j=0 row).  Returns a new tensor."""
    h = h.clone()
    nb = nt = None
    if rows is not None:
        nb, nt = rows["nb"], rows["nt"]
    h[:, 0, :] = torch.matmul(nb, h) if nb is not None else 0.0
    h[:, -1, :] = torch.matmul(nt, h) if nt is not None else 0.0
    return h


def _apply_wall_bcs(P, h: CompState, sides=(True, True)) -> CompState:
    """Free-slip adiabatic walls at jmin/jmax: zero normal-momentum tendency;
    tangential/energy/density tendencies take their Neumann wall values.
    sides masks (jmin, jmax) so open (NSCBC) sides are left alone."""
    if P["sizes"][1] == 1 or P.get("y_periodic", False) or not any(sides):
        return h
    if sides != (True, True):
        # apply to the full state, then restore the untouched side's rows
        full = _apply_wall_bcs(P, h, (True, True))
        out = []
        for a, b in zip(h, full):
            if a is None:
                out.append(None)
                continue
            c = b.clone()
            if not sides[0]:
                c[..., 0, :] = a[..., 0, :]
            if not sides[1]:
                c[..., -1, :] = a[..., -1, :]
            out.append(c)
        return CompState(*out)
    rows = P["bc_rows"]
    hv = h.rhov.clone()
    hv[:, 0, :] = 0.0
    hv[:, -1, :] = 0.0
    hu = _apply_wall_rows(h.rhou, rows["u"])
    hw = _apply_wall_rows(h.rhow, rows["w"])
    nn = rows["u"]     # reuse the NN rows for scalars-like fields
    hrho = _apply_wall_rows(h.rho, nn)
    hE = _apply_wall_rows(h.rhoE, nn)
    hs = h.rhos
    if hs is not None:
        srows = rows.get("s", ())
        hs = torch.stack([
            _apply_wall_rows(hs[i], srows[i] if i < len(srows) else nn)
            for i in range(hs.shape[0])])
    return CompState(hrho, hu, hv, hw, hE, hs)


def _add_gravity(h: CompState, U: CompState, gvec, energy: str):
    """Momentum + g_i rho; total energy adds the work rho g . u
    (reference rhs_flow_euler_*: hq_i += g_i rho, hq4 +=
    CRATIO_INV rho g.u -- the CRATIO_INV cancels in these code-units e)."""
    if not any(gvec):
        return h
    rho = U.rho
    h_ru = h.rhou + gvec[0] * rho
    h_rv = h.rhov + gvec[1] * rho
    h_rw = h.rhow + gvec[2] * rho
    h_rE = h.rhoE
    if energy == "total":
        h_rE = h_rE + (gvec[0] * U.rhou + gvec[1] * U.rhov
                       + gvec[2] * U.rhow)
    return CompState(h.rho, h_ru, h_rv, h_rw, h_rE, h.rhos)


@_trace.span("dycore.buffer")
def _apply_buffer(h: CompState, U: CompState, buf):
    """Compressible buffer relaxation (BOUNDARY_BUFFER RELAX_BLOCK_CF /
    RELAX_BLOCK_RHO): conservative fields relax toward the plane-mean
    initial profiles; h_q -= tau(y) (q - ref(y))."""
    tau = buf["tau"]            # (1, ny, 1)
    refs = buf["refs"]          # name -> (1, ny, 1) conservative refs

    def rx(hc, qc, name):
        return hc - tau * (qc - refs[name])
    hs = h.rhos
    if hs is not None and "rs0" in refs:
        hs = torch.stack([rx(hs[i], U.rhos[i], f"rs{i}")
                          for i in range(hs.shape[0])])
    return CompState(rx(h.rho, U.rho, "rho"),
                     rx(h.rhou, U.rhou, "rhou"),
                     rx(h.rhov, U.rhov, "rhov"),
                     rx(h.rhow, U.rhow, "rhow"),
                     rx(h.rhoE, U.rhoE, "rhoE"), hs)


def rk_step_compressible(P, U: CompState, dtime, gamma: float, mach: float,
                         visc: float, prandtl: float, nscbc=None,
                         ly: float = 1.0, gas=None, lx: float = 1.0,
                         form: str = "divergence", energy: str = "total",
                         mix=None, gvec=(0.0, 0.0, 0.0), buffer=None):
    """One low-storage RK step of the conservative state (the scheme of
    P["rk"]); returns the new state.  nscbc: an nscbc.NSCBCSpec (open
    sides take the characteristic corrections, 'wall' sides the wall
    rows); mix: a combustion MixtureTable; buffer: the relaxation of
    Simulation.attach_buffer_compressible, applied after the boundary
    conditions as the reference (time.f90:808)."""
    from tlab_tpu_torch.dycore.nscbc import apply_nscbc
    dyn.check_main_path(P)
    kdt = P["rk"]["kdt"]
    kco = P["rk"]["kco"]
    h = CompState(*(torch.zeros_like(x) if x is not None else None
                    for x in U))
    for i, k in enumerate(kdt):
        dte = dtime * k
        if energy == "internal":
            dh = rhs_compressible_internal(P, U, gamma, mach, visc,
                                           prandtl, gas=gas, mix=mix)
        else:
            dh = rhs_compressible(P, U, gamma, mach, visc, prandtl,
                                  gas=gas, form=form, mix=mix)
        dh = _add_gravity(dh, U, gvec, energy)
        h = CompState(*(a + b if a is not None else None
                        for a, b in zip(h, dh)))
        if nscbc is not None:
            # y 'wall' sides keep the wall treatment; open sides get the
            # additive characteristic corrections (the reference composes
            # BOUNDARY_BCS_Y on top of the full-domain RHS)
            h = _apply_wall_bcs(P, h, sides=(nscbc.ymin == "wall",
                                             nscbc.ymax == "wall"))
            h = apply_nscbc(P, U, h, gamma, mach, nscbc, ly, lx=lx,
                            energy=energy, mix=mix)
        else:
            h = _apply_wall_bcs(P, h)
        if buffer is not None:
            h = _apply_buffer(h, U, buffer)
        U = CompState(*(q + dte * hq if q is not None else None
                        for q, hq in zip(U, h)))
        U = _clip_scalars(P, U)
        if i < len(kdt) - 1:
            a = kco[i]
            h = CompState(*(a * x if x is not None else None for x in h))
    return U


def _cfl_sum(P, u, v, w, c):
    """max((|u|+c)/dx + (|v|+c)/dy + (|w|+c)/dz) over the box."""
    acc = 0.0
    if "iodx" in P:
        acc = acc + (torch.abs(u) + c) * P["iodx"][:, None, None]
    if "iody" in P:
        acc = acc + (torch.abs(v) + c) * P["iody"][None, :, None]
    if "iodz" in P:
        acc = acc + (torch.abs(w) + c) * P["iodz"][None, None, :]
    return torch.max(acc)


def acoustic_cfl_max(P, U: CompState, gamma: float, mach: float, mix=None,
                     energy: str = "total"):
    """max((|u|+c)/dx + ...) with c the sound speed (reference TIME_COURANT
    compressible branch).  `energy` must match the formulation the rhoE
    slot is stored in, else c is ke-contaminated (the reference derives
    p once per step from the matching conservative set, time.f90:429)."""
    if energy == "internal":
        u, v, w, T, p = primitive_internal(P, U, gamma, mach, mix=mix)
    else:
        u, v, w, T, p = primitive(P, U, gamma, mach, mix=mix)
    if mix is not None and U.rhos is not None:
        # c = sqrt(gama0 p/rho): the reference courant uses the CONSTANT
        # gama0 with the mixture pressure (time.f90:429)
        c = torch.sqrt(torch.clamp(mix.gama0 * p, min=1e-12) / U.rho)
    else:
        c = torch.sqrt(torch.clamp(T, min=1e-12)) / mach
    return _cfl_sum(P, u, v, w, c)


def from_primitive(rho, u, v, w, T, gamma: float, mach: float,
                   s=None, mix=None, energy: str = "total") -> CompState:
    """Conservative state from primitives.  `energy` selects the
    formulation the 5th field is stored in: 'total' rho(e + ke) for
    DNS_EQNS_TOTAL, 'internal' rho e for DNS_EQNS_INTERNAL (the
    reference's conservative arrays differ the same way, dns_main)."""
    if mix is not None and s is not None:
        Y = torch.cat([s, (1.0 - torch.sum(s, dim=0))[None]], dim=0)
        g0 = mix.gama0
        e_nd = (mx.h_mixture(mix, T, Y)
                - (g0 - 1.0) / g0 * mx.gas_constant(mix, Y) * T)
        e = e_nd / ((g0 - 1.0) * mach ** 2)
    else:
        e = T / (gamma * (gamma - 1.0) * mach ** 2)
    ke = 0.5 * (u * u + v * v + w * w) if energy == "total" else 0.0
    return CompState(rho=rho, rhou=rho * u, rhov=rho * v, rhow=rho * w,
                     rhoE=rho * (e + ke),
                     rhos=rho[None] * s if s is not None else None)


# ---------------------------------------------------------------------------
# AirWater (moist two-phase) compressible path -- reference MIXT_TYPE_AIRWATER
# with Equations=internal (RHS_FLOW_GLOBAL_2 + RHS_SCAL_GLOBAL_2).
# The prognostic energy is stored in the reference's THERMAL units
# (cp0 T0; thermodynamics.f90:543-549): mechanical terms in the energy
# equation carry the CRATIO_INV = (gama0-1) M^2 conversion and the
# pressure/gas constants ride the RRATIO scaling inside ThermoParams.
# ---------------------------------------------------------------------------

def primitive_airwater(U: CompState, tp, nr: int = 3):
    """(u, v, w, T, p, ql, newton_err) from the conservative state with
    rhoE = rho e in thermal units (internal-energy formulation) and
    rhos[0] = rho qt.  Saturation adjustment via THERMO_AIRWATER_RE in
    float64 (the per-substep FI_DIAGNOSTIC -> THERMO_CALORIC_TEMPERATURE
    path); newton_err, a 0-d tensor on the state's device, is the
    reference's NEWTONRAPHSON_ERROR log column."""
    rho = U.rho
    u = U.rhou / rho
    v = U.rhov / rho
    w = U.rhow / rho
    e = U.rhoE / rho
    qt = U.rhos[0] / rho
    T, ql, err = th.airwater_re(tp, qt, e, rho, nr=nr)
    p = th.thermal_pressure(tp, qt, ql, rho, T)
    return u, v, w, T, p, ql, torch.max(err)


def gamma_airwater(tp, qt, ql, T):
    """Local cp/cv field (THERMO_GAMMA airwater branch,
    thermo_caloric.f90:223)."""
    cpm = tp.Cd + qt * tp.Cdv + ql * tp.Cvl
    return cpm / (cpm - tp.cratio_inv * th.mixture_R(tp, qt, ql))


def from_primitive_airwater(tp, rho, u, v, w, T, qt, ql) -> CompState:
    """Conservative state with e from THERMO_CALORIC_ENERGY (airwater)."""
    e = th.caloric_energy(tp, qt, ql, T)
    return CompState(rho=rho, rhou=rho * u, rhov=rho * v, rhow=rho * w,
                     rhoE=rho * e, rhos=(rho * qt)[None])


def rhs_airwater_internal(P, U: CompState, tp, visc: float, prandtl: float,
                          schmidt: float, gvec=(0.0, 0.0, 0.0)):
    """Reference RHS_FLOW_GLOBAL_2 + RHS_SCAL_GLOBAL_2 for the AirWater
    mixture: skewsymmetric advection, explicit viscous/diffusion,
    internal-energy equation

      d(rho e)/dt = -skew(rho e u) + CRATIO_INV (Phi - p div u)
                    + (visc/Pr) lap(h(T, q))

    (conduction as the Laplacian of the caloric ENTHALPY, not T), gravity
    g_i rho in the momentum equations (no gravity work in the internal
    form), and plain diff lap(qt) scalar diffusion.  The enthalpy-diffusion
    cross term for Sc != Pr (rhs_scal_global_2.f90:96-130) is left out, as
    tlab_tpu leaves it out: the reference cases run Sc = Pr.  Returns the
    tendency and the primitives (u, v, w, T, p, ql, newton_err)."""
    rho = U.rho
    u, v, w, T, p, ql, err = primitive_airwater(U, tp)
    qt = U.rhos[0] / rho
    ci = tp.cratio_inv

    h_rho = -_div(P, U.rhou, U.rhov, U.rhow)
    px_, py_, pz_ = _grad(P, p)

    def skew(phi, rphi):
        dv = _div(P, rphi * u, rphi * v, rphi * w)
        gx, gy, gz = _grad(P, phi)
        conv = U.rhou * gx + U.rhov * gy + U.rhow * gz
        return -0.5 * (dv + conv - phi * h_rho)

    h_ru = skew(u, U.rhou) - px_ + gvec[0] * rho
    h_rv = skew(v, U.rhov) - py_ + gvec[1] * rho
    h_rw = skew(w, U.rhow) - pz_ + gvec[2] * rho
    e_sp = U.rhoE / rho
    h_re = skew(e_sp, U.rhoE)

    # viscous terms (constant mu) with the caloric enthalpy riding the
    # stacked D2 slot normally used by T: conduction = cond lap(h)
    h_enth = th.caloric_enthalpy(tp, qt, ql, T)
    cond = visc / prandtl
    dtx, dty, dtz, conduction, grads, phi, _ = _visc_terms(
        P, u, v, w, h_enth, visc, cond, False)
    divu = grads[-1]
    h_ru = h_ru + dtx
    h_rv = h_rv + dty
    h_rw = h_rw + dtz
    h_re = h_re + ci * (phi - p * divu) + conduction

    # scalar qt: skewsymmetric advection + diff lap(qt)
    diff = visc / schmidt
    _, qx2 = _d12_stack(P, "x", 0, qt[None])
    _, qy2 = _d12_stack(P, "y", 1, qt[None])
    _, qz2 = _d12_stack(P, "z", 2, qt[None])
    h_rs = skew(qt, U.rhos[0])[None] + diff * (qx2 + qy2 + qz2)

    return CompState(h_rho, h_ru, h_rv, h_rw, h_re, h_rs), \
        (u, v, w, T, p, ql, err)


def rk_step_airwater(P, U: CompState, dtime, tp, visc: float,
                     prandtl: float, schmidt: float, nscbc=None,
                     ly: float = 1.0, gvec=(0.0, 0.0, 0.0), buffer=None):
    """Low-storage RK step for the AirWater internal-energy core
    (TIME_SUBSTEP_COMPRESSIBLE with RHS_FLOW_GLOBAL_2).  Returns the new
    state and the max Newton residual across substeps (NewtonRs), a 0-d
    tensor on the device: the host reads it with the step's diagnostics."""
    from tlab_tpu_torch.dycore.nscbc import apply_nscbc_airwater
    dyn.check_main_path(P)
    kdt = P["rk"]["kdt"]
    kco = P["rk"]["kco"]
    h = CompState(*(torch.zeros_like(x) if x is not None else None
                    for x in U))
    err_max = U.rho.new_zeros(())
    for i, k in enumerate(kdt):
        dte = dtime * k
        dh, prim = rhs_airwater_internal(P, U, tp, visc, prandtl, schmidt,
                                         gvec=gvec)
        err_max = torch.maximum(err_max, prim[6])
        h = CompState(*(a + b if a is not None else None
                        for a, b in zip(h, dh)))
        if nscbc is not None:
            h = apply_nscbc_airwater(P, U, h, tp, nscbc, ly, prim,
                                     gvec=gvec)
        else:
            h = _apply_wall_bcs(P, h)
        if buffer is not None:
            h = _apply_buffer(h, U, buffer)
        U = CompState(*(q + dte * hq if q is not None else None
                        for q, hq in zip(U, h)))
        U = _clip_scalars(P, U)
        if i < len(kdt) - 1:
            a = kco[i]
            h = CompState(*(a * x if x is not None else None for x in h))
    return U, err_max


def acoustic_cfl_max_airwater(P, U: CompState, tp, prim=None):
    """max((|u|+c)/dx + ...) with c = sqrt(gama0 p / rho) -- the
    reference's TIME_COURANT compressible branch uses the CONSTANT
    gama0, not the local mixture gamma (time.f90:429).  prim: the state's
    primitive_airwater, where the caller has it."""
    u, v, w, T, p, ql, _ = prim if prim is not None \
        else primitive_airwater(U, tp)
    gama0 = tp.Cpd_dim / (tp.Cpd_dim - tp.Rd_dim)
    c = torch.sqrt(gama0 * torch.clamp(p, min=1e-30) / U.rho)
    return _cfl_sum(P, u, v, w, c)
