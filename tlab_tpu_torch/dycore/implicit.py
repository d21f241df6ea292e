"""Semi-implicit diffusion time marching: the Spalart, Moser & Rogers (1991)
3-stage scheme (port of tlab_tpu/dycore/implicit.py; reference
RKM_IMP3_DIFFUSION, time.f90:114-134 + rhs_global_incompressible_implicit_3).

Each stage treats advection and sources explicitly and diffusion implicitly,
one Helmholtz solve per prognostic field, with the reference's augmented
variable x = q_new + (kex/kim) q_old, which cancels the explicit Laplacian:

    (1 - dte kim nu Lap) x = aug q_old + dte (h_adv + kco h_adv_old) = rhs
    q_new = x - (kex/kim) q_old

then a pressure projection of the stage velocity with the direct eigen
Poisson solve.  The diffusion number no longer limits dt (the wall-resolved
stretched grids); the advective CFL does.

The advective tendency is the Burgers term with nu = 0 for the whole stack,
so on a CUDA float32 stack the hand-written kernels of ops/burgers.py run
it, three launches a stage.  The Helmholtz solves take the Neumann plan
P["ell"] for a field with Neumann walls on both sides and the Dirichlet plan
P["ell_dd"] otherwise (a no-slip wall, v, a Dirichlet scalar).
"""
from __future__ import annotations

import torch

from tlab_tpu_torch.dycore import incompressible as dyn
from tlab_tpu_torch.dycore.state import State
from tlab_tpu_torch.ops import elliptic
from tlab_tpu_torch.parallel import pencil

# SMR91 coefficients (reference time.f90:114-134)
KDT = (8.0 / 15.0, 5.0 / 12.0, 3.0 / 4.0)
KIM = (111.0 / 256.0, 1.0 / 2.0, 2.0 / 9.0)
KEX = (145.0 / 256.0, -9.0 / 50.0, 2.0 / 9.0)
KCO = (0.0, -17.0 / 25.0, -5.0 / 9.0)


def _advective_rhs(P, state: State, aux=None):
    """Convective tendencies + sources, NO diffusion (nu = 0 Burgers).
    The advecting velocities are the stack's own rows: a stage's velocity
    comes out of the inverse FFTs with permuted strides, and the kernels
    take contiguous operands only."""
    u, v, w, s = state.u, state.v, state.w, state.s
    fields = torch.cat([u[None], v[None], w[None], s], dim=0)
    zero_nu = fields.new_zeros((fields.shape[0], 1, 1, 1))
    adv = dyn._burgers_all(P, "x", 0, fields, fields[0], zero_nu)
    adv += dyn._burgers_all(P, "y", 1, fields, fields[1], zero_nu)
    adv += dyn._burgers_all(P, "z", 2, fields, fields[2], zero_nu)
    h1, h2, h3 = adv[0], adv[1], adv[2]
    hs = adv[3:]
    if P["bodyforce"] is not None:
        h1, h2, h3, hs = P["bodyforce"](P, state, h1, h2, h3, hs, aux=aux)
    return h1, h2, h3, hs


def _plan_for(P, pair):
    """Helmholtz pencil matching the field's wall BCs: NN for Neumann walls
    (free-slip/adiabatic), DD otherwise.  tlab_tpu falls back to the NN
    pencil where a plan has no "ell_dd", which solves a Dirichlet wall
    wrongly without a word; here that raises (Simulation.from_case builds
    both for a TimeOrder=RungeKuttaDiffusion3 case)."""
    if pair[0] == "neumann" and pair[1] == "neumann":
        return P["ell"]
    if P.get("ell_dd") is None:
        raise ValueError(f"walls {pair} need the Dirichlet Helmholtz pencil "
                         "P['ell_dd'] (Simulation.from_case builds it)")
    return P["ell_dd"]


def _helmholtz_update(P, pair, q, rhs, q_wall_aug, alpha_h, kef):
    """Solve (1 - a Lap) x = rhs -> Helmholtz Lap x + beta x = beta rhs.

    Dirichlet walls carry aug*q_wall as the solution value; Neumann walls
    carry zero derivative.
    """
    beta = -1.0 / alpha_h
    f = beta * rhs
    neum = pair[0] == "neumann" and pair[1] == "neumann"
    bcs_b = torch.zeros_like(q[:, 0, :]) if neum else q_wall_aug[0]
    bcs_t = torch.zeros_like(q[:, -1, :]) if neum else q_wall_aug[1]
    if P.get("comm") is not None:
        x = pencil.pencil_helmholtz(_plan_for(P, pair), f, P["comm"], beta,
                                    bcs_b=bcs_b, bcs_t=bcs_t)
    else:
        x = elliptic.helmholtz(_plan_for(P, pair), f, beta,
                               bcs_b=bcs_b, bcs_t=bcs_t)
    return x - kef * q


def rk_step_implicit(P, state: State, dtime, aux=None):
    """One full SMR91 step (3 stages); returns (state, last stage
    pressure) like the explicit rk_step.  aux carries the [ViscChange]
    visc_scale and the inputs of a time-dependent forcing, as for the
    explicit step."""
    dyn.check_main_path(P)
    vscale = dyn._visc_scale(aux)
    visc = P["visc"] * vscale
    h_old = None
    p = None
    for i in range(3):
        dte = dtime * KDT[i]
        kim, kex, kco = KIM[i], KEX[i], KCO[i]
        kef = kex / kim
        aug = 1.0 + kef

        h1, h2, h3, hs = _advective_rhs(P, state, aux=aux)
        h_raw = (h1, h2, h3, hs)           # saved for the next stage's kco
        if h_old is not None and kco != 0.0:
            h1 = h1 + kco * h_old[0]
            h2 = h2 + kco * h_old[1]
            h3 = h3 + kco * h_old[2]
            hs = hs + kco * h_old[3]
        h_old = h_raw

        u, v, w, s = state.u, state.v, state.w, state.s
        alpha_h = dte * kim * visc
        bc_types = P["wall_bc_types"]

        def walls(q):
            return (aug * q[:, 0, :], aug * q[:, -1, :])

        u_new = _helmholtz_update(P, bc_types["u"], u, aug * u + dte * h1,
                                  walls(u), alpha_h, kef)
        v_new = _helmholtz_update(P, ("dirichlet", "dirichlet"), v,
                                  aug * v + dte * h2,
                                  (torch.zeros_like(v[:, 0, :]),
                                   torch.zeros_like(v[:, -1, :])),
                                  alpha_h, kef)
        w_new = _helmholtz_update(P, bc_types["w"], w, aug * w + dte * h3,
                                  walls(w), alpha_h, kef)
        s_list = []
        for isc in range(s.shape[0]):
            a_s = dte * kim * P["diff"][isc] * vscale
            s_list.append(_helmholtz_update(P, bc_types["s"][isc], s[isc],
                                            aug * s[isc] + dte * hs[isc],
                                            walls(s[isc]), a_s, kef))
        s_new = torch.stack(s_list) if s_list else s

        # pressure projection of the stage velocity
        div = dyn.divergence(P, u_new, v_new, w_new) / dte
        bcs_b = torch.zeros_like(v_new[:, 0, :])
        if P.get("comm") is not None:
            p, dpdy = pencil.pencil_poisson(P["ell"], div, P["comm"],
                                            bcs_b=bcs_b, bcs_t=bcs_b,
                                            d1y=P["d1y"])
        else:
            p, dpdy = elliptic.poisson(P["ell"], div, bcs_b=bcs_b,
                                       bcs_t=bcs_b, d1y=P["d1y"])
        u_new = u_new - dte * dyn._d1(P, "x", 0, p)
        v_new = v_new - dte * dpdy
        w_new = w_new - dte * dyn._d1(P, "z", 2, p)

        # wall rows of the state (Dirichlet walls pinned; the implicit solve
        # already imposed them, re-pin after projection)
        v_new[:, 0, :] = 0.0
        v_new[:, -1, :] = 0.0

        state = State(u=u_new, v=v_new, w=w_new, s=s_new, sfc=state.sfc)
    return state, p
