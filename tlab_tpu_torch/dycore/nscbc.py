"""Characteristic (NSCBC) boundary conditions for the compressible core
(Poinsot & Lele, JCP 1992; Lodato et al., JCP 2008; reference
src/tools/dns/boundary_bcs_compressible.f90).

The reference formulation is ADDITIVE: the interior RHS is evaluated
everywhere (including boundary rows, with the one-sided compact rows),
and per-point corrections are added at the open-boundary rows that
cancel the incoming characteristic amplitude as computed by the biased
stencil and replace it with a model:

- outflow: the Poinsot-Lele relaxation F = -pl_out (p - p_ref) with
  pl_out = cout (1 - M2_max) c / L and M2_max the INSTANTANEOUS global
  maximum Mach^2 (the 'Mach drift' reference, time.f90:780-792,
  boundary_bcs_compressible.f90:540-566);
- inflow: all incoming amplitudes relax to a reference state with
  pl_inf = cinf c / L (BOUNDARY_BCS_FLOW_NR_3, idir=2 OY branch);
- transverse corrections after Lodato et al. weighted by ctan
  (BOUNDARY_BCS_FLOW_NR_4 + BOUNDARY_BCS_TRANSVERSE_Y).

All branches are point-masked (torch.where): the whole treatment is dense
edge-plane arithmetic on the device, with no host sync; the normal
derivatives are the edge rows of the dense compact D1 (exactly the
reference's biased compact rows; the plan keeps the dense D1 of a long line
beside its substructured one, so these rows are there at any size).

Nondimensional EOS as in dycore.compressible: p = rho T/(gamma M^2),
e_int = T/(gamma (gamma-1) M^2), hence p = (gamma-1) rho e_int and the
reference's /(gamma-1) energy mapping carries over unchanged.

Port of tlab_tpu/dycore/nscbc.py.  On the pencil mesh (a plan with a
"comm") the tangential derivatives of the y-edge planes go through the
transposes like every other derivative and the Mach drift's max is the
mesh's; open x boundaries with x split over ranks raise (tlab_tpu applies
them at every block's x edges, ROADMAP C).
"""
from __future__ import annotations

import dataclasses

import torch

from tlab_tpu_torch.dycore.compressible import (CompState, gamma_airwater,
                                                mass_fractions, primitive)
from tlab_tpu_torch.ops.derivative import der1
from tlab_tpu_torch.physics import mixtures as mx


@dataclasses.dataclass(frozen=True)
class NSCBCSpec:
    ymin: str = "wall"          # wall | outflow | inflow (y boundaries)
    ymax: str = "wall"
    xmin: str = "none"          # none | outflow | inflow (open x boundaries)
    xmax: str = "none"
    sigma: float = 0.25         # cout: outflow relaxation (Poinsot-Lele)
    cinf: float = 0.0           # inflow relaxation toward the reference
    ctan: float = 0.0           # transverse-term weight (Lodato beta)
    p_inf: float = 1.0          # far-field pressure (nondimensional)
    rho_inf: float = 1.0        # reference density (inflow relaxation)
    u_inf: tuple = (0.0, 0.0, 0.0)   # reference velocity (x, y, z)
    drift: bool = True          # rescale pl_out by (1 - max Mach^2)
    # per-side reference states at the y boundaries (BcsFlowJmin/Jmax%ref,
    # boundary_bcs.f90:224-287: built from the buffer plane means):
    # (rho_ref, un_ref, v1_ref, v2_ref, p_ref[, s_ref]) floats
    refs_ymin: tuple = None
    refs_ymax: tuple = None


def _edge_deriv(P, a, axis: int, side: int):
    """One-sided compact normal derivative at the boundary row."""
    d1 = P["d1y"] if axis == 1 else P["d1x"]
    row = d1[0] if side == 0 else d1[-1]
    if axis == 1:
        return torch.einsum("b,ibk->ik", row, a)
    return torch.einsum("b,bjk->jk", row, a)


def _plane_d1(P, a2d, axis: int, which: str):
    """Tangential derivative of an edge plane: for a y-boundary the plane
    is (nx, nz), and 'x' contracts the first index, 'z' the second, with
    the dense D1 of that direction.  On a mesh the plane rides the
    direction's transposes as a (nx/px, 1, nz/pz) block."""
    from tlab_tpu_torch.dycore.incompressible import _gathered_apply
    M = P.get(f"d1{which}")
    if M is None:
        return torch.zeros_like(a2d)
    ax = 0 if which == "x" else 2
    return _gathered_apply(P, which, a2d[:, None, :],
                           lambda g: der1(M, g, ax))[:, 0, :]


def _global_max(P, v):
    """The max Mach^2 over the box: the value itself on one device, the
    mesh's max on a mesh (the reference's MPI_ALLREDUCE of M2_max,
    time.f90:786)."""
    comm = P.get("comm") if P is not None else None
    if comm is None:
        return v
    return comm["mesh"].all_reduce(v, "max")


def max_mach2(U: CompState, gamma: float, mach: float):
    """Instantaneous global max Mach^2 (reference M2_max, time.f90:780)."""
    u, v, w, T, p = primitive(None, U, gamma, mach)
    c2 = torch.clamp(T, min=1e-12) / mach ** 2
    return torch.max((u * u + v * v + w * w) / c2)


def _nr_corrections(side, r, un, v1, v2, p, gam, drdn, dundn, dv1dn,
                    dv2dn, dpdn, gn, pl_out, pl_inf, refs, idir=2):
    """BOUNDARY_BCS_FLOW_NR_3 as masked plane arithmetic.

    side=0 -> min boundary (iflag<0), side=1 -> max (iflag>0). idir=1
    is the OX branch (the relaxation drives the full incoming Riemann
    invariant p +- rho c un), idir=2 the OY branch (no un forcing).
    refs is (r_ref, un_ref, v1_ref, v2_ref, p_ref). Returns additive
    corrections (hr, hun, hv1, hv2, he_int)."""
    c = torch.sqrt(gam * p / r)
    Mn = un / c
    r_ref, un_ref, v1_ref, v2_ref, p_ref = refs
    z = torch.zeros_like(r)

    if side == 0:
        subsonic = un + c > 0.0
        inflow = un > 0.0
        # --- inflow branch (un > 0 at min) ---------------------------
        dmy_i = 0.5 * (r * (1.0 + Mn) * dundn + (1.0 - Mn) / c * dpdn
                       - r * gn / c)
        hr_i = un * drdn + dmy_i
        hun_i = un * un * drdn + dmy_i * c * (1.0 + Mn) + Mn * dpdn
        hv1_i = un * v1 * drdn + r * un * dv1dn + dmy_i * v1
        hv2_i = un * v2 * drdn + r * un * dv2dn + dmy_i * v2
        he_i = (un * dpdn + dmy_i * c * c) / (gam - 1.0)
        if idir == 1:        # OX: forcing toward the full invariant
            F2 = -pl_inf * (r - r_ref)
            F3 = -pl_inf * (v1 - v1_ref)
            F4 = -pl_inf * (v2 - v2_ref)
            F5 = -pl_inf * (p + r * c * un - (p_ref + r * c * un_ref))
        else:                # OY: no un forcing through F5
            F2 = -pl_inf * c * (r - r_ref)
            F3 = -pl_inf * c * (v1 - v1_ref)
            F4 = -pl_inf * c * (v2 - v2_ref)
            F5 = -pl_inf * c * (p - p_ref)
        dmy_f = F2 + 0.5 * F5 / (c * c)
        hr_i = hr_i + dmy_f
        hun_i = hun_i + un * F2 + 0.5 * (Mn + 1.0) * F5 / c
        hv1_i = hv1_i + r * F3 + v1 * dmy_f
        hv2_i = hv2_i + r * F4 + v2 * dmy_f
        he_i = he_i + 0.5 * F5 / (gam - 1.0)
        # --- outflow branch (un <= 0 at min) -------------------------
        if idir == 1:
            F5o = -pl_out * (p + r * c * un - (p_ref + r * c * un_ref))
        else:
            F5o = -pl_out * (p - p_ref)
        dmy_o = 0.5 * (r * (1.0 + Mn) * dundn + (1.0 + Mn) / c * dpdn
                       - r * gn / c + F5o / c)
        hr_o = dmy_o
        hun_o = dmy_o * c * (1.0 + Mn)
        hv1_o = dmy_o * v1
        hv2_o = dmy_o * v2
        he_o = dmy_o * c * c / (gam - 1.0)
    else:
        subsonic = un - c < 0.0
        inflow = un < 0.0
        dmy_i = 0.5 * (r * (1.0 - Mn) * dundn - (1.0 + Mn) / c * dpdn
                       + r * gn / c)
        hr_i = un * drdn + dmy_i
        hun_i = un * un * drdn - (1.0 - Mn) * c * dmy_i - Mn * dpdn
        hv1_i = un * v1 * drdn + r * un * dv1dn + dmy_i * v1
        hv2_i = un * v2 * drdn + r * un * dv2dn + dmy_i * v2
        he_i = (un * dpdn + dmy_i * c * c) / (gam - 1.0)
        if idir == 1:
            F1 = -pl_inf * c * ((p - r * c * un)
                                - (p_ref - r * c * un_ref))
        else:
            F1 = -pl_inf * c * (p - p_ref)
        F2 = -pl_inf * c * (r - r_ref)
        F3 = -pl_inf * c * (v1 - v1_ref)
        F4 = -pl_inf * c * (v2 - v2_ref)
        dmy_f = F2 + 0.5 * F1 / (c * c)
        hr_i = hr_i + dmy_f
        hun_i = hun_i + un * F2 + 0.5 * (Mn - 1.0) * F1 / c
        hv1_i = hv1_i + r * F3 + v1 * dmy_f
        hv2_i = hv2_i + r * F4 + v2 * dmy_f
        he_i = he_i + 0.5 * F1 / (gam - 1.0)
        F1o = -pl_out * (p - p_ref)
        dmy_o = 0.5 * (r * (1.0 - Mn) * dundn - (1.0 - Mn) / c * dpdn
                       + r * gn / c + F1o / c)
        hr_o = dmy_o
        hun_o = -dmy_o * c * (1.0 - Mn)
        hv1_o = dmy_o * v1
        hv2_o = dmy_o * v2
        he_o = dmy_o * c * c / (gam - 1.0)

    def pick(i, o):
        return torch.where(subsonic, torch.where(inflow, i, o), z)
    return (pick(hr_i, hr_o), pick(hun_i, hun_o), pick(hv1_i, hv1_o),
            pick(hv2_i, hv2_o), pick(he_i, he_o))


def _transverse_corrections(P, side, r, un, v1, v2, p, gam, gvec,
                            beta):
    """BOUNDARY_BCS_TRANSVERSE_Y + NR_4: tangential-derivative terms of
    the edge plane, weighted by beta=ctan. For a y-boundary the
    tangential directions are x ('v1') and z ('v2')."""
    c = torch.sqrt(gam * p / r)
    Mn = un / c
    dx = {k: _plane_d1(P, v, 0, "x")
          for k, v in (("v1", v1), ("un", un), ("v2", v2), ("p", p),
                       ("r", r))}
    dz = {k: _plane_d1(P, v, 0, "z")
          for k, v in (("v1", v1), ("un", un), ("v2", v2), ("p", p),
                       ("r", r))}
    gx, gz = gvec
    # t1..t5 (sign-flipped as the reference) -- transverse convection
    t1 = -(r * dx["v1"] + v1 * dx["r"] + r * dz["v2"] + v2 * dz["r"])
    t2 = -(v1 * dx["un"] + v2 * dz["un"])
    t3 = -(v1 * dx["v1"] + v2 * dz["v1"] + dx["p"] / r - gx)
    t4 = -(v1 * dx["v2"] + v2 * dz["v2"] + dz["p"] / r - gz)
    t5 = -(v1 * dx["p"] + v2 * dz["p"]
           + gam * p * (dx["v1"] + dz["v2"]))
    # lateral characteristic amplitudes along x (m1/m5)
    m1 = (v1 - c) * (dx["p"] - dx["v1"] * r * c)
    m5 = (v1 + c) * (dx["p"] + dx["v1"] * r * c)

    z = torch.zeros_like(r)
    if side == 0:
        subsonic = un + c > 0.0
        inflow = un > 0.0
        dmy_i = 0.5 * t5 / (c * c) - 0.5 * r * t2 / c - t1
        hr_i = dmy_i
        hun_i = 0.5 * (Mn - 1.0) * t5 / c - 0.5 * r * (Mn + 1.0) * t2 \
            - t1 * un
        hv1_i = dmy_i * v1 - r * t3 - 0.5 * (m5 - m1) / c
        hv2_i = dmy_i * v2 - r * t4
        he_i = -0.5 * (t5 + r * c * t2) / (gam - 1.0)
        dmy_o = -0.5 * (1.0 - beta) * (r * c * t2 + t5) / (c * c)
        hun_o = dmy_o * c * (1.0 + Mn)
    else:
        subsonic = un - c < 0.0
        inflow = un < 0.0
        dmy_i = 0.5 * t5 / (c * c) + 0.5 * r * t2 / c - t1
        hr_i = dmy_i
        hun_i = 0.5 * (Mn + 1.0) * t5 / c + 0.5 * r * (Mn - 1.0) * t2 \
            - t1 * un
        hv1_i = dmy_i * v1 - r * t3 - 0.5 * (m5 - m1) / c
        hv2_i = dmy_i * v2 - r * t4
        he_i = -0.5 * (t5 - r * c * t2) / (gam - 1.0)
        dmy_o = 0.5 * (1.0 - beta) * (r * c * t2 - t5) / (c * c)
        hun_o = -dmy_o * c * (1.0 - Mn)
    hr_o = dmy_o
    hv1_o = dmy_o * v1
    hv2_o = dmy_o * v2
    he_o = dmy_o * c * c / (gam - 1.0)

    def pick(i, o):
        return torch.where(subsonic, torch.where(inflow, i, o), z)
    return (pick(hr_i, hr_o), pick(hun_i, hun_o), pick(hv1_i, hv1_o),
            pick(hv2_i, hv2_o), pick(he_i, he_o))


def _add_rows(a, idx, val):
    """a with `val` added at the edge rows `idx` (a new tensor)."""
    a = a.clone()
    a[idx] += val
    return a


def apply_nscbc(P, U: CompState, h: CompState, gamma: float, mach: float,
                spec: NSCBCSpec, ly: float, lx: float = 1.0,
                gvec=(0.0, 0.0, 0.0), energy: str = "total",
                mix=None) -> CompState:
    """Add the characteristic corrections at open boundary rows (y axis
    with idir=2 incl. transverse terms; x axis with idir=1). 'wall'/
    'none' sides are left to the caller.

    mix: combustion mixture table -- the boundary characteristics then
    use the mixture pressure/temperature and the LOCAL gamma field
    (reference GAMMA_LOC from THERMO_GAMMA, time.f90:777), and each
    scalar characteristic feeds the energy with its formation-enthalpy
    weight (boundary_bcs_compressible.f90:723-730 general case)."""
    rho = U.rho
    u, v, w, T, p = primitive(P, U, gamma, mach, mix=mix)
    if mix is not None and U.rhos is not None:
        Y = mass_fractions(U)
        gam = mx.gamma_mixture(mix, T, Y)
        m2 = torch.max((u * u + v * v + w * w) * rho / (gam * p)) \
            if spec.drift else rho.new_tensor(mach ** 2)
        # code-units formation enthalpies a6_i/( (gama0-1) M^2 )
        hform = mix.ai[5] / ((mix.gama0 - 1.0) * mach ** 2)
    else:
        gam = torch.full_like(rho, gamma)
        m2 = max_mach2(U, gamma, mach) if spec.drift else \
            rho.new_tensor(mach ** 2)
        hform = None
    m2 = _global_max(P, m2)
    drift = torch.clamp(1.0 - m2, min=0.0)

    comps = [h.rho, h.rhou, h.rhov, h.rhow, h.rhoE]
    hs = h.rhos
    axes = ((1, (spec.ymin, spec.ymax), ly, 2),
            (0, (spec.xmin, spec.xmax), lx, 1))
    comm = P.get("comm") if P is not None else None
    if comm is not None and comm["px"] > 1 and (spec.xmin, spec.xmax) != (
            "none", "none"):
        raise NotImplementedError(
            "open x boundaries (NSCBC) with x split over ranks: a rank's "
            "block edges are not the domain's (tlab_tpu applies them there, "
            "ROADMAP C)")
    for axis, kinds, length, idir in axes:
        for side in (0, 1):
            kind = kinds[side]
            if kind in ("wall", "none"):
                continue
            j = 0 if side == 0 else -1
            if axis == 1:
                sl = (slice(None), j, slice(None))
                vn, t1, t2 = v, u, w
                gn = gvec[1]
                # momentum component ordering (normal, tan1, tan2) ->
                # (rhov, rhou, rhow)
                mom_idx = (2, 1, 3)
                ref_n, ref_1, ref_2 = (spec.u_inf[1], spec.u_inf[0],
                                       spec.u_inf[2])
            else:
                sl = (j,)
                vn, t1, t2 = u, v, w
                gn = gvec[0]
                mom_idx = (1, 2, 3)
                ref_n, ref_1, ref_2 = (spec.u_inf[0], spec.u_inf[1],
                                       spec.u_inf[2])
            r_b = rho[sl]
            un_b = vn[sl]
            v1_b = t1[sl]
            v2_b = t2[sl]
            p_b = p[sl]
            g_b = gam[sl]
            drdn = _edge_deriv(P, rho, axis, side)
            dundn = _edge_deriv(P, vn, axis, side)
            dv1dn = _edge_deriv(P, t1, axis, side)
            dv2dn = _edge_deriv(P, t2, axis, side)
            dpdn = _edge_deriv(P, p, axis, side)
            c_b = torch.sqrt(g_b * p_b / r_b)
            pl_out = spec.sigma * drift * c_b / length
            pl_inf = (spec.cinf / length) * torch.ones_like(c_b) \
                if kind == "inflow" else torch.zeros_like(c_b)
            refs = (torch.full_like(r_b, spec.rho_inf),
                    torch.full_like(r_b, ref_n),
                    torch.full_like(r_b, ref_1),
                    torch.full_like(r_b, ref_2),
                    torch.full_like(r_b, spec.p_inf))
            hr, hun, hv1, hv2, he = _nr_corrections(
                side, r_b, un_b, v1_b, v2_b, p_b, g_b, drdn, dundn,
                dv1dn, dv2dn, dpdn, gn, pl_out, pl_inf, refs, idir=idir)
            if spec.ctan != 0.0 and axis == 1:
                tr = _transverse_corrections(
                    P, side, r_b, un_b, v1_b, v2_b, p_b, g_b,
                    (gvec[0], gvec[2]), spec.ctan)
                hr, hun, hv1, hv2, he = (a + b for a, b in
                                         zip((hr, hun, hv1, hv2, he),
                                             tr))
            # energy mapping: he is d(rho e_int); total energy adds the
            # kinetic part d(rho|u|^2/2) = sum u_i d(rho u_i) - ke d(rho)
            if energy == "total":
                ke = 0.5 * (un_b ** 2 + v1_b ** 2 + v2_b ** 2)
                hE = he + un_b * hun + v1_b * hv1 + v2_b * hv2 - ke * hr
            else:
                hE = he
            idx = sl
            comps[0] = _add_rows(comps[0], idx, hr)
            comps[mom_idx[0]] = _add_rows(comps[mom_idx[0]], idx, hun)
            comps[mom_idx[1]] = _add_rows(comps[mom_idx[1]], idx, hv1)
            comps[mom_idx[2]] = _add_rows(comps[mom_idx[2]], idx, hv2)
            comps[4] = _add_rows(comps[4], idx, hE)
            if hs is not None:
                for i_s in range(hs.shape[0]):
                    s_f = U.rhos[i_s] / rho
                    dsdn = _edge_deriv(P, s_f, axis, side)
                    hz = _nr_scalar_corrections(
                        side, r_b, un_b, s_f[sl], p_b, g_b, drdn, dundn,
                        dsdn, dpdn, gn, pl_out, pl_inf,
                        torch.full_like(r_b, spec.p_inf),
                        torch.full_like(r_b, spec.rho_inf),
                        torch.zeros_like(r_b), idir=idir)
                    hs = _add_rows(hs, (i_s,) + idx, hz)
                    if hform is not None:
                        # formation-enthalpy energy coupling
                        # h4 += hz (a6_is - a6_NSP)
                        comps[4] = _add_rows(
                            comps[4], idx,
                            hz * float(hform[i_s] - hform[-1]))
    return CompState(*comps, hs)


def apply_nscbc_airwater(P, U: CompState, h: CompState, tp, spec: NSCBCSpec,
                         ly: float, prim, gvec=(0.0, 0.0, 0.0)) -> CompState:
    """BOUNDARY_BCS_Y for the compressible AirWater internal-energy core:
    the same NR_3/NR_4 corrections with the LOCAL mixture gamma field,
    the energy correction scaled by CRATIO_INV (thermal-units energy),
    the qt characteristic added to the scalar tendency, and the
    DIAGNOSTIC ql characteristic added only to the energy with weight
    THERMO_AI(6,1,3) = Lvl (boundary_bcs_compressible.f90:713-775).
    prim: the substep's primitive_airwater of U."""
    rho = U.rho
    u, v, w, T, p, ql, _ = prim
    qt = U.rhos[0] / rho
    gam = gamma_airwater(tp, qt, ql, T)
    ci = tp.cratio_inv

    # Mach drift from the instantaneous local sound speed
    m2 = torch.max((u * u + v * v + w * w) * rho / (gam * p)) if spec.drift \
        else rho.new_zeros(())
    m2 = _global_max(P, m2)
    drift = torch.clamp(1.0 - m2, min=0.0)

    comps = [h.rho, h.rhou, h.rhov, h.rhow, h.rhoE]
    hs = h.rhos
    for side in (0, 1):
        kind = (spec.ymin, spec.ymax)[side]
        if kind in ("wall", "none"):
            continue
        j = 0 if side == 0 else -1
        sl = (slice(None), j, slice(None))
        r_b = rho[sl]
        un_b = v[sl]
        v1_b = u[sl]
        v2_b = w[sl]
        p_b = p[sl]
        g_b = gam[sl]
        drdn = _edge_deriv(P, rho, 1, side)
        dundn = _edge_deriv(P, v, 1, side)
        dv1dn = _edge_deriv(P, u, 1, side)
        dv2dn = _edge_deriv(P, w, 1, side)
        dpdn = _edge_deriv(P, p, 1, side)
        c_b = torch.sqrt(g_b * p_b / r_b)
        pl_out = spec.sigma * drift * c_b / ly
        pl_inf = (spec.cinf / ly) * torch.ones_like(c_b)
        refs_t = (spec.refs_ymin, spec.refs_ymax)[side]
        if refs_t is None:
            refs_t = (spec.rho_inf, spec.u_inf[1], spec.u_inf[0],
                      spec.u_inf[2], spec.p_inf)
        refs = tuple(torch.full_like(r_b, rv) for rv in refs_t[:5])
        s_ref = refs_t[5] if len(refs_t) > 5 else 0.0
        hr, hun, hv1, hv2, he = _nr_corrections(
            side, r_b, un_b, v1_b, v2_b, p_b, g_b, drdn, dundn,
            dv1dn, dv2dn, dpdn, gvec[1], pl_out, pl_inf, refs, idir=2)
        if spec.ctan != 0.0:
            tr = _transverse_corrections(
                P, side, r_b, un_b, v1_b, v2_b, p_b, g_b,
                (gvec[0], gvec[2]), spec.ctan)
            hr, hun, hv1, hv2, he = (a + b for a, b in
                                     zip((hr, hun, hv1, hv2, he), tr))
        idx = sl
        comps[0] = _add_rows(comps[0], idx, hr)
        comps[2] = _add_rows(comps[2], idx, hun)
        comps[1] = _add_rows(comps[1], idx, hv1)
        comps[3] = _add_rows(comps[3], idx, hv2)
        comps[4] = _add_rows(comps[4], idx, he * ci)
        # scalar characteristics: qt (prognostic) and ql (diagnostic,
        # energy-only with weight Lvl = THERMO_AI(6,1,3))
        for s_f, w_en, into_hs, sr in ((qt, 0.0, True, s_ref),
                                       (ql, tp.Lvl, False, 0.0)):
            dsdn = _edge_deriv(P, s_f, 1, side)
            hz = _nr_scalar_corrections(
                side, r_b, un_b, s_f[sl], p_b, g_b, drdn, dundn,
                dsdn, dpdn, gvec[1], pl_out, pl_inf, refs[4], refs[0],
                torch.full_like(r_b, sr), idir=2)
            if into_hs and hs is not None:
                hs = _add_rows(hs, (0,) + idx, hz)
            if w_en != 0.0:
                comps[4] = _add_rows(comps[4], idx, hz * w_en)
    return CompState(*comps, hs)


def _nr_scalar_corrections(side, r, un, s, p, gam, drdn, dundn, dsdn,
                           dpdn, gn, pl_out, pl_inf, p_ref, r_ref, s_ref,
                           idir=2):
    """BOUNDARY_BCS_SCAL_NR_3: additive correction for d(rho s) at an
    open boundary (same wave bookkeeping as the flow NR_3; the scalar
    rides the entropy/vorticity characteristics)."""
    c = torch.sqrt(gam * p / r)
    Mn = un / c
    z = torch.zeros_like(r)
    if side == 0:
        subsonic = un + c > 0.0
        inflow = un > 0.0
        dmy_i = 0.5 * (r * (1.0 + Mn) * dundn + (1.0 - Mn) / c * dpdn
                       - r * gn / c)
        h_i = un * s * drdn + r * un * dsdn + dmy_i * s
        if idir == 2:
            F2 = -pl_inf * c * (r - r_ref)
            F5 = -pl_inf * c * (p - p_ref)
            FZ = -pl_inf * c * (s - s_ref)
        else:
            F2 = -pl_inf * (r - r_ref)
            F5 = -pl_inf * (p + r * c * un - p_ref)
            FZ = -pl_inf * (s - s_ref)
        h_i = h_i + r * FZ + s * (F2 + 0.5 * F5 / (c * c))
        F5o = -pl_out * (p - p_ref)
        dmy_o = 0.5 * (r * (1.0 + Mn) * dundn + (1.0 + Mn) / c * dpdn
                       - r * gn / c + F5o / c)
        h_o = dmy_o * s
    else:
        subsonic = un - c < 0.0
        inflow = un < 0.0
        dmy_i = 0.5 * (r * (1.0 - Mn) * dundn - (1.0 + Mn) / c * dpdn
                       + r * gn / c)
        h_i = un * s * drdn + r * un * dsdn + dmy_i * s
        F1 = -pl_inf * c * (p - p_ref)
        F2 = -pl_inf * c * (r - r_ref)
        FZ = -pl_inf * c * (s - s_ref)
        h_i = h_i + r * FZ + s * (F2 + 0.5 * F1 / (c * c))
        F1o = -pl_out * (p - p_ref)
        dmy_o = 0.5 * (r * (1.0 - Mn) * dundn - (1.0 - Mn) / c * dpdn
                       + r * gn / c + F1o / c)
        h_o = dmy_o * s
    return torch.where(subsonic, torch.where(inflow, h_i, h_o), z)
