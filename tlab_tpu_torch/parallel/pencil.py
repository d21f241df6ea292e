"""Explicit pencil-transpose engine on torch.distributed (port of
tlab_tpu/parallel/pencil.py, after the reference's global transpose engine,
src/base/tlab_mpi_transpose.f90).

Fields live in blocks (nx/px, ny, nz/pz) on the (x, z) rank grid of
parallel/mesh.py; an x or z derivative gathers full lines with one
all-to-all over that grid axis, applies the dense operator (or the Burgers
kernel) on them and scatters the result back.  The advected fields and
the advecting velocity ride the same all-to-all as one stacked tensor: two
collectives a direction a substep for the whole Burgers batch.  y work stays
local.

The Poisson chain (reference OPR_Fourier + OPR_Poisson): x-gather, rfft
along x, kx zero-padded to a multiple of px pz, re-split over x, then over
z with a full-z gather, fft along z, the per-mode vertical solve (y is local
by construction), and the inverse chain.  The transforms are torch.fft's;
tlab_tpu's DFT-as-matmul branch (ops/rdft.py) is not ported.

The step builders return functions of this rank's blocks: tlab_tpu's
shard_map bodies, run by every rank on its own block.
"""
from __future__ import annotations

import torch

from tlab_tpu_torch.dycore.state import State
from tlab_tpu_torch.ops import elliptic
from tlab_tpu_torch.ops import elliptic_factorize as fac

# padded modes: a large eigenvalue (direct solve) and kappa (factorized)
# keep the discarded columns finite
LAM_PAD = 1e6
KAPPA_PAD = 1e3


# ---------------------------------------------------------------------------
# all-to-all transposes of the local block
# ---------------------------------------------------------------------------

def gather_x(mesh, a, field_axis_offset: int = 0):
    """(.., nx/px, ny, nzl) -> (.., nx, ny, nzl/px) over the x group."""
    o = field_axis_offset
    return mesh.all_to_all(a, "x", split=2 + o, concat=0 + o)


def scatter_x(mesh, a, field_axis_offset: int = 0):
    o = field_axis_offset
    return mesh.all_to_all(a, "x", split=0 + o, concat=2 + o)


def gather_z(mesh, a, field_axis_offset: int = 0):
    """(.., nxl, ny, nz/pz) -> (.., nxl/pz, ny, nz) over the z group."""
    o = field_axis_offset
    return mesh.all_to_all(a, "z", split=0 + o, concat=2 + o)


def scatter_z(mesh, a, field_axis_offset: int = 0):
    o = field_axis_offset
    return mesh.all_to_all(a, "z", split=2 + o, concat=0 + o)


GATHER = {"x": gather_x, "z": gather_z}
SCATTER = {"x": scatter_x, "z": scatter_z}


def cast_on_wire(fn, mesh, a, off: int, wire_dtype):
    """fn(mesh, a, off) with the all-to-all moving `wire_dtype` (the
    reference's fp32-compressed fp64 transposes, tlab_mpi_transpose.f90:
    362-376, TransposeTypeK=single); None moves a's own dtype."""
    if wire_dtype is None or a.dtype == wire_dtype:
        return fn(mesh, a, off)
    return fn(mesh, a.to(wire_dtype), off).to(a.dtype)


# ---------------------------------------------------------------------------
# Pencil Poisson
# ---------------------------------------------------------------------------

def kx_offset(mesh, nkx_pad: int) -> int:
    """The first padded kx mode of this rank after the kx re-split over x
    and then z (tlab_tpu's _kx_offset)."""
    return mesh.ix * (nkx_pad // mesh.px) + mesh.iz * (
        nkx_pad // (mesh.px * mesh.pz))


def _with_walls(f, bcs_b, bcs_t):
    f = f.clone()
    f[:, 0, :] = 0.0 if bcs_b is None else bcs_b
    f[:, -1, :] = 0.0 if bcs_t is None else bcs_t
    return f


def _forward(mesh, f, nkx_pad: int):
    """rfft along x of the x-gathered lines, kx padded to nkx_pad, re-split
    over x then z, fft along z: (nkx_pad/(px pz), ny, nz) complex."""
    nx = f.shape[0] * mesh.px
    fh = torch.fft.rfft(gather_x(mesh, f), dim=0)
    pad = nkx_pad - (nx // 2 + 1)
    if pad:
        fh = torch.cat([fh, fh.new_zeros((pad,) + fh.shape[1:])])
    fh = gather_z(mesh, scatter_x(mesh, fh))
    if f.shape[2] * mesh.pz > 1:
        fh = torch.fft.fft(fh, dim=2)
    return fh


def _backward(mesh, uh, nx: int, nz: int, dtype):
    """The inverse of _forward: the (nx/px, ny, nz/pz) real block."""
    if nz > 1:
        uh = torch.fft.ifft(uh, dim=2)
    uh = gather_x(mesh, scatter_z(mesh, uh))[: nx // 2 + 1]
    return scatter_x(mesh, torch.fft.irfft(uh, n=nx, dim=0)).to(dtype)


def pencil_poisson(plan_dev, f, comm, bcs_b=None, bcs_t=None, d1y=None,
                   alpha=0.0, singular_fix: bool = True):
    """Distributed direct eigen Poisson/Helmholtz on this rank's block.

    f: (nx/px, ny, nz/pz).  plan_dev is a plan of pencil_plans (it carries
    "nkx_pad" and the padded (nkx_pad, nz) eigenvalue table
    "lam_xz_pad").  alpha != 0 solves Lap u + alpha u = f (modal
    u'' - (lam - alpha) u, as elliptic.solve_modal) with singular_fix
    False.  Returns p, or (p, dp/dy) with d1y."""
    mesh = comm["mesh"]
    nxl, ny, nzl = f.shape
    nx, nz = nxl * mesh.px, nzl * mesh.pz
    nkx_pad = plan_dev["nkx_pad"]
    fh = _forward(mesh, _with_walls(f, bcs_b, bcs_t), nkx_pad)
    chunk = nkx_pad // mesh.size
    off = kx_offset(mesh, nkx_pad)
    local = {k: plan_dev[k] for k in ("V", "W", "lam_eig", "shift")}
    local["lam_xz"] = plan_dev["lam_xz_pad"][off:off + chunk]
    if off == 0 and plan_dev.get("S_sing") is not None:
        # the (kx, kz) = (0, 0) column lives on the rank whose kx slice
        # starts at 0; z is whole after the gather
        local["S_sing"] = plan_dev["S_sing"]
    uh = elliptic.solve_modal(local, fh, alpha=alpha,
                              singular_fix=singular_fix)
    p = _backward(mesh, uh, nx, nz, f.dtype)
    if d1y is not None:
        from tlab_tpu_torch.ops.derivative import der1
        return p, der1(d1y, p, 1)
    return p


def pencil_helmholtz(plan_dev, f, comm, alpha, bcs_b=None, bcs_t=None):
    """Distributed Helmholtz solve Lap a + alpha a = f on this rank's block
    (the pencil analog of elliptic.helmholtz; reference OPR_Helmholtz at
    any task count): the [PressureFilter]/[Filter] Type=helmholtz backend
    and the SMR91 implicit diffusion on a mesh."""
    return pencil_poisson(plan_dev, f, comm, bcs_b=bcs_b, bcs_t=bcs_t,
                          alpha=alpha, singular_fix=False)


def pencil_poisson_factorize(fac_dev, f, comm, bcs_b=None, bcs_t=None):
    """Distributed factorized Poisson (Neumann walls) on this rank's block:
    the single-device solver's ODE2 composition (ops/elliptic_factorize.py)
    on the rank's kx slice.  fac_dev is the rank's plan of pencil_plans
    (its kappa and tables sliced to the slice, the singular modes it owns
    at their local index).  Returns (p, dp/dy)."""
    mesh = comm["mesh"]
    nxl, ny, nzl = f.shape
    nx, nz = nxl * mesh.px, nzl * mesh.pz
    fh = _forward(mesh, _with_walls(f, bcs_b, bcs_t), fac_dev["nkx_pad"])
    uh, vh = fac.solve_modal_factorize(fac_dev, fh, fh[:, 0, :],
                                       fh[:, -1, :], "nn")
    return (_backward(mesh, uh, nx, nz, f.dtype),
            _backward(mesh, vh, nx, nz, f.dtype))


# ---------------------------------------------------------------------------
# The rank's plan
# ---------------------------------------------------------------------------

def _nkx_pad(nx: int, n_ranks: int) -> int:
    nkx = nx // 2 + 1
    return -(-nkx // n_ranks) * n_ranks


def _pad_eigen(plan: dict, nkx_pad: int) -> dict:
    """A direct eigen plan with its (nkx, nz) table padded to nkx_pad rows
    for the tiled kx all-to-alls."""
    out = dict(plan)
    lam = plan["lam_xz"]
    pad = nkx_pad - lam.shape[0]
    out["lam_xz_pad"] = torch.cat(
        [lam, lam.new_full((pad, lam.shape[1]), LAM_PAD)]) if pad else lam
    out["nkx_pad"] = nkx_pad
    return out


def _local_factorize(mesh, plan: dict, nkx_pad: int) -> dict:
    """The rank's factorized plan: kappa padded to nkx_pad rows, sliced to
    the rank's kx modes, its per-mode tables built for that slice, and the
    singular modes it owns at their local index."""
    chunk = nkx_pad // mesh.size
    off = kx_offset(mesh, nkx_pad)
    kap = plan["kappa"]
    pad = nkx_pad - kap.shape[0]
    if pad:
        kap = torch.cat([kap, kap.new_full((pad, kap.shape[1]), KAPPA_PAD)])
    out = {k: v for k, v in plan.items() if k != "tables"}
    out["kappa"] = kap[off:off + chunk].contiguous()
    out["sing_idx"] = tuple((i - off, k) for i, k in plan["sing_idx"]
                            if off <= i < off + chunk)
    out["nkx_pad"] = nkx_pad
    out["tables"] = fac.build_tables(out)
    return out


def pencil_plans(mesh, P: dict, wire_dtype=None) -> dict:
    """P made this rank's: the comm descriptor P["comm"] = {"px", "pz",
    "wire", "mesh"}, the Poisson plans padded and sliced for the kx
    all-to-alls, and the x/z-extended tables sliced to the rank's block or
    to its gathered lines (the CFL's inverse spacings, the immersed
    boundary's mask and fills).  The buffer and the wavemaker tables are
    sliced where they are used (buffer.localize, forcing.
    localize_wavemaker), since a step's aux replaces some of them."""
    from tlab_tpu_torch import ibm as ibmmod
    px, pz = mesh.px, mesh.pz
    nx = P["sizes"][0]
    nkx_pad = _nkx_pad(nx, px * pz)
    Pp = dict(P)
    comm = {"px": px, "pz": pz, "wire": wire_dtype, "mesh": mesh}
    Pp["comm"] = comm
    for key in ("ell", "ell_stag", "ell_dd"):
        if P.get(key) is not None:
            Pp[key] = _pad_eigen(P[key], nkx_pad)
    if P.get("ell_fac") is not None:
        Pp["ell_fac"] = _local_factorize(mesh, P["ell_fac"], nkx_pad)
    if "iodx" in P:
        nxl = P["iodx"].shape[0] // px
        Pp["iodx"] = P["iodx"][mesh.ix * nxl:(mesh.ix + 1) * nxl]
    if "iodz" in P:
        nzl = P["iodz"].shape[0] // pz
        Pp["iodz"] = P["iodz"][mesh.iz * nzl:(mesh.iz + 1) * nzl]
    ibm = P.get("ibm")
    if ibm is not None:
        loc = {k: ibmmod.localize_block(v, comm) if k in ("eps", "fluid")
               else v for k, v in ibm.items()}
        if "fills" in ibm:
            shape = tuple(P["sizes"])
            loc["fills"] = {
                name: ibmmod.localize_fill(
                    fill, name, comm, shape,
                    gathered=name != "y" and comm[f"p{name}"] > 1)
                for name, fill in ibm["fills"].items()}
        Pp["ibm"] = loc
    return Pp


# ---------------------------------------------------------------------------
# Step builders (tlab_tpu's shard_map bodies)
# ---------------------------------------------------------------------------

def make_pencil_step(mesh, P, rk_step_fn, wire_dtype=None,
                     inner_steps: int = 1):
    """step(state, dtime, aux=None) -> (state, last p) on this rank's
    blocks: inner_steps full RK steps of rk_step_fn(Pp, state, dtime, aux)
    -> (state, p) with the rank's plan Pp (pencil_plans), whose P["comm"]
    routes the dycore's x/z work through the transposes.  aux leaves that
    extend over x or z are sliced to the block by the dycore."""
    Pp = pencil_plans(mesh, P, wire_dtype)

    def step(state, dtime, aux=None):
        p = None
        for _ in range(max(inner_steps, 1)):
            state, p = rk_step_fn(Pp, state, dtime, aux)
        return state, p

    step.plan = Pp
    return step


def make_pencil_filter(mesh, P, mats=None, helmholtz_alpha=None,
                       wire_dtype=None):
    """filt(state) -> state on this rank's blocks: the domain filter
    through the same engine as the step (reference OPR_FILTER at any task
    count, opr_filter.f90:200-285): x/z line-filter matrices on the
    gathered lines, y locally; Type=helmholtz through pencil_helmholtz."""
    from tlab_tpu_torch.dycore import incompressible as dyn
    from tlab_tpu_torch.ops.derivative import apply_along
    Pp = pencil_plans(mesh, P, wire_dtype)

    def one(arr):
        if helmholtz_alpha is not None:
            al = helmholtz_alpha
            return pencil_helmholtz(Pp["ell"], al * arr, Pp["comm"],
                                    al).to(arr.dtype)
        for name, ax in (("x", 0), ("y", 1), ("z", 2)):
            M = mats.get(name)
            if M is not None:
                arr = dyn._gathered_apply(
                    Pp, name, arr, lambda g, M=M, ax=ax: apply_along(M, g, ax))
        return arr

    def filt(state):
        s = state.s
        if s.shape[0]:
            s = torch.stack([one(s[i]) for i in range(s.shape[0])])
        return State(u=one(state.u), v=one(state.v), w=one(state.w), s=s,
                     sfc=state.sfc)

    filt.plan = Pp
    return filt


def make_pencil_step_particles(mesh, P, grid, pprops, wire_dtype=None):
    """Coupled flow + Lagrangian-particle step on the mesh (reference
    TIME_SUBSTEP_PARTICLE at any task count, time.f90:906 +
    particle_mpi_send_recv.f90:13), tlab_tpu's make_pencil_step_particles.

    Particles are owner-sharded fixed-capacity slots (X, V, T, M) of this
    rank (particles/parallel.py); each RK substep interpolates the
    pre-substep velocity on the halo-extended blocks, advances the
    particles and migrates the boundary crossers one ring pass a
    direction, the low-storage tendencies riding as payload.  The flow
    substep is what tlab_tpu's particle step does (tendency, q += dte h,
    h *= kco: no scalar clip, wall values, surface or immersed boundary;
    ROADMAP C 28, kept), through the stacked carry as the single-device
    particle step of the port (particles/stepping.py).
    Returns step(state, (X, V, T, M), dtime) -> (state, (X, V, T, M), p)."""
    from tlab_tpu_torch.dycore import incompressible as dyn
    from tlab_tpu_torch.particles import parallel as pp
    from tlab_tpu_torch.particles.core import wrap_positions

    Pp = pencil_plans(mesh, P, wire_dtype)
    locate = pp.make_block_locator(mesh, grid)
    kdt = tuple(P["rk"]["kdt"])
    kco = tuple(P["rk"]["kco"])
    y_lo, y_hi = float(grid.y.nodes[0]), float(grid.y.nodes[-1])
    bil = pprops.bil_cloud if pprops.type.startswith("bil_cloud") else None
    ir_field = getattr(P.get("bodyforce"), "ir_field", None) \
        if bil is not None else None

    def step(state, parts, dtime):
        from tlab_tpu_torch.dycore.state import stack, unstack
        X, V_all, T, M = parts
        V, PR = V_all[:, :3], V_all[:, 3:]
        npp = PR.shape[1]
        hpx = torch.zeros_like(X)
        hpv = torch.zeros_like(V)
        hpp = torch.zeros_like(PR)
        Q = stack(state)
        H = torch.zeros_like(Q)
        p = None
        last = len(kdt) - 1
        for i, k in enumerate(kdt):
            dte = dtime * k
            # particles first, with the PRE-substep velocity (reference
            # TIME_RUNGEKUTTA order, time.f90:220-246)
            halo = pp.halo_exchange(mesh, Q[:3])
            loc = locate(X)
            uf = torch.stack([pp.interpolate_block(halo[c], loc)
                              for c in range(3)], dim=1)
            if pprops.type == "inertia":
                acc = (uf - V) / max(pprops.stokes, 1e-30)
                acc[:, 1] -= pprops.settling
                dpx, dpv = V, acc
            elif pprops.type == "tinia":
                dpx, dpv = torch.zeros_like(X), torch.zeros_like(V)
            else:                      # tracer
                dpx, dpv = uf, torch.zeros_like(V)
            if pprops.bcs == "stick":
                at_wall = ((X[:, 1] <= y_lo) | (X[:, 1] >= y_hi))[:, None]
                dpx = torch.where(at_wall, 0.0, dpx)
                dpv = torch.where(at_wall, 0.0, dpv)
            hpx = hpx + dpx
            hpv = hpv + dpv
            if bil is not None:
                # droplet-scalar sources of the CURRENT Eulerian state with
                # the pencil operators, interpolated on the halo-extended
                # blocks (reference RHS_PART_1); one halo exchange for the
                # whole source stack
                from tlab_tpu_torch.particles import bil_cloud as bc
                now = unstack(Q, state.sfc)
                rad = ir_field(now) if ir_field is not None else None
                src = bc.eulerian_sources(Pp, now.s, P["visc"], bil,
                                          radiation=rad)
                drhs = bc.droplet_rhs(bil, pp.halo_exchange(mesh, src), loc,
                                      interp=pp.interpolate_block)
                w = min(2, npp)
                hpp = hpp.clone()
                hpp[:, :w] += drhs[:, :w]
                PR = PR + dte * hpp
            X = wrap_positions(grid, X + dte * hpx)
            V = V + dte * hpv
            # migrate the crossers; the RK carries travel as payload
            payload = torch.cat([V, hpx, hpv, PR, hpp], dim=1)
            sp = pp.ShardedParticles(x=X, v=payload, tags=T, mask=M)
            sp = pp.migrate(mesh, sp, grid, "x")
            sp = pp.migrate(mesh, sp, grid, "z")
            X, T, M = sp.x, sp.tags, sp.mask
            V = sp.v[:, 0:3]
            hpx = sp.v[:, 3:6]
            hpv = sp.v[:, 6:9]
            PR = sp.v[:, 9:9 + npp]
            hpp = sp.v[:, 9 + npp:]
            # the flow's substep, as the single-device particle step's
            H, p = dyn.substep_rhs_stacked(Pp, Q, H, dte)
            Q = Q + dte * H
            if i < last:
                a = kco[i]
                H.mul_(a)
                hpx, hpv, hpp = a * hpx, a * hpv, a * hpp
        if bil is not None:
            # post-step bookkeeping (reference time.f90:250-258): clip
            # negative liquid; variant 4 advances the residence clocks
            from tlab_tpu_torch.particles import bil_cloud as bc
            PR = PR.clone()
            PR[:, :2] = bc.liquid_clip(PR[:, :2])
            if bil.variant >= 4 and npp >= 4:
                PR[:, 2:4] = bc.residence_update(bil, dtime, X[:, 1],
                                                 PR[:, 2:4])
        return unstack(Q, state.sfc), (X, torch.cat([V, PR], dim=1), T, M), p

    step.plan = Pp
    return step


def make_pencil_step_compressible(mesh, P, step_fn, wire_dtype=None,
                                  return_scalar: bool = False):
    """step(U, dtime) on this rank's blocks of the conservative state: the
    compressible core with P["comm"] routing its x/z derivatives (the
    [D1;D2] viscous stacks gather, apply and scatter as Burgers), the NSCBC
    tangential planes and the Mach drift mesh-global.  step_fn(Pp, U,
    dtime) -> U, or (U, scalar) with return_scalar, whose scalar (the
    AirWater NewtonRs) is then the world's max (tlab_tpu's pmax)."""
    Pp = pencil_plans(mesh, P, wire_dtype)

    if return_scalar:
        def step(U, dtime):
            new_U, val = step_fn(Pp, U, dtime)
            return new_U, mesh.all_reduce(val, "max")
    else:
        def step(U, dtime):
            return step_fn(Pp, U, dtime)

    step.plan = Pp
    return step


def block_shapes(px: int, pz: int, shape) -> dict:
    """The local, x-gathered and z-gathered block shapes of a global
    (nx, ny, nz) field on a (px, pz) mesh (what K1-K3 see on each)."""
    nx, ny, nz = shape
    return {"local": (nx // px, ny, nz // pz),
            "x": (nx, ny, nz // (px * pz)),
            "z": (nx // (px * pz), ny, nz)}


def check_decomposition(px: int, pz: int, nx: int, nz: int) -> None:
    """tlab_tpu's decomposition rule (tools/dns.py:727-735), same text."""
    if (nx % px or nz % pz or (nz // pz) % px or (nx // px) % pz):
        raise ValueError(
            f"mesh ({px},{pz}) incompatible with grid ({nx},{nz}): "
            "needs nx%px==0, nz%pz==0, (nz/pz)%px==0, (nx/px)%pz==0")

