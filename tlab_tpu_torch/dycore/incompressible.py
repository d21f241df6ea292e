"""Incompressible dynamical core: fused Burgers RHS + pressure projection
on the stacked carry.  Port of the single-device Boussinesq functions of
tlab_tpu/dycore/incompressible.py (its module docstring describes the
substep, after the reference's rhs_global_incompressible_1.f90 and
time.f90 TIME_RUNGEKUTTA).

Per substep: the Burgers term nu d2(q) - u_i d1(q) along x, y and z for the
whole (3+ns) stack (convective form on a CUDA float32 stack: the
hand-written kernel of ops/burgers.py; the skew-symmetric and divergence
forms, a dealiased direction and the anelastic set: dense products, as in
tlab_tpu), the body forces (P["bodyforce"]), the pressure projection
(factorized or direct eigen Poisson, unstaggered or horizontally staggered,
optionally filtered), then the wall rows of the tendencies; q += dte h; the
scalars clipped to the plan's bounds; h *= kco.

The anelastic set (P["anelastic"]: the background density rho_bar(y) and
its inverse) weights the diffusion by 1/rho_bar, the projection's forcing
by rho_bar and the pressure gradient by 1/rho_bar, and logs div(rho_bar u).

The boundary machinery: an immersed boundary (P["ibm"]) replaces the solid
points of the stack and of the advecting velocity by their spline fill
before each direction's Burgers term, and forces the state in the solids
after each substep; buffer zones (P["buffer"]) relax the tendency toward
reference profiles before the projection, their inflow-strip references
replaced by aux["refs_x"] where an unsteady inflow feeds them; the
interactive surface BC (P["surface_bc"]) moves the wall scalars with the
flux anomaly each substep and carries its state as State.sfc.

Long lines (ops/thomas.py): a direction of 2304 points or more (the
crossovers of build_device_plans; the entry points read them from
TLAB_TPU_THOMAS_MIN_N for a line between walls and TLAB_TPU_PARTITION_MIN_N
for a periodic one) takes the substructured first derivative instead of
the dense product, and a periodic uniform one also the substructured
second derivative in its Burgers term, which then skips the kernel (as
tlab_tpu's gate does).

On the (x, z) rank mesh (parallel/, a plan of pencil.pencil_plans with
P["comm"]) the step runs on this rank's block: an x or z derivative, a
staggered operator or a line filter gathers the direction's full lines with
one all-to-all and scatters the result back (_gathered_apply); the Burgers
term gathers the fields and the advecting velocity as one stack, and the
kernel or the dense product runs on the gathered lines; the projection
solves through the pencil Poisson solvers; the surface BC's plane means are
the mesh's.  The immersed boundary's tables, the buffer's and the
wavemaker's are the block's (pencil_plans, buffer.localize,
forcing.localize_wavemaker).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from tlab_tpu_torch.constants import BC
from tlab_tpu_torch.fdm.plan import DerivPlan, FdmPlan
from tlab_tpu_torch.physics.params import NSParams
from tlab_tpu_torch import device as _device
from tlab_tpu_torch import ibm as ibmmod
from tlab_tpu_torch.dycore import buffer as bufmod
from tlab_tpu_torch.dycore import timemarch
from tlab_tpu_torch.dycore.state import State, stack, unstack
from tlab_tpu_torch.ops import burgers
from tlab_tpu_torch.ops import elliptic
from tlab_tpu_torch.ops import elliptic_factorize as fac
from tlab_tpu_torch.ops import thomas
from tlab_tpu_torch.ops.derivative import (apply_along, der1, der12,
                                           op_precision)
from tlab_tpu_torch.ops.filter import apply_filter
from tlab_tpu_torch.utils import trace as _trace


# ---------------------------------------------------------------------------
# Boundary-condition configuration (as tlab_tpu, pure NumPy)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WallBCs:
    """Tendency BCs at jmin/jmax per variable: 'dirichlet' | 'neumann' | 'none'.

    'freeslip' walls => tangential velocities neumann, normal dirichlet;
    'noslip' => all dirichlet (reference boundary_bcs.f90:114-118).
    """

    u: tuple = ("dirichlet", "dirichlet")
    v: tuple = ("dirichlet", "dirichlet")
    w: tuple = ("dirichlet", "dirichlet")
    s: tuple = (("dirichlet", "dirichlet"),)

    @staticmethod
    def from_velocity_kind(jmin: str, jmax: str,
                           scalar_bcs=(("dirichlet", "dirichlet"),)):
        def tang(kind):
            return "neumann" if kind == "freeslip" else "dirichlet"
        return WallBCs(
            u=(tang(jmin), tang(jmax)),
            v=("dirichlet", "dirichlet"),
            w=(tang(jmin), tang(jmax)),
            s=tuple(scalar_bcs),
        )


def neumann_value_rows(plan_y: DerivPlan, bot: bool, top: bool):
    """Row vectors (nb, nt) with wall value = row . u_column giving du/dy=0.

    Dense equivalent of reference BOUNDARY_BCS_NEUMANN_Y: from the Neumann-
    reduced derivative D (rows with f'_wall = 0), the wall value follows from
    the wall row of the compact system A f' = B f.
    """
    ibc = {(True, False): BC.ND, (False, True): BC.DN,
           (True, True): BC.NN}[(bot, top)]
    D = plan_y.d1[ibc]
    A1, B1 = plan_y.A1, plan_y.B1
    nb = nt = None
    if bot:
        nb = (A1[0, :] @ D - B1[0, :]) / B1[0, 0]
        nb[0] += 1.0
    if top:
        nt = (A1[-1, :] @ D - B1[-1, :]) / B1[-1, -1]
        nt[-1] += 1.0
    return nb, nt


# ---------------------------------------------------------------------------
# Device plan assembly
# ---------------------------------------------------------------------------

# the line length from which a direction takes the substructured operators
# of ops/thomas.py: tlab_tpu's default crossover, set between the power-of-two
# sizes its TPU measurement put on either side (2048 dense, 4096 banded)
BANDED_MIN_N = 2304


def banded_crossovers(banded_min_n: Optional[int] = None) -> dict:
    """build_device_plans' crossover keywords as the entry points
    (Simulation.from_case, entry.build) set them: `banded_min_n` for both
    kinds of line where it is given, else TLAB_TPU_THOMAS_MIN_N for a line
    between walls and TLAB_TPU_PARTITION_MIN_N for a periodic one, read at
    each call as tlab_tpu reads them at each plan
    (tlab_tpu/dycore/incompressible.py:136-137), each BANDED_MIN_N when
    unset."""
    if banded_min_n is not None:
        return {"banded_min_n": banded_min_n, "periodic_min_n": banded_min_n}
    return {"banded_min_n": int(os.environ.get("TLAB_TPU_THOMAS_MIN_N",
                                               BANDED_MIN_N)),
            "periodic_min_n": int(os.environ.get("TLAB_TPU_PARTITION_MIN_N",
                                                 BANDED_MIN_N))}


def build_device_plans(fdm: FdmPlan, nsp: NSParams, bcs: WallBCs,
                       rk_name: str = "RungeKuttaExplicit4",
                       dtype=torch.float32, device="cuda",
                       wall_refs=None, bodyforce=None,
                       factorize: bool = True, with_elliptic: bool = True,
                       banded_min_n: int = BANDED_MIN_N,
                       periodic_min_n: Optional[int] = None) -> dict:
    """The plan dict of operator tensors and coefficients on `device`.

    The keys of tlab_tpu's build_device_plans: P["ell"] is the direct eigen
    Poisson plan (Neumann walls), P["bodyforce"] the source hook
    (runtime.make_sources) or None.  With `factorize` (the reference's
    default formulation, for ny > 4) P["ell_fac"] holds the factorized
    Poisson plan, which the projection prefers; a caller that builds its
    own (staggered wavenumbers) or wants the direct solver passes False.
    with_elliptic=False builds no Poisson plan at all (the compressible set,
    which has no projection and allows a periodic y).

    A long line gets the substructured plans of ops/thomas.py under
    tlab_tpu's conditions: a non-periodic line of `banded_min_n` points or
    more "d1<x>_banded", a periodic uniform one of `periodic_min_n` (None:
    `banded_min_n`) or more "d1<x>_banded" and "d2<x>_banded".  The two are
    tlab_tpu's TLAB_TPU_THOMAS_MIN_N and TLAB_TPU_PARTITION_MIN_N; the
    entry points read those (banded_crossovers), this function reads no
    environment."""
    dev = _device.resolve(device)
    _device.full_fp32_matmul()
    if with_elliptic and not fdm.x.periodic:
        # tlab_tpu builds no factorized plan for it and gives its direct
        # eigen plan lam_x = 0 for every x mode (ops/elliptic.py:235), a
        # solve that leaves d/dx out of the Laplacian; its spatial cases keep
        # x periodic and damp the ends with the Imin/Imax buffers
        raise NotImplementedError(
            "non-periodic x: the Poisson solvers need periodic x (tlab_tpu "
            "solves such a case with lam_x = 0 for every x mode, leaving "
            "d/dx out of the projection; spatial cases keep x periodic and "
            "damp the ends with [BufferZone] PointsImin/PointsImax)")
    if with_elliptic and fdm.y.periodic:
        raise NotImplementedError(
            "the pressure projection needs walls in y (a periodic y is the "
            "compressible set's, which builds its plans with_elliptic=False)")
    scheme = timemarch.get_scheme(rk_name)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(dev, dtype)

    # the banded plans are rounded to the run's precision on the host, as
    # tlab_tpu's are (the fused operator F is formed from the rounded Tinv)
    nt = np.dtype(str(dtype).replace("torch.", ""))
    P = {
        "rk": {"kdt": tuple(scheme.kdt), "kco": tuple(scheme.kco),
               "ktime": tuple(scheme.ktime),
               "explicit_diffusion": "diffusion" not in rk_name.lower()},
        "visc": float(nsp.visc),
        "diff": tuple(nsp.visc / sc for sc in nsp.schmidt),
        "sizes": tuple(p.size for p in (fdm.x, fdm.y, fdm.z)),
    }
    if periodic_min_n is None:
        periodic_min_n = banded_min_n
    for name, plan in (("x", fdm.x), ("y", fdm.y), ("z", fdm.z)):
        if plan.size > 1:
            P[f"d1{name}"] = t(plan.d1[BC.DD])
            P[f"d12{name}"] = t(plan.d12[BC.DD])
            P[f"iod{name}"] = t(1.0 / plan.jac)
            if not plan.periodic:
                if plan.size >= banded_min_n:
                    P[f"d1{name}_banded"] = thomas.device_plan(
                        thomas.banded_plan(plan.A1, plan.B1, nt), dtype, dev)
            elif plan.size >= periodic_min_n and plan.uniform:
                P[f"d1{name}_banded"] = thomas.device_plan(
                    thomas.banded_plan(plan.A1, plan.B1, nt, periodic=True),
                    dtype, dev)
                P[f"d2{name}_banded"] = thomas.device_plan(
                    thomas.banded_plan(plan.A2, plan.B2, nt, periodic=True),
                    dtype, dev)

    # wall-tendency BC rows along y
    def rows_for(pair):
        bot = pair[0] == "neumann"
        top = pair[1] == "neumann"
        if not (bot or top) or fdm.y.periodic:
            return None
        # the reference uses the matched-ibc reduction; for mixed cases the
        # difference is only in the far-wall rows, which are unused
        nb, nt = neumann_value_rows(fdm.y, True, True)
        return {"nb": t(nb) if bot else None, "nt": t(nt) if top else None}

    P["bc_rows"] = {
        "u": rows_for(bcs.u), "v": rows_for(bcs.v), "w": rows_for(bcs.w),
        "s": tuple(rows_for(p) for p in bcs.s),
    }
    P["wall_bc_types"] = {"u": bcs.u, "v": bcs.v, "w": bcs.w, "s": bcs.s}
    P["wall_refs"] = wall_refs or {"u": (0.0, 0.0), "v": (0.0, 0.0),
                                   "w": (0.0, 0.0)}
    P["diffusion_constant"] = timemarch.diffusion_constant(fdm, nsp)
    P["bodyforce"] = bodyforce
    if not with_elliptic:
        return P
    with _trace.trace("runtime.elliptic_plans"):
        P["ell"] = elliptic.device_elliptic_plan(
            elliptic.build_elliptic_plan(fdm, ibc=BC.NN), dtype, dev)
        if factorize and fdm.y.size > 4:
            P["ell_fac"] = fac.device_factorize_plan(
                fac.build_factorize_plan(fdm), dtype, dev)
    return P


def scalar_bounds(mins, maxs, dtype, device):
    """The plan's "scal_bounds" entry: the [Control] MinScalar/MaxScalar
    lists as (ns, 1, 1, 1) tensors that the step clips the scalars to."""
    def t(vals):
        return torch.tensor(tuple(vals), dtype=torch.float64).to(
            device, dtype).reshape(-1, 1, 1, 1)
    return t(mins), t(maxs)


ADV_FORMS = ("convective", "skewsymmetric", "divergence")


def check_main_path(P: dict) -> None:
    """Raise if P asks for an advection form the step does not have, or
    carries a mesh descriptor that is not a rank's (pencil.pencil_plans
    makes it)."""
    comm = P.get("comm")
    if comm is not None and comm.get("mesh") is None:
        raise ValueError("plan key 'comm' without this rank's mesh: build "
                         "the plan with parallel.pencil.pencil_plans")
    if P.get("adv_form", "convective") not in ADV_FORMS:
        raise ValueError(f"advection form {P['adv_form']!r}: one of "
                         f"{ADV_FORMS}")


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------

def _axis_comm(P, axis_name: str):
    """The mesh descriptor P["comm"] where this direction is split over
    ranks (x with px > 1, z with pz > 1), else None (y never is)."""
    comm = P.get("comm")
    if comm is None or axis_name == "y":
        return None
    return comm if comm[f"p{axis_name}"] > 1 else None


def _gathered_apply(P, axis_name: str, a, fn):
    """fn on the gathered full lines of `a` (..., nxl, ny, nzl) along
    axis_name, scattered back (the OPR_Partial transpose sandwich,
    opr_partial.f90:59-142); fn(a) itself where the direction is not split.
    Shared by _d1, _d2, _stag, the compressible [D1;D2] stacks and the line
    filters."""
    comm = _axis_comm(P, axis_name)
    if comm is None:
        return fn(a)
    from tlab_tpu_torch.parallel import pencil
    off = a.ndim - 3
    g = pencil.cast_on_wire(pencil.GATHER[axis_name], comm["mesh"], a, off,
                            comm["wire"])
    return pencil.cast_on_wire(pencil.SCATTER[axis_name], comm["mesh"],
                               fn(g), off, comm["wire"])


@_trace.span("dycore.d1")
def _d1(P, axis_name: str, axis: int, a):
    """First derivative along one direction of a 3-D field or a 4-D stack
    (`axis` is valid for `a` itself): the substructured solve where the
    direction has a banded plan, else the dense product."""
    M = P.get(f"d1{axis_name}")
    if M is None:
        return torch.zeros_like(a)
    bp = P.get(f"d1{axis_name}_banded")
    if bp is not None:
        return _gathered_apply(P, axis_name, a,
                               lambda g: thomas.banded_der1(bp, g, axis))
    return _gathered_apply(P, axis_name, a, lambda g: der1(M, g, axis))


def _d2(P, axis_name: str, axis: int, a):
    """Compact second derivative along one direction (the OPR_P2 analog):
    the second half of the stacked [D1;D2] product (dense, as tlab_tpu's
    _d2 whatever the line's length)."""
    d12 = P.get(f"d12{axis_name}")
    if d12 is None:
        return torch.zeros_like(a)
    return _gathered_apply(P, axis_name, a,
                           lambda g: der12(d12, g, axis)[1])


@_trace.span("dycore.d12")
def _d12_apply(P, axis_name: str, axis: int, arr):
    """(d1 arr, d2 arr) along axis+1 of a 4-D stack: the substructured
    circulant plans of a periodic long line (2(L+2b) instead of 2N
    multiply-adds a point), else one dense [D1;D2] product."""
    b1 = P.get(f"d1{axis_name}_banded")
    b2 = P.get(f"d2{axis_name}_banded")
    if b1 is not None and b2 is not None and b1.get("periodic"):
        return (thomas.banded_der1(b1, arr, axis + 1),
                thomas.banded_der1(b2, arr, axis + 1))
    return der12(P[f"d12{axis_name}"], arr, axis + 1)


def divergence(P, u, v, w):
    return _d1(P, "x", 0, u) + _d1(P, "y", 1, v) + _d1(P, "z", 2, w)


def _stag(P, axis_name: str, which: str, a):
    """Apply a staggered-grid operator (ivp/ipv/dvp/dpv: interpolation or
    derivative, velocity to pressure nodes or back) along x or z; identity
    when the axis has no extent (2-D runs).  The operators are dense
    circulants (fdm/stagger.py), each one product."""
    M = P["stag"].get(f"{which}{axis_name}")
    if M is None:
        return a
    axis = 0 if axis_name == "x" else 2
    return _gathered_apply(P, axis_name, a, lambda g: der1(M, g, axis))


def divergence_staggered(P, u, v, w):
    """Divergence on the staggered pressure nodes (what the staggered
    projection annihilates)."""
    return (_stag(P, "z", "ivp", _stag(P, "x", "dvp", u))
            + _stag(P, "z", "ivp",
                    _stag(P, "x", "ivp", _d1(P, "y", 1, v)))
            + _stag(P, "x", "ivp", _stag(P, "z", "dvp", w)))


def _dealias_matrix(P, axis_name: str):
    """The dealiasing filter of one direction, or None."""
    dea = P.get("dealias")
    return dea.get(axis_name) if dea else None


def _fused_burgers_ok(P, axis_name: str, fields) -> bool:
    """Gate for the hand-written CUDA kernel (ops/burgers.py), the
    counterpart of tlab_tpu's _fused_burgers_ok and its call site: a
    float32 stack on CUDA, no banded plan for this direction, no anelastic
    weighting, no dealiasing filter along this direction, convective
    advection.  There is no switch to turn it off: where the gate holds,
    the kernel runs or the step raises."""
    return (fields.is_cuda and fields.dtype == torch.float32
            and P.get(f"d1{axis_name}_banded") is None
            and P.get("anelastic") is None
            and _dealias_matrix(P, axis_name) is None
            and P.get("adv_form", "convective") == "convective")


@_trace.span("ops.burgers")
def _burgers_all(P, axis_name: str, axis: int, fields, conv, nu):
    """nu d2 f - c d1 f along one direction for ALL fields of the stack.

    fields: (F, nx, ny, nz); conv: (nx, ny, nz) advecting velocity; nu:
    (F, 1, 1, 1) per-field diffusivity.

    P['adv_form'] selects the advection formulation (reference [Main]
    TermAdvection, rhs_flow_global_incompressible_1/2/3.f90):
      convective     nu d2 f - c d1 f            (default, form 1)
      skewsymmetric  nu d2 f - 0.5 (c d1 f + d1 (c f))   (form 2)
      divergence     nu d2 f - d1 (c f)                  (form 3)
    The conservative forms stack [f; c f] into one [D1;D2] product of
    width 2F.  Like a dealiased direction they are dense products, as in
    tlab_tpu, whose fused kernel computes the convective form only.

    With an immersed boundary the solid points of `fields` and `conv` are
    first replaced by the direction's spline fill (new tensors: the stack
    passed in is the state), then the kernel or the dense product runs as
    without one (tlab_tpu/dycore/incompressible.py:359-375).

    On a mesh with this direction split (P["comm"]) the fields and the
    advecting velocity go to the full lines as ONE stacked all-to-all, the
    immersed boundary's fill (then the gathered lines' table) applies there,
    the term is computed on the gathered lines -- the kernel takes the
    stack's two views as they are -- and the result is scattered back."""
    d12 = P.get(f"d12{axis_name}")
    if d12 is None:
        return torch.zeros_like(fields)
    comm = _axis_comm(P, axis_name)
    ibm = P.get("ibm")
    fill = ibm.get("fills", {}).get(axis_name) if ibm is not None else None
    if comm is None:
        if fill is not None:
            # replace solid regions by smooth interpolants before
            # derivatives (reference ibm_burgers hook, opr_burgers.f90:468)
            fields = ibmmod.apply_spline_fill(fields, fill)
            conv = ibmmod.apply_spline_fill(conv, fill)
        return _burgers_lines(P, axis_name, axis, fields, conv, nu)
    from tlab_tpu_torch.parallel import pencil
    mesh, wire = comm["mesh"], comm["wire"]
    stack = pencil.cast_on_wire(pencil.GATHER[axis_name], mesh,
                                torch.cat([fields, conv[None]]), 1, wire)
    if fill is not None:
        # the fill on the gathered full lines, where the reference fills
        # its MPI-gathered pencils (ibm_spline.f90:30)
        stack = ibmmod.apply_spline_fill(stack, fill)
    res = _burgers_lines(P, axis_name, axis, stack[:-1], stack[-1], nu)
    return pencil.cast_on_wire(pencil.SCATTER[axis_name], mesh, res, 1, wire)


def _burgers_lines(P, axis_name: str, axis: int, fields, conv, nu):
    """_burgers_all's term on whole lines of the direction (after the fill
    and, on a mesh, the gather)."""
    d12 = P[f"d12{axis_name}"]
    form = P.get("adv_form", "convective")
    if form in ("divergence", "skewsymmetric"):
        F = fields.shape[0]
        dall, d2all = _d12_apply(P, axis_name, axis,
                                 torch.cat([fields, conv[None] * fields]))
        da, d2a, dprod = dall[:F], d2all[:F], dall[F:]
        if form == "divergence":
            adv = dprod
        else:
            adv = 0.5 * (conv[None] * da + dprod)
        ane = P.get("anelastic")
        if ane is not None:
            d2a = d2a * ane["rho_inv"][None, None, :, None]
        return nu * d2a - adv
    if _fused_burgers_ok(P, axis_name, fields):
        # the kernel of TLAB_TPU_MATMUL_PRECISION's contract (the port's
        # unset default: 3xTF32), as tlab_tpu's call site
        # (tlab_tpu/dycore/incompressible.py:428-435)
        return burgers.fused_burgers(d12, fields, conv, nu.reshape(-1), axis,
                                     op_precision(fields.dtype))
    # the dense branch: one [D1;D2] product, or a long line's substructured
    # operators
    da, d2a = _d12_apply(P, axis_name, axis, fields)
    ane = P.get("anelastic")
    if ane is not None:
        # mu-constant anelastic diffusion: nu_eff = nu / rho_bar(y)
        # (reference OPR_Burgers rhoinv weighting, opr_burgers.f90:487-516)
        d2a = d2a * ane["rho_inv"][None, None, :, None]
    dea = _dealias_matrix(P, axis_name)
    if dea is not None:
        # filter the factors of the advection product before multiplying
        # (reference OPR_Burgers_1D dealiasing, opr_burgers.f90:478-499)
        return nu * d2a - apply_along(dea, conv, axis)[None] \
            * apply_along(dea, da, axis + 1)
    return nu * d2a - conv[None] * da


def _pressure_filter(P):
    """The [PressureFilter] as a function of one field, or None: a
    Helmholtz solve with the direct eigen plan (the marker dict
    {"helmholtz_alpha": alpha}), or the line-filter matrices."""
    pfil = P.get("pfilter")
    if pfil is None:
        return None
    comm = P.get("comm")
    if isinstance(pfil, dict) and "helmholtz_alpha" in pfil:
        # Type=helmholtz: one implicit elliptic solve per field
        # (opr_filter.f90:285 + opr_elliptic.f90 OPR_Helmholtz), the
        # distributed solve on a mesh
        al = pfil["helmholtz_alpha"]
        if comm is not None:
            from tlab_tpu_torch.parallel import pencil
            return lambda arr: pencil.pencil_helmholtz(
                P["ell"], al * arr, comm, al).to(arr.dtype)
        return lambda arr: elliptic.helmholtz(P["ell"], al * arr, al)
    if comm is not None and not callable(pfil):
        def filt(arr):
            for name, ax in (("x", 0), ("y", 1), ("z", 2)):
                M = pfil.get(name)
                if M is not None:
                    arr = _gathered_apply(
                        P, name, arr,
                        lambda g, M=M, ax=ax: apply_along(M, g, ax))
            return arr
        return filt
    return lambda arr: apply_filter(pfil, arr)


def _solve_pressure(P, u, v, w, h1, h2, h3, dte):
    """Pressure projection (reference rhs_global_incompressible_1.f90:
    177-360): assemble the forcing divergence, solve the Poisson problem
    with the wall-normal tendency as Neumann data, filter, and return the
    pressure-gradient components on the velocity nodes
    -> (dpdx, dpdy, dpdz, p).  The anelastic set weights the forcing and
    the Neumann data by rho_bar (the 1/rho_bar weighting of the gradient
    is the caller's)."""
    ane = P.get("anelastic")
    if P.get("remove_divergence", True):
        # default: the forcing carries q/dte so the projection removes
        # the RESIDUAL divergence too ([Main] TermDivergence=remove,
        # rhs_global_incompressible_1.f90:177)
        inv_dte = 1.0 / dte
        fx = h1 + u * inv_dte
        fy = h2 + v * inv_dte
        fz = h3 + w * inv_dte
    else:                        # TermDivergence=none
        fx, fy, fz = h1, h2, h3
    if ane is not None:
        rho = ane["rho"][None, :, None]
        fx, fy, fz = fx * rho, fy * rho, fz * rho
    stag = P.get("stag")
    if stag is not None:
        # horizontally staggered pressure (reference stagger_on branch,
        # rhs_global_incompressible_1.f90:216-320): forcing divergence
        # assembled on the pressure nodes with the VP operators
        div = divergence_staggered(P, fx, fy, fz)
        h2_s = _stag(P, "z", "ivp", _stag(P, "x", "ivp", h2))
    else:
        div = _d1(P, "y", 1, fy) + _d1(P, "x", 0, fx) + _d1(P, "z", 2, fz)
        h2_s = h2
    bcs_b, bcs_t = h2_s[:, 0, :], h2_s[:, -1, :]
    if ane is not None:
        bcs_b = bcs_b * ane["rho"][0]
        bcs_t = bcs_t * ane["rho"][-1]
    if P.get("comm") is not None:
        # the distributed solves of the rank's block (the factorized one,
        # or the direct eigen pencil with the staggered table if staggered)
        from tlab_tpu_torch.parallel import pencil
        if P.get("ell_fac") is not None:
            p, dpdy = pencil.pencil_poisson_factorize(
                P["ell_fac"], div, P["comm"], bcs_b=bcs_b, bcs_t=bcs_t)
        else:
            ell = P["ell_stag"] if stag is not None else P["ell"]
            p, dpdy = pencil.pencil_poisson(ell, div, P["comm"],
                                            bcs_b=bcs_b, bcs_t=bcs_t,
                                            d1y=P["d1y"])
    elif P.get("ell_fac") is not None:
        # reference-default factorized formulation: stage-consistent dpdy
        # removes divergence to round-off (opr_elliptic.f90:108-110); when
        # staggered, the plan carries the staggered-derivative wavenumbers
        p, dpdy = fac.poisson_factorize(P["ell_fac"], div,
                                        bcs_b=bcs_b, bcs_t=bcs_t)
    else:
        # direct eigen pencil; staggered runs use the staggered-wavenumber
        # table: the unstaggered one would not annihilate the staggered
        # divergence
        ell = P["ell_stag"] if stag is not None else P["ell"]
        p, dpdy = elliptic.poisson(ell, div, bcs_b=bcs_b, bcs_t=bcs_t,
                                   d1y=P["d1y"])
    filt = _pressure_filter(P)
    if filt is not None:
        # [PressureFilter]: filter p and dp/dy after the Poisson solve
        # (rhs_global_incompressible_1.f90:287-291) -- stabilizes the
        # staggered scheme's near-Nyquist pressure modes
        p = filt(p)
        dpdy = filt(dpdy)
    if stag is not None:
        # pressure gradient back on velocity nodes with the PV operators
        # (reference rhs_global_incompressible_1.f90:307-320)
        dpdx = _stag(P, "z", "ipv", _stag(P, "x", "dpv", p))
        dpdy = _stag(P, "x", "ipv", _stag(P, "z", "ipv", dpdy))
        dpdz = _stag(P, "x", "ipv", _stag(P, "z", "dpv", p))
    else:
        dpdx = _d1(P, "x", 0, p)
        dpdz = _d1(P, "z", 2, p)
    return dpdx, dpdy, dpdz, p


def _apply_wall_rows_stacked(H, i, rows):
    """Set the j=0 / j=ny-1 rows of tendency i of the stack H in place:
    Dirichlet rows to 0, Neumann rows to the value with zero wall-normal
    derivative (the nt row sees the updated j=0 row, as in tlab_tpu)."""
    nb = nt = None
    if rows is not None:
        nb, nt = rows["nb"], rows["nt"]
    H[i, :, 0, :] = torch.matmul(nb, H[i]) if nb is not None else 0.0
    H[i, :, -1, :] = torch.matmul(nt, H[i]) if nt is not None else 0.0
    _trace.count("library.cublas", (nb is not None) + (nt is not None))


# aux keys of tlab_tpu's step that the port does not carry
_AUX_OFF_PATH = {"fac_tables": "ROADMAP 'Do not port' (the factorize tables "
                               "are part of the plan)"}


def _visc_scale(aux) -> float:
    """The [ViscChange] ramp's factor on every diffusivity, from the step's
    aux dict (1.0 without one).  'rtime', the step's time, passes through
    to the body forces, 'refs_x' (an unsteady inflow's planes) to the
    buffer; the other keys of tlab_tpu's aux raise."""
    if not aux:
        return 1.0
    for key in aux:
        if key not in ("visc_scale", "rtime", "refs_x"):
            raise NotImplementedError(
                f"aux key {key!r}: "
                + _AUX_OFF_PATH.get(key, "the step knows no such key"))
    return float(aux.get("visc_scale", 1.0))


@_trace.span("dycore.substep")
def substep_rhs_stacked(P, Q, H, dte, aux=None):
    """The tendency of one substep on the stacked carry Q, H
    (3+ns, nx, ny, nz), rows u, v, w, s1..  Returns (H_new, p); H is not
    modified (H_new is a new tensor, updated in place below).  aux:
    {"visc_scale": factor} scales the diffusivities ahead of the Burgers
    terms; {"rtime": t} is the step's time for a time-dependent forcing
    (the wavemaker); {"refs_x": name -> (1, ny, nz|1)} replaces the
    buffer's inflow-strip references (an unsteady inflow)."""
    check_main_path(P)
    u, v, w = Q[0], Q[1], Q[2]
    visc = P["visc"]
    scale = _visc_scale(aux)
    nu = torch.tensor([d * scale for d in (visc,) * 3 + tuple(P["diff"])],
                      dtype=Q.dtype, device=Q.device).reshape(-1, 1, 1, 1)
    # accumulate in place: one (3+ns)-field stack less alive at a time
    adv = _burgers_all(P, "x", 0, Q, u, nu)
    adv += _burgers_all(P, "y", 1, Q, v, nu)
    adv += _burgers_all(P, "z", 2, Q, w, nu)
    H = adv.add_(H)

    if P.get("bodyforce") is not None:
        # the sources add into the rows of H (views), in tlab_tpu's order:
        # Burgers, sources, projection, wall rows; what a hook returns as a
        # new tensor (tlab_tpu's hooks are functional) is copied into its row
        rows = (H[0], H[1], H[2], H[3:])
        forced = P["bodyforce"](P, State(u=u, v=v, w=w, s=Q[3:]), *rows,
                                aux=aux)
        for row, new in zip(rows, forced):
            if new is not row:
                row.copy_(new)

    buf = P.get("buffer")
    if buf is not None:
        # buffer/sponge relaxation before the projection, into H's rows
        # (reference rhs_global_incompressible_1.f90:172); an unsteady
        # inflow's planes replace the Imin/Imax strips' references
        if aux and "refs_x" in aux:
            buf = dict(buf, refs_x=aux["refs_x"])
        bufmod.relax_stack(bufmod.localize(buf, P.get("comm")), Q, H)

    dpdx, dpdy, dpdz, p = _solve_pressure(P, u, v, w, H[0], H[1], H[2], dte)
    ane = P.get("anelastic")
    if ane is not None:
        ri = ane["rho_inv"][None, :, None]
        dpdx, dpdy, dpdz = ri * dpdx, ri * dpdy, ri * dpdz
    H[0] -= dpdx
    H[1] -= dpdy
    H[2] -= dpdz

    rows = P["bc_rows"]
    _apply_wall_rows_stacked(H, 0, rows["u"])
    _apply_wall_rows_stacked(H, 1, rows["v"])
    _apply_wall_rows_stacked(H, 2, rows["w"])
    for i in range(Q.shape[0] - 3):
        _apply_wall_rows_stacked(H, 3 + i, rows["s"][i])
    return H, p


def _enforce_wall_rows(P, Q) -> None:
    """Re-impose Dirichlet wall values on the stacked carry Q, in place
    (reference applies BcsFlowJmin/Jmax%ref each substep, boundary_bcs.f90):
    no-penetration v=0 always; u/w pinned for no-slip walls.  Protects
    against ICs or round-off drift depositing values on pinned rows."""
    kinds = P["wall_bc_types"]
    refs = P["wall_refs"]
    for i, name in ((1, "v"), (0, "u"), (2, "w")):
        for side in (0, 1):
            if kinds[name][side] == "dirichlet":
                Q[i, :, (0, -1)[side], :] = refs[name][side]


def _surface_anomalies(P, s_pre):
    """The flux anomalies of surface_bc_step from the scalars before the
    substep's update: (bottom, top), each (ns, nx, nz) or None where that
    side does not couple.

    Bottom: hfx = diff d1y[0].s, anomaly hfx - <hfx>.  Top: hfx = -diff
    d1y[-1].s, and its average is the reference's: +diff times the BOTTOM
    plane's mean derivative (AVG1V2D at j=1, boundary_bcs.f90:531-537), as
    tlab_tpu mirrors it.  <.> is the plane mean (tlab_tpu's pmean: on a
    mesh the mean of the blocks' means)."""
    sbc = P.get("surface_bc")
    d1y = P["d1y"]
    diff = torch.tensor(P["diff"], dtype=s_pre.dtype,
                        device=s_pre.device)[:, None, None]
    comm = P.get("comm")

    def pmean(a):
        m = torch.mean(a, dim=(1, 2), keepdim=True)
        return comm["mesh"].mean(m) if comm is not None else m

    def couples(cpl):
        return cpl is not None and any(c != 0.0 for c in cpl)

    bottom = top = None
    if couples(sbc.get("cpl_jmin")):
        hfx = diff * torch.matmul(d1y[0], s_pre)
        bottom = hfx - pmean(hfx)
    if couples(sbc.get("cpl_jmax")):
        hfx = -diff * torch.matmul(d1y[-1], s_pre)
        top = hfx - pmean(diff * torch.matmul(d1y[0], s_pre))
    return bottom, top


def _surface_update(P, s, sfc, anomalies, dte) -> None:
    """sfc[side] += cpl anomaly, then the wall row of s += dte sfc[side], in
    place on s (ns, nx, ny, nz) and sfc (2, ns, nx, nz)."""
    sbc = P["surface_bc"]
    for side, (anom, key, j) in enumerate(zip(
            anomalies, ("cpl_jmin", "cpl_jmax"), (0, -1))):
        if anom is None:
            continue
        cpl = torch.tensor(sbc[key], dtype=s.dtype,
                           device=s.device)[:, None, None]
        sfc[side] += cpl * anom
        s[:, :, j, :] += dte * sfc[side]


def surface_bc_step(P, s_pre, s_new, sfc, dte):
    """Interactive (linear) surface BC (reference BOUNDARY_BCS_SURFACE_Y,
    boundary_bcs.f90:478-545 + the hs wall-row imposition,
    rhs_global_incompressible_1.f90:390-396):

        ref += cpl (hfx - <hfx>)        (per substep, flux of the
                                         PRE-update scalar)
        wall TENDENCY = ref  =>  s_wall += dte ref

    The persistent surface state ref rides as State.sfc (2, ns, nx, nz);
    sides with SfcType=static keep ref = 0 (frozen Dirichlet wall).
    Returns (s_updated, sfc_updated), new tensors; the step does the same
    in place on its carry."""
    if P.get("surface_bc") is None or s_new.shape[0] == 0 or sfc is None:
        return s_new, sfc
    s_new, sfc = s_new.clone(), sfc.clone()
    _surface_update(P, s_new, sfc, _surface_anomalies(P, s_pre), dte)
    return s_new, sfc


def _rk_core_stacked(P, Q, dtime, kdt, kco, aux=None, sfc=None):
    """One low-storage RK step on the stacked carry.  Updates Q (and sfc,
    the surface state where P["surface_bc"] couples) in place -- the
    callers pass a carry they own -- and returns (Q, last p).

    A substep, in tlab_tpu's order (_rk_substep): the tendency; q += dte h;
    the scalars clipped; the interactive surface BC, from the fluxes of the
    scalars before the update; the immersed boundary's direct forcing;
    h *= kco."""
    H = torch.zeros_like(Q)
    p = None
    last = len(kdt) - 1
    bounds = P.get("scal_bounds")      # (mins, maxs), each (ns, 1, 1, 1)
    surface = P.get("surface_bc") is not None and sfc is not None \
        and Q.shape[0] > 3
    ibm = P.get("ibm")
    for i, k in enumerate(kdt):
        dte = dtime * k
        H, p = substep_rhs_stacked(P, Q, H, dte, aux)
        if surface:
            anomalies = _surface_anomalies(P, Q[3:])
        Q.add_(H, alpha=dte)
        if bounds is not None and Q.shape[0] > 3:
            # per-substep scalar clipping (reference DNS_BOUNDS_LIMIT,
            # dns_local.f90:67-90)
            torch.clamp(Q[3:], min=bounds[0], max=bounds[1], out=Q[3:])
        if surface:
            _surface_update(P, Q[3:], sfc, anomalies, dte)
        if ibm is not None:
            # direct forcing: zero state in solids after the substep
            # (reference dns_main.f90:254-257)
            ibmmod.force_stack(ibm, Q)
        if i < last:
            H.mul_(kco[i])
    return Q, p


def _surface_state(P, state: State):
    """The surface state the step updates: a copy of state.sfc, or zeros
    (2, ns, nx, nz) where the plan couples and the state has none
    (tlab_tpu creates it in rk_step, :854-858, and in dns.run); state.sfc
    itself where nothing couples."""
    if P.get("surface_bc") is None or not state.s.shape[0]:
        return state.sfc
    if state.sfc is None:
        ns, nx, _, nz = state.s.shape
        return state.s.new_zeros((2, ns, nx, nz))
    return state.sfc.clone()


def rk_step(P, state: State, dtime, aux=None):
    """One full low-storage RK step; returns (new_state, last pressure)."""
    sfc = _surface_state(P, state)
    Q = stack(state)
    _enforce_wall_rows(P, Q)
    Q, p = _rk_core_stacked(P, Q, dtime, P["rk"]["kdt"], P["rk"]["kco"],
                            aux, sfc)
    return unstack(Q, sfc), p


def rk_loop_stacked(P, state: State, dtime, n_steps: int, aux=None):
    """n_steps full RK steps with the State<->stack conversion done once.
    Returns (state, last p).  With an immersed boundary or a surface BC the
    walls are pinned again each step, as tlab_tpu's loop of rk_step does
    for those plans (:900-905); the surface state is created before the
    loop (tlab_tpu's loop would need it in state.sfc already)."""
    sfc = _surface_state(P, state)
    Q = stack(state)
    p = torch.zeros_like(Q[0])
    each_step = P.get("ibm") is not None or P.get("surface_bc") is not None
    for n in range(n_steps):
        if n == 0 or each_step:
            _enforce_wall_rows(P, Q)
        Q, p = _rk_core_stacked(P, Q, dtime, P["rk"]["kdt"], P["rk"]["kco"],
                                aux, sfc)
    return unstack(Q, sfc), p


# ---------------------------------------------------------------------------
# Diagnostics for the step log / adaptive dt
# ---------------------------------------------------------------------------

@_trace.span("dycore.diagnostics")
def cfl_advective_max(P, state: State):
    """max(|u|/dx + |v|/dy + |w|/dz), cf. reference TIME_COURANT."""
    acc = 0.0
    if "iodx" in P:
        acc = acc + torch.abs(state.u) * P["iodx"][:, None, None]
    if "iody" in P:
        acc = acc + torch.abs(state.v) * P["iody"][None, :, None]
    if "iodz" in P:
        acc = acc + torch.abs(state.w) * P["iodz"][None, None, :]
    return torch.max(acc)


@_trace.span("dycore.diagnostics")
def dilatation_minmax(P, state: State):
    """Dilatation extrema for the step log / bounds control (on the
    pressure nodes for a staggered run).  Anelastic runs monitor the
    CONSTRAINT residual div(rho_bar u) -- the reference weights the
    velocity by rbackground before FI_INVARIANT_P (dns_local.f90:158-166)
    -- so a healthy anelastic run logs round-off, not the physical
    div(u) = -v dlnrho/dy."""
    div = divergence_staggered if P.get("stag") is not None else divergence
    ane = P.get("anelastic")
    if ane is not None:
        r = ane["rho"][None, :, None]
        d = div(P, state.u * r, state.v * r, state.w * r)
    else:
        d = div(P, state.u, state.v, state.w)
    return torch.min(d), torch.max(d)


def next_dt(P, cfl_max_value, cfla, cfld):
    """Host-side dt selection (reference TIME_COURANT final ops); the
    diffusion limit applies only to fully explicit schemes
    (time.f90:530-534, RKM_EXP3/EXP4).  A semi-implicit run starting
    from REST (cfl max 0) still needs a finite dt, so the diffusion
    limit serves as the cold-start fallback."""
    cfl_max_value = float(cfl_max_value)
    dtc = cfla / cfl_max_value if cfl_max_value > 0 else np.inf
    dconst = P["diffusion_constant"]
    dtd = cfld / dconst if dconst > 0 else np.inf
    if not P["rk"].get("explicit_diffusion", True):
        return dtc if np.isfinite(dtc) else dtd
    return min(dtc, dtd)
