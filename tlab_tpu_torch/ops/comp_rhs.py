"""The compressible internal-energy right-hand side's pointwise algebra in
fused fp32 kernels (csrc/comp_rhs.cu), around its derivative products.

They replace no TPU kernel: tlab_tpu's compressible right-hand side is
left to XLA, which fuses the algebra around its products; the port ran it
as ~150 PyTorch elementwise passes a substep (primitives, fluxes, the sums
of the divergences, stresses, dissipation, Laplacians, the scalar's cross
terms).  What bounds it on an H100 is bytes, so each kernel makes one pass
over the points, reading each input and writing each output once:

- ``flux(axis, U, cT, cP, prim)``: the direction's fluxes [rho u u_d + p
  delta_1d, rho v u_d + p delta_2d, rho w u_d + p delta_3d, rho e u_d, rho
  s u_d] (4 + ns fields, one tensor) from the state, and with ``prim`` the
  stack [u, v, w, T] and s that the [D1;D2] products take (entry points
  comp_flux_x/y/z);
- ``assemble(axis, der, h, grads, first, last, ...)``: the direction's
  derivatives into the tendencies h (5 + ns fields, one tensor; written by
  the first direction, added to by the others), the direction's velocity
  gradients kept for the last direction, which adds Phi - p div u to the
  energy and returns div u (comp_assemble_x/y/z);
- ``final(h, dd, mu)``: (mu / 3) d_i(div u) into the momentum tendencies
  (comp_final).

dycore/compressible.py (``_rhs_internal_fused``) calls them in that order.
On a CPU tensor each runs its plain version, the same algebra in PyTorch
(the tests'); on a CUDA tensor it launches the kernel or raises.  Under
the NaN trap's per-op check each call is one op named after its entry
point.  Launches are counted in ``launches``, the span registry's counter
dycore.comp_fused.k.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from tlab_tpu_torch.ops import _build
from tlab_tpu_torch.utils import nantrap
from tlab_tpu_torch.utils import trace as _trace

# the kernels' own limit (csrc/comp_rhs.cu kMaxScalars): scalars a call
MAX_SCALARS = 8
_SLOTS = 16
_MU, _COND, _CT, _CP, _DIFF = range(5)
# each entry point's arguments: the in and out slots, the point count, its
# int arguments, the coefficients and the stream
_INTS = {**{f"comp_flux_{d}": 1 for d in "xyz"},
         **{f"comp_assemble_{d}": 3 for d in "xyz"}, "comp_final": 0}
_entries: dict = {}

# launches by entry point, counted where a launch is made
launches: dict = {}


def reset_launches() -> None:
    launches.clear()


# the span registry's counter dycore.comp_fused.k, set to 0 by its reset()
_trace.source("dycore.comp_fused.k", lambda: sum(launches.values()),
              reset_launches)


class Derivs(NamedTuple):
    """One direction's derivatives that assemble() takes: d of the mass
    flux rho u_d, of the flux() fields (momentum 0-2, energy 3, the scalars
    4..), (d1, d2) of [u, v, w, T] and of s, and d rho (None without
    scalars)."""
    mass: torch.Tensor
    flux: tuple
    d1: torch.Tensor
    d2: torch.Tensor
    s1: Optional[torch.Tensor] = None
    s2: Optional[torch.Tensor] = None
    rho: Optional[torch.Tensor] = None


def _coef(mu=0.0, cond=0.0, cT=0.0, cP=0.0, diff=()):
    c = [0.0] * _SLOTS
    c[_MU], c[_COND], c[_CT], c[_CP] = mu, cond, cT, cP
    c[_DIFF:_DIFF + len(diff)] = diff
    return c


def _checked(name: str, fn, inputs):
    """fn() as one op of the NaN trap's per-op check, named `name`: its
    results checked where the check is live."""
    if not nantrap.checking():
        return fn()
    with nantrap.suspended():
        res = fn()
    nantrap.check(res, name, inputs)
    return res


def _entry(name: str):
    """The library's entry point `name`, its arguments bound at the first
    call."""
    if not _entries:
        lib = _build.library("comp_rhs")
        for entry, k in _INTS.items():
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] \
                + [ctypes.c_int] * k + [ctypes.c_void_p] * 2
            fn.restype = ctypes.c_int
            _entries[entry] = fn
    return _entries[name]


def _launch(name: str, ref, ins, outs, ints, coef) -> None:
    """The entry point `name` on `ref`'s device and stream: pointer slots
    `ins` and `outs` (None for a field that is not there; float32, the
    outputs contiguous), the int arguments `ints` after the point count,
    the coefficient slots `coef`."""
    ins = [None if t is None else t.contiguous() for t in ins]
    for t in (*ins, *outs):
        if t is None:
            continue
        if t.device != ref.device:
            raise ValueError(f"{name}: a field is on {t.device}, the state "
                             f"on {ref.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32, got {t.dtype}")
    n = ref.numel()
    fn = _entry(name)

    def slots(ts):
        ptrs = [None if t is None else t.data_ptr() for t in ts]
        return (ctypes.c_void_p * _SLOTS)(*ptrs, *[None] * (_SLOTS - len(ts)))
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        err = fn(slots(ins), slots(outs), n, *ints,
                 (ctypes.c_float * _SLOTS)(*coef), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launches[name] = launches.get(name, 0) + 1


def _check_scalars(ns: int) -> None:
    if ns > MAX_SCALARS:
        raise ValueError(f"the kernels take at most {MAX_SCALARS} scalars, "
                         f"got {ns}")


def flux(axis: int, U, cT: float, cP: float, prim: bool):
    """(fluxes (4 + ns, ...), [u, v, w, T] (4, ...) or None, s (ns, ...) or
    None) of the state U (dycore.compressible.CompState, rho e in its fifth
    field) along spatial axis `axis`, T = (rho e / rho) cT and p = rho T
    cP; the primitives where `prim`."""
    ns = 0 if U.rhos is None else U.rhos.shape[0]
    name = f"comp_flux_{'xyz'[axis]}"
    return _checked(name, lambda: _flux(axis, U, ns, cT, cP, prim, name),
                    tuple(U))


def _flux(axis, U, ns, cT, cP, prim, name):
    rho = U.rho
    if rho.device.type == "cpu":
        return flux_plain(axis, U, cT, cP, prim)
    _check_scalars(ns)
    f = rho.new_empty((4 + ns,) + rho.shape)
    st = rho.new_empty((4,) + rho.shape) if prim else None
    s = rho.new_empty((ns,) + rho.shape) if prim and ns else None
    _launch(name, rho, tuple(U[:5]) + (U.rhos,), (f, st, s), (ns,),
            _coef(cT=cT, cP=cP))
    return f, st, s


def flux_plain(axis: int, U, cT: float, cP: float, prim: bool):
    """flux() in PyTorch, on any device and type."""
    rho = U.rho
    vel = [m / rho for m in (U.rhou, U.rhov, U.rhow)]
    T = U.rhoE / rho * cT
    p = rho * T * cP
    ud = vel[axis]
    rows = [m * ud for m in (U.rhou, U.rhov, U.rhow)]
    rows[axis] = rows[axis] + p
    rows.append(U.rhoE * ud)
    f = torch.stack(rows)
    s = None
    if U.rhos is not None:
        f = torch.cat([f, U.rhos * ud[None]])
        s = U.rhos / rho[None] if prim else None
    return f, (torch.stack(vel + [T]) if prim else None), s


def assemble(axis: int, der: Derivs, U, h, grads: dict, first: bool,
             last: bool, mu: float, cond: float, cT: float, cP: float,
             diff=()):
    """Add direction `axis`'s terms to the tendencies h (5 + ns, ...), a
    new tensor where `first` (h is then ignored): -d(rho u_d), -d(flux_i)
    + mu d2 u_i, -d(rho e u_d) + cond d2 T, -d(rho s u_d) + diff (rho d2 s
    + d rho d s).  Returns (h, g, divu): g the direction's velocity
    gradients (3, ...) where not `last`; where `last`, divu, with Phi - p
    div u added to the energy from these gradients and those of `grads`
    (spatial axis -> g of an earlier direction; a direction missing there
    contributes none)."""
    ns = 0 if U.rhos is None else U.rhos.shape[0]
    if len(diff) != ns:
        raise ValueError(f"{len(diff)} diffusivities for {ns} scalars")
    name = f"comp_assemble_{'xyz'[axis]}"
    args = (axis, der, U, h, grads, first, last, mu, cond, cT, cP, diff)
    return _checked(name, lambda: _assemble(name, ns, *args),
                    (der, tuple(U), grads))


def _assemble(name, ns, axis, der, U, h, grads, first, last, mu, cond, cT,
              cP, diff):
    rho = U.rho
    if rho.device.type == "cpu":
        return assemble_plain(axis, der, U, h, grads, first, last, mu, cond,
                              cT, cP, diff)
    _check_scalars(ns)
    if first:
        h = rho.new_empty((5 + ns,) + rho.shape)
    g = None if last else rho.new_empty((3,) + rho.shape)
    divu = rho.new_empty(rho.shape) if last else None
    fl = der.flux
    ins = (der.mass, fl[0], fl[1], fl[2], fl[3], fl[4] if ns else None,
           der.d1, der.d2, der.s1, der.s2, der.rho, rho, U.rhoE,
           grads.get(0), grads.get(1), grads.get(2))
    _launch(name, rho, ins, (h, g, divu),
            (ns, int(first), int(last)),
            _coef(mu, cond, cT, cP, diff))
    return h, g, divu


def assemble_plain(axis: int, der: Derivs, U, h, grads: dict, first: bool,
                   last: bool, mu: float, cond: float, cT: float, cP: float,
                   diff=()):
    """assemble() in PyTorch, on any device and type (h is updated in
    place where not `first`)."""
    rho = U.rho
    ns = 0 if U.rhos is None else U.rhos.shape[0]
    fl = der.flux
    terms = [-der.mass] \
        + [-fl[c] + mu * der.d2[c] for c in range(3)] \
        + [-fl[3] + cond * der.d2[3]]
    for q in range(ns):
        terms.append(-fl[4][q] + diff[q] * (rho * der.s2[q]
                                            + der.rho * der.s1[q]))
    new = torch.stack(terms)
    if first:
        h = new
    else:
        h += new
    if not last:
        return h, der.d1[:3], None
    G = [der.d1[:3] if d == axis else grads.get(d) for d in range(3)]
    G = [torch.zeros_like(der.d1[:3]) if g is None else g for g in G]
    (ux, vx, wx), (uy, vy, wy), (uz, vz, wz) = G
    divu = ux + vy + wz
    lam = -2.0 / 3.0
    txx = mu * (2.0 * ux + lam * divu)
    tyy = mu * (2.0 * vy + lam * divu)
    tzz = mu * (2.0 * wz + lam * divu)
    phi = (txx * ux + tyy * vy + tzz * wz + mu * (uy + vx) * (uy + vx)
           + mu * (uz + wx) * (uz + wx) + mu * (vz + wy) * (vz + wy))
    p = rho * (U.rhoE / rho * cT) * cP
    h[4] += phi - p * divu
    return h, None, divu


def final(h, dd, mu: float):
    """h[1 + i] += (mu / 3) dd[i], dd the derivatives of div u along x, y,
    z (None where a direction has none), in place; returns h."""
    return _checked("comp_final", lambda: _final(h, dd, mu),
                    tuple(dd))


def _final(h, dd, mu):
    if h.device.type == "cpu":
        return final_plain(h, dd, mu)
    _launch("comp_final", h[0], tuple(dd), (h,), (),
            _coef(mu=mu / 3.0))
    return h


def final_plain(h, dd, mu: float):
    """final() in PyTorch, on any device and type."""
    for c, d in enumerate(dd):
        if d is not None:
            h[1 + c] += mu / 3.0 * d
    return h
