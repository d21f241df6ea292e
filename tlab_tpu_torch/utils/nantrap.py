"""The NaN trap: `--debug-nans` and `[Main] DebugNans=yes|true` (port of
tlab_tpu/tools/cli.py:129-133, the flag, and :178-179 and :213-216, where
the flag and the case key set jax.config's jax_debug_nans).

What it ports is jax_debug_nans as tlab_tpu uses it, and nothing more: it
traps NaN, not Inf (tlab_tpu never sets jax_debug_infs), and raises
FloatingPointError("invalid value (nan) encountered in <op>").  The trap
changes no number: a run with it on computes what the run without it
computes, through the same kernels, and only reads flags besides.

jax_debug_nans checks the outputs of each dispatched computation: each
eager primitive, or each jax.jit call as a whole; on a hit it runs the
computation again op by op to name the primitive that made the NaN.  The
port has no jit, so both levels are here:

- A region (`region(name, fn, mesh)`) stands for one of tlab_tpu's jit
  boundaries.  It runs fn with the per-op check off, then one reduction
  over the floating and complex tensors (and NumPy arrays) it returned and
  one flag read by the host (on a rank mesh the world's MAX of the ranks'
  flags, so that every rank raises at the same step).  On a hit it runs fn
  again, from the copy of its inputs taken at entry, under the per-op
  check, which names the op.  A NaN made inside a region and masked away
  before its output does not trap, as in tlab_tpu.  Regions nested in a
  region, or met in a re-run, are part of it.
- The per-op check (`_PerOp`, a TorchDispatchMode) checks what every aten
  op wrote: its output tensors, or its mutated arguments (in-place and
  out= ops).  It is the trap outside regions, where tlab_tpu runs eager
  ops, and the locator inside them.  Factory and copy ops make no NaN and
  are not checked (an `empty` holds whatever the memory held), nor are
  views and the collectives (c10d returns work handles; a NaN a rank
  receives was made, and checked, where it was sent).  The Burgers kernels
  launch through ctypes, where no dispatcher sees them:
  ops/burgers.fused_burgers checks its own output and names its entry
  point (`check`).
On a rank mesh a re-run does not stop at the op: every rank runs its
region to its end (its collectives then match), keeps the first op that
made a NaN from inputs that held none, and the ranks agree on the lowest
rank that found one; every rank raises with that op.

The trap is on inside `trap(True)`: the CLI holds it over a whole command,
dns.run and the post-processing entry points take `debug_nans=` and hold
it over their work.

Regions, and tlab_tpu's jit each stands for (tlab_tpu/tools/dns.py unless
named):

| Region (port) | tlab_tpu |
| --- | --- |
| `tools/dns.make_step_functions` step: `incompressible.rk_step`, `rk_loop_stacked`, `implicit.rk_step_implicit` with the diagnostics | `:354` (`_step`), `:324` (`_step`, unsteady inflow) |
| the same with particles: `particles/stepping.rk_step_with_particles` | `:420` (`step`) |
| the pencil step (`parallel/pencil.make_pencil_step`, `make_pencil_step_particles`) with the mesh's diagnostics | `parallel/pencil.py:283` (`_mesh_jit`), `:372`, `:404` (`_mesh_diag`, `_pdiag`) |
| the compressible set's `make_step_functions` step (`tools/dns._compressible_step_functions`: ideal gas, mixtures, AirWater, on a mesh) | `:208`, `:225` (`_comp_step`), `:145`, `:185` (`_aw_diag`, `_comp_diag`) |
| the step-0 diagnostics (`diagnostics`, read by `tools/dns._run`, the one time loop of both sets) | `:428`, `:156`, `:198`, `:218`, `:245` (`cfl_only`) |
| the filter sponge and the [Filter] cadence (`_Ranks.filters`) | `:869` (`sponge_fn`), `:890` (`filter_fn`) |
| `stats/averages.stats_tables` | `stats/averages.py:168` (`make_stats_tables_fn`) |
| `tools/dns._inrun_pdfs_spectra` | `:515` (`compute`) |
| `tools/dns.write_statistics_compressible` | `:644` (`compute`) |
| the spatial mode's gradients and sums (`velocity_gradients` of `tools/dns._incompressible`, the reducer of `_compressible`) | `:990` (`spatial_grads_fn`), `stats/spatial.py:110`, `:592` |
| the diagnostic pressure of planes, towers, PhaseAvg (`dycore/pressure.pressure_boussinesq`, `tools/dns._incompressible`'s `pressure`) | eager in tlab_tpu |
| each post-processing command's per-snapshot computation (`tools/postprocess`) | eager in tlab_tpu |
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

_aten = torch.ops.aten
# ops that make no NaN: factories (whose memory is not a result) and copies
_UNCHECKED = {getattr(_aten, n) for n in (
    "empty", "empty_like", "empty_strided", "empty_permuted", "new_empty",
    "new_empty_strided", "_to_copy", "copy_", "clone", "detach", "alias",
    "lift_fresh", "lift_fresh_copy", "set_", "resize_",
    "_local_scalar_dense") if hasattr(_aten, n)}
_NAME_BYTES = 160

_state = {"on": False, "mode": None, "depth": 0}


def active() -> bool:
    """Whether the trap is on."""
    return _state["on"]


def checking() -> bool:
    """Whether the per-op check is live (the trap is on, outside a region,
    or in a region's re-run)."""
    return _state["mode"] is not None


def _floats(tree) -> list:
    """The floating and complex tensors and NumPy arrays of a pytree."""
    out = []
    for a in _pytree.tree_leaves(tree):
        if torch.is_tensor(a):
            if (a.is_floating_point() or a.is_complex()) \
                    and a.layout == torch.strided and a.numel():
                out.append(a)
        elif isinstance(a, np.ndarray) and a.dtype.kind in "fc":
            out.append(a)
    return out


def _has_nan(arrays) -> bool:
    """Whether any of `arrays` holds a NaN (a host read a tensor)."""
    for a in arrays:
        if torch.is_tensor(a):
            if bool(torch.isnan(a).any()):
                return True
        elif np.isnan(a).any():
            return True
    return False


def _message(op: str, where: str = "") -> str:
    return f"invalid value (nan) encountered in {op}" + where


class _PerOp(TorchDispatchMode):
    """The per-op check.  record=False raises at the first op whose
    result holds NaN; record=True (a re-run on a rank mesh) keeps the
    first op that made a NaN from inputs that held none (else the first
    whose result held one) and raises nothing."""

    def __init__(self, record: bool = False):
        super().__init__()
        self.record = record
        self.made = None
        self.first = None

    def hit(self, op: str, inputs=()) -> None:
        if not self.record:
            raise FloatingPointError(_message(op))
        if self.first is None:
            self.first = op
        if self.made is None and not _has_nan(_floats(inputs)):
            self.made = op

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten" or func.overloadpacket in _UNCHECKED \
                or func.is_view:
            return out
        mutated = _floats([args[i] if i < len(args) else kwargs.get(a.name)
                           for i, a in enumerate(func._schema.arguments)
                           if a.alias_info is not None
                           and a.alias_info.is_write])
        written = _floats(out) or mutated
        if written and _has_nan(written):
            inputs = ()
            if self.record:
                # what the op read: its arguments but the ones it wrote
                wrote = {t.untyped_storage().data_ptr() for t in mutated}
                inputs = [t for t in _floats((args, kwargs))
                          if t.untyped_storage().data_ptr() not in wrote]
            self.hit(str(func), inputs)
        return out


@contextlib.contextmanager
def _mode(mode):
    """`mode` as the per-op check over the block (None: no check)."""
    prev = _state["mode"]
    with contextlib.ExitStack() as stack:
        stack.enter_context(_disable_current_modes())
        if mode is not None:
            stack.enter_context(mode)
        _state["mode"] = mode
        try:
            yield
        finally:
            _state["mode"] = prev


@contextlib.contextmanager
def trap(on: bool = True):
    """The trap over the block, where `on` (a no-op where the trap is on
    already, or `on` is false)."""
    if not on or _state["on"]:
        yield
        return
    _state["on"] = True
    try:
        with _mode(_PerOp()):
            yield
    finally:
        _state["on"] = False


@contextlib.contextmanager
def suspended():
    """The per-op check off over the block (a launch no dispatcher sees;
    `check` then checks its result)."""
    if _state["mode"] is None:
        yield
        return
    with _mode(None):
        yield


def check(out, op: str, inputs=()) -> None:
    """The per-op check of a result made outside the dispatcher (a ctypes
    launch): where the check is live and `out` holds NaN, op is the op that
    made it."""
    mode = _state["mode"]
    if mode is not None and _has_nan(_floats(out)):
        mode.hit(op, inputs)


def nan_flag(out, mesh=None) -> bool:
    """Whether the floating outputs `out` hold a NaN (on a mesh: on any
    rank; every rank must call it).  One reduction: the sum of each tensor,
    NaN where it holds one (and where +inf meets -inf, which an exact
    isnan then rules out), read by the host once."""
    arrays = _floats(out)
    dev = [a for a in arrays if torch.is_tensor(a)]
    hit = any(bool(np.isnan(a).any()) for a in arrays
              if not torch.is_tensor(a))
    if dev and not hit:
        sums = torch.stack([
            torch.isnan((torch.view_as_real(a) if a.is_complex() else a)
                        .sum()).to(dev[0].device) for a in dev])
        hit = bool(sums.any()) and _has_nan(dev)
    if mesh is not None:
        flag = torch.tensor(float(hit), dtype=torch.float64,
                            device=mesh.device)
        hit = bool(mesh.all_reduce(flag, "max").item() > 0.0)
    return hit


def _copy(tree):
    return _pytree.tree_map(
        lambda a: a.clone() if torch.is_tensor(a) else a, tree)


def _agreed(mesh, mode):
    """(the rank, the op) the mesh's re-runs name: the lowest rank whose op
    made a NaN from inputs that held none, else the lowest whose op's
    result held one; (None, None) where no rank found one."""
    n = mesh.size
    key = mesh.rank if mode.made else n + mesh.rank if mode.first else 2 * n
    src = int(mesh.all_reduce(torch.tensor(
        float(key), dtype=torch.float64, device=mesh.device), "min").item())
    if src >= 2 * n:
        return None, None
    code = torch.zeros(_NAME_BYTES, dtype=torch.float64, device=mesh.device)
    if key == src:
        raw = (mode.made or mode.first).encode()[:_NAME_BYTES]
        code[:len(raw)] = torch.tensor(list(raw), dtype=torch.float64)
    raw = bytes(int(c) for c in mesh.all_reduce(code, "max").tolist() if c)
    return src % n, raw.decode()


def _locate(name: str, fn, args, kwargs, mesh) -> None:
    """Run the region again from its inputs under the per-op check, and
    raise with the op it names (the region's name where it names none)."""
    mode = _PerOp(record=mesh is not None)
    with _mode(mode):
        fn(*args, **kwargs)
    if mesh is None:
        raise FloatingPointError(_message(
            name, "; its op-by-op re-run made none"))
    src, op = _agreed(mesh, mode)
    if op is None:
        raise FloatingPointError(_message(
            name, f" on the {mesh.px}x{mesh.pz} mesh; its op-by-op re-run "
            "made none"))
    raise FloatingPointError(_message(
        op, f" (rank {src} of the {mesh.px}x{mesh.pz} mesh, in {name})"))


def region(name: str, fn, mesh=None):
    """fn as a region named `name` (see the module's docstring).  mesh: the
    rank mesh every rank calls it on (None: one device, or a call that
    rank 0 makes alone)."""
    def call(*args, **kwargs):
        if not _state["on"] or _state["depth"]:
            return fn(*args, **kwargs)
        _state["depth"] += 1
        try:
            with _mode(None):
                saved = _copy((args, kwargs))
                out = fn(*args, **kwargs)
                hit = nan_flag(out, mesh)
            if hit:
                _locate(name, fn, *saved, mesh)
        finally:
            _state["depth"] -= 1
        return out

    call.__name__ = getattr(fn, "__name__", name)
    call.__doc__ = getattr(fn, "__doc__", None)
    return call
