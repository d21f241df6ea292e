"""Where one RK substep's device time goes, by part, on one CUDA card.

    python3 -m tlab_tpu_torch.tools.profile_step [--shape 512 256 256]
                                                 [--steps 2] [--compressible]

Builds the shear layer of ``entry.build`` in float32, takes one warm-up
step, then times `--steps` RK steps with CUDA events recorded around each
part of the substep (the Burgers term per axis, the Poisson solve, the
dense first-derivative products of the projection, the substep as a whole
and the step as a whole).  The events sit on the stream between the
launches and synchronise nothing, so the parts add up to the stream time.
Prints the card's name and power limit, then one line per part in
ms/substep with its share, then the host wall time of the same steps.

Then the same steps as the DNS loop takes them (tools/dns.py::
make_step_functions: rk_step with the scalar clip, then the CFL and
dilatation diagnostics, then the host's one read of them): one line per
part in ms/step, the host wall time a step, whose excess over the stream
time is the card's idle time at the read, and each step's wall time.

--compressible profiles the compressible set's step instead, as the DNS
loop takes it (tools/dns.py::_compressible_step_functions, one host read a
step), for two case files of the repo in float32: tests/data/
case02_small3d.ini at 512x256x256 (chip_smoke.py's 12a: the ideal gas,
internal energy) and tests/data/case14_small3d.ini at 256x192x128 (13a: the
compressible AirWater set with NSCBC outflow and its buffer), each from its
initial state (compressible_initial_state; case02's random fields are
drawn on the host, ~25 s).  The parts: the dense first-derivative products
(dyn._d1), the [D1;D2] products (dyn._d12_apply), the fp64 saturation
adjustment (thermo.airwater_re), the mixture's caloric Newton, the NSCBC
corrections, the buffer, and the rest of the step (the elementwise
passes, the RK update, the diagnostics).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
import types

import torch

from tlab_tpu_torch import entry
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.dycore import compressible as comp_mod
from tlab_tpu_torch.dycore import incompressible as dyn
from tlab_tpu_torch.dycore import nscbc
from tlab_tpu_torch.ops import burgers
from tlab_tpu_torch.ops import elliptic_factorize as fac
from tlab_tpu_torch.physics import thermo
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.tools import dns as dns_tool
from tlab_tpu_torch.tools.initialize import compressible_initial_state


class Spans:
    """CUDA-event pairs by name, summed after a synchronise."""

    def __init__(self):
        self.pairs: dict = {}

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.pairs.setdefault(name(*args) if callable(name) else name,
                                  []).append((start, end))
            return out
        return timed

    def total_ms(self, name) -> float:
        return sum(a.elapsed_time(b) for a, b in self.pairs.get(name, ()))


def profile(shape, steps: int) -> dict:
    """ms per substep by part, over `steps` RK steps after one warm-up."""
    _, P, state = entry.build(*shape, torch.float32, "cuda", seed=0)
    state, _ = dyn.rk_loop_stacked(P, state, entry.DT, 1)
    torch.cuda.synchronize()
    spans = Spans()
    saved = (dyn._burgers_all, dyn._d1, dyn.substep_rhs_stacked,
             fac.poisson_factorize)
    dyn._burgers_all = spans.wrap(lambda P, name, *a: f"burgers_{name}",
                                  dyn._burgers_all)
    dyn._d1 = spans.wrap("d1 products", dyn._d1)
    dyn.substep_rhs_stacked = spans.wrap("substep", dyn.substep_rhs_stacked)
    fac.poisson_factorize = spans.wrap("poisson_factorize",
                                       fac.poisson_factorize)
    try:
        burgers.launches[:] = [0, 0, 0]
        loop = spans.wrap("loop", dyn.rk_loop_stacked)
        t0 = time.perf_counter()
        loop(P, state, entry.DT, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        (dyn._burgers_all, dyn._d1, dyn.substep_rhs_stacked,
         fac.poisson_factorize) = saved
    substeps = steps * len(P["rk"]["kdt"])
    ms = {name: spans.total_ms(name) / substeps for name in spans.pairs}
    parts = {f"Burgers {a} (K{i + 1})": ms[f"burgers_{a}"]
             for i, a in enumerate("xyz")}
    parts["poisson_factorize"] = ms["poisson_factorize"]
    parts["divergence + pressure gradient (d1 products)"] = ms["d1 products"]
    parts["rest of the substep"] = ms["substep"] - sum(parts.values())
    parts["RK update outside the substep"] = ms["loop"] - ms["substep"]
    return {"parts": parts, "stream_ms": ms["loop"],
            "wall_ms": 1e3 * wall / substeps, "substeps": substeps,
            "launches": list(burgers.launches)}


def profile_dns_step(shape, steps: int) -> dict:
    """ms per RK step by part of the DNS loop's step, over `steps` steps
    after one warm-up, each ending in the host's read of the diagnostics."""
    _, P, state = entry.build(*shape, torch.float32, "cuda", seed=0)
    P["scal_bounds"] = dyn.scalar_bounds((0.0,), (1.0,), torch.float32,
                                         "cuda")
    step, _ = dns_tool.make_step_functions(
        types.SimpleNamespace(P=P, anelastic=None))
    state, _, diag = step(state, entry.DT)
    diag.tolist()
    spans = Spans()
    names = ("rk_step", "substep_rhs_stacked", "cfl_advective_max",
             "dilatation_minmax")
    saved = [getattr(dyn, n) for n in names]
    for n in names:
        setattr(dyn, n, spans.wrap(n, getattr(dyn, n)))
    try:
        stamps = [time.perf_counter()]
        for _ in range(steps):
            state, _, diag = step(state, entry.DT)
            diag.tolist()                   # the loop's one sync a step
            stamps.append(time.perf_counter())
        wall = stamps[-1] - stamps[0]
    finally:
        for n, fn in zip(names, saved):
            setattr(dyn, n, fn)
    ms = {n: spans.total_ms(n) / steps for n in names}
    parts = {"substeps (5 x substep_rhs_stacked)": ms["substep_rhs_stacked"],
             "rest of rk_step (wall values, stack, RK update, scalar clip)":
                 ms["rk_step"] - ms["substep_rhs_stacked"],
             "cfl_advective_max": ms["cfl_advective_max"],
             "dilatation_minmax": ms["dilatation_minmax"]}
    stream = ms["rk_step"] + ms["cfl_advective_max"] + ms["dilatation_minmax"]
    return {"parts": parts, "stream_ms": stream,
            "wall_ms": 1e3 * wall / steps, "steps": steps,
            "each_ms": [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]}


# the compressible cases: (tag, case file, shape); the files' [Grid] and
# [IniGrid*] keys are set together, as chip_smoke.py's comp_case does
COMPRESSIBLE_CASES = (
    ("12a case02 (ideal gas)", "tests/data/case02_small3d.ini",
     (512, 256, 256)),
    ("13a case14 (AirWater, NSCBC, buffer)", "tests/data/case14_small3d.ini",
     (256, 192, 128)))
# (module, attribute, part) of the compressible step's wrapped calls
COMPRESSIBLE_PARTS = (
    (dyn, "_d1", "d1 products"),
    (dyn, "_d12_apply", "[D1;D2] products"),
    (thermo, "airwater_re", "fp64 saturation adjustment (airwater_re)"),
    (comp_mod, "mixture_thermal", "mixture caloric Newton"),
    (nscbc, "apply_nscbc", "NSCBC corrections"),
    (nscbc, "apply_nscbc_airwater", "NSCBC corrections"),
    (comp_mod, "_apply_buffer", "buffer relaxation"))


def _case_at(path: str, shape) -> str:
    """The case file's text with [Grid] and [IniGrid*] at `shape`."""
    import re
    nx, ny, nz = shape
    with open(path) as fh:
        text = fh.read()
    for section, key, value in (("Grid", "Imax", nx), ("Grid", "Jmax", ny),
                                ("Grid", "Kmax", nz),
                                ("IniGridOx", "points_1", nx + 1),
                                ("IniGridOy", "points_1", ny),
                                ("IniGridOz", "points_1", nz + 1)):
        text, n = re.subn(rf"(\[{section}\][^\[]*?^{key}=)[^\n]*",
                          rf"\g<1>{value}", text, flags=re.M | re.S)
        assert n == 1, (section, key)
    return text


def profile_compressible(path: str, shape, steps: int) -> dict:
    """ms per RK step by part of the compressible DNS loop's step, over
    `steps` steps after one warm-up, each ending in the host's read."""
    sim = Simulation.from_case(load_case(Ini(text=_case_at(path, shape))),
                               dtype=torch.float32, device="cuda")
    U = compressible_initial_state(sim, seed=0)
    sim.attach_buffer_compressible(U)
    step, diagnostics = dns_tool._compressible_step_functions(sim)
    dt = 0.5 * sim.case.time_cfl / diagnostics(U)[0].item()
    U, _, diag = step(U, dt)
    diag.tolist()
    spans = Spans()
    saved = [(mod, attr, getattr(mod, attr))
             for mod, attr, _ in COMPRESSIBLE_PARTS]
    for mod, attr, part in COMPRESSIBLE_PARTS:
        setattr(mod, attr, spans.wrap(part, getattr(mod, attr)))
    whole = spans.wrap("step", step)
    try:
        stamps = [time.perf_counter()]
        for _ in range(steps):
            U, _, diag = whole(U, dt)
            diag.tolist()                   # the loop's one sync a step
            stamps.append(time.perf_counter())
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    n_sub = len(sim.P["rk"]["kdt"])
    parts = {part: spans.total_ms(part) / (steps * n_sub)
             for part in dict.fromkeys(p for _, _, p in COMPRESSIBLE_PARTS)
             if part in spans.pairs}
    stream = spans.total_ms("step") / (steps * n_sub)
    parts["the rest (elementwise passes, RK update, diagnostics)"] = \
        stream - sum(parts.values())
    wall = stamps[-1] - stamps[0]
    return {"parts": parts, "stream_ms": stream,
            "wall_ms": 1e3 * wall / (steps * n_sub), "steps": steps,
            "n_sub": n_sub, "dt": dt,
            "each_ms": [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", type=int, nargs=3, default=(512, 256, 256))
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--compressible", action="store_true",
                    help="profile the compressible cases instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA card; device times come only from one",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    if args.compressible:
        for tag, path, shape in COMPRESSIBLE_CASES:
            res = profile_compressible(path, shape, args.steps)
            print(f"[profile] {smi}; {tag} {shape} fp32, {res['steps']} "
                  f"steps of dt {res['dt']:.3e}, {res['n_sub']} substeps a "
                  "step, each read by the host:")
            for name, v in res["parts"].items():
                print(f"[profile] {name}: {v:.3f} ms/substep "
                      f"({100 * v / res['stream_ms']:.1f}%)")
            print(f"[profile] stream {res['stream_ms']:.3f} ms/substep, host "
                  f"wall {res['wall_ms']:.3f} ms/substep; each step "
                  + " ".join(f"{v:.1f}" for v in res["each_ms"]) + " ms")
            del res
        return 0
    res = profile(tuple(args.shape), args.steps)
    print(f"[profile] {smi}; {tuple(args.shape)} fp32, {res['substeps']} "
          f"substeps; kernel launches {res['launches']}")
    for name, v in res["parts"].items():
        print(f"[profile] {name}: {v:.3f} ms/substep "
              f"({100 * v / res['stream_ms']:.1f}%)")
    print(f"[profile] stream {res['stream_ms']:.3f} ms/substep, host wall "
          f"{res['wall_ms']:.3f} ms/substep")
    del res
    drv = profile_dns_step(tuple(args.shape), args.steps)
    print(f"[profile] the DNS loop's step ({drv['steps']} steps, each read by "
          "the host):")
    for name, v in drv["parts"].items():
        print(f"[profile] {name}: {v:.3f} ms/step "
              f"({100 * v / drv['wall_ms']:.1f}%)")
    print(f"[profile] stream {drv['stream_ms']:.3f} ms/step, host wall "
          f"{drv['wall_ms']:.3f} ms/step, idle at the read "
          f"{drv['wall_ms'] - drv['stream_ms']:.3f} ms/step; each step "
          + " ".join(f"{v:.1f}" for v in drv["each_ms"]) + " ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
