"""Where one RK substep's device time goes, by part, on one CUDA card.

    python3 -m tlab_tpu_torch.tools.profile_step [--shape 512 256 256]
                                                 [--steps 2]

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
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
import types

import torch

from tlab_tpu_torch import entry
from tlab_tpu_torch.dycore import incompressible as dyn
from tlab_tpu_torch.ops import burgers
from tlab_tpu_torch.ops import elliptic_factorize as fac
from tlab_tpu_torch.tools import dns as dns_tool


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", type=int, nargs=3, default=(512, 256, 256))
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA card; device times come only from one",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
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
