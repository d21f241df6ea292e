"""One run of one cell of the benchmark of tlab_tpu_torch on CUDA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Run from the root of a checkout.  The cell is an entry of BENCHMARK.json's
`workloads`; its configuration, traffic mix, metrics and limits are the
files that the entry names (harness/spec.py).  With --trace 0 the run
prints the cell's end-to-end metrics, with --trace 1 its per-layer ones.
Every run compares what its timed path produced with the plain float64
reference (harness/check.py) and prints each number compared beside its
limit as the last lines of its standard error; the last line of its
standard output is one JSON object: correct, attempted, failed, metrics,
device (with busy_s, window_s and a breakdown when traced) and checks.

A cell whose `chips` is more than 1 runs as the ranks of its
configuration's [Parallel] Mesh, one process a card (harness/mesh.py).
It refuses to run (exit 2, no result) without as many CUDA cards as the
cell asks for, and fails (exit 3, no result) if JAX, its libraries or the
JAX package tlab_tpu were loaded, in this process or in a rank.
"""
from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """The wall-clock time this process started (Linux /proc), else now."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fh:
            btime = next(float(ln.split()[1]) for ln in fh
                         if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


T_START = _process_start()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness.guard import FORBIDDEN, loaded_forbidden  # noqa: E402,F401


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from harness import cell as cellmod
    from harness import spec

    cell = spec.find_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"run.py: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result = cellmod.run(cell, args.seed, args.seconds, bool(args.trace),
                         device="cuda", t_start=T_START, log=log)
    bad = loaded_forbidden() + result.pop("ranks_forbidden", [])
    if bad:
        print(f"run.py: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
