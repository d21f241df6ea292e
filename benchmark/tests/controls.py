"""The control's readings on the card, at a cell's own size: the
reference put in the program's place one precision lower (float32 with
TF32 products; harness/cell.py's control="tf32"), judged by the same
numbers as the program, one whole run a seed in one process.  With
--kind fp32 the reference runs wholly in plain float32 instead (its
Poisson solve and its AirWater background too), with --kind bg32 in
float64 on the background rounded to float32: witnesses of what float32
itself reads.  The benchmark's own runs never do this.

    python3 benchmark/tests/controls.py --workload <cell> --seconds <s>
                          --seeds <n>,<n>,... [--kind tf32|fp32|bg32]

Prints one JSON line a seed: {"seed", "correct", "checks"}.  The
program's own lower-precision path (TLAB_TPU_MATMUL_PRECISION=high or
default in K1-K3) needs no script: run benchmark/run.py with it set.
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shape", type=int, nargs=3, default=None)
    ap.add_argument("--kind", choices=("tf32", "fp32", "bg32"),
                    default="tf32")
    args = ap.parse_args(argv)
    from harness import cell, spec
    c = spec.find_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = cell.run(c, seed, args.seconds, False, device=args.device,
                     shape=args.shape,
                     control=args.kind,
                     log=lambda m: print(m, file=sys.stderr, flush=True))
        print(json.dumps({"seed": seed, "correct": r["correct"],
                          "checks": {k: v["value"] for k, v
                                     in r["checks"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
