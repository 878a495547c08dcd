#!/usr/bin/env python3
"""Read the numbers that decide ``correct`` over many seeds in one
process: the program's readings (from which a limit's lower reading is
taken) and, for the same runs, the readings of the control and of planted
faults put in the program's place (its upper readings).

    python3 benchmark/control.py --workload CELL --seeds N,N,... \\
        --seconds S [--variants tf32,half_batch] [--rehearse]

Each seed is a whole run of the cell (set-up, a window of ``--seconds``,
the check). Variants: ``tf32`` (the training cells' control: the
reference with TF32 matmuls), ``half_batch`` (a training fault: every
batch's first half alone, the mean over it), ``bf16`` (the parameter
server's control: the trajectory in bfloat16). Prints one JSON line per
seed and, last, the largest program reading and the smallest reading of
each variant per number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--variants", default="")
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)

    from harness import cell

    variants = [v for v in args.variants.split(",") if v]
    lower, upper = {}, {v: {} for v in variants}
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = cell.Ctx(args.workload, seed, args.seconds, False,
                       rehearse=args.rehearse)
        res = cell.run(ctx, variants=variants)
        row = {"seed": seed, "correct": res["correct"],
               "readings": {k: c["value"] for k, c in res["checks"].items()},
               "variants": res.get("variants", {}),
               "metrics": {k: m["value"] for k, m in res["metrics"].items()},
               "device": res["device"]}
        print(json.dumps(row), flush=True)
        for k, v in row["readings"].items():
            lower[k] = max(lower.get(k, v), v)
        for var, rd in row["variants"].items():
            for k, v in rd.items():
                upper[var][k] = min(upper[var].get(k, v), v)
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
