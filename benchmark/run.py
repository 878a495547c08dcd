#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1
        [--rehearse]

Runs from the root of a checkout that holds ``brpc_tpu_torch``. Needs as
many CUDA cards as the cell asks for; without them it exits with code 2
and prints no result. ``--rehearse`` runs the cell's code on the CPU at
the configuration's tiny ``rehearse`` sizes: its numbers describe no
card. Prints the numbers compared beside their limits as the last lines
of standard error, and one JSON object as the last line of standard
output. See benchmark/README.md.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
# A library that would load JAX is told not to. (The program builds into
# fixed directories of the checkout: native/build_torch/ and
# brpc_tpu_torch/ops/_build/.) One intra-op thread in this process and in
# the server process it starts: the hot path's host work is the lanes'
# own threads, and an idle pool of one thread a core beside them made
# the step time swing by a quarter between 10-second windows on the card.
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="the CPU at a tiny size (no card numbers)")
    args = ap.parse_args(argv)

    from harness import cell

    try:
        ctx = cell.Ctx(args.workload, args.seed, args.seconds,
                       bool(args.trace), rehearse=args.rehearse,
                       t_start=T_START)
        result = cell.run(ctx)
    except cell.RunError as e:
        print(f"benchmark: {e}", file=sys.stderr, flush=True)
        return 2
    cell.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
