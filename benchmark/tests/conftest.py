"""The benchmark's own tests: its folder and the checkout's root on the
import path, as ``benchmark/run.py`` puts them."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
for p in (os.path.dirname(BENCH), BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def bench_with(*cells):
    """BENCHMARK.json with ``cells`` added: the mixes kept under
    ``traffic/`` for cells the manifest does not hold yet."""
    import json

    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"] += [dict(c, chips=1, why="test") for c in cells]
    return bench


INT8 = {"name": "ps.int8-rounds", "config": "gpt2-small-params",
        "traffic": "int8-rounds"}
