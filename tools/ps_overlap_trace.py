#!/usr/bin/env python3
"""Times and traces serial and overlapped parameter-server steps on the card,
for one or several checkouts.

    python3 tools/ps_overlap_trace.py [TREE ...] [--rounds N] [--steps N]
                                      [--out-dir DIR]

Each TREE (default: this checkout) is the root of a checkout holding
``brpc_tpu_torch/``. Every round runs the trees in order and then in
reverse (A B B A for two), each in its own process. A run sets up
chip_smoke.py phase 6's parameter-server run — the GPT-2 small MLP stack
(24 layers, 56,623,104 fp32 weights, a batch of 8 x 1024 tokens), a
ParameterServer on the card in the same process, an OverlappedStepDriver
over tpu:// — and for each of serial and overlapped: primes, takes one
warm step, times ``--steps`` steps (host clock around synchronized
steps, with the step driver's compute / exposed / overlapped
communication), then takes one more step under torch.profiler (CPU and
CUDA activities).
From that trace it reports the device's busy time (the union of its
kernels and copies), its idle share of the step, and the busy time of
every CUDA stream with the kernels it ran; the Chrome trace goes to
``<out-dir>/ps_<tree>_<round>_<mode>.json`` (default: a
``ps_overlap_trace`` directory under the system's temporary directory).

Prints the card's name and power limit, one JSON line per run, then the
medians per tree as the last line. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union_ms(spans) -> float:
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def summarize(trace_path: str, wall_ms: float) -> dict:
    """Device busy time, idle share and per-stream busy time of a Chrome
    trace of one step (event times in microseconds)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in _DEVICE_CATS]
    streams = collections.defaultdict(list)
    names = collections.defaultdict(collections.Counter)
    for e in dev:
        sid = e.get("args", {}).get("stream", -1)
        streams[sid].append((e["ts"], e["ts"] + e["dur"]))
        names[sid][e["name"][:48]] += e["dur"] / 1e3
    busy = _union_ms(span for spans in streams.values() for span in spans)
    return {"trace_wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
            "streams": {str(sid): {
                "busy_ms": _union_ms(spans),
                "top": [(n, round(ms, 3))
                        for n, ms in names[sid].most_common(4)]}
                for sid, spans in streams.items()}}


def run_one(tree: str, tag: str, steps: int, out_dir: str) -> dict:
    """One tree in this process: serial and overlapped, timed and traced."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import BETA, LR, PLANE
    from brpc_tpu_torch.models.tensor_service import LayeredMLP
    from brpc_tpu_torch.runtime.param_server import (ParameterClient,
                                                     ParameterServer)
    from brpc_tpu_torch.runtime.step_driver import OverlappedStepDriver
    from brpc_tpu_torch.runtime.tensor import TensorArena

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    sys.setswitchinterval(0.0005)  # as chip_smoke.py phase 6
    dev = torch.device("cuda")
    h = LayeredMLP(PLANE["sizes"], device=dev)
    init = {k: v.cpu().numpy() for k, v in h.init_params().items()}
    x, y = h.data(PLANE["batch"], seed=1)
    out = {"tree": tree}
    for mode, overlap in (("serial", False), ("overlapped", True)):
        ps = ParameterServer(init, lr=LR, momentum=BETA,
                             arena=TensorArena(256 << 20), device=dev)
        cl = ParameterClient(f"tpu://127.0.0.1:{ps.start()}",
                             arena=TensorArena(256 << 20), device=dev)
        try:
            cl.meta()
            d = OverlappedStepDriver(cl, h, overlap=overlap, window=4)
            d.prime()
            d.step(x, y)  # warm
            rows = []
            for _ in range(steps):
                torch.cuda.synchronize()
                t = time.monotonic()
                d.step(x, y)
                torch.cuda.synchronize()
                rows.append({"wall_ms": (time.monotonic() - t) * 1e3,
                             **{k: d.last_stats[k] for k in
                                ("compute_ms", "exposed_comm_ms",
                                 "overlapped_comm_ms")}})
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t = time.monotonic()
                d.step(x, y)
                torch.cuda.synchronize()
                wall_ms = (time.monotonic() - t) * 1e3
            path = os.path.join(out_dir, f"ps_{tag}_{mode}.json")
            prof.export_chrome_trace(path)
            out[mode] = {"steps": rows, **summarize(path, wall_ms)}
        finally:
            cl.close()
            ps.stop()
            ps.server.close()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", default=[HERE])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out-dir", default=os.path.join(
        tempfile.gettempdir(), "ps_overlap_trace"))
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--tag", default="run", help=argparse.SUPPRESS)
    args = ap.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)
    if args.one:
        print(json.dumps(run_one(args.one, args.tag, args.steps,
                                 args.out_dir)), flush=True)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("ps_overlap_trace: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = collections.defaultdict(list)
    for rnd in range(args.rounds):
        for i, tree in enumerate(args.trees + args.trees[::-1]):
            name = os.path.basename(os.path.abspath(tree))
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", tree,
                 "--tag", f"{name}_{rnd}_{i}", "--steps", str(args.steps),
                 "--out-dir", args.out_dir],
                capture_output=True, text=True)
            if r.returncode != 0:
                print(r.stdout[-2000:], r.stderr[-4000:], file=sys.stderr)
                return r.returncode
            row = json.loads(r.stdout.strip().splitlines()[-1])
            print(json.dumps(row), flush=True)
            runs[tree].append(row)
    medians = {}
    for tree, rows in runs.items():
        medians[tree] = {
            mode: {k: statistics.median(
                [s[k] for row in rows for s in row[mode]["steps"]])
                for k in ("wall_ms", "compute_ms", "exposed_comm_ms",
                          "overlapped_comm_ms")}
            | {"device_idle_share": statistics.median(
                [row[mode]["device_idle_share"] for row in rows])}
            for mode in ("serial", "overlapped")}
    print(smi, flush=True)
    print(json.dumps({"card": smi, "medians": medians}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
