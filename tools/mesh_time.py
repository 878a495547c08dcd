#!/usr/bin/env python3
"""Times chip_smoke.py phase 10's mesh harness on four cards over NCCL.

    python3 tools/mesh_time.py [--steps N] [--warm N] [--seed S] [--rehearse]

Phase 10 runs ``LayeredMLP`` at the GPT-2 small MLP stack (``PLANE``: 24
layers of 768 -> 3072 -> 768, a batch of 8 x 1024 tokens) over a 2 x 2
client x shard mesh of four ranks sharing one card over gloo. This runs
the same stack, mesh and driver (``OverlappedStepDriver``, phase 10's
window, the ``ParameterServer`` in this process on ``cuda:0``, rank 0 on
the wire, ``client=None`` elsewhere) with one card a rank over NCCL
(``parallel.launch.run_ranks``), overlapped and then serial. Each rank
takes ``--warm`` steps (the first opens NCCL's connections), then
``--steps`` steps timed on the host clock around a synchronized step,
the harness as it runs, then ``--steps`` more with each collective
timed, the card synchronized on both sides of it (chip_smoke.py's
``_timed_verbs``): the step's time in collectives.

Prints the card's name and power limit, one JSON line a mode with the
slowest rank's time for each step, then the medians and their min-max as
the last line. Needs four CUDA cards and nvcc. ``--rehearse`` runs the
same code on four CPU ranks over gloo at a small size (its times
describe no card).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (PLANE, MESH, LR, BETA, _timed_verbs)

REHEARSAL = {"sizes": [64, 256, 64, 256, 64], "batch": 64}


def _plane(rehearse: bool) -> dict:
    return REHEARSAL if rehearse else cs.PLANE


def _rank(addr: str, overlap: bool, steps: int, warm: int, seed: int,
          rehearse: bool) -> dict:
    """One rank of the mesh: warm steps, timed steps, split steps."""
    import torch
    import torch.distributed as dist

    from brpc_tpu_torch.models.tensor_service import LayeredMLP
    from brpc_tpu_torch.parallel.mesh import make_mesh
    from brpc_tpu_torch.runtime.param_server import ParameterClient
    from brpc_tpu_torch.runtime.step_driver import OverlappedStepDriver
    from brpc_tpu_torch.runtime.tensor import TensorArena

    if rehearse:
        dev = torch.device("cpu")
        torch.cuda.synchronize = lambda *a: None  # for _timed_verbs
    else:
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    plane = _plane(rehearse)
    h = LayeredMLP(plane["sizes"], mesh=make_mesh(cs.MESH["client"],
                                                  cs.MESH["shard"]),
                   seed=seed, device=dev)
    cl = (ParameterClient(addr, arena=TensorArena(256 << 20), device=dev)
          if h.is_wire else None)
    verbs: list = []
    try:
        d = OverlappedStepDriver(cl, h, overlap=overlap,
                                 window=cs.MESH["window"])
        d.prime()
        i = 0

        def step() -> float:
            nonlocal i
            x, y = h.data(plane["batch"], seed=seed + 100 + i)
            i += 1
            torch.cuda.synchronize()
            t = time.monotonic()
            d.step(x, y)
            torch.cuda.synchronize()
            return time.monotonic() - t

        for _ in range(warm):
            step()
        wall = [step() for _ in range(steps)]
        split = []
        restore = cs._timed_verbs(verbs)
        try:
            for _ in range(steps):
                n0 = len(verbs)
                split.append((step(), sum(verbs[n0:]), len(verbs) - n0))
        finally:
            restore()
    finally:
        if cl is not None:
            cl.close()
    return {"rank": dist.get_rank(), "is_wire": h.is_wire, "wall_s": wall,
            "split": split, "versions": dict(d.versions)}


def _spread(ms: list) -> dict:
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args()
    import torch

    from brpc_tpu_torch.models.tensor_service import LayeredMLP
    from brpc_tpu_torch.parallel.launch import run_ranks
    from brpc_tpu_torch.runtime.param_server import ParameterServer
    from brpc_tpu_torch.runtime.tensor import TensorArena

    n = cs.MESH["client"] * cs.MESH["shard"]
    if args.rehearse:
        dev, card = torch.device("cpu"), "CPU rehearsal (no card)"
    else:
        if torch.cuda.device_count() < n:
            print(f"mesh_time: needs {n} CUDA cards", file=sys.stderr)
            return 1
        from brpc_tpu_torch.ops import _build

        _build.load()  # build once here, before the ranks start
        dev = torch.device("cuda", 0)
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip()
    print(card, flush=True)
    plane = _plane(args.rehearse)
    h = LayeredMLP(plane["sizes"], seed=args.seed, device=dev)
    init = {k: v.cpu().numpy() for k, v in h.init_params().items()}
    total = args.warm + 2 * args.steps
    summary = {}
    for overlap in (True, False):
        mode = "overlapped" if overlap else "serial"
        ps = ParameterServer(init, lr=cs.LR, momentum=cs.BETA,
                             arena=TensorArena(256 << 20), device=dev)
        try:
            ranks = run_ranks(
                n, _rank, (f"tpu://127.0.0.1:{ps.start()}", overlap,
                           args.steps, args.warm, args.seed, args.rehearse),
                device_type=dev.type, timeout_s=1200)
            versions = ps.state().versions
        finally:
            ps.stop()
            ps.server.close()
        if versions != {k: total for k in h.names}:
            print(f"mesh_time: {mode}: server versions {versions}, not "
                  f"{total} each", file=sys.stderr)
            return 1
        step_ms = [max(r["wall_s"][s] for r in ranks) * 1e3
                   for s in range(args.steps)]
        split_ms = [max(r["split"][s][0] for r in ranks) * 1e3
                    for s in range(args.steps)]
        verb_ms = [max(r["split"][s][1] for r in ranks) * 1e3
                   for s in range(args.steps)]
        calls = [r["split"][0][2] for r in ranks]
        print(json.dumps({"mode": mode, "step_ms": step_ms,
                          "split_step_ms": split_ms,
                          "collectives_ms": verb_ms,
                          "collective_calls_a_step": calls}), flush=True)
        summary[mode] = {"step_ms": _spread(step_ms),
                         "split_step_ms": _spread(split_ms),
                         "collectives_ms": _spread(verb_ms)}
    print(json.dumps({"card": card, "tensors": len(h.names),
                      "batch": plane["batch"], "ranks": n,
                      "steps": args.steps, "warm": args.warm,
                      "slowest_rank_ms": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
