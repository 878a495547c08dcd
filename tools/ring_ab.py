#!/usr/bin/env python3
"""Times the port's ring attention of several checkouts on four ranks.

    python3 tools/ring_ab.py TREE [TREE ...] [--rounds N]
        [--setup nccl|shared] [--dtypes bfloat16,float32] [--trace-dir DIR]

Each TREE is the root of a checkout holding ``brpc_tpu_torch/``;
``TREE@eager`` runs that checkout in a process that never captures a
CUDA graph (no ``ring``, no ``graph2``: the eager verbs alone). Every
round runs the trees in order and then in reverse (A B B A for two), each
in its own process, which builds that tree's kernels and spawns 4 ranks
with that tree's ``parallel.launch.run_ranks``: one card a rank over NCCL
(``--setup nccl``, needs 4 cards) or 4 ranks on ``cuda:0`` over gloo
(``--setup shared``). Each rank holds its 2048-row shard of one Llama 3 8B
attention layer (b1 h32 hkv8 s8192 d128, causal) and times, with CUDA
events after a barrier (median of 20, the four timed in turns):

- ``ring``: the tree's ``ring_attention`` (over NCCL a tree whose ring
  captures itself as a CUDA graph replays it here: the first call of
  the check runs eagerly, the second captures);
- ``eager``: the same ring run eagerly (``_ring_eager``, on a tree that
  has it: the packed hops without the graph);
- ``graph2``: over NCCL on a tree with ``_RingGraph``, the same overlapped schedule
  with K and V shifted as two tensors into fresh buffers each hop
  (``ring_shift_start([k, v])``, the hop before the packing), captured
  and replayed as a CUDA graph: the graph without the packing;
- ``serial``: the same folds with each hop's shift waited on before its
  fold is enqueued (``ring_shift`` then ``flash_attention_carry``: the
  schedule before the overlap);
- ``hops``: the 3 shifts alone; ``folds``: the 4 folds alone, on the
  blocks the shifts deliver, received beforehand;
- ``hidden``: (serial - ring) / min(hops, folds), the share of the
  shorter of the two that the ring hides.

Each rank also checks that the ring's output (three calls), the eager
ring's and graph2's equal the serialized schedule's bit for bit. With
``--trace-dir``, the first round takes one ``torch.profiler`` trace a
dtype on every rank of the ring and one of the eager ring, each of three
calls in a row, and reads the last (the first absorb the ranks' skew
from starting the profiler): the host's time in the call (``host_us``,
the call's range on the host's clock, and ``host_us_per_hop``, that over
the ring's n iterations), the device's busy and idle share over that
call's device window (first to last device activity it launched), how
much of the hop's device time (NCCL's kernels; staged, the copies) runs
under K3's kernels (``flash_*``), and how much of K3's time falls inside
a hop's span (NCCL's kernel; staged, from the hop's first copy out to its
last copy back, the host's transfer between); the Chrome traces are
written gzipped into DIR. On a shared card each process traces its own
work only.

Prints the card's name and power limit, one JSON line per run, then the
medians per tree, with the least and most of each over the runs, as the
last line. Needs CUDA cards and nvcc.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import statistics
import subprocess
import sys

LLAMA3_8B_ATTN = (1, 32, 8, 8192, 128)  # b, h, hkv, s, d; causal
RANKS = 4
REPS = 20


def _timed(fns: dict, reps: int) -> dict:
    """name -> median CUDA-event ms of each function, the functions timed
    in turns, the ranks lined up by a barrier and the card idle before
    each timing (one warm call each)."""
    import torch
    import torch.distributed as dist

    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            dist.barrier()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times[name].append(a.elapsed_time(b))
    return {name: statistics.median(t) for name, t in times.items()}


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _length(u) -> float:
    return sum(b - a for a, b in u)


def _overlap(u, w) -> float:
    """Length of the intersection of two unions of intervals."""
    i = j = 0
    total = 0.0
    while i < len(u) and j < len(w):
        lo, hi = max(u[i][0], w[j][0]), min(u[i][1], w[j][1])
        total += max(0.0, hi - lo)
        if u[i][1] < w[j][1]:
            i += 1
        else:
            j += 1
    return total


TRACED_CALLS = 3


def _trace(fn, path: str, hops: int) -> dict:
    """``TRACED_CALLS`` profiled calls of ``fn``, each after a barrier;
    the last one's host time (its ``record_function`` range) and device
    work (matched to the launches made inside that range by correlation
    id: the first calls absorb the ranks' skew from starting the
    profiler): host time over ``hops`` iterations, device busy/idle share
    over its device window, the hop's device time under K3 and K3's time
    inside a hop's span. The whole trace is gzipped to ``path``."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACED_CALLS):
            torch.cuda.synchronize()
            dist.barrier()
            with record_function("ring_ab_call"):
                fn()
            torch.cuda.synchronize()
    raw = path[:-len(".gz")]
    prof.export_chrome_trace(raw)
    with open(raw) as f:
        events = json.load(f)["traceEvents"]
    with open(raw, "rb") as src, gzip.open(path, "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(raw)
    calls = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") == "ring_ab_call")
    if not calls:
        return {"device_events": 0}
    lo, hi = calls[-1]
    host = {"host_us": hi - lo, "host_us_per_hop": (hi - lo) / hops}
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and lo <= e["ts"] <= hi and "correlation" in e.get("args",
                                                                   {})}
    dev = [(e["ts"], e["ts"] + e["dur"], e["name"], e["cat"],
            e.get("args", {}).get("stream"))
           for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                               "gpu_memset")
           and "dur" in e
           and e.get("args", {}).get("correlation") in launched]
    if not dev:
        return {"device_events": 0, **host}
    flash = _union((a, b) for a, b, n, _c, _s in dev if "flash_" in n)
    hop = _union((a, b) for a, b, n, c, _s in dev
                 if "nccl" in n.lower() or c == "gpu_memcpy")
    # A hop's span: NCCL's kernel; staged, its first copy out to its last
    # copy back (one side stream a hop), the host's transfer between.
    spans = {}
    for a, b, n, c, stream in dev:
        if "nccl" in n.lower():
            spans[(a, b)] = [a, b]
        elif c == "gpu_memcpy":
            lo, hi = spans.get(stream, [a, b])
            spans[stream] = [min(lo, a), max(hi, b)]
    spans = _union(spans.values())
    busy = _union((a, b) for a, b, _n, _c, _s in dev)
    window = max(e[1] for e in dev) - min(e[0] for e in dev)
    under = _overlap(hop, flash)
    return {**host, "device_events": len(dev), "window_us": window,
            "busy_us": _length(busy),
            "idle_share": 1.0 - _length(busy) / window if window else 0.0,
            "flash_us": _length(flash), "hop_us": _length(hop),
            "hop_under_flash_us": under,
            "hop_under_flash_share": under / _length(hop) if hop else 0.0,
            "hop_span_us": _length(spans),
            "flash_under_hop_span_share": (_overlap(flash, spans)
                                           / _length(flash) if flash
                                           else 0.0),
            "hop_kernels": sorted({n for _a, _b, n, c, _s in dev
                                   if "nccl" in n.lower()
                                   or c == "gpu_memcpy"}),
            "trace": os.path.basename(path)}


def _rank(dtypes: list, trace_to: str | None, graphs: bool = True) -> dict:
    """One rank: its shard of the Llama layer in each dtype, timed;
    ``graphs`` False: nothing is captured in this process."""
    import torch
    import torch.distributed as dist

    from brpc_tpu_torch.ops import flash_attention as fa
    from brpc_tpu_torch.ops import ring_attention as ra
    from brpc_tpu_torch.ops.ring_attention import hop_offsets, ring_attention
    from brpc_tpu_torch.parallel.collectives import (ring_shift,
                                                     ring_shift_start)
    from brpc_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    rank, n = dist.get_rank(), dist.get_world_size()
    mesh = make_mesh(client=1, shard=n)
    group = mesh.get_group("shard")
    b, h, hkv, s, d = LLAMA3_8B_ATTN
    sq = s // n
    out = {"rank": rank, "device": torch.cuda.get_device_name()}
    for name in dtypes:
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(b, heads, s, d, generator=gen, device="cuda")
                   .to(getattr(torch, name))[:, :, rank * sq:(rank + 1) * sq]
                   .contiguous() for heads in (h, hkv, hkv))
        ring = ring_attention(mesh, causal=True)
        blocks = [(k, v)]
        for _ in range(n - 1):
            blocks.append(tuple(ring_shift(list(blocks[-1]), group)))

        # The folds of the ring on the blocks ``blocks`` yields, in hop
        # order (the tool's own copy of ring_replay: it also times
        # checkouts older than that function).
        def replay(blocks):
            carry = fa.flash_init(b, h, sq, d, device="cuda")
            for hop, (kb, vb) in enumerate(blocks):
                carry = fa.flash_attention_carry(
                    q, kb, vb, *carry, hop_offsets(rank, hop, n, sq),
                    causal=True)
            return fa.flash_finalize(carry[1], carry[2], q.dtype)

        def shifted():  # each hop's shift waited on before its fold
            kb, vb = k, v
            for hop in range(n):
                if hop:
                    kb, vb = ring_shift([kb, vb], group)
                yield kb, vb

        def hops():
            kb, vb = k, v
            for _ in range(n - 1):
                kb, vb = ring_shift([kb, vb], group)

        def serial():
            return replay(shifted())

        def folds():
            return replay(blocks)

        def two_tensor(q, k, v):  # the overlap, K and V as two tensors
            def arriving():
                kb, vb = k, v
                for hop in range(n):
                    shift = (ring_shift_start([kb, vb], group)
                             if hop + 1 < n else None)
                    yield kb, vb
                    if shift is not None:
                        kb, vb = shift.wait()
            return ra.ring_replay(q, arriving(), rank, n, causal=True)

        fns = {"serial": serial, "hops": hops, "folds": folds}
        if graphs:
            fns["ring"] = lambda: ring(q, k, v)
        if hasattr(ra, "_ring_eager"):
            fns["eager"] = lambda: ra._ring_eager(q, k, v, group, rank, n,
                                                  causal=True)
        if (graphs and hasattr(ra, "_RingGraph")
                and dist.get_backend(group) == "nccl"):
            two_tensor(q, k, v)  # eager first, as the ring's own graph
            graph2 = ra._RingGraph(two_tensor, q, k, v)
            fns["graph2"] = lambda: graph2(q, k, v)
        want = serial()
        for what in (["ring"] * 3 * graphs + ["eager", "graph2"]):
            if what in fns and not torch.equal(fns[what](), want):
                raise RuntimeError(f"rank {rank} {name}: the {what} output "
                                   "differs from the serialized schedule's")
        ms = _timed(fns, REPS)
        if graphs:
            ms["hidden"] = ((ms["serial"] - ms["ring"])
                            / min(ms["hops"], ms["folds"]))
        if trace_to:
            for what in ("ring", "eager", "graph2"):
                if what in fns:
                    ms[f"trace_{what}"] = _trace(
                        fns[what], f"{trace_to}_{name}_{what}_rank{rank}"
                        ".json.gz", n)
        out[name] = ms
        del q, k, v, blocks
    return out


def one(spec: str, setup: str, dtypes: list, trace_dir: str | None) -> dict:
    """This tree's ring on 4 spawned ranks, in this process's children
    (``spec``: TREE or TREE@eager)."""
    tree, _, mode = spec.partition("@")
    if mode not in ("", "eager"):
        raise ValueError(f"ring_ab: {spec}: only @eager follows a tree")
    sys.path.insert(0, os.path.abspath(tree))
    from brpc_tpu_torch.ops import _build
    from brpc_tpu_torch.parallel.launch import run_ranks

    _build.load()  # build once here, before the ranks start
    trace_to = None
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        label = (os.path.basename(os.path.abspath(tree)) or "tree") + (
            "_eager" if mode else "")
        trace_to = os.path.abspath(os.path.join(trace_dir,
                                                f"ring_{setup}_{label}"))
    ranks = run_ranks(RANKS, _rank, (dtypes, trace_to, not mode),
                      device_type="cuda", share_card=setup == "shared",
                      timeout_s=300)
    return {"tree": spec, "setup": setup, "ranks": ranks}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--setup", choices=("nccl", "shared"), default="nccl")
    ap.add_argument("--dtypes", default="bfloat16,float32")
    ap.add_argument("--trace-dir")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    dtypes = args.dtypes.split(",")
    if set(dtypes) - {"bfloat16", "float32"}:
        ap.error(f"--dtypes takes bfloat16 and float32, not {dtypes}")
    if args.one:
        print(json.dumps(one(args.one, args.setup, dtypes, args.trace_dir)),
              flush=True)
        return 0
    import torch

    need = RANKS if args.setup == "nccl" else 1
    if torch.cuda.device_count() < need:
        print(f"ring_ab: --setup {args.setup} needs {need} CUDA card(s)",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    order = list(args.trees)
    for rnd in range(args.rounds):
        for tree in order + order[::-1]:
            cmd = [sys.executable, os.path.abspath(__file__), "--one", tree,
                   "--setup", args.setup, "--dtypes", args.dtypes]
            if args.trace_dir and rnd == 0 and not any(
                    r["tree"] == tree for r in runs):
                cmd += ["--trace-dir", args.trace_dir]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                print(r.stdout + r.stderr, file=sys.stderr)
                return 1
            runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]), flush=True)
    keys = ("ring", "eager", "graph2", "serial", "hops", "folds", "hidden")

    def stats(tree, rank, name, key):
        vals = [run["ranks"][rank][name][key] for run in runs
                if run["tree"] == tree and key in run["ranks"][rank][name]]
        return ({"median": statistics.median(vals), "min": min(vals),
                 "max": max(vals)} if vals else None)

    summary = {tree: {name: {rank: {key: stats(tree, rank, name, key)
                                    for key in keys}
                             for rank in range(RANKS)} for name in dtypes}
               for tree in order}
    print(json.dumps({"card": smi, "setup": args.setup,
                      "ms": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
