#!/usr/bin/env python3
"""Times and traces serial and overlapped parameter-server steps on the card,
for one or several checkouts and two set-ups of the server.

    python3 tools/ps_overlap_trace.py [TREE ...] [--rounds N] [--steps N]
        [--setups same-process,own-process] [--switch-interval S]
        [--out-dir DIR]

Each TREE (default: this checkout) is the root of a checkout holding
``brpc_tpu_torch/``. Every round runs the trees in order and then in
reverse (A B B A for two), each in a process of its own, and inside that
process the set-ups in turns (reversed every other round). A run sets up
chip_smoke.py phase 6's parameter-server run: the GPT-2 small MLP stack
(24 layers, 56,623,104 fp32 weights, a batch of 8 x 1024 tokens) and an
OverlappedStepDriver over tpu://, with the ParameterServer on the card

  * ``same-process``: in the trainer's process, pulls over RPC (the
    set-up of chip_smoke.py's int8 and mesh runs);
  * ``own-process``: in a process of its own
    (``brpc_tpu_torch/parallel/ps_process.py`` of THIS checkout, serving
    the tree's package), with one-sided pulls: the JAX package's set-up
    (bench.py's ``_STEP_CHILD``) and chip_smoke.py phase 6's raw runs.

The trainer runs under ``sys.setswitchinterval(--switch-interval)``
(0.0005, as chip_smoke.py phase 6 and bench.py set it). For each set-up
and each of serial and overlapped it primes, takes one warm step, times
``--steps`` steps (host clock around synchronized steps, with the
driver's ``last_stats``: the compute lane's host time, exposed and
overlapped communication), then takes one more step under torch.profiler
(CPU and CUDA activities; the own-process server profiles itself over the
same step). Every step node is wrapped in a ``record_function`` of its
span's name for that step only. From the traces it reports:

  * the device's busy time (the union of every kernel and copy of both
    processes, on the common clock of the two traces) and its idle share
    of the step, each stream's busy time with what it ran, and how long
    the trainer's and the server's device work ran at the same time;
  * the compute lane's host time split into CUDA synchronizations
    (``handoff.publish``'s per-gradient wait), torch operators (their
    launches included) and the rest, Python and waits for the
    interpreter lock;
  * the wire lanes' host time (summed over the lanes) split by node
    kind (push, opt, pull), and into torch operators (of which
    host-blocking copies, ``cudaMemcpyAsync`` from or to pageable
    memory), synchronizations outside them (``handoff.settle``) and the
    rest (RPC waits, Python, the lock).

Chrome traces go to ``<out-dir>/ps_<tree>_<round>_<setup>_<mode>.json``
(and ``..._server.json``; default: a ``ps_overlap_trace`` directory under
the system's temporary directory). Prints the card's name and power limit,
one JSON line per run, a table of medians, then the medians per tree and
set-up as the last line. Needs one CUDA card; ``--rehearse`` runs the same
code on the CPU at a small size (its times describe no card).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETUPS = {"same-process": (False, False),
          "own-process": (True, True)}  # (own process, one-sided pulls)
MODES = (("serial", False), ("overlapped", True))
STAT_KEYS = ("wall_ms", "compute_ms", "exposed_comm_ms",
             "overlapped_comm_ms")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
          "cudaEventSynchronize")
_REHEARSAL = {"sizes": [24] + [64, 24] * 3, "batch": 256}


# ---------------------------------------------------------------- the traces

def _union(spans) -> list:
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _length_ms(spans) -> float:
    return sum(b - a for a, b in _union(spans)) / 1e3


def _intersect_ms(xs, ys) -> float:
    xs, ys, i, j, total = _union(xs), _union(ys), 0, 0, 0.0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total / 1e3


def load_trace(path: str) -> list:
    """A Chrome trace's complete events, their times moved onto the
    trace's absolute clock (microseconds), so two processes' traces of
    one host line up."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0) / 1e3
    out = []
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and "dur" in e:
            e = dict(e, ts=e["ts"] + base)
            out.append(e)
    return out


def _inside(e, spans) -> bool:
    return any(a <= e["ts"] and e["ts"] + e["dur"] <= b for a, b in spans)


def _toplevel(events) -> list:
    """The events not nested in another of the list (one thread's)."""
    out, end = [], None
    for e in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
        if end is None or e["ts"] >= end:
            out.append(e)
            end = e["ts"] + e["dur"]
    return out


def lane_split(events) -> dict:
    """The host time of the step's lanes, read from the ``step/*``
    annotations: each lane's time in torch operators (top level; their
    launches, copies and the copies' own waits included), in CUDA
    synchronizations outside any operator (``handoff.publish`` on the
    compute lane, ``handoff.settle`` on the wire lane) and the rest
    (Python and waits for the interpreter lock, and on the wire lane the
    RPC waits); of the operators' time, the host-blocking copies. The wire
    lane also by node kind. ``other`` is the threads outside the lanes
    (a same-process server's handlers)."""
    nodes = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("step/")]
    by_tid = collections.defaultdict(list)
    for e in events:
        by_tid[e.get("tid")].append(e)

    def split(evs, spans):
        inner = [e for e in evs if _inside(e, spans)]
        ops = _toplevel([e for e in inner if e.get("cat") == "cpu_op"])
        op_spans = [(e["ts"], e["ts"] + e["dur"]) for e in ops]
        rt = [e for e in inner if e.get("cat") == "cuda_runtime"]
        return {"ops_ms": sum(e["dur"] for e in ops) / 1e3,
                "sync_ms": sum(e["dur"] for e in rt if e["name"] in _SYNCS
                               and not _inside(e, op_spans)) / 1e3,
                "copy_ms": sum(e["dur"] for e in rt
                               if e["name"].startswith("cudaMemcpy")) / 1e3}

    out, lane_tids = {}, set()
    for lane, kinds in (("compute", ("fwd", "bwd")),
                        ("wire", ("push", "opt", "pull"))):
        mine = [e for e in nodes if e["name"][5:].split(":")[0] in kinds]
        if not mine:
            continue
        tids = {e["tid"] for e in mine}
        lane_tids |= tids
        spans = [(e["ts"], e["ts"] + e["dur"]) for e in mine]
        row = {"host_ms": sum(e["dur"] for e in mine) / 1e3,
               **split([e for t in tids for e in by_tid[t]], spans)}
        row["rest_ms"] = row["host_ms"] - row["ops_ms"] - row["sync_ms"]
        if lane == "wire":
            for k in kinds:
                row[f"{k}_ms"] = sum(e["dur"] for e in mine if
                                     e["name"][5:].split(":")[0] == k) / 1e3
        out[lane] = row
    rest = [e for t, evs in by_tid.items() if t not in lane_tids
            for e in evs]
    if rest:
        out["other"] = split(rest, [(min(e["ts"] for e in rest),
                                     max(e["ts"] + e["dur"] for e in rest))])
    return out


def device_summary(wall_ms: float, trainer, server=None) -> dict:
    """Device busy time over both processes, idle share, per-stream busy
    time, and the time the trainer's and the server's device work
    overlapped."""
    streams = collections.defaultdict(list)
    top = collections.defaultdict(collections.Counter)
    per_proc = {}
    for who, events in (("trainer", trainer), ("server", server or [])):
        dev = [e for e in events if e.get("cat") in _DEVICE_CATS]
        per_proc[who] = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
        for e in dev:
            sid = f"{who}:{e.get('args', {}).get('stream', -1)}"
            streams[sid].append((e["ts"], e["ts"] + e["dur"]))
            top[sid][e["name"][:40]] += e["dur"] / 1e3
    busy = _length_ms(per_proc["trainer"] + per_proc["server"])
    return {"trace_wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
            "trainer_busy_ms": _length_ms(per_proc["trainer"]),
            "server_busy_ms": _length_ms(per_proc["server"]),
            "cross_process_overlap_ms": _intersect_ms(per_proc["trainer"],
                                                      per_proc["server"]),
            "streams": {sid: {"busy_ms": _length_ms(spans), "top": [
                (n, round(ms, 3)) for n, ms in top[sid].most_common(4)]}
                for sid, spans in streams.items()}}


# ---------------------------------------------------------------- one tree

def _launcher():
    """This checkout's ps_process module, loaded by path: it serves the
    package of whichever tree it is given."""
    spec = importlib.util.spec_from_file_location(
        "_ps_process_here",
        os.path.join(HERE, "brpc_tpu_torch", "parallel", "ps_process.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _node_annotations(step_driver):
    """Each step node inside a ``record_function`` of its span's name."""
    import torch

    orig = step_driver._traced

    def traced(name, fn):
        inner = orig(name, fn)

        def run(done):
            with torch.profiler.record_function(name):
                return inner(done)
        return run

    step_driver._traced = traced
    try:
        yield
    finally:
        step_driver._traced = orig


def _profile(acts):
    """torch.profiler over every thread of the process (the wire lane and
    the same-process server's handlers too), where this torch has the
    switch; else the calling thread's CPU events only."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import profile

    try:
        cfg = _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return profile(activities=acts)
    return profile(activities=acts, experimental_config=cfg)


def run_one(tree: str, tag: str, setups: list, steps: int, out_dir: str,
            switch: float, rehearse: bool) -> dict:
    """One tree in this process: every set-up, serial and overlapped,
    timed and traced."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from torch.profiler import ProfilerActivity

    from chip_smoke import BETA, LR, PLANE
    from brpc_tpu_torch.models.tensor_service import LayeredMLP
    from brpc_tpu_torch.runtime import step_driver
    from brpc_tpu_torch.runtime.param_server import (ParameterClient,
                                                     ParameterServer)
    from brpc_tpu_torch.runtime.tensor import TensorArena

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    sys.setswitchinterval(switch)
    plane = _REHEARSAL if rehearse else PLANE
    dev = torch.device("cpu" if rehearse else "cuda")
    sync = (lambda: None) if rehearse else torch.cuda.synchronize
    acts = [ProfilerActivity.CPU] + ([] if rehearse
                                     else [ProfilerActivity.CUDA])
    h = LayeredMLP(plane["sizes"], device=dev)
    init = {k: v.cpu().numpy() for k, v in h.init_params().items()}
    x, y = h.data(plane["batch"], seed=1)
    ServerProcess = _launcher().ServerProcess
    out = {"tree": tree, "switch_interval": switch}
    for setup in setups:
        own, oneside = SETUPS[setup]
        for mode, overlap in MODES:
            if own:
                srv = ServerProcess(init, lr=LR, momentum=BETA, device=dev,
                                    arena_bytes=1 << 30, oneside=oneside,
                                    timeout_s=900, root=tree)
                addr = srv.addr
            else:
                srv = ParameterServer(init, lr=LR, momentum=BETA,
                                      arena=TensorArena(256 << 20),
                                      device=dev)
                addr = f"tpu://127.0.0.1:{srv.start()}"
            cl = ParameterClient(addr, arena=TensorArena(256 << 20),
                                 device=dev, oneside=oneside)
            try:
                cl.meta()
                d = step_driver.OverlappedStepDriver(cl, h, overlap=overlap,
                                                     window=4)
                d.prime()
                d.step(x, y)  # warm
                rows = []
                for _ in range(steps):
                    sync()
                    t = time.monotonic()
                    d.step(x, y)
                    sync()
                    rows.append({"wall_ms": (time.monotonic() - t) * 1e3,
                                 **{k: d.last_stats[k] for k in
                                    STAT_KEYS[1:]}})
                path = os.path.join(out_dir, f"ps_{tag}_{setup}_{mode}.json")
                if own:
                    srv.profile_start()
                with _node_annotations(step_driver), _profile(acts) as prof:
                    sync()
                    t = time.monotonic()
                    d.step(x, y)
                    sync()
                    wall_ms = (time.monotonic() - t) * 1e3
                server = None
                if own:
                    srv.profile_stop(path[:-5] + "_server.json")
                    server = load_trace(path[:-5] + "_server.json")
                prof.export_chrome_trace(path)
                trainer = load_trace(path)
                out[f"{setup}/{mode}"] = {
                    "steps": rows,
                    "traced_stats": {k: d.last_stats[k]
                                     for k in STAT_KEYS[1:]},
                    **device_summary(wall_ms, trainer, server),
                    "lanes": lane_split(trainer)}
            finally:
                cl.close()
                if own:
                    srv.close()
                else:
                    srv.stop()
                    srv.server.close()
    return out


# ---------------------------------------------------------------- the A/B

def _medians(rows: list, key: str) -> dict:
    runs = [r[key] for r in rows if key in r]
    med = {k: statistics.median(s[k] for r in runs for s in r["steps"])
           for k in STAT_KEYS}
    for k in ("device_idle_share", "device_busy_ms", "trainer_busy_ms",
              "server_busy_ms", "cross_process_overlap_ms"):
        med[k] = statistics.median(r[k] for r in runs)
    for lane in ("compute", "wire"):
        for k in runs[0]["lanes"].get(lane, {}):
            med[f"{lane}_{k}"] = statistics.median(
                r["lanes"][lane][k] for r in runs)
    med["runs"] = len(runs)
    return med


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", default=[HERE])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--setups", default="same-process,own-process",
                    help="comma-separated, from " + ", ".join(SETUPS))
    ap.add_argument("--switch-interval", type=float, default=0.0005)
    ap.add_argument("--out-dir", default=os.path.join(
        tempfile.gettempdir(), "ps_overlap_trace"))
    ap.add_argument("--rehearse", action="store_true",
                    help="the CPU at a small size (no card numbers)")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--tag", default="run", help=argparse.SUPPRESS)
    args = ap.parse_args()
    setups = args.setups.split(",")
    for s in setups:
        if s not in SETUPS:
            ap.error(f"unknown set-up {s!r}")
    os.makedirs(args.out_dir, exist_ok=True)
    if args.one:
        print(json.dumps(run_one(args.one, args.tag, setups, args.steps,
                                 args.out_dir, args.switch_interval,
                                 args.rehearse)), flush=True)
        return 0

    import torch

    if args.rehearse:
        smi = "CPU rehearsal (no card)"
    elif not torch.cuda.is_available():
        print("ps_overlap_trace: needs a CUDA card", file=sys.stderr)
        return 1
    else:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = collections.defaultdict(list)
    for rnd in range(args.rounds):
        order = setups if rnd % 2 == 0 else setups[::-1]
        for i, tree in enumerate(args.trees + args.trees[::-1]):
            name = os.path.basename(os.path.abspath(tree))
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", tree,
                 "--tag", f"{name}_{rnd}_{i}", "--steps", str(args.steps),
                 "--setups", ",".join(order), "--switch-interval",
                 repr(args.switch_interval), "--out-dir", args.out_dir]
                + (["--rehearse"] if args.rehearse else []),
                capture_output=True, text=True)
            if r.returncode != 0:
                print(r.stdout[-2000:], r.stderr[-4000:], file=sys.stderr)
                return r.returncode
            row = json.loads(r.stdout.strip().splitlines()[-1])
            print(json.dumps(row), flush=True)
            runs[tree].append(row)
    medians = {tree: {f"{s}/{m}": _medians(rows, f"{s}/{m}")
                      for s in setups for m, _ in MODES}
               for tree, rows in runs.items()}
    cols = ("wall_ms", "compute_ms", "exposed_comm_ms", "overlapped_comm_ms",
            "device_idle_share", "compute_host_ms", "compute_sync_ms",
            "compute_ops_ms", "compute_rest_ms", "wire_host_ms",
            "wire_copy_ms", "wire_sync_ms")
    print("tree setup/mode " + " ".join(cols), flush=True)
    for tree, by in medians.items():
        for key, med in by.items():
            print(os.path.basename(os.path.abspath(tree)), key, " ".join(
                f"{med.get(c, float('nan')):.4g}" for c in cols), flush=True)
    print(smi, flush=True)
    print(json.dumps({"card": smi, "switch_interval": args.switch_interval,
                      "medians": medians}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
