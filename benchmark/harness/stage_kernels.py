"""Device time of the kernels the program launches inside its own stage
ranges (``observability.tracing.stage``: a ``stage/<name>`` range while a
profiler runs), for one profiled stretch of the trainer's process.

A kernel counts for a stage when the runtime call that launched it (a
``cuda_runtime`` or ``cuda_driver`` event, matched to the kernel by its
correlation id) starts inside one of the stage's ranges, on the range's
own thread or on an autograd engine thread (the threads that run the
backward pass a stage's ``torch.autograd.grad`` call waits on). Copies
and memsets do not count. ``harness/profiling.py``'s stretch keeps no
events, so this is a profile of its own.
"""

from __future__ import annotations

import bisect
import os
import shutil
import tempfile

from harness import profiling, trace

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
RANGE_CATS = ("cpu_op", "user_annotation")


def _autograd_threads(events) -> set:
    return {e.get("tid") for e in events
            if e.get("cat") == "cpu_op"
            and e["name"].startswith("autograd::engine::evaluate_function")}


def stage_kernel_us(events, stages) -> dict:
    """``{stage: microseconds}`` of the kernels launched inside each
    stage's ranges."""
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            c = e.get("args", {}).get("correlation")
            if c is not None:
                kernels[c] = kernels.get(c, 0.0) + e["dur"]
    engine = _autograd_threads(events)
    launches = sorted((e["ts"], e.get("tid"),
                       e.get("args", {}).get("correlation"))
                      for e in events if e.get("cat") in LAUNCH_CATS)
    starts = [t for t, _tid, _c in launches]
    out = {}
    for s in stages:
        ranges = [(e["ts"], e["ts"] + e["dur"], e.get("tid"))
                  for e in events if e.get("cat") in RANGE_CATS
                  and e["name"] == f"stage/{s}"]
        seen = set()
        for lo, hi, tid in ranges:
            i = bisect.bisect_left(starts, lo)
            while i < len(launches) and launches[i][0] <= hi:
                _t, ltid, c = launches[i]
                if c in kernels and (ltid == tid or ltid in engine):
                    seen.add(c)
                i += 1
        out[s] = sum(kernels[c] for c in seen)
    return out


def profiled_stages(ctx, body, stages) -> dict:
    """Run ``body()`` under a CPU and CUDA profiler over every thread of
    this process -> ``{stage: seconds}`` of kernel time."""
    tmp = tempfile.mkdtemp(prefix="bench_stages_")
    path = os.path.join(tmp, "trainer.json")
    try:
        with profiling._profiler(ctx.cuda) as prof:
            body()
            ctx.sync()
        prof.export_chrome_trace(path)
        events = trace.load(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {s: us / 1e6 for s, us in stage_kernel_us(events, stages).items()}

