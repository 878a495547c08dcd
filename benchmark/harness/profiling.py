"""The traced stretch: torch.profiler over every thread of this process
and, where the parameter server runs in a process of its own, over that
process too, both on one clock; reduced at once to the numbers the
per-layer metrics read, and the trace files deleted."""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile

import torch

from harness import trace

STRETCH = "bench/stretch"


@contextlib.contextmanager
def node_annotations():
    """Each step node of the step driver inside a ``record_function`` of
    its span's name (as ``tools/ps_overlap_trace.py`` does), so the
    trace names what each lane ran."""
    from brpc_tpu_torch.runtime import step_driver

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


def _profiler(cuda: bool):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    try:
        from torch._C._profiler import _ExperimentalConfig

        cfg = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return profile(activities=acts)
    return profile(activities=acts, experimental_config=cfg)


def profiled(ctx, body, server=None) -> dict:
    """Run ``body()`` under the profilers and reduce the traces: the
    stretch's length, the device's busy time in it (the union of every
    kernel and copy of both processes), the time and count of K1
    (``momentum_kernel``) and K2 (``dequant_kernel``), the device
    operations that took most time and the idle gaps by what the host
    was doing."""
    tmp = tempfile.mkdtemp(prefix="bench_trace_")
    mine = os.path.join(tmp, "trainer.json")
    theirs = os.path.join(tmp, "server.json")
    try:
        if server is not None:
            server.profile_start()
        try:
            with node_annotations(), _profiler(ctx.cuda) as prof:
                with torch.profiler.record_function(STRETCH):
                    body()
                    ctx.sync()
        finally:
            if server is not None:
                server.profile_stop(theirs)
        prof.export_chrome_trace(mine)
        events = trace.load(mine)
        lo, hi = trace.stretch(events, STRETCH)
        if server is not None:
            events += trace.load(theirs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # Every launch of the traces: each profiler runs only around the
    # stretch.
    k1_us, k1_n = trace.kernel_us(events, "momentum_kernel")
    k2_us, k2_n = trace.kernel_us(events, "dequant_kernel")
    return {"stretch_s": (hi - lo) / 1e6,
            "busy_s": trace.busy_us(events, lo, hi) / 1e6,
            "k1_s": k1_us / 1e6, "k1_launches": k1_n,
            "k2_s": k2_us / 1e6, "k2_launches": k2_n,
            "device_ops": trace.top_device_ops(events, lo, hi),
            "idle_gaps": trace.idle_gaps(events, lo, hi)}
