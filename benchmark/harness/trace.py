"""Reading torch.profiler Chrome traces: device busy time as the union of
every kernel and copy of one or more processes on the traces' common
clock, kernel time by name, and what the host was doing in the device's
idle gaps.

The interval arithmetic is that of ``tools/ps_overlap_trace.py``
(``_union``, ``load_trace``, ``device_summary``), copied so that the
yardstick cannot move with the program's tools.
"""

from __future__ import annotations

import collections
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union(spans) -> list:
    """Merge ``(start, end)`` intervals into disjoint sorted ones."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def clip(spans, lo: float, hi: float) -> list:
    return [(max(a, lo), min(b, hi)) for a, b in spans
            if min(b, hi) > max(a, lo)]


def length(spans) -> float:
    return sum(b - a for a, b in union(spans))


def load(path: str) -> list:
    """A Chrome trace's complete events, their times (microseconds) moved
    onto the trace's absolute clock, so two processes' traces of one host
    line up."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0) / 1e3
    return [dict(e, ts=e["ts"] + base) for e in doc["traceEvents"]
            if e.get("ph") == "X" and "dur" in e]


def device_events(events) -> list:
    return [e for e in events if e.get("cat") in DEVICE_CATS]


def busy_us(events, lo: float, hi: float) -> float:
    """Microseconds of ``[lo, hi]`` in which some device event ran."""
    return length(clip([(e["ts"], e["ts"] + e["dur"])
                        for e in device_events(events)], lo, hi))


def kernel_us(events, name_part: str) -> tuple:
    """(summed microseconds, count) of the kernels whose name holds
    ``name_part``."""
    ks = [e for e in events if e.get("cat") == "kernel"
          and name_part in e["name"]]
    return sum(e["dur"] for e in ks), len(ks)


def top_device_ops(events, lo: float, hi: float, n: int = 10) -> list:
    """The ``n`` device operations that took most time, by name:
    ``[[name, seconds], ...]``."""
    tot = collections.Counter()
    for e in device_events(events):
        if lo <= e["ts"] <= hi:
            tot[e["name"][:80]] += e["dur"] / 1e6
    return [[k, v] for k, v in tot.most_common(n)]


def _label(e) -> str:
    """A host event's kind: a step node's name without its layer
    (``step/pull``), else the event's name."""
    name = e["name"]
    if name.startswith("step/"):
        return name.split(":")[0]
    return name[:60]


def idle_gaps(events, lo: float, hi: float, n: int = 10) -> list:
    """The device's idle time in ``[lo, hi]`` by what the host was doing:
    each gap is named after the innermost host annotation (a step node's
    ``record_function``, or the harness's own) or torch operator that
    covers its middle, and the gaps are summed by that name. ->
    ``[[name, seconds], ...]``, the ``n`` largest."""
    busy = union(clip([(e["ts"], e["ts"] + e["dur"])
                       for e in device_events(events)], lo, hi))
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    host = sorted((e for e in events
                   if e.get("cat") in ("user_annotation", "cpu_op")),
                  key=lambda e: e["ts"])
    tot = collections.Counter()
    # One sweep: the gaps come in time order, and ``cover`` keeps the host
    # events begun by a gap's middle that have not ended before it.
    cover, j = [], 0
    for a, b in gaps:
        mid = (a + b) / 2
        while j < len(host) and host[j]["ts"] <= mid:
            cover.append(host[j])
            j += 1
        cover = [e for e in cover if e["ts"] + e["dur"] >= mid]
        if cover:
            inner = min(cover, key=lambda e: e["dur"])
            tot[_label(inner)] += (b - a) / 1e6
        else:
            tot["(no host event)"] += (b - a) / 1e6
    return [[k, v] for k, v in tot.most_common(n)]


def stretch(events, name: str) -> tuple:
    """``(start, end)`` in microseconds of the annotation ``name`` (the
    harness's profiled stretch)."""
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] == name:
            return e["ts"], e["ts"] + e["dur"]
    raise ValueError(f"no {name!r} annotation in the trace")
