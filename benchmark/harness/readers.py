"""Arithmetic the metric readers share (``metrics/<name>.py``). Each takes
the run's record and returns None where the record holds nothing for it:
another kind of cell, no traced stretch, or no card (a CPU rehearsal)."""

from __future__ import annotations

from harness import roofline


def traced(rec: dict, kind: str):
    """The traced stretch's reduction, for a card run of ``kind``."""
    if rec.get("kind") != kind or "peaks" not in rec:
        return None
    return rec.get("traced")


def k1_share(rec: dict, kind: str):
    """K1's share of its byte bound, percent."""
    t = traced(rec, kind)
    if t is None or not t["k1_launches"]:
        return None
    bound = roofline.k1_bytes(t["k1_elements"]) / rec["peaks"]["hbm_Bps"]
    return 100.0 * bound / t["k1_s"]


def k2_share(rec: dict, kind: str):
    """K2's share of its byte bound, percent."""
    t = traced(rec, kind)
    if t is None or not t["k2_launches"] or not t.get("k2_codes"):
        return None
    bound = roofline.k2_bytes(t["k2_codes"]) / rec["peaks"]["hbm_Bps"]
    return 100.0 * bound / t["k2_s"]


def idle_share(rec: dict, kind: str):
    """Percent of the traced stretch in which no kernel or copy of any
    process ran on the card."""
    t = traced(rec, kind)
    if t is None or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["stretch_s"])


def mean_stat(rec: dict, key: str):
    """The mean of the step driver's ``last_stats[key]`` over the window's
    steps."""
    stats = rec.get("step_stats")
    if not stats:
        return None
    return sum(s[key] for s in stats) / len(stats)


def median_ms(rec: dict, call: str):
    """The median wall time of the window's ``call`` calls, ms."""
    times = sorted(rec.get("call_times", {}).get(call, []))
    if not times:
        return None
    n = len(times)
    mid = (times[(n - 1) // 2] + times[n // 2]) / 2
    return 1e3 * mid
