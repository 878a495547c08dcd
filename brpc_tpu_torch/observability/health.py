"""Self-monitoring: the stall watchdog's health state machine and the
flight recorder, from Python.

The native side (native/trpc/stall_watchdog.*, native/tbvar/
flight_recorder.*) does the work: a dedicated watchdog pthread — never a
fiber, never touching the GIL — heartbeats the fiber scheduler and the
timer thread and walks a health state machine (``ok -> degraded ->
stalled``); on ``stalled`` it dumps fiber stacks, ICI credit state and
the flight-recorder tail to a file. This module starts and tunes it,
reads its verdict, and decodes the flight recorder. Everything here is
callable from a plain thread while every fiber worker is parked.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional

from brpc_tpu_torch.observability.metrics import _snapshot_buf
from brpc_tpu_torch.runtime import native

STATE_NAMES = {0: "ok", 1: "degraded", 2: "stalled"}

# One flight-recorder line, as tbrpc_flight_snapshot renders it:
#   <ts_us> tid=<os_tid>[!] seq=<n> <TYPE> a=0x<hex> b=0x<hex> [phase=<p>]
_FLIGHT_LINE = re.compile(
    r"^(?P<ts_us>\d+) tid=(?P<tid>\d+)(?P<gone>!?) seq=(?P<seq>\d+) "
    r"(?P<type>\S+)\s+a=0x(?P<a>[0-9a-f]+) b=0x(?P<b>[0-9a-f]+)"
    r"(?: phase=(?P<phase>\S+))?$")

# Watchdog/flight knobs -> native reloadable flag names.
_FLAG_NAMES = {
    "poll_ms": "watchdog_poll_ms",
    "degraded_ms": "watchdog_degraded_ms",
    "stalled_ms": "watchdog_stalled_ms",
    "credit_stall_ms": "watchdog_credit_stall_ms",
    "autodump": "watchdog_autodump",
    "flight_enabled": "flight_recorder_enabled",
    "flight_ring_events": "flight_recorder_ring_events",
}


def configure(**knobs: int) -> None:
    """Set watchdog/flight-recorder flags by short name (reloadable):
    ``poll_ms``, ``degraded_ms``, ``stalled_ms``, ``credit_stall_ms``,
    ``autodump``, ``flight_enabled``, ``flight_ring_events``."""
    L = native.lib()
    for key, value in knobs.items():
        flag = _FLAG_NAMES.get(key)
        if flag is None:
            raise ValueError(f"unknown watchdog knob {key!r}; choose from "
                             f"{sorted(_FLAG_NAMES)}")
        if L.tbrpc_flag_set(flag.encode(), str(int(value)).encode()) != 0:
            raise ValueError(f"flag {flag} rejected value {value!r}")


def start_watchdog(dump_dir: Optional[str] = None, **knobs: int) -> None:
    """Start the native watchdog pthread (idempotent); ``dump_dir``
    receives stall dumps. Knobs are set first, so the windows are in place
    before the first poll."""
    if knobs:
        configure(**knobs)
    if native.lib().tbrpc_watchdog_start(
            dump_dir.encode() if dump_dir else None) != 0:
        raise RuntimeError("watchdog thread failed to start")


def stop_watchdog() -> None:
    """Stop and join the watchdog pthread (restartable)."""
    native.lib().tbrpc_watchdog_stop()


def state() -> str:
    """Current health state: "ok", "degraded" or "stalled"."""
    return STATE_NAMES.get(native.lib().tbrpc_health_state(), "unknown")


def health() -> Dict:
    """The decoded /healthz document: state, reason, since_us, stall
    count, transition history, last dump path."""
    raw = _snapshot_buf(native.lib().tbrpc_health_dump_json)
    return json.loads(raw.decode(errors="replace"))


def last_dump_path() -> Optional[str]:
    """Absolute path of the newest stall dump, or None."""
    raw = _snapshot_buf(native.lib().tbrpc_health_last_dump_path)
    return raw.decode(errors="replace") or None


def flight_snapshot(max_events: int = 256) -> str:
    """The flight-recorder tail as text, one line per event: the newest
    ``max_events`` across every thread ring, merged and time-sorted."""
    return _snapshot_buf(native.lib().tbrpc_flight_snapshot,
                         max_events).decode(errors="replace")


def flight_events(max_events: int = 256) -> List[Dict]:
    """The flight-recorder tail decoded: one dict per event with ts_us,
    tid, thread_live, seq, type, a, b and phase (RPC_PHASE events)."""
    out: List[Dict] = []
    for line in flight_snapshot(max_events).splitlines():
        m = _FLIGHT_LINE.match(line.rstrip())
        if m is None:
            continue  # header or unknown line
        out.append({
            "ts_us": int(m.group("ts_us")),
            "tid": int(m.group("tid")),
            "thread_live": m.group("gone") != "!",
            "seq": int(m.group("seq")),
            "type": m.group("type"),
            "a": int(m.group("a"), 16),
            "b": int(m.group("b"), 16),
            "phase": m.group("phase"),
        })
    return out


def flight_total_events() -> int:
    """Events ever recorded process-wide."""
    return native.lib().tbrpc_flight_total_events()
