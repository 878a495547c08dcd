"""rpcz tracing from Python: stage timings and Python-created spans.

The native stack propagates {trace_id, span_id} through a fiber-local slot
and the wire; a server handler's callback thread carries its server span.
``stage(name)`` attaches "name=<us>us" to the ACTIVE span (the per-stage
breakdown of the tensor path: rpc / arena_stage / device_put / dequant /
fused_update); ``trace_span(name)`` opens a span of its own. Both no-op
cheaply while rpcz is off.

The read side: ``dump_rpcz`` returns the collected spans without an HTTP
round trip and raises the typed ``RpczDisabled`` while collection is
off (an empty list always means "nothing matched"); ``find_trace``
finds the newest trace of a method; ``rpcz_set_sample_1_in_n`` keeps
rpcz on at bounded cost by sampling one in N new root traces.

Switch rpcz on only after the process's first native server has
started: a process that enables it before any server exists dies with
``std::bad_alloc`` when that first server starts (a fault of the shared
native layer).
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import time
from typing import Iterator, List, Optional, Tuple

from brpc_tpu_torch.runtime import native


class RpczDisabled(RuntimeError):
    """Typed "rpcz is off" signal: span dumps raise it while collection is
    disabled, so a caller tells "tracing was off" from "nothing matched".
    ``source`` names where the dump was attempted ("local", or a member's
    address in a fleet)."""

    def __init__(self, source: str = "local"):
        super().__init__(
            f"rpcz is disabled on {source} (enable with rpcz_enable() or "
            "GET /flags/rpcz_enabled?setvalue=1)")
        self.source = source


def rpcz_enable(on: bool = True) -> None:
    native.lib().tbrpc_rpcz_set_enabled(1 if on else 0)


def rpcz_enabled() -> bool:
    return native.lib().tbrpc_rpcz_enabled() != 0


def rpcz_set_sample_1_in_n(n: int) -> None:
    """Collect 1 of every ``n`` NEW root traces (1 = every trace); spans
    inside a sampled trace always record, so sampled traces stay whole
    across the fleet. The same storage as the native rpcz_sample_1_in_n
    flag."""
    if native.lib().tbrpc_flag_set(b"rpcz_sample_1_in_n",
                                   str(int(n)).encode()) != 0:
        raise ValueError(f"rpcz_sample_1_in_n rejected {n!r} (must be >= 1)")


def rpcz_sample_1_in_n() -> int:
    return native.lib().tbrpc_rpcz_sample_1_in_n()


def current_trace() -> Tuple[int, int]:
    """The active (trace_id, span_id) on this thread/fiber; (0, 0) = none."""
    t = ctypes.c_uint64()
    s = ctypes.c_uint64()
    native.lib().tbrpc_trace_current(ctypes.byref(t), ctypes.byref(s))
    return t.value, s.value


def set_trace(trace_id: int, span_id: int) -> None:
    """Make (trace_id, span_id) the active context of this thread — how a
    pooled worker thread carries its caller's trace."""
    native.lib().tbrpc_trace_set(trace_id, span_id)


def clear_trace() -> None:
    native.lib().tbrpc_trace_clear()


def new_id() -> int:
    return native.lib().tbrpc_trace_new_id()


def annotate(text: str) -> None:
    """Attach free-form text to the active span (no-op without one)."""
    native.lib().tbrpc_span_annotate(text.encode("utf-8", errors="replace"))


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    """Time the body and attach "name=<us>us" to the ACTIVE span."""
    t0 = time.monotonic()
    try:
        yield
    finally:
        annotate(f"{name}={int((time.monotonic() - t0) * 1e6)}us")


class SpanHandle:
    """The identifiers of an open trace_span (query /rpcz?trace=%016x)."""

    def __init__(self, trace_id: int, span_id: int):
        self.trace_id = trace_id
        self.span_id = span_id
        self.error_code = 0

    def set_error(self, code: int) -> None:
        self.error_code = code


@contextlib.contextmanager
def trace_span(name: str, *, server_side: bool = False
               ) -> Iterator[SpanHandle]:
    """A Python-created rpcz span around the body: links into the
    surrounding trace (or starts a root, subject to head sampling), and
    downstream calls made in the body parent here."""
    L = native.lib()
    if not rpcz_enabled():
        yield SpanHandle(0, 0)
        return
    parent_trace, parent_span = current_trace()
    if parent_trace == 0 and not L.tbrpc_rpcz_sample_root():
        yield SpanHandle(0, 0)
        return
    trace_id = parent_trace if parent_trace != 0 else new_id()
    span_id = new_id()
    handle = SpanHandle(trace_id, span_id)
    set_trace(trace_id, span_id)
    start_us = L.tbrpc_now_us()
    try:
        yield handle
    except BaseException:
        handle.error_code = handle.error_code or native.TRPC_EINTERNAL
        raise
    finally:
        end_us = L.tbrpc_now_us()
        if parent_trace != 0 or parent_span != 0:
            set_trace(parent_trace, parent_span)
        else:
            clear_trace()
        L.tbrpc_span_emit(trace_id, span_id, parent_span,
                          1 if server_side else 0, start_us, end_us,
                          handle.error_code, name.encode())


def dump_rpcz(trace_id: int = 0) -> List[dict]:
    """Collected spans as dicts (annotations included), the fields the
    /rpcz page renders; ``trace_id`` != 0 narrows to one trace, oldest
    first. Raises ``RpczDisabled`` while collection is off."""
    from brpc_tpu_torch.observability.metrics import _snapshot_buf

    L = native.lib()
    if L.tbrpc_rpcz_enabled() == 0:
        raise RpczDisabled("local")
    raw = _snapshot_buf(L.tbrpc_rpcz_dump_json, trace_id)
    return json.loads(raw.decode(errors="replace")) if raw else []


def find_trace(service_method: str) -> Optional[str]:
    """The trace id (hex) of the most recent span of ``service_method``;
    None if none was collected."""
    for span in dump_rpcz():
        if span["service_method"] == service_method:
            return span["trace_id"]
    return None
