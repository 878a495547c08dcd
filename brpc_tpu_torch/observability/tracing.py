"""rpcz tracing from Python: stage timings and Python-created spans.

The native stack propagates {trace_id, span_id} through a fiber-local slot
and the wire; a server handler's callback thread carries its server span.
``stage(name)`` attaches "name=<us>us" to the ACTIVE span (the per-stage
breakdown of the tensor path: rpc / arena_stage / device_put / dequant /
fused_update); ``trace_span(name)`` opens a span of its own. Both no-op
cheaply while rpcz is off.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
from typing import Iterator, Tuple

from brpc_tpu_torch.runtime import native


def rpcz_enable(on: bool = True) -> None:
    native.lib().tbrpc_rpcz_set_enabled(1 if on else 0)


def rpcz_enabled() -> bool:
    return native.lib().tbrpc_rpcz_enabled() != 0


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
