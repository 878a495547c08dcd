"""The port's one span mechanism: stage timings and Python-created spans,
on rpcz, on /vars and on the torch profiler's clock.

The native stack propagates {trace_id, span_id} through a fiber-local slot
and the wire; a server handler's callback thread carries its server span.
``stage(name)`` times a body at a layer boundary (the tensor path's
rpc / arena_stage / wire_wait / h2d / d2h / dequant / fused_update, the
server's serve / queue_wait, the codec's encode). Every
exit adds the body's microseconds and one call to the native Adders
``torch_stage_<name>_us`` and ``torch_stage_<name>_calls`` (always on,
read on /vars and /brpc_metrics); while rpcz is on it attaches
"name=<us>us" to the ACTIVE span. A stage's time includes the stages
nested in it. ``trace_span(name)`` opens an rpcz span of its own, and
does nothing on rpcz while rpcz is off.

While a torch profiler runs in the process (on any thread: one flag,
``torch.autograd.profiler._is_profiler_enabled``), a stage's body also
runs inside a ``stage/<name>`` range and a span's inside a range of its
name: ranges on the profiler's clock, the one its device trace uses.
They are ``_RecordFunctionFast`` ranges (``cpu_op`` events, about a
tenth of ``record_function``'s host cost), ``record_function`` where
torch lacks it. Nothing is built while no profiler runs. A profiler
sees threads other than the one it started on only when it is given
``_ExperimentalConfig(profile_all_threads=True)``.

The read side: ``dump_rpcz`` returns the collected spans without an HTTP
round trip and raises the typed ``RpczDisabled`` while collection is
off (an empty list always means "nothing matched"); ``find_trace``
finds the newest trace of a method; ``rpcz_set_sample_1_in_n`` keeps
rpcz on at bounded cost by sampling one in N new root traces.

rpcz may be switched on before a process's first native server starts.
A process that switches it on and then imports jax before that first
server dies with ``std::bad_alloc`` when the server starts (a fault of
the shared native layer); the port imports no jax.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

from brpc_tpu_torch.observability import metrics
from brpc_tpu_torch.runtime import native

try:
    from torch._C._profiler import _RecordFunctionFast as _Range
except ImportError:  # an older torch: the public range, ~10x the cost
    _Range = torch.profiler.record_function

# Entered in place of a profiler range while no profiler runs: reusable,
# so the off path builds nothing.
_NO_RANGE = contextlib.nullcontext()


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
    return native.lib().held_rpcz_enabled() != 0


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
    """Attach free-form text to the active span (no-op without one, and
    no native call while rpcz is off)."""
    L = native.lib()
    if L.held_rpcz_enabled():
        L.tbrpc_span_annotate(text.encode("utf-8", errors="replace"))


_stage_adders: Dict[str, Tuple[metrics.Counter, metrics.Counter]] = {}


def _stage_counters(name: str) -> Tuple[metrics.Counter, metrics.Counter]:
    """The (``torch_stage_<name>_us``, ``torch_stage_<name>_calls``)
    Adders of stage ``name``, created on first use."""
    got = _stage_adders.get(name)
    if got is None:
        got = _stage_adders[name] = (
            metrics.counter(f"torch_stage_{name}_us"),  # tpulint: allow(metric-name)
            metrics.counter(f"torch_stage_{name}_calls"))  # tpulint: allow(metric-name)
    return got


class _Stage:
    __slots__ = ("_name", "_calls", "_range", "_t0", "us")

    def __init__(self, name: str, calls: int):
        self._name = name
        self._calls = calls

    def __enter__(self) -> "_Stage":
        if _autograd_profiler._is_profiler_enabled:
            self._range = _Range(f"stage/{self._name}")
            self._range.__enter__()
        else:
            self._range = None
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        us = self.us = int((time.monotonic() - self._t0) * 1e6)
        if self._range is not None:
            self._range.__exit__(*exc)
        total, calls = _stage_counters(self._name)
        total.add(us)
        if self._calls:
            calls.add(self._calls)
        L = native.lib()
        if L.held_rpcz_enabled():
            L.tbrpc_span_annotate(f"{self._name}={us}us".encode())


def stage(name: str, calls: int = 1) -> _Stage:
    """Time the body as stage ``name``: its microseconds and ``calls``
    calls on the stage's Adders (``calls=0`` adds a further part of a
    wait already counted once), a ``stage/<name>`` profiler range while
    a profiler runs, and "name=<us>us" on the ACTIVE span while rpcz is
    on. After the body the stage's ``us`` holds its time, for a caller
    that feeds a recorder of its own from the same clock."""
    return _Stage(name, calls)


class SpanHandle:
    """The identifiers of an open trace_span (query /rpcz?trace=%016x)."""

    def __init__(self, trace_id: int, span_id: int):
        self.trace_id = trace_id
        self.span_id = span_id
        self.error_code = 0

    def set_error(self, code: int) -> None:
        self.error_code = code

    @property
    def trace_hex(self) -> str:
        """The trace id as /rpcz queries take it (``?trace=<hex>``)."""
        return f"{self.trace_id:016x}"


@contextlib.contextmanager
def trace_span(name: str, *, server_side: bool = False
               ) -> Iterator[SpanHandle]:
    """A Python-created rpcz span around the body: links into the
    surrounding trace (or starts a root, subject to head sampling), and
    downstream calls made in the body parent here. While a profiler runs,
    the body is also a profiler range of the span's name, whether rpcz is
    on or off."""
    rng = (_Range(name) if _autograd_profiler._is_profiler_enabled
           else _NO_RANGE)
    with rng:
        with _rpcz_span(name, server_side) as handle:
            yield handle


@contextlib.contextmanager
def _rpcz_span(name: str, server_side: bool) -> Iterator[SpanHandle]:
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
    L = native.lib()
    if L.tbrpc_rpcz_enabled() == 0:
        raise RpczDisabled("local")
    raw = metrics._snapshot_buf(L.tbrpc_rpcz_dump_json, trace_id)
    return json.loads(raw.decode(errors="replace")) if raw else []


def find_trace(service_method: str) -> Optional[str]:
    """The trace id (hex) of the most recent span of ``service_method``;
    None if none was collected."""
    for span in dump_rpcz():
        if span["service_method"] == service_method:
            return span["trace_id"]
    return None
