"""Python-registered tbvar metrics — the port's half of /vars.

Counters, latency recorders and passive gauges created here are NATIVE
tbvar variables (capi ``tbrpc_var_*``) in the same process-wide registry
as the framework's own ``rpc_server_*``/``rpc_client_*`` series. Handles
are immortal (the native registry references them for the process
lifetime) and deduplicated here by name through the get-or-create helpers.

The port's tensor and parameter-server series carry a ``torch_`` prefix
(``torch_tensor_pull``, ``torch_param_server_push``, ...): tbvar names are
one namespace per process, and a process may load both data planes.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, Dict

from brpc_tpu_torch.runtime import native


class Counter:
    """A native Adder<int64> exposed under ``name``."""

    def __init__(self, name: str):
        self._L = native.lib()
        self._h = self._L.tbrpc_var_adder_create(name.encode())
        if not self._h:
            raise ValueError(f"metric name already registered: {name!r}")
        self.name = name

    def add(self, delta: int = 1) -> None:
        self._L.held_var_adder_add(self._h, delta)

    def value(self) -> int:
        return self._L.tbrpc_var_adder_value(self._h)


class LatencyRecorder:
    """The native latency bundle: {prefix}_latency, _max_latency, _qps,
    _count, _latency_99, _latency_999."""

    def __init__(self, prefix: str):
        self._L = native.lib()
        self._h = self._L.tbrpc_var_latency_create(prefix.encode())
        if not self._h:
            raise ValueError(f"metric prefix already registered: {prefix!r}")
        self.prefix = prefix

    def record_us(self, latency_us: int) -> None:
        self._L.tbrpc_var_latency_record(self._h, max(0, int(latency_us)))

    def record_s(self, seconds: float) -> None:
        self.record_us(int(seconds * 1e6))

    def _v(self, what: int) -> int:
        return self._L.tbrpc_var_latency_value(self._h, what)

    def count(self) -> int:
        return self._v(0)

    def qps(self) -> int:
        return self._v(1)

    def avg_us(self) -> int:
        return self._v(2)

    def max_us(self) -> int:
        return self._v(3)

    def p50(self) -> int:
        return self._v(50)

    def p90(self) -> int:
        return self._v(90)

    def p99(self) -> int:
        return self._v(99)

    def p999(self) -> int:
        return self._v(999)

    def snapshot(self) -> Dict[str, int]:
        """The recorded percentiles (us), for a result row."""
        return {"count": self.count(), "avg_us": self.avg_us(),
                "p50_us": self.p50(), "p99_us": self.p99(),
                "max_us": self.max_us()}


class NullSeries:
    """A series that records nothing and reads 0, with the write and read
    surface of a Counter and a LatencyRecorder: for code that keeps its
    recorders in a dict but must run without registering native series
    (a metric-free harness)."""

    def record_s(self, *_a) -> None: ...

    def record_us(self, *_a) -> None: ...

    def add(self, *_a) -> None: ...

    def count(self) -> int:
        return 0

    def p99(self) -> int:
        return 0

    def qps(self) -> int:
        return 0

    def value(self) -> int:
        return 0


class PassiveGauge:
    """A native PassiveStatus<int64> whose value is ``fn()`` at scrape
    time (under the native registry lock: keep ``fn`` trivial)."""

    def __init__(self, name: str, fn: Callable[[], int]):
        self._L = native.lib()

        def _cb(_ctx) -> int:
            try:
                return int(fn())
            except Exception:  # noqa: BLE001 — a failing gauge reads as -1
                return -1

        # The trampoline must outlive the process-lifetime registration.
        self._cb = native._GAUGE_CB(_cb)
        _immortal_cbs.append(self._cb)
        self._h = self._L.tbrpc_var_gauge_create(name.encode(), self._cb,
                                                 None)
        if not self._h:
            raise ValueError(f"metric name already registered: {name!r}")
        self.name = name


_mu = threading.Lock()
_registry: Dict[str, object] = {}
_immortal_cbs: list = []


def _get_or_create(name: str, cls, factory):
    with _mu:
        got = _registry.get(name)
        if got is None:
            got = _registry[name] = factory()
        elif not isinstance(got, cls):
            raise TypeError(
                f"metric {name!r} is already a {type(got).__name__}, "
                f"not a {cls.__name__}")
        return got


def counter(name: str) -> Counter:
    return _get_or_create(name, Counter, lambda: Counter(name))


def latency(prefix: str) -> LatencyRecorder:
    return _get_or_create(prefix, LatencyRecorder,
                          lambda: LatencyRecorder(prefix))


def gauge(name: str, fn: Callable[[], int]) -> PassiveGauge:
    """Get-or-create; an existing gauge keeps its ORIGINAL fn."""
    return _get_or_create(name, PassiveGauge,
                          lambda: PassiveGauge(name, fn))


# Roles that restart within one process (fleet clients, migrators, a
# re-created named server) cannot re-register a gauge: registrations are
# immortal and keep their first callback. These read through a table
# instead, where the newest repointable_gauge(name, ...) wins.
_repoint_mu = threading.Lock()
_repoint_holders: Dict[str, Callable[[], int]] = {}


def repointable_gauge(name: str, fn: Callable[[], int]) -> None:
    """(Re)point gauge ``name`` at ``fn``; the native registration happens
    on the first call for the name and reads the current holder at scrape
    time."""
    with _repoint_mu:
        first = name not in _repoint_holders
        _repoint_holders[name] = fn
    if first:
        def _read(name=name) -> int:
            with _repoint_mu:
                f = _repoint_holders.get(name)
            return int(f()) if f is not None else 0

        gauge(name, _read)


def _snapshot_buf(call, *args) -> bytes:
    """The capi dumps' two-call copy-out: size, then fetch (again if the
    snapshot grew between the calls)."""
    need = call(*args, None, 0)
    while need > 0:
        buf = ctypes.create_string_buffer(need + 1)
        got = call(*args, buf, need + 1)
        if got <= need:
            return buf.value
        need = got
    return b""


def dump_vars(prefix: str = "") -> str:
    """Every exposed variable as "name : value" lines (/vars parity)."""
    return _snapshot_buf(native.lib().tbrpc_vars_dump,
                         prefix.encode()).decode(errors="replace")


def dump_prometheus() -> str:
    """Prometheus text format, byte-identical to /brpc_metrics."""
    return _snapshot_buf(native.lib().tbrpc_vars_dump_prometheus).decode(
        errors="replace")


def dump_fibers() -> str:
    """Every live fiber with its state and, for a parked fiber, a
    symbolized stack (the /fibers page), reachable from a plain thread
    even when every fiber worker is parked."""
    return _snapshot_buf(native.lib().tbrpc_debug_dump_fibers).decode(
        errors="replace")


def dump_ici() -> str:
    """Sender/receiver state of every live tpu:// endpoint (TX credit,
    pending control bytes, parked writers): dump_fibers' companion for
    wedge hunting, here beside it as the JAX package has it."""
    return native.dump_ici()
