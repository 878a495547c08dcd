"""Cross-language observability in the port: one /vars + /brpc_metrics +
/rpcz view covering the native fiber runtime and the PyTorch data plane.

  metrics    — Python-registered native tbvars (Counter / LatencyRecorder /
               PassiveGauge, ``torch_``-prefixed by their callers) and the
               dumps (/vars, Prometheus, fibers, tpu:// endpoints).
  tracing    — rpcz from Python: trace_span() spans, stage() annotations,
               trace-context access, span dumps, 1-in-N root sampling.
  health     — the stall watchdog's state machine (/healthz) and the
               flight recorder (/flightz).
  fleet_view — the fleet plane: cross-process trace assembly (skew-
               corrected), registry-driven metric/health aggregation
               (the Python twin of /fleetz).

Importing this package touches nothing native; the native library loads
on first use.
"""

from brpc_tpu_torch.observability import fleet_view, health, metrics, tracing
from brpc_tpu_torch.observability.fleet_view import (AssembledTrace,
                                                     FleetObserver,
                                                     assemble_trace,
                                                     estimate_skew_us)
from brpc_tpu_torch.observability.health import (flight_events,
                                                 flight_snapshot,
                                                 health_state,
                                                 last_dump_path,
                                                 start_watchdog)
from brpc_tpu_torch.observability.metrics import (Counter, LatencyRecorder,
                                                  PassiveGauge, counter,
                                                  dump_prometheus, dump_vars,
                                                  gauge, latency)
from brpc_tpu_torch.observability.tracing import (RpczDisabled, annotate,
                                                  current_trace, dump_rpcz,
                                                  rpcz_enable, rpcz_enabled,
                                                  rpcz_sample_1_in_n,
                                                  rpcz_set_sample_1_in_n,
                                                  stage, trace_span)

__all__ = [
    "metrics", "tracing", "health", "fleet_view",
    "Counter", "LatencyRecorder", "PassiveGauge",
    "counter", "latency", "gauge", "dump_vars", "dump_prometheus",
    "annotate", "current_trace", "dump_rpcz", "rpcz_enable", "rpcz_enabled",
    "rpcz_sample_1_in_n", "rpcz_set_sample_1_in_n", "RpczDisabled",
    "stage", "trace_span",
    "AssembledTrace", "FleetObserver", "assemble_trace", "estimate_skew_us",
    "start_watchdog", "health_state", "last_dump_path",
    "flight_snapshot", "flight_events",
]
