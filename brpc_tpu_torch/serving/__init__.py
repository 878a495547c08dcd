"""Streaming inference serving in the port: token streams over the native
Streaming RPC (credit-windowed, tcp and tpu://), per-session KV caches in
TensorArena pages, and a continuous-batching decode engine that admits and
retires sessions at step boundaries, running the decoder on the card.

  session  — Session/SessionManager: KV arena pages (monolithic or a paged
             block pool with a shared-prefix cache), open/decode/close
             lifecycle, TTL eviction, per-tenant session quotas, export
             and import, one-sided KV publication, /sessionz,
             torch_serving_* recorders
  engine   — DecodeEngine: the batched step loop over
             models/decoder.decode_step, try-write emission with bounded
             pending buffers; spec_k > 0 switches it to draft -> verify ->
             commit speculative steps
  server   — ServingServer: Gen/Open, Gen/Close and Gen/Spec over tstd,
             the /gen HTTP chunked fallback
  client   — ServingClient/TokenStream/SessionShed: HIGH-stamped session
             control, token iteration with TTFT tracking
  router   — ServingRouter (sticky ketama placement by session id with a
             penalty box and load-aware spill), ServingFleetClient and
             FleetTokenStream (reads follow "moved:" redirects through
             Gen/Resume, prefix-exact)
  fleet    — FleetServingServer: registry membership by role, live KV
             migration (MigrateService Probe/Install over the tensor wire
             or a one-sided read), drain, prefill/decode disaggregation
"""

from brpc_tpu_torch.serving.client import (ServingClient, SessionShed,
                                           TokenStream)
from brpc_tpu_torch.serving.engine import DecodeEngine
from brpc_tpu_torch.serving.fleet import FleetServingServer
from brpc_tpu_torch.serving.router import (FleetTokenStream,
                                           ServingFleetClient,
                                           ServingRouter)
from brpc_tpu_torch.serving.server import ServingServer
from brpc_tpu_torch.serving.session import (ACTIVE, DONE, FROZEN, QUEUED,
                                            SHED, CallableSink,
                                            ProgressiveSink, Session,
                                            SessionManager, StreamSink,
                                            serving_metrics)

__all__ = [
    "ACTIVE", "DONE", "FROZEN", "QUEUED", "SHED",
    "CallableSink", "DecodeEngine", "FleetServingServer",
    "FleetTokenStream", "ProgressiveSink", "ServingClient",
    "ServingFleetClient", "ServingRouter", "ServingServer", "Session",
    "SessionManager", "SessionShed", "StreamSink", "TokenStream",
    "serving_metrics",
]
