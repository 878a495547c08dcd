"""The serving front door: a native Server hosting the Gen service.

The JAX package's ``serving/server.py`` in the port; the decoder runs on
``device`` (default CUDA; raises when CUDA is missing).

Protocol (tstd, over tcp or tpu://):
  * ``Gen/Open`` — request JSON ``{"prompt": [ids], "max_tokens": N,
    "deadline_ms": M?}`` with a STREAM attached (native.open_stream);
    the handler accepts the stream, admits a session carrying the
    request's ambient QoS tenant (session control is stamped HIGH by the
    client; token data rides the stream's credit window outside
    admission), and answers ``{"session": id}``. Tokens then arrive on
    the stream as ``T<id>`` frames; a clean close ends the generation, an
    ``E<reason>`` frame precedes an abnormal close.
  * ``Gen/Close`` — ``{"session": id}``: explicit early termination.
  * ``Gen/Spec`` — ``{"spec_k": N}``: speculative decoding's window from
    the next step on (0 switches it off); answers the new and the
    previous value.

HTTP fallback: ``GET /gen?prompt=1,2,3&max_tokens=8[&tenant=t]`` on the
builtin console port streams the same frames as text lines over a chunked
progressive response — curl consumes a token stream with no tstd client.
"""

from __future__ import annotations

import ctypes
import json
import urllib.parse
from typing import Optional

from brpc_tpu_torch.models.decoder import DecoderParams
from brpc_tpu_torch.runtime import native
from brpc_tpu_torch.serving.engine import DecodeEngine
from brpc_tpu_torch.serving.session import (ProgressiveSink, SessionManager,
                                            StreamSink)

# The /gen HTTP path registers once per process (the native handler table
# lives as long as the process) and routes to the NEWEST server. Where
# another package registered /gen first, the registration raises.
_http_route = {"server": None, "registered": False}


def _ambient_tenant_priority():
    """The request's QoS as the handler thread carries it (installed
    natively around every handler: the tenant/priority the client
    stamped, or defaults)."""
    L = native.lib()
    prio = ctypes.c_int()
    buf = ctypes.create_string_buffer(512)
    L.tbrpc_qos_get(ctypes.byref(prio), buf, len(buf))
    return buf.value.decode(errors="replace"), prio.value


class ServingServer:
    """Session manager + decode engine + RPC/HTTP front ends."""

    def __init__(self, params: Optional[DecoderParams] = None, *,
                 max_batch: int = 4, max_len: int = 64, dim: int = 32,
                 ttl_s: float = 30.0, tenant_max_sessions: int = 0,
                 stall_timeout_s: float = 2.0, eos_id: int = 0,
                 stream_window: int = 256 << 10,
                 kv_arena_bytes: int = 8 << 20,
                 publish_kv: bool = False, spec_k: int = 0,
                 draft: str = "ngram",
                 draft_params: Optional[DecoderParams] = None,
                 paged: bool = False, block_rows: int = 8, device=None):
        self.manager = SessionManager(
            max_len=max_len, dim=dim, ttl_s=ttl_s,
            tenant_max_sessions=tenant_max_sessions,
            stall_timeout_s=stall_timeout_s,
            kv_arena_bytes=kv_arena_bytes, publish_kv=publish_kv,
            paged=paged, block_rows=block_rows)
        self.engine = DecodeEngine(self.manager, params,
                                   max_batch=max_batch, eos_id=eos_id,
                                   spec_k=spec_k, draft=draft,
                                   draft_params=draft_params, device=device)
        self.stream_window = stream_window
        self.server = native.Server()
        self.server.add_service("Gen", self._handle)
        if not _http_route["registered"]:
            native.register_http_stream_handler("/gen", _gen_http)
            _http_route["registered"] = True
        _http_route["server"] = self
        self.port: Optional[int] = None

    # ---- RPC handlers ----

    def _handle(self, method: str, request: bytes, attachment: bytes):
        if method == "Open":
            return self._open(request)
        if method == "Close":
            doc = json.loads(request.decode() or "{}")
            ok = self.manager.close(str(doc.get("session", "")))
            return json.dumps({"closed": bool(ok)}).encode(), b""
        if method == "Spec":
            # The live speculative-decoding setting (admin and A/B): from
            # the NEXT step boundary on; 0 is the kill switch. Answers
            # the previous value so a driver can restore it.
            doc = json.loads(request.decode() or "{}")
            old = self.engine.spec_k
            if "spec_k" in doc:
                k = int(doc["spec_k"])
                if k < 0 or k > 16:
                    raise native.RpcError(native.TRPC_EINTERNAL,
                                          f"spec_k {k} out of range")
                self.engine.spec_k = k
            return json.dumps({"spec_k": self.engine.spec_k,
                               "was": old}).encode(), b""
        raise native.RpcError(native.TRPC_ENOMETHOD,
                              f"no such method: Gen/{method}")

    def _open(self, request: bytes):
        # Parse and validate EVERYTHING before accepting the stream: an
        # accepted stream not handed to a session must be closed on every
        # failure path, or its native read buffer leaks for the process
        # lifetime.
        try:
            doc = json.loads(request.decode() or "{}")
            prompt = [int(t) for t in doc.get("prompt", [])]
            max_tokens = int(doc.get("max_tokens", 16))
            deadline_ms = doc.get("deadline_ms")
            if deadline_ms is not None:
                # 0 is a REAL (already-expired) deadline, not "none": the
                # session must shed at its first step boundary.
                deadline_ms = int(deadline_ms)
            priority = int(doc.get("priority", native.PRIORITY_BULK))
            # Caller-chosen session id (a fleet's sticky routing key);
            # None lets the manager mint one.
            sid = doc.get("session")
            if sid is not None:
                sid = str(sid)[:128] or None
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            raise native.RpcError(native.TRPC_EREQUEST,
                                  f"bad Gen/Open request: {e}")
        stream = native.accept_stream(self.stream_window)
        if stream is None:
            raise native.RpcError(
                native.TRPC_EREQUEST,
                "Gen/Open requires a stream (use open_stream; "
                "plain-HTTP clients use /gen)")
        # Tenant from the QoS meta the control RPC carried (stamped HIGH,
        # so control stays admittable under bulk load); the SESSION's
        # lane is the request's declared data priority, BULK by default.
        tenant, _control_prio = _ambient_tenant_priority()
        try:
            sess = self._admit_open(
                prompt, max_tokens, StreamSink(stream), tenant=tenant,
                priority=priority,
                deadline_s=(deadline_ms / 1000.0
                            if deadline_ms is not None else None),
                sid=sid)
        except Exception:
            stream.close()  # any admission failure: never leak the stream
            raise
        self.engine.notify()
        return json.dumps({"session": sess.id}).encode(), b""

    def _admit_open(self, prompt, max_tokens, sink, **kw):
        """The admission seam a serving fleet overrides (drain gate,
        prefill-role marking); here a plain manager open."""
        return self.manager.open(prompt, max_tokens, sink, **kw)

    # ---- lifecycle ----

    def start(self, addr: str = "127.0.0.1:0") -> int:
        self.port = self.server.start(addr)
        self.engine.start()
        return self.port

    def stop(self) -> None:
        self.engine.stop()
        self.manager.shutdown()
        if _http_route["server"] is self:
            _http_route["server"] = None
        self.server.close()


def _gen_http(path: str, query: str, progressive_id: int):
    """The /gen HTTP fallback handler (callback-pool thread): admit a
    session whose sink is the progressive response; the engine feeds it
    from then on."""
    srv: Optional[ServingServer] = _http_route["server"]
    if srv is None:
        return 503, b"no serving engine in this process\n", False
    q = dict(urllib.parse.parse_qsl(query))
    try:
        prompt = [int(t) for t in q.get("prompt", "").split(",") if t]
        max_tokens = int(q.get("max_tokens", "16"))
        deadline_ms = int(q["deadline_ms"]) if "deadline_ms" in q else None
    except ValueError:
        return 400, b"bad prompt/max_tokens\n", False
    try:
        sess = srv.manager.open(
            prompt, max_tokens, ProgressiveSink(progressive_id),
            tenant=q.get("tenant", ""), priority=native.PRIORITY_BULK,
            deadline_s=(deadline_ms / 1000.0
                        if deadline_ms is not None else None))
    except native.RpcError as e:
        return 429 if e.overloaded else 400, (str(e) + "\n").encode(), False
    srv.engine.notify()
    # The first chunk names the session; token lines follow.
    return 200, (json.dumps({"session": sess.id}) + "\n").encode(), True
