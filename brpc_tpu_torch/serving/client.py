"""Streaming inference client: open a session, iterate tokens as they
arrive (time-to-first-token decoupled from generation completing).

The JAX package's ``serving/client.py`` in the port (it touches no
device). QoS discipline: session CONTROL — the Open/Close RPCs — is stamped
HIGH with the client's tenant (admission keeps the control plane live
under bulk load); token DATA rides the stream's own credit window, which
never competes at the server's admission gate. A slow consumer of one
TokenStream backpressures only its own stream.
"""

from __future__ import annotations

import json
import time
from typing import Iterator, List, Optional

from brpc_tpu_torch.runtime import native
from brpc_tpu_torch.serving.session import FRAME_ERROR, FRAME_TOKEN


class SessionShed(native.RpcError):
    """The server shed this session mid-stream (deadline, slow reader,
    quota, shutdown — or a migration retire); ``reason`` carries the
    server's E-frame text, ``code`` the error-coded close when the shed
    arrived as a coded CLOSE frame (E_SESSION_MOVED = the session lives
    on, follow it with Gen/Resume)."""

    def __init__(self, reason: str, code: int = native.TRPC_ELIMIT):
        super().__init__(code or native.TRPC_ELIMIT,
                         f"session shed: {reason}")
        self.reason = reason

    @property
    def moved(self) -> Optional[str]:
        """The migration forwarding address, from the E-frame's
        "moved:<addr>" text — None when this shed is not a move (the
        coded-close-only case still reads as moved via ``code``)."""
        if self.reason.startswith("moved:"):
            return native.parse_moved(self.reason)
        return None


class TokenStream:
    """Iterator over one session's tokens. ``ttft_s`` is set once the
    first token lands; ``tokens`` accumulates them."""

    def __init__(self, client: "ServingClient", session_id: str,
                 stream: "native.Stream"):
        self._client = client
        self.session_id = session_id
        self.stream = stream
        self.opened_at = time.monotonic()
        self.ttft_s: Optional[float] = None
        self.tokens: List[int] = []
        self._done = False

    def read_token(self, timeout_ms: int = -1) -> Optional[int]:
        """Next token, None on timeout. Raises StopIteration at clean
        EOF, SessionShed when the server terminated the session."""
        if self._done:
            raise StopIteration
        try:
            frame = self.stream.read(timeout_ms)
        except native.StreamClosed as e:
            self._done = True
            if e.error:
                # The server closed with an error code (credit-exempt
                # CLOSE frame): a shed, even when the E-frame carrying
                # the reason couldn't fit our full window. The code rides
                # along so a fleet client can key E_SESSION_MOVED off it.
                raise SessionShed(f"stream closed with error {e.error}",
                                  code=e.error) from None
            raise StopIteration from None
        if frame is None:
            return None
        if frame.startswith(FRAME_ERROR):
            self._done = True
            reason = frame[len(FRAME_ERROR):].decode(errors="replace")
            raise SessionShed(
                reason, code=(native.E_SESSION_MOVED
                              if reason.startswith("moved:")
                              else native.TRPC_ELIMIT))
        token = int(frame[len(FRAME_TOKEN):])
        if self.ttft_s is None:
            self.ttft_s = time.monotonic() - self.opened_at
        self.tokens.append(token)
        return token

    def __iter__(self) -> Iterator[int]:
        while True:
            try:
                tok = self.read_token()
            except StopIteration:
                return
            if tok is not None:
                yield tok

    def close(self) -> None:
        """Early termination: tell the server (HIGH control) and close
        the local stream half."""
        if not self._done:
            self._done = True
            self._client._close_session(self.session_id)
        self.stream.close()

    def __enter__(self) -> "TokenStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ServingClient:
    """Client to one ServingServer ("host:port" or "tpu://host:port")."""

    def __init__(self, addr: str, *, tenant: str = "",
                 timeout_ms: int = 5000):
        self.addr = addr
        self.tenant = tenant
        self.channel = native.Channel(addr, timeout_ms=timeout_ms,
                                      max_retry=0)

    def open(self, prompt: List[int], max_tokens: int = 16, *,
             deadline_ms: Optional[int] = None,
             priority: Optional[int] = None,
             recv_window: int = 256 << 10,
             session: Optional[str] = None) -> TokenStream:
        """Open a generation session; raises RpcError (``.overloaded``
        with a retry hint) when the server sheds the OPEN. `priority` is the
        SESSION's batch-admission lane (BULK default — token data); the
        Open RPC itself always rides HIGH (control). `session` picks the
        session id — the serving fleet's sticky routing key."""
        req = {"prompt": list(prompt), "max_tokens": max_tokens}
        if deadline_ms is not None:
            req["deadline_ms"] = deadline_ms
        if priority is not None:
            req["priority"] = priority
        if session is not None:
            req["session"] = session
        # Gen/* is QoS-native by construction: there is no pre-QoS Gen
        # server to negotiate with.  tpulint: allow(negotiation)
        with native.qos(native.PRIORITY_HIGH, self.tenant):
            stream, body = native.open_stream(
                self.channel, "Gen/Open", json.dumps(req).encode(),
                max_buf_size=recv_window)
        sid = str(json.loads(body.decode()).get("session", ""))
        return TokenStream(self, sid, stream)

    def resume(self, session_id: str, have: int = 0, *,
               recv_window: int = 256 << 10) -> TokenStream:
        """Re-attach to a session that migrated HERE (``have`` = tokens
        already received — the server replays everything after them, so
        the stream stays prefix-exact across the move). Raises RpcError:
        E_SESSION_MOVED when it moved again (``native.parse_moved`` of the
        text is where), E_NO_SUCH when this server never had it, and
        ENOMETHOD from a server that takes no migrations."""
        req = {"session": session_id, "have": int(have)}
        # Gen/* is QoS-native by construction (see open()).
        # tpulint: allow(negotiation)
        with native.qos(native.PRIORITY_HIGH, self.tenant):
            stream, _body = native.open_stream(
                self.channel, "Gen/Resume", json.dumps(req).encode(),
                max_buf_size=recv_window)
        return TokenStream(self, session_id, stream)

    def locate(self, session_id: str) -> Optional[str]:
        """Where a session this server used to hold went: the forwarding
        address recorded by its migration retire, or None (unknown /
        still local)."""
        resp, _ = self.channel.call("Gen/Locate", json.dumps(
            {"session": session_id}).encode())
        return json.loads(resp.decode()).get("moved") or None

    def generate(self, prompt: List[int], max_tokens: int = 16,
                 **kw) -> List[int]:
        """Convenience: open + drain + close; returns the full token
        list (still streamed under the hood)."""
        with self.open(prompt, max_tokens, **kw) as ts:
            return list(ts)

    def _close_session(self, session_id: str) -> None:
        try:
            # Gen/* is QoS-native by construction (see open()).
            # tpulint: allow(negotiation)
            with native.qos(native.PRIORITY_HIGH, self.tenant):
                self.channel.call("Gen/Close", json.dumps(
                    {"session": session_id}).encode())
        except native.RpcError:
            pass  # the server may already be gone; local close suffices

    def close(self) -> None:
        self.channel.close()

    def __enter__(self) -> "ServingClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
