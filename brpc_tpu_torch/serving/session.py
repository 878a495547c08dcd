"""Session manager for streaming inference: per-session KV caches in
TensorArena pages, the open/decode/close lifecycle, TTL eviction,
per-tenant session quotas and the /sessionz document.

The JAX package's ``serving/session.py`` in the port. Everything here is
host state: KV rows live in registered transfer memory (a native
``TensorArena``; a failure to load the native library raises), and the
engine (``serving/engine.py``) is the only code that copies them to the
card, inside its model stage.

A session is one generation request: a prompt, a token budget, a KV cache
(two (max_len, dim) fp32 planes in an arena range keyed by the session
id) and a SINK the engine emits tokens into (a native credit-windowed
Stream, an HTTP progressive response, or any callable).

QoS rides along: a session carries the opener's tenant and priority;
session control (the Open/Close RPCs) is stamped HIGH by the client,
token data rides the stream's own credit window outside admission, and a
session's deadline is honoured between decode steps (an expired session
sheds at a step boundary, never mid-write).

Slow-reader isolation: the engine only try-writes (timeout 0). A stalled
reader's tokens queue in the session's bounded pending buffer; when the
buffer overflows or stalls past ``stall_timeout_s``, that session alone
is shed.

Paged KV (``paged=True``): the per-session (2, max_len, dim) planes give
way to a fixed-capacity KV BLOCK POOL (a block is ``block_rows`` rows of
both planes, carved from the same arena) plus a per-session block table.
Admission keys on free blocks, not the ``len(prompt)+max_tokens`` worst
case; a table grows lazily as decode advances. On top sits a
copy-on-write shared-prefix cache: every full block of committed prompt
tokens is keyed by a rolling content digest, an open whose prompt prefix
matches cached blocks references them (refcounted; the opener skips
those prefill rows), and a write into a block with other referents
faults a private copy first. TTL/pressure eviction reclaims cold
zero-ref cached blocks, spill/fault-in moves block sets (the spill
counters count blocks), one-sided publication exposes per-block slots
``kv:<sid>:k:<j>`` under the same seqlock/version discipline, and export
manifests carry the block digests so a destination asks only for the
blocks its own cache misses. Block-table and refcount writes happen ONLY
under ``_mu`` (a CoW fault racing a release is the double-free shape).

Metric names carry the port's ``torch_`` prefix (``torch_serving_ttft``
and so on): tbvar names are one namespace per process.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import numpy as np

from brpc_tpu_torch.runtime import native
from brpc_tpu_torch.runtime.tensor import OnesideWindow, TensorArena

# Session states.
QUEUED = "queued"    # admitted, waiting for a batch lane
ACTIVE = "active"    # in the running batch
FROZEN = "frozen"    # mid-migration: decode paused, KV exportable
DONE = "done"        # generation finished (EOS / budget), sink closed
SHED = "shed"        # evicted: deadline, TTL, stalled reader, or quota

# Token wire framing on a stream (and, as text lines, on the HTTP
# fallback): b"T" + ascii token id per message; b"E" + utf-8 reason ends
# a shed session before close. A clean close with no E-frame means the
# generation completed.
FRAME_TOKEN = b"T"
FRAME_ERROR = b"E"


class StreamSink:
    """Emits token frames into a native Stream (server half)."""

    def __init__(self, stream: "native.Stream"):
        self.stream = stream

    def emit(self, frame: bytes) -> str:
        """-> "ok" | "full" (credit window exhausted: buffer it) | "dead"
        (peer gone)."""
        try:
            return "ok" if self.stream.write(frame, timeout_ms=0) else "full"
        except native.StreamClosed:
            return "dead"

    def close(self, error: str = "", code: int = 0) -> None:
        if error:
            # The reason as a data frame is a probe only (close runs on
            # the engine thread; a bounded wait here would stall every
            # other session on the full window that caused the shed)...
            try:
                self.stream.write(FRAME_ERROR + error.encode(),
                                  timeout_ms=0)
            except native.StreamClosed:
                pass
            # ...the signal is the error code on the credit-exempt CLOSE
            # frame, so the client never mistakes a shed for a completed
            # generation. A migration close rides E_SESSION_MOVED; every
            # other shed the overload-shaped ELIMIT.
            self.stream.close(code or native.TRPC_ELIMIT)
        else:
            self.stream.close()


class ProgressiveSink:
    """Emits token frames as text lines on an HTTP chunked response: no
    per-reader credit window (the socket write queue is the backpressure),
    the same bounded pending-buffer shed policy through "dead"."""

    def __init__(self, progressive_id: int):
        self.progressive_id = progressive_id

    def emit(self, frame: bytes) -> str:
        ok = native.progressive_write(self.progressive_id, frame + b"\n")
        return "ok" if ok else "dead"

    def close(self, error: str = "", code: int = 0) -> None:
        if error:
            native.progressive_write(self.progressive_id,
                                     FRAME_ERROR + error.encode() + b"\n")
        native.progressive_close(self.progressive_id)


class CallableSink:
    """Test/offline sink: tokens go to a Python callable."""

    def __init__(self, fn: Callable[[bytes], None]):
        self.fn = fn
        self.closed_with: Optional[str] = None
        self.closed_code: int = 0

    def emit(self, frame: bytes) -> str:
        self.fn(frame)
        return "ok"

    def close(self, error: str = "", code: int = 0) -> None:
        self.closed_with = error
        self.closed_code = code


_metrics_cache = None
_metrics_mu = threading.Lock()


def serving_metrics():
    """The process-wide serving recorders (native tbvar series, so they
    ride /vars and every scrape)."""
    global _metrics_cache
    with _metrics_mu:
        if _metrics_cache is None:
            from brpc_tpu_torch.observability import metrics as obs

            _metrics_cache = {
                # Time-to-first-token: open() -> first token frame emitted.
                "ttft": obs.latency("torch_serving_ttft"),
                # One sample per emitted token: its qps IS tokens/s.
                "token": obs.latency("torch_serving_token_emit"),
                "tokens": obs.counter("torch_serving_tokens"),
                "shed": obs.counter("torch_serving_shed"),
                # Sessions shipped out/in, and cold-KV page-out/fault-in.
                "migrated_out": obs.counter("torch_serving_migrated_out"),
                "migrated_in": obs.counter("torch_serving_migrated_in"),
                "spill_out": obs.counter("torch_serving_kv_spill_out"),
                "spill_in": obs.counter("torch_serving_kv_spill_in"),
                # Speculative decoding: per-step acceptance percentage
                # samples, cumulative proposals/acceptances, spec steps.
                "spec_accept": obs.latency("torch_serving_spec_accept"),
                "spec_proposed": obs.counter("torch_serving_spec_proposed"),
                "spec_accepted": obs.counter("torch_serving_spec_accepted"),
                "spec_steps": obs.counter("torch_serving_spec_steps"),
                # Paged KV: shared-prefix hits/misses per prompt block
                # looked up at open/import, and KV bytes a migration
                # shipped.
                "prefix_hits": obs.counter("torch_serving_prefix_hits"),
                "prefix_misses": obs.counter("torch_serving_prefix_misses"),
                "migrated_kv_bytes": obs.counter(
                    "torch_serving_migrated_kv_bytes"),
            }
            # The torch_serving_sessions / _kv_bytes / _kv_spilled_bytes
            # gauges are (re)pointed by each SessionManager.
        return _metrics_cache


class Session:
    """One generation request. Engine-internal fields (lane, pos, token)
    are owned by the engine thread; bookkeeping fields are guarded by the
    manager's lock."""

    def __init__(self, sid: str, prompt: List[int], max_tokens: int,
                 tenant: str, priority: int, deadline_s: Optional[float],
                 sink, kv_off: int, kv_nbytes: int,
                 kv_k: np.ndarray, kv_v: np.ndarray):
        self.id = sid
        self.prompt = list(prompt)
        self.max_tokens = max_tokens
        self.tenant = tenant
        self.priority = priority
        self.sink = sink
        self.kv_off = kv_off
        self.kv_nbytes = kv_nbytes
        self.kv_k = kv_k  # (max_len, dim) fp32 view of arena pages
        self.kv_v = kv_v
        self.state = QUEUED
        self.opened_at = time.monotonic()
        # `is not None`, not truthiness: deadline_s == 0.0 is a REAL
        # (already-expired) deadline that must shed at the first boundary.
        self.deadline_at = (self.opened_at + deadline_s
                            if deadline_s is not None else None)
        self.last_progress = self.opened_at
        # Engine-owned decode state.
        self.lane = -1
        self.pos = 0            # cache rows filled (prompt + generated)
        self.token = 0          # last generated token (next step's input)
        self.emitted = 0
        self.ttft_s: Optional[float] = None
        # Every generated token id, in order — the resume-replay source:
        # a migrated session re-emits out_tokens[have:] on its new server
        # so the client's stream is prefix-exact across the move (no torn
        # or duplicated token, whatever was in flight when the old stream
        # closed).
        self.out_tokens: List[int] = []
        # Prefill/decode disaggregation: a prefill-role session freezes
        # for handoff the moment its first token is computed instead of
        # streaming it (the decode server replays + continues).
        self.prefill_handoff = False
        # KV paging: True while the planes live in the host spill store
        # (kv_k/kv_v are None, kv_off invalid) — faulted back on admit.
        self.paged = False
        # Paged-KV mode (manager.paged): the session's logical rows map
        # onto pool blocks through this table; kv_k/kv_v stay None and
        # kv_nbytes tracks len(block_table) * block bytes. The rolling
        # content digest per FULL block of prompt tokens is precomputed
        # at open (the prefix-cache key; also the migration manifest's
        # block identity). Table writes happen under the manager's _mu
        # only.
        self.block_table: List[int] = []
        self.prompt_digests: List[str] = []
        # Speculative decoding (engine-adapted, EPHEMERAL: never
        # exported — an imported session restarts from the optimistic
        # default): spec_k == 0 means "engine default" until the first
        # proposal round adapts it; spec_ema is the acceptance-rate EMA
        # that drives the adaptation (floor k=1 under mismatch).
        self.spec_k = 0
        self.spec_ema = 1.0
        # Slow-reader pending buffer (engine-owned).
        self.pending: List[bytes] = []
        self.pending_bytes = 0
        self.stalled_since: Optional[float] = None
        self.shed_reason = ""
        self.shed_code = 0

    def age_s(self) -> float:
        return time.monotonic() - self.opened_at

    def expired(self, now: float) -> bool:
        return self.deadline_at is not None and now >= self.deadline_at


class SessionManager:
    """Open/close lifecycle + KV arena + quotas + TTL + /sessionz.

    `kv_arena_bytes` bounds total KV state; per-session usage is
    2 * max_len * dim * 4 bytes. `tenant_max_sessions` (0 = off) sheds a
    tenant's session OPENs beyond its quota with ELIMIT — the serving
    twin of the per-tenant RPC quota, applied at the session granularity
    where KV memory is the scarce resource."""

    def __init__(self, *, max_len: int = 64, dim: int = 32,
                 kv_arena_bytes: int = 8 << 20, ttl_s: float = 30.0,
                 tenant_max_sessions: int = 0,
                 stall_timeout_s: float = 2.0,
                 max_pending_bytes: int = 32 << 10,
                 publish_kv: bool = False,
                 paged: bool = False, block_rows: int = 8):
        self.max_len = max_len
        self.dim = dim
        self.ttl_s = ttl_s
        self.tenant_max_sessions = tenant_max_sessions
        self.stall_timeout_s = stall_timeout_s
        self.max_pending_bytes = max_pending_bytes
        # KV state lives in REGISTERED transfer memory (the arena gauges
        # and /tensorz cover serving state too).
        self.arena = TensorArena(kv_arena_bytes)
        # One-sided KV publication (publish_kv=True):
        # session KV planes are exactly the large, versioned, read-mostly
        # objects one-sided reads want — publish each plane (not-owned:
        # the session keeps its range) under "kv:<sid>:k"/":v" with
        # version = rows filled, seqlock-write-locked across each decode
        # step, so a migration/prefill reader in another process can pull
        # a session's cache without a serving RPC. Paged mode publishes
        # per-BLOCK slots "kv:<sid>:k:<j>" instead (version = rows
        # filled in block j) under the same discipline.
        self.oneside = None
        if publish_kv:
            self.oneside = OnesideWindow(self.arena)
        # ---- paged-KV block pool ----
        self.paged = bool(paged)
        self.block_rows = 0
        self._pool_cap = 0
        if self.paged:
            # block_rows must divide max_len (the table axis is
            # max_len // block_rows); shrink to the largest divisor so
            # odd windows still work.
            r = max(1, min(int(block_rows), max_len))
            while max_len % r:
                r -= 1
            self.block_rows = r
            self._blk_plane = r * dim * 4       # one plane's bytes/block
            self._block_nbytes = 2 * self._blk_plane
            # Carve BOTH pool planes as two contiguous arena ranges (the
            # oneside directory above already took its slice): largest
            # capacity that fits, probed downward — the capacity is
            # fixed for the manager's lifetime, which is what keeps the
            # paged decode dispatch one fixed shape.
            cap = max(1, kv_arena_bytes // self._block_nbytes)
            while cap > 0:
                try:
                    self._pool_k_off = self.arena.alloc(
                        cap * self._blk_plane)
                except MemoryError:
                    cap -= max(1, cap // 16)
                    continue
                try:
                    self._pool_v_off = self.arena.alloc(
                        cap * self._blk_plane)
                    break
                except MemoryError:
                    self.arena.free(self._pool_k_off)
                    cap -= max(1, cap // 16)
            if cap <= 0:
                raise MemoryError(
                    f"kv_arena_bytes {kv_arena_bytes} too small for one "
                    f"{self._block_nbytes}-byte KV block")
            self._pool_cap = cap
            self._pool_k = self.arena.view(
                self._pool_k_off, cap * self._blk_plane).view(
                np.float32).reshape(cap, r, dim)
            self._pool_v = self.arena.view(
                self._pool_v_off, cap * self._blk_plane).view(
                np.float32).reshape(cap, r, dim)
            self._free_blocks: List[int] = list(range(cap - 1, -1, -1))
            self._block_refs = [0] * cap
            self._block_digest: List[Optional[str]] = [None] * cap
            self._block_fill = [0] * cap
            # digest -> block id; insertion order approximates LRU for
            # the zero-ref reclaim walk. Entries may be live-shared
            # (refs >= 1) or warm (refs == 0, reclaimable under
            # pressure / TTL).
            self._prefix_cache: "OrderedDict[str, int]" = OrderedDict()
            self._cache_touched: Dict[int, float] = {}
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._cow_faults = 0
        self._mu = threading.Lock()
        self._sessions: Dict[str, Session] = {}
        self._ids = itertools.count(1)
        self._kv_bytes = 0
        self._shed_total = 0
        self._done_total = 0
        # Speculative-decode accounting mirror (the engine's per-step
        # proposal/acceptance totals — /sessionz renders the accept rate
        # without reaching into native counters).
        self._spec_proposed = 0
        self._spec_accepted = 0
        # Host-side KV spill store: {sid: (k_rows, v_rows)} detached
        # numpy copies of the first `pos` rows (rows >= pos are zero by
        # construction — the engine writes row pos then advances — so
        # paging [:pos] is lossless). Cold sessions page out here under
        # arena pressure and fault back in on their next admission.
        self._spill: Dict[str, tuple] = {}
        self._spilled_bytes = 0
        self._m = serving_metrics()
        from brpc_tpu_torch.observability import metrics as obs

        obs.repointable_gauge("torch_serving_sessions", self._live_count)
        obs.repointable_gauge("torch_serving_kv_bytes",
                              lambda: self._kv_bytes)
        obs.repointable_gauge("torch_serving_kv_spilled_bytes",
                              lambda: self._spilled_bytes)
        # Paged-pool occupancy (0 in monolithic mode — registered
        # unconditionally so re-pointing stays last-manager-wins).
        obs.repointable_gauge("torch_serving_kv_blocks_free",
                              self._blocks_free)
        obs.repointable_gauge("torch_serving_kv_blocks_shared",
                              self._blocks_shared)
        # Keep ONE stable bound-method object: the guarded clear at
        # shutdown compares identity against the registered provider.
        self._sessionz_fn = self.sessionz_json
        native.set_sessionz_provider(self._sessionz_fn)

    # ---- lifecycle ----

    def open(self, prompt: List[int], max_tokens: int, sink, *,
             tenant: str = "", priority: int = native.PRIORITY_BULK,
             deadline_s: Optional[float] = None,
             sid: Optional[str] = None,
             prefill_handoff: bool = False) -> Session:
        """Admit a session (or shed with ELIMIT on tenant quota / arena
        exhaustion — carrying a retry hint like every overload shed).

        ``sid`` lets the caller pick the session id (the serving fleet's
        sticky routing key — the SAME id must resolve on whichever server
        the session migrates to); a live duplicate answers E_EXISTS.
        Under arena pressure, cold sessions page out to the host spill
        store before the open is shed."""
        if not prompt:
            raise native.RpcError(native.TRPC_EREQUEST, "empty prompt")
        if max_tokens < 1:
            # A zero-budget session would be admitted to a lane but never
            # decode and never satisfy the retire condition — pinned until
            # the TTL sweep, a client-triggerable lane exhaustion.
            raise native.RpcError(native.TRPC_EREQUEST,
                                  "max_tokens must be >= 1")
        if len(prompt) + max_tokens > self.max_len:
            raise native.RpcError(
                native.TRPC_EREQUEST,
                f"prompt+max_tokens {len(prompt)}+{max_tokens} "
                f"exceeds the KV window {self.max_len}")
        per_plane = self.max_len * self.dim * 4
        with self._mu:
            if sid is not None:
                dup = self._sessions.get(sid)
                if dup is not None and dup.state in (QUEUED, ACTIVE,
                                                     FROZEN):
                    from brpc_tpu_torch.runtime.param_server import (
                        E_EXISTS)

                    raise native.RpcError(
                        E_EXISTS, f"session {sid} already live here")
            if self.tenant_max_sessions > 0:
                live = sum(1 for s in self._sessions.values()
                           if s.tenant == tenant
                           and s.state in (QUEUED, ACTIVE))
                if live >= self.tenant_max_sessions:
                    self._shed_total += 1
                    self._m["shed"].add(1)
                    raise native.RpcError(
                        native.TRPC_ELIMIT,
                        f"tenant {tenant or '(none)'} over session quota "
                        f"{self.tenant_max_sessions} (retry_after_ms=50)")
            if self.paged:
                if sid is None:
                    sid = f"s{next(self._ids)}"
                sess = Session(sid, prompt, max_tokens, tenant, priority,
                               deadline_s, sink, -1, 0, None, None)
                sess.prefill_handoff = prefill_handoff
                # Admission keys on FREE BLOCKS (prompt + first generated
                # row), not len(prompt)+max_tokens worst case — raises
                # ELIMIT itself on true pool exhaustion.
                self._admit_paged_locked(sess)
                self._sessions[sid] = sess
                self.publish_kv(sess)
                return sess
            off = self._alloc_kv_locked(2 * per_plane)
            if off is None:
                self._shed_total += 1
                self._m["shed"].add(1)
                raise native.RpcError(
                    native.TRPC_ELIMIT,
                    "KV arena exhausted (retry_after_ms=100)")
            if sid is None:
                sid = f"s{next(self._ids)}"
            kv_k = self.arena.view(off, per_plane).view(np.float32).reshape(
                self.max_len, self.dim)
            kv_v = self.arena.view(off + per_plane, per_plane).view(
                np.float32).reshape(self.max_len, self.dim)
            kv_k[:] = 0.0
            kv_v[:] = 0.0
            sess = Session(sid, prompt, max_tokens, tenant, priority,
                           deadline_s, sink, off, 2 * per_plane, kv_k, kv_v)
            # Set BEFORE the session becomes visible: a running engine may
            # admit it the moment it lands in the table, and the handoff
            # flag must already be there.
            sess.prefill_handoff = prefill_handoff
            self._sessions[sid] = sess
            self._kv_bytes += 2 * per_plane
            # Publishable from birth (version 0 = no rows filled), INSIDE
            # _mu: published before any finish()/evict can release the
            # range — a post-release publish would pin a freed (and
            # reallocatable) range under this session's name forever.
            self.publish_kv(sess)
        return sess

    # ---- KV paging (the memory-pressure valve) ----

    def _alloc_kv_locked(self, nbytes: int) -> Optional[int]:
        """Arena alloc that, under pressure, pages COLD sessions' KV out
        to the host spill store (oldest-progress first) and retries —
        an open/fault sheds only once nothing cold is left to evict.
        Caller holds _mu."""
        while True:
            try:
                return self.arena.alloc(nbytes)
            except MemoryError:
                pass
            # Cold = waiting for a lane (QUEUED, incl. parked imports)
            # and not already paged: ACTIVE sessions are mid-decode on an
            # engine lane and FROZEN ones are mid-export — neither can
            # lose its planes here.
            cold = [s for s in self._sessions.values()
                    if s.state == QUEUED and s.lane < 0
                    and not s.paged and s.kv_k is not None]
            if not cold:
                return None
            cold.sort(key=lambda s: s.last_progress)
            self._page_out_locked(cold[0])

    def _page_out_locked(self, sess: Session) -> None:
        """Move ``sess``'s KV planes to the host spill store and free the
        arena range. Only the first ``pos`` rows are captured (later rows
        are zero by construction), detached copies so the freed range's
        reuse cannot alias them."""
        if self.oneside is not None:
            self.oneside.unpublish(f"kv:{sess.id}:k")
            self.oneside.unpublish(f"kv:{sess.id}:v")
        k_rows = np.array(sess.kv_k[:sess.pos])
        v_rows = np.array(sess.kv_v[:sess.pos])
        self._spill[sess.id] = (k_rows, v_rows)
        self._spilled_bytes += k_rows.nbytes + v_rows.nbytes
        self._kv_bytes -= sess.kv_nbytes
        sess.kv_k = sess.kv_v = None
        self.arena.free(sess.kv_off)
        sess.kv_off = -1
        sess.paged = True
        self._m["spill_out"].add(1)

    def page_out(self, sess: Session) -> bool:
        """Explicitly page one cold session out (the pressure path does
        this automatically); False when it isn't pageable right now."""
        with self._mu:
            if sess.state != QUEUED or sess.lane >= 0 or sess.paged:
                return False
            if self.paged:
                if not sess.block_table:
                    return False
                self._page_out_paged_locked(sess)
                return True
            if sess.kv_k is None:
                return False
            self._page_out_locked(sess)
            return True

    def fault_in(self, sess: Session) -> bool:
        """Bring a paged session's KV back into the arena (the admission
        path calls this before activating it); False when the arena stays
        exhausted even after paging colder sessions out."""
        if self.paged:
            return self._fault_in_paged(sess)
        per_plane = self.max_len * self.dim * 4
        with self._mu:
            if not sess.paged:
                return True
            off = self._alloc_kv_locked(2 * per_plane)
            if off is None:
                return False
            k_rows, v_rows = self._spill.pop(sess.id)
            self._spilled_bytes -= k_rows.nbytes + v_rows.nbytes
            sess.kv_off = off
            sess.kv_k = self.arena.view(off, per_plane).view(
                np.float32).reshape(self.max_len, self.dim)
            sess.kv_v = self.arena.view(off + per_plane, per_plane).view(
                np.float32).reshape(self.max_len, self.dim)
            sess.kv_k[:] = 0.0
            sess.kv_v[:] = 0.0
            sess.kv_k[:sess.pos] = k_rows
            sess.kv_v[:sess.pos] = v_rows
            self._kv_bytes += sess.kv_nbytes
            sess.paged = False
            self._m["spill_in"].add(1)
            self.publish_kv(sess)
            return True

    # ---- paged-KV block pool + shared-prefix cache ----
    #
    # Invariant: _free_blocks / _block_refs / _block_digest /
    # _prefix_cache and every Session.block_table write happen under
    # _mu. A block is accounted in _kv_bytes
    # exactly while it is OFF the free list — warm cached blocks
    # (refs == 0, digest set) still hold memory and stay counted.

    def _prefix_digests(self, prompt: List[int]) -> List[str]:
        """Rolling content digest per FULL block of prompt tokens: block
        j's digest commits to tokens [0, (j+1)*block_rows) — equal
        digests mean equal committed-prefix content, and (the decoder
        being deterministic) bit-equal KV rows."""
        r = self.block_rows
        out: List[str] = []
        prev = ""
        for j in range(len(prompt) // r):
            blk = ",".join(str(int(t)) for t in prompt[j * r:(j + 1) * r])
            prev = hashlib.sha1(
                f"{prev}|{blk}".encode()).hexdigest()[:16]
            out.append(prev)
        return out

    def _blocks_free(self) -> int:
        """Free-list blocks plus warm cached ones (reclaimable on
        demand) — the admission headroom gauge."""
        if not self.paged:
            return 0
        with self._mu:
            return len(self._free_blocks) + sum(
                1 for bid in self._prefix_cache.values()
                if self._block_refs[bid] == 0)

    def _blocks_shared(self) -> int:
        if not self.paged:
            return 0
        with self._mu:
            return sum(1 for n in self._block_refs if n >= 2)

    def _alloc_block_locked(self) -> Optional[int]:
        """One block off the free list; under pressure reclaims warm
        cached blocks (oldest cache entry first), then pages a cold
        session's block set out to the host spill store. None only when
        nothing is reclaimable. Caller holds _mu."""
        while True:
            if self._free_blocks:
                bid = self._free_blocks.pop()
                self._block_refs[bid] = 1
                self._block_digest[bid] = None
                self._block_fill[bid] = 0
                self._kv_bytes += self._block_nbytes
                return bid
            stale = next((d for d, b in self._prefix_cache.items()
                          if self._block_refs[b] == 0), None)
            if stale is not None:
                self._cache_drop_locked(stale)
                continue
            cold = [s for s in self._sessions.values()
                    if s.state == QUEUED and s.lane < 0
                    and not s.paged and s.block_table]
            if not cold:
                return None
            cold.sort(key=lambda s: s.last_progress)
            self._page_out_paged_locked(cold[0])

    def _incref_block_locked(self, bid: int) -> None:
        self._block_refs[bid] += 1
        d = self._block_digest[bid]
        if d is not None:
            self._prefix_cache.move_to_end(d)
            self._cache_touched[d] = time.monotonic()

    def _decref_block_locked(self, bid: int) -> None:
        self._block_refs[bid] -= 1
        if self._block_refs[bid] <= 0 and self._block_digest[bid] is None:
            # Zero-ref CACHED blocks stay resident (warm prefix cache,
            # reclaimed under pressure or by the TTL sweep).
            self._block_refs[bid] = 0
            self._free_blocks.append(bid)
            self._kv_bytes -= self._block_nbytes

    def _cache_insert_locked(self, sess: Session, j: int) -> None:
        bid = sess.block_table[j]
        if self._block_digest[bid] is not None:
            return
        d = sess.prompt_digests[j]
        if d in self._prefix_cache:
            return  # identical content already cached under another block
        self._prefix_cache[d] = bid
        self._block_digest[bid] = d
        self._cache_touched[d] = time.monotonic()

    def _cache_drop_locked(self, d: str) -> int:
        bid = self._prefix_cache.pop(d)
        self._block_digest[bid] = None
        self._cache_touched.pop(d, None)
        if self._block_refs[bid] == 0:
            self._free_blocks.append(bid)
            self._kv_bytes -= self._block_nbytes
        return bid

    def _admit_paged_locked(self, sess: Session) -> None:
        """Build a new session's block table: reference cached full
        prompt blocks (the shared-prefix hit — those prefill rows are
        skipped outright via sess.pos), allocate private blocks for the
        rest of the prompt + the first generated row. Later rows
        allocate lazily in kv_write_row. Raises ELIMIT on exhaustion."""
        r = self.block_rows
        prompt = sess.prompt
        digests = self._prefix_digests(prompt)
        sess.prompt_digests = digests
        nhit = 0
        for d in digests:
            bid = self._prefix_cache.get(d)
            if bid is None or self._block_fill[bid] != r:
                break
            nhit += 1
        self._prefix_hits += nhit
        self._prefix_misses += len(digests) - nhit
        self._m["prefix_hits"].add(nhit)
        self._m["prefix_misses"].add(len(digests) - nhit)
        need_total = -(-(len(prompt) + 1) // r)
        table: List[int] = []
        for j in range(nhit):
            bid = self._prefix_cache[digests[j]]
            self._incref_block_locked(bid)
            table.append(bid)
        for j in range(nhit, need_total):
            bid = self._alloc_block_locked()
            if bid is None:
                for b in table:
                    self._decref_block_locked(b)
                self._shed_total += 1
                self._m["shed"].add(1)
                raise native.RpcError(
                    native.TRPC_ELIMIT,
                    "KV blocks exhausted (retry_after_ms=100)")
            self._pool_k[bid, :] = 0.0
            self._pool_v[bid, :] = 0.0
            table.append(bid)
        sess.block_table = table
        sess.kv_nbytes = len(table) * self._block_nbytes
        # Prefill skip: rows [0, nhit*r) are bit-identical to the cached
        # blocks' contents (same tokens, same params, deterministic
        # decoder) — decode resumes there. NEVER past len(prompt)-1: the
        # final prompt row's ingestion computes the first token, so a
        # fully block-aligned prompt re-ingests its last row — which
        # lands IN a shared block and CoW-faults a private copy.
        sess.pos = min(nhit * r, len(prompt) - 1)

    def _ensure_writable_locked(self, sess: Session, j: int) -> bool:
        """Make block-table slot ``j`` privately writable: grow the
        table with fresh zeroed blocks, and copy-on-write when the slot's
        block is shared (refs > 1) OR cached (a write would invalidate
        the digest under readers — the copy leaves the cached original
        warm). False on pool exhaustion."""
        bt = sess.block_table
        while len(bt) <= j:
            bid = self._alloc_block_locked()
            if bid is None:
                return False
            self._pool_k[bid, :] = 0.0
            self._pool_v[bid, :] = 0.0
            bt.append(bid)
            sess.kv_nbytes = len(bt) * self._block_nbytes
        bid = bt[j]
        if self._block_refs[bid] > 1 or self._block_digest[bid] is not None:
            nb = self._alloc_block_locked()
            if nb is None:
                return False
            self._pool_k[nb, :] = self._pool_k[bid]
            self._pool_v[nb, :] = self._pool_v[bid]
            self._block_fill[nb] = self._block_fill[bid]
            self._decref_block_locked(bid)
            bt[j] = nb
            self._cow_faults += 1
        return True

    def kv_write_row(self, sess: Session, row: int, k_row, v_row) -> bool:
        """Engine-thread row write through the block table (the paged
        twin of ``sess.kv_k[row] = k_row``). False = pool exhausted (the
        engine sheds the session at the step boundary). Completing a
        full PROMPT block inserts it into the shared-prefix cache."""
        r = self.block_rows
        j, o = divmod(row, r)
        bt = sess.block_table
        # Unlocked fast path: a private (refs == 1, uncached) block can
        # only be re-shared through the prefix cache, and only THIS
        # engine thread inserts this session's blocks there — no open()
        # can incref it concurrently.
        if (j >= len(bt) or self._block_refs[bt[j]] > 1
                or self._block_digest[bt[j]] is not None):
            with self._mu:
                if not self._ensure_writable_locked(sess, j):
                    return False
        bid = bt[j]
        self._pool_k[bid, o] = k_row
        self._pool_v[bid, o] = v_row
        if o + 1 > self._block_fill[bid]:
            self._block_fill[bid] = o + 1
        if o + 1 == r and j < len(sess.prompt_digests):
            with self._mu:
                self._cache_insert_locked(sess, j)
        return True

    def pool_arrays(self):
        """Detached (capacity, block_rows, dim) fp32 copies of both pool
        planes — never hand an arena view to an asynchronous copy (the
        arena-alias rule)."""
        return np.array(self._pool_k), np.array(self._pool_v)

    def dispatch_pool(self, tables: np.ndarray):
        """Compact per-step dispatch copies: only the blocks ``tables``
        references (dedup'd, remapped, padded to the fixed
        batch*table-width slot count so every step has one shape) —
        the step's device transfer tracks the batch's KV, not the
        arena's capacity, which is the whole point of paging. Advanced
        indexing detaches the copies (the arena-alias rule); no lock:
        blocks referenced by in-flight lanes cannot be freed mid-step,
        and the engine thread is the only row writer."""
        uniq, inv = np.unique(tables, return_inverse=True)
        slots = tables.size
        sub_k = np.zeros((slots, self.block_rows, self.dim), np.float32)
        sub_v = np.zeros_like(sub_k)
        sub_k[:len(uniq)] = self._pool_k[uniq]
        sub_v[:len(uniq)] = self._pool_v[uniq]
        return sub_k, sub_v, inv.reshape(tables.shape).astype(np.int32)

    def padded_table(self, sess: Session) -> List[int]:
        """Block table padded to the fixed width max_len//block_rows
        (keeps the dispatch's shape fixed). Padding entries
        gather garbage rows that the attention mask scores -1e30 —
        exact-zero weight under fp32 softmax, bit-parity preserved."""
        width = self.max_len // self.block_rows
        return sess.block_table + [0] * (width - len(sess.block_table))

    def _gather_rows_locked(self, sess: Session):
        """Detached (pos, dim) fp32 row copies assembled from the block
        table (spill/export source)."""
        r = self.block_rows
        k = np.zeros((sess.pos, self.dim), np.float32)
        v = np.zeros_like(k)
        for j, bid in enumerate(sess.block_table):
            lo = j * r
            if lo >= sess.pos:
                break
            hi = min(sess.pos, lo + r)
            k[lo:hi] = self._pool_k[bid, :hi - lo]
            v[lo:hi] = self._pool_v[bid, :hi - lo]
        return k, v

    def _page_out_paged_locked(self, sess: Session) -> None:
        """Block-granular spill: gather filled rows to the host store,
        decref every table block (shared ones just drop a referent —
        their bytes stay for the other sessions)."""
        if self.oneside is not None:
            for j in range(len(sess.block_table)):
                self.oneside.unpublish(f"kv:{sess.id}:k:{j}")
                self.oneside.unpublish(f"kv:{sess.id}:v:{j}")
        k_rows, v_rows = self._gather_rows_locked(sess)
        self._spill[sess.id] = (k_rows, v_rows)
        self._spilled_bytes += k_rows.nbytes + v_rows.nbytes
        nblocks = len(sess.block_table)
        for bid in sess.block_table:
            self._decref_block_locked(bid)
        sess.block_table = []
        sess.kv_nbytes = 0
        sess.paged = True
        self._m["spill_out"].add(nblocks)

    def _fault_in_paged(self, sess: Session) -> bool:
        """Rebuild a spilled session's block table: full prompt blocks
        below pos re-reference the prefix cache when still resident
        (bit-identical by digest), everything else gets a private block
        restored from the spill rows. All-or-nothing."""
        r = self.block_rows
        with self._mu:
            if not sess.paged:
                return True
            k_rows, v_rows = self._spill[sess.id]
            need = -(-sess.pos // r) if sess.pos else 0
            table: List[int] = []
            ok = True
            for j in range(need):
                d = (sess.prompt_digests[j]
                     if (j < len(sess.prompt_digests)
                         and (j + 1) * r <= sess.pos) else None)
                bid = self._prefix_cache.get(d) if d is not None else None
                if bid is not None and self._block_fill[bid] == r:
                    self._incref_block_locked(bid)
                    table.append(bid)
                    continue
                bid = self._alloc_block_locked()
                if bid is None:
                    ok = False
                    break
                lo = j * r
                hi = min(sess.pos, lo + r)
                self._pool_k[bid, :] = 0.0
                self._pool_v[bid, :] = 0.0
                self._pool_k[bid, :hi - lo] = k_rows[lo:hi]
                self._pool_v[bid, :hi - lo] = v_rows[lo:hi]
                self._block_fill[bid] = hi - lo
                table.append(bid)
            if not ok:
                for bid in table:
                    self._decref_block_locked(bid)
                return False
            self._spill.pop(sess.id)
            self._spilled_bytes -= k_rows.nbytes + v_rows.nbytes
            sess.block_table = table
            sess.kv_nbytes = len(table) * self._block_nbytes
            sess.paged = False
            self._m["spill_in"].add(len(table))
            self.publish_kv(sess)
            return True

    def probe_prefix(self, blocks: List[Optional[str]],
                     block_rows: int = 0) -> List[int]:
        """Migration pre-flight: which of the manifest's block slots
        does THIS manager need shipped? Digest-bearing slots resolve
        against the prefix cache; digest-less slots (partial / generated
        rows) always ship. Mismatched block geometry needs everything."""
        if (not self.paged
                or (block_rows and block_rows != self.block_rows)):
            return list(range(len(blocks)))
        need: List[int] = []
        with self._mu:
            for j, d in enumerate(blocks):
                bid = self._prefix_cache.get(d) if d is not None else None
                if bid is None or self._block_fill[bid] != self.block_rows:
                    need.append(j)
        return need

    def prefix_rows(self, digest: str):
        """Detached (block_rows, dim) k/v copies of a cached full block,
        or None — the oneside fault-in path's local-cache short-circuit."""
        if not self.paged:
            return None
        with self._mu:
            bid = self._prefix_cache.get(digest)
            if bid is None or self._block_fill[bid] != self.block_rows:
                return None
            return np.array(self._pool_k[bid]), np.array(self._pool_v[bid])

    def get(self, sid: str) -> Optional[Session]:
        with self._mu:
            return self._sessions.get(sid)

    def note_spec(self, proposed: int, accepted: int) -> None:
        """Engine hook: account one speculative step's draft proposals
        vs acceptances (the /sessionz accept-rate source)."""
        with self._mu:
            self._spec_proposed += proposed
            self._spec_accepted += accepted

    def activate(self, sess: Session, lane: int) -> bool:
        """Atomic QUEUED -> ACTIVE(+lane) transition for the engine's
        admission. False when the session left QUEUED concurrently (a
        Gen/Close between the engine's snapshot and this call) — without
        the lock, admission could resurrect a SHED session whose KV views
        finish() already released. The lane is assigned IN the same
        critical section so a finish() racing right after always sees
        lane >= 0 and defers the KV release to the engine's sweep."""
        with self._mu:
            if sess.state != QUEUED:
                return False
            sess.state = ACTIVE
            sess.lane = lane
            sess.last_progress = time.monotonic()
            return True

    def finish(self, sess: Session, *, shed_reason: str = "",
               shed_code: int = 0) -> None:
        """Terminal transition (engine thread or Close RPC): close the
        sink, account, and release the KV range — UNLESS the session
        still sits on an engine lane: a concurrent decode step may be
        mid-write into the KV views, so laned sessions keep their range
        until the engine's step-boundary sweep calls release_kv (writing
        into a terminal session's still-held range is harmless; writing
        into a freed-and-reallocated one is not). ``shed_code`` rides the
        sink's error-coded close (E_SESSION_MOVED for a migration retire;
        the ELIMIT default otherwise). Idempotent."""
        with self._mu:
            if sess.state in (DONE, SHED):
                return
            sess.state = SHED if shed_reason else DONE
            sess.shed_reason = shed_reason
            sess.shed_code = shed_code
            if shed_reason:
                self._shed_total += 1
                self._m["shed"].add(1)
            else:
                self._done_total += 1
            if sess.lane < 0:
                self._release_kv_locked(sess)
        try:
            if sess.sink is not None:
                sess.sink.close(shed_reason, shed_code)
        except TypeError:
            try:  # a custom sink without the code parameter
                sess.sink.close(shed_reason)
            except Exception:  # noqa: BLE001
                pass
        except Exception:  # noqa: BLE001 — a dead sink is already closed
            pass

    def _release_kv_locked(self, sess: Session) -> None:
        if sess.paged:
            # The rows live in the spill store, not the arena/pool.
            rows = self._spill.pop(sess.id, None)
            if rows is not None:
                self._spilled_bytes -= rows[0].nbytes + rows[1].nbytes
            sess.paged = False
            return
        if self.paged:
            if not sess.block_table:
                return
            if self.oneside is not None:
                for j in range(len(sess.block_table)):
                    self.oneside.unpublish(f"kv:{sess.id}:k:{j}")
                    self.oneside.unpublish(f"kv:{sess.id}:v:{j}")
            for bid in sess.block_table:
                self._decref_block_locked(bid)
            sess.block_table = []
            sess.kv_nbytes = 0
            return
        if sess.kv_k is None:
            return
        if self.oneside is not None:
            # Unpublish BEFORE the free: the range may be reallocated to
            # a new session immediately, and a still-published slot would
            # hand a reader the new session's bytes under the old name.
            self.oneside.unpublish(f"kv:{sess.id}:k")
            self.oneside.unpublish(f"kv:{sess.id}:v")
        self._kv_bytes -= sess.kv_nbytes
        # Drop the views BEFORE freeing the range: a freed range can be
        # reallocated to a new session immediately.
        sess.kv_k = sess.kv_v = None
        self.arena.free(sess.kv_off)

    def release_kv(self, sess: Session) -> None:
        """Free a terminal session's KV range (the engine's lane sweep —
        the one place that knows no step is mid-write)."""
        with self._mu:
            self._release_kv_locked(sess)

    # ---- live migration (the serving fleet's freeze/ship/resume) ----

    def freeze(self, sess: Session) -> bool:
        """QUEUED/ACTIVE -> FROZEN: decode pauses for this session (the
        engine frees its lane at the next step boundary WITHOUT releasing
        the KV) so its state can be exported. False when the session is
        already terminal/frozen."""
        with self._mu:
            if sess.state not in (QUEUED, ACTIVE):
                return False
            sess.state = FROZEN
            sess.last_progress = time.monotonic()
            return True

    def unfreeze(self, sess: Session) -> None:
        """FROZEN -> live: the ship failed — decode resumes locally
        (nothing was lost: export is a copy). A session still holding
        its engine lane (the freeze never reached a step boundary, e.g.
        a stalled engine timed the exporter out) goes back to ACTIVE on
        that SAME lane — re-queueing it would let admission hand it a
        second lane while the first still references it (double-decode).
        The lane check shares _mu with park_frozen_lane, so the engine's
        sweep and this transition serialize."""
        with self._mu:
            if sess.state == FROZEN:
                sess.state = ACTIVE if sess.lane >= 0 else QUEUED

    def park_frozen_lane(self, sess: Session) -> bool:
        """The engine's sweep-side half of the freeze handshake: clear a
        FROZEN session's lane under _mu (True = the engine should free
        the lane slot; lane == -1 then signals the exporter it is safe
        to read). False when an unfreeze won the race — the session is
        ACTIVE again and keeps its lane."""
        with self._mu:
            if sess.state != FROZEN:
                return False
            sess.lane = -1
            return True

    def exportable(self, sess: Session) -> bool:
        """True once a frozen session is off its engine lane — the one
        point where no decode step can be mid-write into its planes."""
        return sess.state == FROZEN and sess.lane < 0

    def export_session(self, sess: Session):
        """-> (manifest dict, (2, pos, dim) fp32 KV rows) for a FROZEN,
        off-lane session: everything the destination needs to resume the
        EXACT trajectory — prompt, decode position, last token, the full
        emitted-token list (resume replay), tenant/priority/deadline, and
        the filled KV rows (version == pos, the published-KV contract)."""
        if not self.exportable(sess):
            raise native.RpcError(
                native.TRPC_EINTERNAL,
                f"session {sess.id} not exportable "
                f"(state={sess.state}, lane={sess.lane})")
        with self._mu:
            if sess.paged:
                k_rows, v_rows = self._spill[sess.id]
                k_rows = np.array(k_rows)
                v_rows = np.array(v_rows)
            elif self.paged:
                k_rows, v_rows = self._gather_rows_locked(sess)
            else:
                k_rows = np.array(sess.kv_k[:sess.pos])
                v_rows = np.array(sess.kv_v[:sess.pos])
            manifest = {
                "session": sess.id,
                "prompt": list(sess.prompt),
                "max_tokens": sess.max_tokens,
                "tenant": sess.tenant,
                "priority": sess.priority,
                "pos": sess.pos,
                "token": sess.token,
                "emitted": sess.emitted,
                "out_tokens": list(sess.out_tokens),
                "dim": self.dim,
            }
            if sess.deadline_at is not None:
                manifest["deadline_s"] = max(
                    0.0, sess.deadline_at - time.monotonic())
            if self.paged:
                # Block identity rides the manifest: a paged destination
                # probes these digests against its own prefix cache and
                # requests ONLY the slots it misses (None = partial or
                # generated-row block, always shipped).
                r = self.block_rows
                manifest["block_rows"] = r
                manifest["blocks"] = [
                    (sess.prompt_digests[j]
                     if (j < len(sess.prompt_digests)
                         and (j + 1) * r <= sess.pos) else None)
                    for j in range(-(-sess.pos // r) if sess.pos else 0)]
        kv = np.stack([k_rows, v_rows]) if sess.pos else np.zeros(
            (2, 0, self.dim), np.float32)
        return manifest, kv

    def import_session(self, manifest: dict, kv) -> Session:
        """Install a migrated session (the receiving half of export):
        the session arrives PARKED — sink=None, skipped by admission —
        until the client's Gen/Resume attaches a stream. Raises ELIMIT
        when the arena stays exhausted (the source keeps the session)."""
        sid = str(manifest["session"])
        prompt = [int(t) for t in manifest["prompt"]]
        pos = int(manifest["pos"])
        dim = int(manifest["dim"])
        if dim != self.dim:
            raise native.RpcError(
                native.TRPC_EINTERNAL,
                f"KV dim mismatch: session {sid} has {dim}, "
                f"this server runs {self.dim}")
        if len(prompt) + int(manifest["max_tokens"]) > self.max_len:
            raise native.RpcError(
                native.TRPC_EINTERNAL,
                f"session {sid} exceeds this server's KV window "
                f"{self.max_len}")
        if self.paged:
            sess = self._install_paged(manifest, sid, prompt, pos, kv)
            self._m["migrated_in"].add(1)
            return sess
        if manifest.get("kv_blocks") is not None:
            raise native.RpcError(
                native.TRPC_EINTERNAL,
                f"session {sid} shipped a partial block payload to a "
                "monolithic server")
        kv = np.asarray(kv, dtype=np.float32).reshape(2, pos, dim)
        per_plane = self.max_len * self.dim * 4
        with self._mu:
            live = self._sessions.get(sid)
            if live is not None and live.state in (QUEUED, ACTIVE, FROZEN):
                from brpc_tpu_torch.runtime.param_server import E_EXISTS

                raise native.RpcError(
                    E_EXISTS, f"session {sid} already live here")
            off = self._alloc_kv_locked(2 * per_plane)
            if off is None:
                raise native.RpcError(
                    native.TRPC_ELIMIT,
                    "KV arena exhausted (retry_after_ms=100)")
            kv_k = self.arena.view(off, per_plane).view(np.float32).reshape(
                self.max_len, self.dim)
            kv_v = self.arena.view(off + per_plane, per_plane).view(
                np.float32).reshape(self.max_len, self.dim)
            kv_k[:] = 0.0
            kv_v[:] = 0.0
            kv_k[:pos] = kv[0]
            kv_v[:pos] = kv[1]
            sess = Session(sid, prompt, int(manifest["max_tokens"]),
                           str(manifest.get("tenant", "")),
                           int(manifest.get("priority",
                                            native.PRIORITY_BULK)),
                           manifest.get("deadline_s"), None, off,
                           2 * per_plane, kv_k, kv_v)
            sess.pos = pos
            sess.token = int(manifest.get("token", 0))
            sess.emitted = int(manifest.get("emitted", 0))
            sess.out_tokens = [int(t) for t in
                               manifest.get("out_tokens", [])]
            self._sessions[sid] = sess
            self._kv_bytes += 2 * per_plane
            self.publish_kv(sess)
        self._m["migrated_in"].add(1)
        return sess

    def _install_paged(self, manifest: dict, sid: str, prompt: List[int],
                       pos: int, kv) -> Session:
        """Paged half of import_session: block slots resolve against the
        LOCAL prefix cache first (the migration only had to ship the
        misses); a slot that is neither shipped nor cached raises
        E_NO_SUCH so the source falls back to a full-plane ship."""
        from brpc_tpu_torch.runtime.param_server import E_EXISTS, E_NO_SUCH

        r = self.block_rows
        nblocks = -(-pos // r) if pos else 0
        # Digests are derived LOCALLY (same rolling hash over the same
        # prompt tokens) — manifest digests are advisory; a mismatched
        # source geometry simply cache-misses into the shipped rows.
        digests = self._prefix_digests(prompt)
        kv_blocks = manifest.get("kv_blocks")
        src_r = int(manifest.get("block_rows", r) or r)
        if kv_blocks is not None and src_r != r:
            # Mismatched geometry forces a full ship (probe_prefix needs
            # every slot); the rows are contiguous either way.
            kv_blocks = None
        kv = np.asarray(kv, dtype=np.float32)
        src: Dict[int, tuple] = {}
        if kv_blocks is None:
            kv = kv.reshape(2, pos, self.dim)
            for j in range(nblocks):
                lo, hi = j * r, min(pos, j * r + r)
                src[j] = (kv[0, lo:hi], kv[1, lo:hi])
        else:
            kv = kv.reshape(2, -1, self.dim)
            off = 0
            for j in sorted(int(x) for x in kv_blocks):
                lo, hi = j * r, min(pos, j * r + r)
                src[j] = (kv[0, off:off + hi - lo],
                          kv[1, off:off + hi - lo])
                off += hi - lo
        with self._mu:
            live = self._sessions.get(sid)
            if live is not None and live.state in (QUEUED, ACTIVE, FROZEN):
                raise native.RpcError(
                    E_EXISTS, f"session {sid} already live here")
            table: List[int] = []
            hits = misses = 0
            try:
                for j in range(nblocks):
                    d = (digests[j] if (j < len(digests)
                                        and (j + 1) * r <= pos) else None)
                    bid = (self._prefix_cache.get(d)
                           if d is not None else None)
                    if bid is not None and self._block_fill[bid] == r:
                        self._incref_block_locked(bid)
                        table.append(bid)
                        hits += 1
                        continue
                    if d is not None:
                        misses += 1
                    rows = src.get(j)
                    if rows is None:
                        raise native.RpcError(
                            E_NO_SUCH,
                            f"block {j} of session {sid} neither shipped "
                            "nor cached here")
                    bid = self._alloc_block_locked()
                    if bid is None:
                        raise native.RpcError(
                            native.TRPC_ELIMIT,
                            "KV blocks exhausted (retry_after_ms=100)")
                    n = rows[0].shape[0]
                    self._pool_k[bid, :] = 0.0
                    self._pool_v[bid, :] = 0.0
                    self._pool_k[bid, :n] = rows[0]
                    self._pool_v[bid, :n] = rows[1]
                    self._block_fill[bid] = n
                    table.append(bid)
                    if (d is not None and n == r
                            and d not in self._prefix_cache):
                        # A freshly shipped full prompt block seeds the
                        # local cache — the NEXT migration/open of this
                        # prefix ships nothing.
                        self._prefix_cache[d] = bid
                        self._block_digest[bid] = d
                        self._cache_touched[d] = time.monotonic()
            except Exception:
                for b in table:
                    self._decref_block_locked(b)
                raise
            self._prefix_hits += hits
            self._prefix_misses += misses
            self._m["prefix_hits"].add(hits)
            self._m["prefix_misses"].add(misses)
            sess = Session(sid, prompt, int(manifest["max_tokens"]),
                           str(manifest.get("tenant", "")),
                           int(manifest.get("priority",
                                            native.PRIORITY_BULK)),
                           manifest.get("deadline_s"), None, -1,
                           len(table) * self._block_nbytes, None, None)
            sess.block_table = table
            sess.prompt_digests = digests
            sess.pos = pos
            sess.token = int(manifest.get("token", 0))
            sess.emitted = int(manifest.get("emitted", 0))
            sess.out_tokens = [int(t) for t in
                               manifest.get("out_tokens", [])]
            self._sessions[sid] = sess
            self.publish_kv(sess)
        return sess

    def attach_sink(self, sess: Session, sink, have: int = 0) -> int:
        """Un-park an imported session: attach the client's new stream
        and queue ``out_tokens[have:]`` for replay (``have`` = tokens the
        client already holds — the prefix-exactness contract: nothing is
        re-sent that landed, nothing in flight at the old server is
        lost). Returns the number of frames queued for replay."""
        have = max(0, min(int(have), len(sess.out_tokens)))
        with self._mu:
            if sess.state != QUEUED or sess.sink is not None:
                raise native.RpcError(
                    native.TRPC_EINTERNAL,
                    f"session {sess.id} not awaiting resume "
                    f"(state={sess.state})")
            replay = sess.out_tokens[have:]
            for tok in replay:
                frame = FRAME_TOKEN + str(tok).encode()
                sess.pending.append(frame)
                sess.pending_bytes += len(frame)
            sess.sink = sink
            sess.last_progress = time.monotonic()
        return len(replay)

    # ---- one-sided KV publication (publish_kv=True) ----

    def kv_begin_step(self, sessions) -> None:
        """Write-lock the published KV slots of ``sessions`` (seq -> odd)
        before the engine's in-place plane writes: a one-sided reader
        that lands mid-step retries/falls back instead of copying a
        half-written row. ``publish_kv(sess)`` commits after the step.
        No-op without a window."""
        if self.oneside is None:
            return
        for sess in sessions:
            if self.paged:
                bt = sess.block_table
                if not bt:
                    continue
                # A step writes at pos (spec: pos..pos+W-1) — lock every
                # published slot from the write frontier on. Blocks the
                # step grows lazily are published only AFTER it commits,
                # so they need no seqlock here.
                j0 = min(sess.pos // self.block_rows, len(bt) - 1)
                for j in range(j0, len(bt)):
                    self.oneside.begin_rewrite(f"kv:{sess.id}:k:{j}")
                    self.oneside.begin_rewrite(f"kv:{sess.id}:v:{j}")
            elif sess.kv_k is not None:
                self.oneside.begin_rewrite(f"kv:{sess.id}:k")
                self.oneside.begin_rewrite(f"kv:{sess.id}:v")

    def publish_kv(self, sess: Session) -> None:
        """(Re)publish ``sess``'s KV planes at version = rows filled.
        Not-owned publication: the session keeps its range (released via
        the engine's lane sweep, which unpublishes first). No-op without
        a window or once the KV is released."""
        if self.oneside is None:
            return
        if self.paged:
            if not sess.block_table:
                return
            r, pbp = self.block_rows, self._blk_plane
            try:
                for j, bid in enumerate(sess.block_table):
                    ver = min(r, max(0, sess.pos - j * r))
                    self.oneside.publish(
                        f"kv:{sess.id}:k:{j}",
                        self._pool_k_off + bid * pbp, pbp, ver, own=False)
                    self.oneside.publish(
                        f"kv:{sess.id}:v:{j}",
                        self._pool_v_off + bid * pbp, pbp, ver, own=False)
            except (ValueError, RuntimeError):
                pass  # directory full: not publishable
            return
        if sess.kv_k is None:
            return
        per_plane = self.max_len * self.dim * 4
        try:
            self.oneside.publish(f"kv:{sess.id}:k", sess.kv_off, per_plane,
                                 sess.pos, own=False)
            self.oneside.publish(f"kv:{sess.id}:v",
                                 sess.kv_off + per_plane, per_plane,
                                 sess.pos, own=False)
        except (ValueError, RuntimeError):
            pass  # directory full: this session simply isn't publishable

    def close(self, sid: str) -> bool:
        """Explicit client Close: ends the session whatever its state."""
        sess = self.get(sid)
        if sess is None:
            return False
        self.finish(sess, shed_reason="closed by client")
        return True

    def evict_expired(self, now: Optional[float] = None) -> List[Session]:
        """TTL + deadline sweep — called at step boundaries (and usable
        standalone): deadline-expired live sessions and TERMINAL sessions
        older than ttl_s (retained for /sessionz post-mortems) go."""
        now = time.monotonic() if now is None else now
        shed, drop = [], []
        with self._mu:
            if self.paged:
                # Block-granular TTL: warm cached blocks (zero-ref) that
                # nobody touched for ttl_s go back to the free list.
                stale = [d for d, bid in self._prefix_cache.items()
                         if self._block_refs[bid] == 0
                         and now - self._cache_touched.get(d, now)
                         > self.ttl_s]
                for d in stale:
                    self._cache_drop_locked(d)
            for sess in self._sessions.values():
                if sess.state in (QUEUED, ACTIVE, FROZEN):
                    # FROZEN counts as live: a migration that stalls past
                    # the TTL sheds like any idle session (finish releases
                    # the KV) instead of leaking the frozen range.
                    if sess.expired(now):
                        shed.append(sess)
                    elif now - sess.last_progress > self.ttl_s:
                        shed.append(sess)  # idle past TTL: evict
                elif now - sess.last_progress > self.ttl_s:
                    drop.append(sess.id)
            for sid in drop:
                del self._sessions[sid]
        for sess in shed:
            reason = ("deadline expired" if sess.expired(now)
                      else "idle past ttl")
            self.finish(sess, shed_reason=reason)
        return shed

    # ---- introspection ----

    def _live_count(self) -> int:
        with self._mu:
            return sum(1 for s in self._sessions.values()
                       if s.state in (QUEUED, ACTIVE, FROZEN))

    def live(self) -> List[Session]:
        with self._mu:
            return [s for s in self._sessions.values()
                    if s.state in (QUEUED, ACTIVE, FROZEN)]

    def sessionz_doc(self) -> dict:
        m = self._m
        with self._mu:
            sessions = [{
                "id": s.id, "tenant": s.tenant or "(none)",
                "priority": s.priority, "state": s.state,
                "tokens": s.emitted,
                "kv_bytes": (s.kv_nbytes
                             if (s.kv_k is not None or s.block_table)
                             else 0),
                "age_s": int(s.age_s()), "pending": s.pending_bytes,
                "paged": s.paged, "spec_k": s.spec_k,
                "blocks": len(s.block_table),
            } for s in self._sessions.values()]
            active = sum(1 for s in self._sessions.values()
                         if s.state in (QUEUED, ACTIVE, FROZEN))
            kv_bytes = self._kv_bytes
            spilled = self._spilled_bytes
            shed_total = self._shed_total
            spec_prop = self._spec_proposed
            spec_acc = self._spec_accepted
            pfx_hits = self._prefix_hits
            pfx_misses = self._prefix_misses
            cow = self._cow_faults
            if self.paged:
                blocks_free = len(self._free_blocks) + sum(
                    1 for bid in self._prefix_cache.values()
                    if self._block_refs[bid] == 0)
                blocks_shared = sum(1 for n in self._block_refs if n >= 2)
                blocks_cached = len(self._prefix_cache)
            else:
                blocks_free = blocks_shared = blocks_cached = 0
        lookups = pfx_hits + pfx_misses
        return {
            "active": active,
            "kv_bytes": kv_bytes,
            "kv_spilled_bytes": spilled,
            "tokens_per_s": m["token"].qps(),
            "ttft_p99_us": m["ttft"].p99(),
            "tokens_total": m["tokens"].value(),
            "shed_total": shed_total,
            "spec_proposed": spec_prop,
            "spec_accepted": spec_acc,
            "spec_accept_pct": (round(100.0 * spec_acc / spec_prop, 1)
                                if spec_prop else 0.0),
            # Paged KV: the aggregate-ratio hit rate (never a mean of
            # percentages) + pool occupancy for the native page.
            "paged_mode": self.paged,
            "block_rows": self.block_rows,
            "kv_blocks_free": blocks_free,
            "kv_blocks_shared": blocks_shared,
            "kv_blocks_cached": blocks_cached,
            "prefix_hits": pfx_hits,
            "prefix_misses": pfx_misses,
            "prefix_hit_pct": (round(100.0 * pfx_hits / lookups, 1)
                               if lookups else 0.0),
            "cow_faults": cow,
            "sessions": sessions,
        }

    def sessionz_json(self) -> str:
        return json.dumps(self.sessionz_doc())

    def shutdown(self) -> None:
        """Finish every live session and release the arena."""
        for sess in self.live():
            self.finish(sess, shed_reason="server shutting down")
        with self._mu:
            # The engine is stopped by now (ServingServer.stop order):
            # laned sessions' deferred ranges can be reclaimed safely.
            for sess in self._sessions.values():
                self._release_kv_locked(sess)
        # Clear only if WE are still the registered provider (a newer
        # manager's registration survives our shutdown).
        native.clear_sessionz_provider(self._sessionz_fn)
        self.arena.close()
