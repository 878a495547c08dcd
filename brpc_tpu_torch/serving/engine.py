"""Continuous-batching decode driver: a step loop over the decoder
(``models/decoder.py``) that admits newly opened sessions into the
running batch AT STEP BOUNDARIES and retires finished or shed ones,
emitting each session's token on its own stream the moment the step that
produced it completes — time-to-first-token does not wait for any other
session.

The JAX package's ``serving/engine.py`` in the port. The batch has FIXED
``max_batch`` lanes: live sessions map onto lanes, the rest are masked,
so every step runs one shape and a lane's tokens never depend on which
other sessions share the batch. Each lane's KV rows live in its
session's arena range (host memory); a step copies them to the card,
runs the decoder there and brings back only the new (k, v) row per lane
and the next tokens. That device work happens inside the step's model
stage ("model"; "draft" and "verify" on the speculative path) and
nowhere else, on a CUDA stream of the engine's own, and the copy of the
outputs back to the host is what ends a step. Copies out of arena views
block, so a released page is never rewritten under a copy in flight.

Emission never blocks the step loop: tokens are try-written (timeout 0)
onto the session's sink; a slow reader's tokens queue in that session's
bounded pending buffer, and the session is shed when the buffer
overflows or stalls past the timeout — one stalled consumer costs only
its own stream.

QoS: a session's deadline is checked between steps (an expired session
sheds at a step boundary, never mid-write); admission prefers HIGH
priority sessions over BULK when lanes are scarce. Each step runs inside
an rpcz span with stage annotations.

Speculative decoding: with ``spec_k > 0`` a step goes draft -> verify ->
commit. A proposer fills a fixed-shape (max_batch, W <= spec_k+1) window
per step (remaining prompt tokens first — known inputs need no
verification, so prefill ingests up to W rows per dispatch — then draft
proposals: the model-free n-gram prompt lookup, or a smaller draft
decoder with its own engine-owned KV plane); ONE ``verify_step`` scores
every position with the exact ``decode_step`` math, and the commit walk
accepts the longest prefix where each proposal equals the previous
position's target argmax, plus the target's own token at the first
mismatch. Output is therefore identical to non-speculative greedy
decoding. Rejection is a pointer rewind: only accepted rows are written
back (paging, export and one-sided publication see committed rows only),
and the draft plane rewinds the same way. Per-session ``spec_k`` adapts
on an acceptance-rate EMA (floor 1); ``engine.spec_k = 0`` is the live
kill switch, the verbatim single-token path.
"""

from __future__ import annotations

import contextlib
import threading
import time
import traceback
from typing import List, Optional

import numpy as np
import torch

from brpc_tpu_torch.models.decoder import (DecoderParams, decode_step,
                                           decode_step_paged, draft_propose,
                                           emit_done, init_decoder,
                                           ngram_propose, verify_step,
                                           verify_step_paged)
from brpc_tpu_torch.observability import tracing
from brpc_tpu_torch.serving.session import (ACTIVE, DONE, FRAME_TOKEN,
                                            FROZEN, QUEUED, SHED, Session,
                                            SessionManager, serving_metrics)
from brpc_tpu_torch.utils.device import resolve_device


class DecodeEngine:
    """Owns the step loop thread. ``start()``/``stop()`` bracket it; tests
    may instead call ``step()`` directly for deterministic single-stepping
    (the loop and the manual mode share every code path).

    ``device`` (default CUDA; raises when CUDA is missing) is where the
    decoder runs; ``params`` (default: drawn from a generator seeded 0 at
    the manager's width) are moved there. ``draft_params`` (default: a
    generator seeded 1, ``draft_dim`` wide) serve ``draft="model"``."""

    def __init__(self, manager: SessionManager,
                 params: Optional[DecoderParams] = None, *,
                 max_batch: int = 4, eos_id: int = 0,
                 step_idle_s: float = 0.02, spec_k: int = 0,
                 draft: str = "ngram",
                 draft_params: Optional[DecoderParams] = None,
                 draft_dim: int = 16, spec_ema_alpha: float = 0.3,
                 device=None):
        self.manager = manager
        self.device = resolve_device(device)
        if params is None:
            params = init_decoder(torch.Generator().manual_seed(0),
                                  dim=manager.dim, device=self.device)
        self.params = DecoderParams(*(t.to(self.device) for t in params))
        self.max_batch = max_batch
        self.eos_id = eos_id
        self.step_idle_s = step_idle_s
        # spec_k is a PLAIN attribute read once per step: setting it live
        # (Gen/Spec, tests) takes effect at the next step boundary, and 0
        # is the kill switch — the verbatim single-token path.
        if draft not in ("ngram", "model"):
            raise ValueError(f"unknown draft proposer {draft!r}")
        self.spec_k = int(spec_k)
        self.draft = draft
        self.spec_ema_alpha = spec_ema_alpha
        self._draft_params: Optional[DecoderParams] = None
        if draft == "model":
            if draft_params is None:
                draft_params = init_decoder(
                    torch.Generator().manual_seed(1), dim=draft_dim,
                    device=self.device)
            self._draft_params = DecoderParams(
                *(t.to(self.device) for t in draft_params))
            ddim = self._draft_params.embed.shape[1]
            # The draft's KV planes are ENGINE-owned, keyed by lane and
            # session id: spec state is ephemeral (freeze, migration and
            # paging never ship it; an importing engine rebuilds it by
            # catch-up ingestion; a rejected run is a pointer rewind).
            self._draft_kv_k = np.zeros((max_batch, manager.max_len, ddim),
                                        np.float32)
            self._draft_kv_v = np.zeros_like(self._draft_kv_k)
        self._draft_sid: List[Optional[str]] = [None] * max_batch
        self._draft_pos = [0] * max_batch
        # The engine thread is the only device user of a serving server;
        # its device work runs on a stream of its own. The parameters'
        # placing copies complete before the first step reads them.
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            for p in (*self.params, *(self._draft_params or ())):
                p.record_stream(self._stream)
        # Bytes each step copied host -> card (the last step's).
        self.last_h2d_bytes = 0
        self.steps = 0
        # Serving-fleet hook: called (engine thread, must only enqueue)
        # when a prefill-role session freezes at its handoff point.
        self.on_session_frozen = None
        self._lanes: List[Optional[Session]] = [None] * max_batch
        self._mu = threading.Lock()
        self._wake = threading.Condition(self._mu)
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._m = serving_metrics()

    def _device_ctx(self):
        """Enters the engine's CUDA stream (nothing on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _to_device(self, arr: np.ndarray, dtype=None) -> torch.Tensor:
        """A host array on the engine's device: a blocking copy, complete
        before return. Integer arrays become int64, the decoder's index
        type."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if dtype is None:
            dtype = t.dtype if t.is_floating_point() else torch.int64
        self.last_h2d_bytes += t.numel() * t.element_size()
        return t.to(self.device, dtype=dtype, copy=True)

    def _lanes_to_device(self, sessions: List[Session]):
        """(B, L, D) device planes, zero but for each session's arena
        rows in its lane, each copied straight from the arena view."""
        B, L, D = self.max_batch, self.manager.max_len, self.manager.dim
        kv_k = torch.zeros((B, L, D), dtype=torch.float32,
                           device=self.device)
        kv_v = torch.zeros_like(kv_k)
        for sess in sessions:
            kv_k[sess.lane].copy_(torch.from_numpy(sess.kv_k))
            kv_v[sess.lane].copy_(torch.from_numpy(sess.kv_v))
        self.last_h2d_bytes += 2 * len(sessions) * L * D * 4
        return kv_k, kv_v

    # ---- lifecycle ----

    def start(self) -> None:
        with self._mu:
            if self._running:
                return
            self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        name="decode-engine", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        with self._mu:
            self._running = False
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def notify(self) -> None:
        """A session was opened: wake the loop for admission."""
        with self._mu:
            self._wake.notify_all()

    def _loop(self) -> None:
        while True:
            with self._mu:
                if not self._running:
                    return
            try:
                progressed = self.step()
            except Exception:  # noqa: BLE001 — a dead engine thread hangs
                # every session on the server; log loudly, pause, go on.
                traceback.print_exc()
                progressed = False
                time.sleep(0.1)
            if not progressed:
                with self._mu:
                    if not self._running:
                        return
                    self._wake.wait(timeout=self.step_idle_s)

    # ---- one step ----

    def _admit(self) -> None:
        """Fill free lanes from QUEUED sessions, HIGH priority first (the
        QoS lanes applied to batch admission), then open order. PARKED
        sessions (imported by a migration, no sink until the client's
        Resume attaches one) are skipped; paged-out sessions fault their
        KV back in here — the "next decode" of the paging contract."""
        free = [i for i, s in enumerate(self._lanes) if s is None]
        if not free:
            return
        queued = [s for s in self.manager.live()
                  if s.state == QUEUED and s.sink is not None]
        queued.sort(key=lambda s: (s.priority, s.opened_at))
        for sess in queued:
            if not free:
                break
            if sess.paged and not self.manager.fault_in(sess):
                continue  # arena still exhausted: stays queued for now
            # Atomic under the manager lock: a Gen/Close racing this
            # admission loses cleanly (activate False) instead of being
            # resurrected onto a lane with freed KV views.
            if self.manager.activate(sess, free[0]):
                self._lanes[free.pop(0)] = sess

    def _retire(self, sess: Session, *, shed_reason: str = "") -> None:
        if 0 <= sess.lane < len(self._lanes):
            self._lanes[sess.lane] = None
        # Engine-thread-owned: the session is leaving the batch at a
        # step boundary and finish() below retakes _mu before any
        # state change.  tpulint: allow(state-machine)
        sess.lane = -1
        self.manager.finish(sess, shed_reason=shed_reason)

    def _flush_pending(self, sess: Session, now: float) -> bool:
        """Drain the session's pending frames with try-writes. False =>
        the session must be shed (dead sink, overflow, or stall)."""
        while sess.pending:
            frame = sess.pending[0]
            verdict = sess.sink.emit(frame)
            if verdict == "ok":
                sess.pending.pop(0)
                sess.pending_bytes -= len(frame)
                sess.stalled_since = None
                continue
            if verdict == "dead":
                sess.shed_reason = "reader gone"
                return False
            # "full": the reader is slow. Bounded patience.
            if sess.stalled_since is None:
                sess.stalled_since = now
            if (sess.pending_bytes > self.manager.max_pending_bytes
                    or now - sess.stalled_since
                    > self.manager.stall_timeout_s):
                sess.shed_reason = "slow reader"
                return False
            return True  # keep buffering; retry next step
        return True

    def _emit(self, sess: Session, token: int, now: float) -> bool:
        frame = FRAME_TOKEN + str(token).encode()
        sess.pending.append(frame)
        sess.pending_bytes += len(frame)
        ok = self._flush_pending(sess, now)
        if ok:
            if sess.emitted == 0:
                # TTFT = open -> first token produced (handed to the wire
                # or, for a briefly-full window, its credit queue).
                sess.ttft_s = now - sess.opened_at
                self._m["ttft"].record_s(sess.ttft_s)
            sess.emitted += 1
            sess.out_tokens.append(token)  # the resume-replay record
            self._m["tokens"].add(1)
            self._m["token"].record_us(1)  # one sample per token: qps
        return ok

    def step(self) -> bool:
        """One decode step: evict/admit at the boundary, run the batched
        model over active lanes, emit. Returns False when there was
        nothing to do (the loop then idles)."""
        now = time.monotonic()
        # Step boundary: deadline/TTL sheds first — an expired session
        # never consumes another model step (and is never cut mid-write).
        for sess in self.manager.evict_expired(now):
            if 0 <= sess.lane < len(self._lanes):
                self._lanes[sess.lane] = None
                # Terminal sessions only (evict_expired transitioned
                # them under _mu); no admission path can race a
                # terminal state.  tpulint: allow(state-machine)
                sess.lane = -1
                self.manager.release_kv(sess)
        # Sweep lanes whose session was finished EXTERNALLY (client
        # Close, shutdown) since the last step: free the lane and release
        # the KV range finish() deferred to us — the one point where no
        # step can be mid-write into it. FROZEN sessions (a migrator's
        # freeze landing mid-step) free their lane the same way but KEEP
        # their KV: lane == -1 is the exporter's it-is-safe-to-read
        # signal, and the range stays live for the export.
        for i, sess in enumerate(self._lanes):
            if sess is None:
                continue
            if sess.state in (DONE, SHED):
                self._lanes[i] = None
                # Terminal sweep, same discipline as above.
                # tpulint: allow(state-machine)
                sess.lane = -1
                self.manager.release_kv(sess)
            elif sess.state == FROZEN:
                # State re-checked UNDER the manager lock: an unfreeze
                # (failed ship resuming locally) racing this sweep must
                # either win (session back to ACTIVE, keeps its lane) or
                # lose (lane parked, unfreeze re-queues it) — never leave
                # an off-lane ACTIVE session or a double-laned one.
                if self.manager.park_frozen_lane(sess):
                    self._lanes[i] = None
        self._admit()
        active = [s for s in self._lanes if s is not None]
        if not active:
            return False
        # Finished sessions may linger on their lane while a slow reader
        # drains their pending tail — they no longer decode. With NOTHING
        # decodable, skip the model/span entirely and report idle so the
        # loop sleeps between drain attempts instead of busy-spinning
        # (and minting empty rpcz spans) until the tail flushes or the
        # stall timeout sheds it.
        decodable = [s for s in active if s.emitted < s.max_tokens]
        if not decodable:
            self._drain_finished(now)
            return False
        if self.spec_k > 0:
            self._step_spec(decodable)
        else:
            self._step_plain(decodable)
        self._drain_finished(time.monotonic())
        return True

    def _step_plain(self, decodable: List[Session]) -> None:
        """The reference single-token step (spec_k == 0, the kill
        switch): one ``decode_step`` dispatch, one emission per lane."""
        with tracing.trace_span("decode_step"):
            tracing.annotate(f"batch={len(decodable)}")
            with tracing.stage("model"):
                B = self.max_batch
                L = self.manager.max_len
                mgr = self.manager
                lengths = np.zeros((B,), np.int32)
                tokens = np.zeros((B,), np.int32)
                for sess in decodable:
                    i = sess.lane
                    lengths[i] = sess.pos
                    tokens[i] = (sess.prompt[sess.pos]
                                 if sess.pos < len(sess.prompt)
                                 else sess.token)
                if mgr.paged:
                    # Block-indexed dispatch: only the blocks this
                    # batch's tables reference cross to the card
                    # (compact dedup'd copies remapped to a fixed slot
                    # count — one shape, transfer cost independent of
                    # arena capacity).
                    tables = np.zeros((B, L // mgr.block_rows), np.int32)
                    for sess in decodable:
                        tables[sess.lane] = mgr.padded_table(sess)
                    pool_k, pool_v, tables = mgr.dispatch_pool(tables)
                self.last_h2d_bytes = 0
                with self._device_ctx():
                    if mgr.paged:
                        out = decode_step_paged(
                            self.params, self._to_device(pool_k),
                            self._to_device(pool_v),
                            self._to_device(tables),
                            self._to_device(lengths),
                            self._to_device(tokens))
                    else:
                        kv_k, kv_v = self._lanes_to_device(decodable)
                        out = decode_step(self.params, kv_k, kv_v,
                                          self._to_device(lengths),
                                          self._to_device(tokens))
                    # The D2H of the step's outputs ends the step.
                    nxt, k_new, v_new = (t.cpu().numpy() for t in out)
            with tracing.stage("emit"):
                now = time.monotonic()
                # Published KV slots go write-locked across the in-place
                # row writes below; publish_kv() after each session's
                # write commits the new version (one-sided readers of a
                # mid-step plane retry/fall back instead of seeing a
                # half-written row).
                self.manager.kv_begin_step(decodable)
                handoffs = []
                for sess in decodable:
                    if sess.state != ACTIVE:
                        continue  # finished externally mid-step: swept
                    i = sess.lane  # at the next boundary
                    if mgr.paged:
                        # Table-routed row write (lazy block growth +
                        # CoW); False = pool truly exhausted — shed THIS
                        # session, everyone else keeps decoding.
                        if not mgr.kv_write_row(sess, sess.pos,
                                                k_new[i], v_new[i]):
                            self._retire(sess,
                                         shed_reason="kv blocks exhausted")
                            continue
                    else:
                        sess.kv_k[sess.pos] = k_new[i]
                        sess.kv_v[sess.pos] = v_new[i]
                    sess.pos += 1
                    sess.last_progress = now
                    if sess.pos < len(sess.prompt):
                        continue  # prefill: consume prompt, emit nothing
                    sess.token = int(nxt[i])
                    if sess.prefill_handoff and sess.emitted == 0:
                        # Disaggregation handoff point: the prompt rows
                        # are all in KV and the first token is computed.
                        # Record it as generated-but-not-streamed (the
                        # DECODE server replays it at resume — prefill is
                        # throughput-shaped; TTFT belongs to decode) and
                        # freeze after the publish below. The EOS clamp
                        # must apply HERE too (the normal emit path below
                        # is skipped): it rides the manifest's max_tokens
                        # so the destination — or the local fallback —
                        # stops exactly where colocated decode would.
                        sess.out_tokens.append(sess.token)
                        sess.emitted += 1
                        if emit_done(sess.token, sess.emitted,
                                     sess.max_tokens, self.eos_id):
                            sess.max_tokens = sess.emitted
                        handoffs.append(sess)
                        continue
                    if not self._emit(sess, sess.token, now):
                        self._retire(sess, shed_reason=sess.shed_reason)
                        continue
                    if emit_done(sess.token, sess.emitted,
                                 sess.max_tokens, self.eos_id):
                        sess.max_tokens = sess.emitted  # EOS: stop decoding
                # Commit every slot kv_begin_step write-locked — including
                # sessions the loop skipped (their bytes are unchanged;
                # the republish just restores an even seq).
                for sess in decodable:
                    self.manager.publish_kv(sess)
                self._freeze_handoffs(handoffs)
            self.steps += 1

    def _freeze_handoffs(self, handoffs: List[Session]) -> None:
        """Freeze prefill-complete sessions AFTER their KV publish
        commits, so the exporter (lane == -1 is its go signal) only ever
        reads a fully published position."""
        for sess in handoffs:
            if 0 <= sess.lane < len(self._lanes):
                self._lanes[sess.lane] = None
            # Prefill handoff: the engine owns the lane until freeze()
            # (which takes _mu) publishes FROZEN; lane == -1 is the
            # exporter go signal.  tpulint: allow(state-machine)
            sess.lane = -1
            if self.manager.freeze(sess) \
                    and self.on_session_frozen is not None:
                self.on_session_frozen(sess)

    # ---- the speculative step (spec_k > 0) ----

    def _reset_draft_lane(self, i: int, sess: Session) -> None:
        """(Re)bind lane ``i``'s engine-owned draft state to ``sess`` —
        the lane changed hands (admission, migration import, unfreeze):
        whatever draft run was in flight is discarded and the plane
        rebuilds by catch-up ingestion from the committed sequence."""
        self._draft_sid[i] = sess.id
        self._draft_pos[i] = 0
        if self._draft_params is not None:
            self._draft_kv_k[i] = 0.0
            self._draft_kv_v[i] = 0.0

    def _fill_windows(self, decodable: List[Session], W: int):
        """Build the (B, W) verify window: per lane, remaining COMMITTED
        inputs first (prompt tokens and the pending last emission — known
        values need no verification, so prefill ingests up to W rows per
        dispatch), then up to the lane's adapted ``spec_k`` draft
        proposals. Returns (window, n_known, n_prop, seqs)."""
        B = self.max_batch
        window = np.zeros((B, W), np.int32)
        n_known = np.zeros((B,), np.int32)
        n_prop = np.zeros((B,), np.int32)
        d_ingested = np.zeros((B,), np.int32)
        seqs = {}
        model_lanes = []
        for sess in decodable:
            i = sess.lane
            seq = sess.prompt + sess.out_tokens
            seqs[sess.id] = seq
            t_known = min(W, len(seq) - sess.pos)
            window[i, :t_known] = seq[sess.pos:sess.pos + t_known]
            n_known[i] = t_known
            if self._draft_sid[i] != sess.id:
                self._reset_draft_lane(i, sess)
            if self._draft_params is not None:
                model_lanes.append(sess)
                continue
            want = min(max(1, sess.spec_k or self.spec_k), W - t_known)
            if want > 0:
                props = ngram_propose(seq[:sess.pos + t_known], want)
                window[i, t_known:t_known + len(props)] = props
                n_prop[i] = len(props)
        if model_lanes:
            self._model_draft(model_lanes, window, n_known, n_prop,
                              d_ingested, seqs, W)
        return window, n_known, n_prop, d_ingested, seqs

    def _model_draft(self, lanes, window, n_known, n_prop, d_ingested,
                     seqs, W: int) -> None:
        """One ``draft_propose`` dispatch over every model-draft lane:
        the draft ingests committed tokens its plane hasn't seen (prompt
        rows, post-import catch-up, last step's correction) and proposes
        autoregressively past them. Proposals are usable only when the
        draft's ingest frontier reaches the target's (the steady-state
        lag is 0 or 1 rows; a cold plane spends a few windows catching
        up and the lane decodes plain-width meanwhile)."""
        L = self.manager.max_len
        B = self.max_batch
        d_window = np.zeros((B, W), np.int32)
        d_known = np.zeros((B,), np.int32)
        d_lengths = np.zeros((B,), np.int32)
        for sess in lanes:
            i = sess.lane
            seq = seqs[sess.id]
            start = self._draft_pos[i]
            m = min(W, len(seq) - start)
            d_window[i, :m] = seq[start:start + m]
            d_known[i] = m
            d_lengths[i] = start
        with self._device_ctx():
            out = draft_propose(
                self._draft_params, self._to_device(self._draft_kv_k),
                self._to_device(self._draft_kv_v),
                self._to_device(d_lengths), self._to_device(d_window),
                self._to_device(d_known))
            d_y, d_k, d_v = (t.cpu().numpy() for t in out)
        for sess in lanes:
            i = sess.lane
            start = self._draft_pos[i]
            m = int(d_known[i])
            d_ingested[i] = m
            rows = min(W, L - start)
            self._draft_kv_k[i, start:start + rows] = d_k[i, :rows]
            self._draft_kv_v[i, start:start + rows] = d_v[i, :rows]
            t_known = int(n_known[i])
            want = min(max(1, sess.spec_k or self.spec_k), W - t_known)
            # Aligned iff the draft's first proposal predicts exactly the
            # row after the target's last known input.
            if start + m != sess.pos + t_known:
                continue  # catch-up window: nothing proposable yet
            k_eff = min(want, W - m)
            if k_eff <= 0:
                continue
            props = d_y[i, m - 1:m - 1 + k_eff]
            window[i, t_known:t_known + k_eff] = props
            n_prop[i] = k_eff

    def _step_spec(self, decodable: List[Session]) -> None:
        """Draft -> verify -> commit. One fixed-shape ``verify_step``
        dispatch scores the whole window; the commit walk accepts the
        longest prefix where every proposal equals the previous
        position's target argmax (plus the target's token at the first
        mismatch), writes ONLY accepted rows back into the session's
        arena planes (rejection = pointer rewind; paging/export/oneside
        never see a draft row), and pushes each accepted emission through
        the bounded pending buffers with the EOS/max_tokens clamp applied
        mid-window. The window width is 1 + the widest per-lane need this
        step, so adaptation shrinks the dispatch, not just the fill."""
        B = self.max_batch
        L = self.manager.max_len
        spec_max = self.spec_k
        need = 1
        for sess in decodable:
            known = len(sess.prompt) + len(sess.out_tokens) - sess.pos
            if known > 1:  # prefill: the whole window is known inputs
                need = max(need, min(spec_max, known - 1))
            else:
                need = max(need, max(1, min(spec_max,
                                            sess.spec_k or spec_max)))
        W = 1 + need
        with tracing.trace_span("decode_step"):
            tracing.annotate(f"batch={len(decodable)} spec_w={W}")
            mgr = self.manager
            self.last_h2d_bytes = 0
            with tracing.stage("draft"):
                lengths = np.zeros((B,), np.int32)
                for sess in decodable:
                    lengths[sess.lane] = sess.pos
                window, n_known, n_prop, d_ingested, seqs = \
                    self._fill_windows(decodable, W)
            with tracing.stage("verify"):
                if mgr.paged:
                    tables = np.zeros((B, L // mgr.block_rows), np.int32)
                    for sess in decodable:
                        tables[sess.lane] = mgr.padded_table(sess)
                    pool_k, pool_v, tables = mgr.dispatch_pool(tables)
                with self._device_ctx():
                    if mgr.paged:
                        out = verify_step_paged(
                            self.params, self._to_device(pool_k),
                            self._to_device(pool_v),
                            self._to_device(tables),
                            self._to_device(lengths),
                            self._to_device(window))
                    else:
                        kv_k, kv_v = self._lanes_to_device(decodable)
                        out = verify_step(self.params, kv_k, kv_v,
                                          self._to_device(lengths),
                                          self._to_device(window))
                    y, k_rows, v_rows = (t.cpu().numpy() for t in out)
            with tracing.stage("emit"):
                now = time.monotonic()
                self.manager.kv_begin_step(decodable)
                handoffs = []
                proposed = accepted = 0
                for sess in decodable:
                    if sess.state != ACTIVE:
                        continue  # finished externally mid-step: swept
                    i = sess.lane
                    t_known = int(n_known[i])
                    props = int(n_prop[i])
                    d_start, d_m = self._draft_pos[i], int(d_ingested[i])
                    ncommit = 0
                    compared = 0  # proposals the walk actually evaluated
                    shed = False
                    for j in range(W):
                        if j >= t_known:
                            if j >= t_known + props:
                                break  # window tail: padding, never valid
                            compared += 1
                            if int(window[i, j]) != int(y[i, j - 1]):
                                break  # draft != target argmax: rewind
                        r = sess.pos + j
                        if mgr.paged:
                            if not mgr.kv_write_row(sess, r, k_rows[i, j],
                                                    v_rows[i, j]):
                                sess.shed_reason = "kv blocks exhausted"
                                shed = True
                                break  # rows before j stay committed
                        else:
                            sess.kv_k[r] = k_rows[i, j]
                            sess.kv_v[r] = v_rows[i, j]
                        ncommit = j + 1
                        if r < len(sess.prompt) - 1:
                            continue  # pure prefill row: nothing to emit
                        tok = int(y[i, j])
                        sess.token = tok
                        if sess.prefill_handoff and sess.emitted == 0:
                            # The disaggregation handoff point is still
                            # "first token computed": record it, clamp,
                            # freeze — the decode member continues, so no
                            # further window position may commit here.
                            sess.out_tokens.append(tok)
                            sess.emitted = 1
                            if emit_done(tok, 1, sess.max_tokens,
                                         self.eos_id):
                                sess.max_tokens = 1
                            handoffs.append(sess)
                            break
                        if not self._emit(sess, tok, now):
                            shed = True
                            break
                        if emit_done(tok, sess.emitted, sess.max_tokens,
                                     self.eos_id):
                            sess.max_tokens = sess.emitted
                            break
                    sess.pos += ncommit
                    sess.last_progress = now
                    acc = max(0, ncommit - t_known)
                    # Account only proposals the walk COMPARED: a break
                    # at a known position (EOS/budget spent, handoff,
                    # shed) leaves the rest unevaluated — counting them
                    # as rejections would bias the accept rate and drag
                    # the k-adaptation EMA down on every session's last
                    # step.
                    if compared > 0:
                        proposed += compared
                        accepted += acc
                        a = self.spec_ema_alpha
                        sess.spec_ema = ((1.0 - a) * sess.spec_ema
                                         + a * (acc / compared))
                        sess.spec_k = max(1, min(
                            spec_max, int(round(sess.spec_ema * spec_max))))
                    # Draft plane pointer rewinds with the acceptance:
                    # rows past the last committed input are garbage and
                    # will be rewritten from the committed sequence.
                    if self._draft_params is not None and d_m > 0:
                        self._draft_pos[i] = min(d_start + d_m + acc,
                                                 sess.pos)
                    if shed:
                        self._retire(sess, shed_reason=sess.shed_reason)
                for sess in decodable:
                    self.manager.publish_kv(sess)
                self._freeze_handoffs(handoffs)
                if proposed:
                    self._m["spec_proposed"].add(proposed)
                    self._m["spec_accepted"].add(accepted)
                    self._m["spec_accept"].record_us(
                        int(round(100.0 * accepted / proposed)))
                    self.manager.note_spec(proposed, accepted)
                self._m["spec_steps"].add(1)
            self.steps += 1

    def _drain_finished(self, now: float) -> None:
        """Close finished sessions once their pending tail drains — a
        slow reader keeps its lane (bounded by the stall/overflow shed)
        but never delays anyone else's close."""
        for sess in [s for s in self._lanes if s is not None]:
            if sess.state != ACTIVE:
                continue
            if (sess.pos >= len(sess.prompt)
                    and sess.emitted >= sess.max_tokens):
                if not self._flush_pending(sess, now):
                    self._retire(sess, shed_reason=sess.shed_reason)
                elif not sess.pending:
                    self._retire(sess)
