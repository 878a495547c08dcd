"""Transport-agnostic collective algorithms — the pure engine.

The port of brpc_tpu/collectives/core.py. The ring/tree schedules
(``ring.py``) plus the per-hop codec (``quant.py``) compose into
allreduce/allgather here against an abstract ``Link``;
:class:`~brpc_tpu_torch.collectives.group.CollectiveGroup` wires a Link
to the real tensor wire (per-peer TensorChannel + PipelineWindow), while
``models.tp_layers.LocalRing`` wires one to in-memory mailboxes — same
algorithm code on both, so the unit tests pin what the fleet runs. The
algorithms reduce host fp32 buffers, as the JAX package's do: they are
wire staging, not device math. ``host_array``/``like_input`` map a
verb's torch-tensor argument onto that host buffer and its result back.

Link protocol (duck-typed):

  * ``send(dst_rank, phase, step, idx, meta, blob, frag=0, nfrags=1)``
    — deliver one chunk fragment; may buffer/pipeline, must raise on a
    dead peer.
  * ``recv(phase, step, frag=0)`` -> ``(idx, meta, blob)`` — block for
    the matching inbound fragment; raises :class:`CollectiveAborted`
    flavors on timeout/abort (a member left, the deadline passed).

Hops are FRAGMENTED (``ring.fragment_spans``): each chunk rides as a
train of bounded fragments so the sender's encode/stage of fragment f+1
overlaps the wire of fragment f and the receiver reduces fragments as
they arrive — without this, an 8MB hop is one monolithic RPC whose
staging, wire and decode serialize (measured ~2x slower end to end).

Failure semantics (the PartialPush/PartialPull pattern one level up): a
hop failure raises :class:`CollectiveAborted` carrying ``done`` — the
chunk indexes whose FINAL reduced value this member already holds, with
their spans and values — so a caller can salvage partial results (or
verify nothing landed) instead of guessing. The operation never
half-applies: the input array is not mutated.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

import torch

from brpc_tpu_torch.collectives import ring as ring_mod
from brpc_tpu_torch.collectives.quant import ChunkCodec

# App-level error codes, continuing the 2040+ range (param_server.py
# holds 2040-2043, tensor.py E_UNDECODABLE=2044) — the JAX package's.
E_COLL_EPOCH = 2045   # chunk stamped with a different membership epoch
E_COLL_ABORT = 2046   # collective failed (timeout / member left)


class CollectiveAborted(RuntimeError):
    """A collective failed cleanly mid-flight.

    ``phase``/``step`` locate the hop; ``done`` maps chunk index ->
    ``(span, fp32 values)`` for every chunk whose FINAL reduction this
    member already completed (per-chunk salvage); ``reason`` is the
    triggering condition ("timeout", "member-left", "epoch", or the
    transport error text)."""

    def __init__(self, reason: str, phase: str = "", step: int = -1,
                 done: Optional[Dict[int, tuple]] = None):
        at = f" at {phase}:{step}" if phase else ""
        salv = f"; {len(done or {})} chunk(s) salvaged"
        super().__init__(f"collective aborted{at}: {reason}{salv}")
        self.reason = reason
        self.phase = phase
        self.step = step
        self.done = dict(done or {})


class MemberLeft(CollectiveAborted):
    """Registry watch (or a dead-peer transport error) reported a frozen
    ring member gone mid-collective."""


class CollectiveTimeout(CollectiveAborted):
    """The op deadline elapsed waiting for a hop."""


def host_array(array) -> np.ndarray:
    """A verb's argument as a contiguous host fp32 array: a CUDA tensor
    costs one D2H on the calling thread's current stream; a CPU tensor
    is viewed in place; numpy passes through."""
    if isinstance(array, torch.Tensor):
        array = array.detach().to("cpu", torch.float32).contiguous().numpy()
    return np.ascontiguousarray(np.asarray(array), dtype=np.float32)


def like_input(out: np.ndarray, array) -> torch.Tensor:
    """A verb's host result as a tensor on the input's device (CPU for a
    numpy input, sharing the result's memory)."""
    t = torch.from_numpy(np.ascontiguousarray(out))
    if isinstance(array, torch.Tensor) and array.device.type != "cpu":
        return t.to(array.device)
    return t


def _salvage(acc: np.ndarray, spans, done_idx) -> Dict[int, tuple]:
    return {i: (spans[i], acc[spans[i][0]:spans[i][0] + spans[i][1]].copy())
            for i in sorted(done_idx)}


DEFAULT_FRAG_ELEMS = 1 << 18  # 1MB of fp32 per wire fragment


def _detach_u8(blob) -> np.ndarray:
    """A forwarding copy that cannot alias transport-owned pages."""
    return np.array(np.asarray(blob).reshape(-1).view(np.uint8))


def ring_allreduce(rank: int, n: int, x: np.ndarray, codec: ChunkCodec,
                   link, name: str, codec_name=None,
                   frag_elems: int = DEFAULT_FRAG_ELEMS,
                   on_chunk=None) -> np.ndarray:
    """Sum ``x`` across the ring -> fp32 array shaped like ``x``;
    every member returns the IDENTICAL values (the owner of a chunk
    adopts the dequantized form it broadcast, so quantization cannot
    make members disagree).

    ``on_chunk(idx, (offset, length), values)`` — the T3 track-and-
    trigger hook (arXiv 2401.16677): fires on the CALLER's
    thread the moment chunk ``idx`` reaches its FINAL value, while later
    chunks are still on the wire. Finality points: the owned chunk fires
    inside allgather step 0 AFTER the dequantized adoption (firing right
    after reduce-scatter would hand the trigger a value quantization is
    about to replace — members would disagree); every other chunk fires
    as its allgather hop decodes. ``values`` is a detached fp32 copy of
    the final span; a trigger exception aborts the op like any link
    failure. The raw SUM is what lands — averaging is the trigger's job,
    exactly as it is the caller's on the returned array."""
    flat = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if n == 1:
        out = flat.copy()
        if on_chunk is not None and out.size:
            on_chunk(0, (0, out.size), out.copy())
        return out.reshape(np.shape(x))
    acc = flat.copy()
    spans = ring_mod.chunk_spans(acc.size, n)
    succ = (rank + 1) % n
    done: set = set()
    # ---- reduce-scatter: n-1 hops, each dequant -> add -> (next hop
    # requantizes with its own EF position). Fragmented: send the whole
    # fragment train first (the window pipelines staging against the
    # wire), then reduce inbound fragments as they land.
    for s, (send_idx, recv_idx) in enumerate(
            ring_mod.reduce_scatter_steps(rank, n)):
        off, ln = spans[send_idx]
        try:
            frags = codec.encode_chunk(f"{name}#rs{s}",
                                       acc[off:off + ln], codec_name,
                                       frag_elems)
            for f, (meta, blob) in enumerate(frags):
                link.send(succ, "rs", s, send_idx, meta, blob,
                          frag=f, nfrags=len(frags))
            roff, rln = spans[recv_idx]
            for f, (fo, fl) in enumerate(
                    ring_mod.fragment_spans(rln, frag_elems)):
                _idx, rmeta, rblob = link.recv("rs", s, frag=f)
                if fl:
                    codec.reduce_into(rmeta, rblob,
                                      acc[roff + fo:roff + fo + fl])
        except CollectiveAborted as e:
            e.done = _salvage(acc, spans, done)
            raise
    own = ring_mod.owned_chunk(rank, n)
    done.add(own)
    # ---- allgather: the owner quantizes its reduced chunk ONCE (and
    # adopts the dequantized value so all members agree); every later
    # hop forwards the received fragments VERBATIM — no requant, no
    # compounding ----
    fwd: Optional[list] = None  # [(meta, detached blob), ...] per frag
    for s, (send_idx, recv_idx) in enumerate(
            ring_mod.allgather_steps(rank, n)):
        try:
            if s == 0:
                ooff, oln = spans[own]
                send_frags = codec.encode_chunk(f"{name}#ag",
                                                acc[ooff:ooff + oln],
                                                codec_name, frag_elems)
                for (meta, blob), (fo, fl) in zip(
                        send_frags,
                        ring_mod.fragment_spans(oln, frag_elems)):
                    if fl:
                        acc[ooff + fo:ooff + fo + fl] = codec.decode(
                            meta, blob)
                if on_chunk is not None and oln:
                    on_chunk(own, (ooff, oln),
                             acc[ooff:ooff + oln].copy())
            else:
                send_frags = fwd  # type: ignore[assignment]
            for f, (meta, blob) in enumerate(send_frags):
                link.send(succ, "ag", s, send_idx, meta, blob,
                          frag=f, nfrags=len(send_frags))
            roff, rln = spans[recv_idx]
            fwd = []
            for f, (fo, fl) in enumerate(
                    ring_mod.fragment_spans(rln, frag_elems)):
                _idx, rmeta, rblob = link.recv("ag", s, frag=f)
                if fl:
                    acc[roff + fo:roff + fo + fl] = codec.decode(rmeta,
                                                                 rblob)
                fwd.append((rmeta, _detach_u8(rblob)))
        except CollectiveAborted as e:
            e.done = _salvage(acc, spans, done)
            raise
        done.add(recv_idx)
        if on_chunk is not None and rln:
            on_chunk(recv_idx, (roff, rln), acc[roff:roff + rln].copy())
    return acc.reshape(np.shape(x))


def ring_reduce_scatter(rank: int, n: int, x: np.ndarray,
                        codec: ChunkCodec, link, name: str, codec_name=None,
                        frag_elems: int = DEFAULT_FRAG_ELEMS):
    """The ring's reduce-scatter phase as a standalone verb: sum ``x``
    across the ring, each member keeping ONLY its owned chunk — the
    bandwidth-optimal building block (S(n-1)/n bytes per member, half an
    allreduce) for workloads that shard the reduced result anyway (a
    sharded optimizer step; an allgather later completes an allreduce).
    Returns ``((offset, length), fp32 chunk values)`` over the flattened
    input — ``offset/length`` = ``chunk_spans(x.size, n)[owned_chunk]``,
    identical on every member's derivation.

    Each hop re-encodes (dequant -> add -> requant with the hop's own EF
    position, exactly the allreduce rs phase), so the codec negotiates
    per SUCCESSOR — no ring-wide agreement needed (unlike allgather
    forwarding)."""
    flat = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    spans = ring_mod.chunk_spans(flat.size, n)
    own = ring_mod.owned_chunk(rank, n)
    if n == 1:
        return spans[0], flat.copy()
    acc = flat.copy()
    succ = (rank + 1) % n
    for s, (send_idx, recv_idx) in enumerate(
            ring_mod.reduce_scatter_steps(rank, n)):
        off, ln = spans[send_idx]
        try:
            frags = codec.encode_chunk(f"{name}#rs{s}",
                                       acc[off:off + ln], codec_name,
                                       frag_elems)
            for f, (meta, blob) in enumerate(frags):
                link.send(succ, "rs", s, send_idx, meta, blob,
                          frag=f, nfrags=len(frags))
            roff, rln = spans[recv_idx]
            for f, (fo, fl) in enumerate(
                    ring_mod.fragment_spans(rln, frag_elems)):
                _idx, rmeta, rblob = link.recv("rs", s, frag=f)
                if fl:
                    codec.reduce_into(rmeta, rblob,
                                      acc[roff + fo:roff + fo + fl])
        except CollectiveAborted as e:
            e.done = {}  # no chunk is final until the last hop lands
            raise
    off, ln = spans[own]
    return (off, ln), acc[off:off + ln].copy()


def tree_broadcast(rank: int, n: int, x, codec: ChunkCodec, link,
                   name: str, codec_name=None, root: int = 0,
                   frag_elems: int = DEFAULT_FRAG_ELEMS) -> np.ndarray:
    """One-to-all broadcast on the tree schedule: the root encodes ONCE
    (quantized only when every receiver can decode it — the tree-
    allreduce broadcast-leg rule) and sends to every other member; the
    root ADOPTS its own dequantized form so all members return bitwise
    identical arrays. Non-root members pass ``x=None`` — fragment 0's
    metadata carries the shape (the allgather framing), which is all a
    receiver needs."""
    if n == 1:
        return np.ascontiguousarray(x, dtype=np.float32).copy()
    if rank != root:
        _idx, rmeta0, rblob0 = link.recv("bc", 0, frag=0)
        nfrags = int(rmeta0.get("nfrags", 1))
        parts = [codec.decode(rmeta0, rblob0)]
        for f in range(1, nfrags):
            _idx, rmeta, rblob = link.recv("bc", 0, frag=f)
            parts.append(codec.decode(rmeta, rblob))
        return np.concatenate(parts).reshape(rmeta0.get("oshape", [-1]))
    if x is None:
        raise ValueError("broadcast root must supply the array")
    flat = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    shape = list(np.shape(x))
    frags = codec.encode_chunk(f"{name}#bc", flat, codec_name, frag_elems)
    frags[0] = (dict(frags[0][0], oshape=shape, src=root,
                     nfrags=len(frags)), frags[0][1])
    for dst in range(n):
        if dst == root:
            continue
        for f, (meta, blob) in enumerate(frags):
            link.send(dst, "bc", 0, root, meta, blob,
                      frag=f, nfrags=len(frags))
    parts = [codec.decode(meta, blob) for meta, blob in frags]
    out = np.concatenate(parts) if parts else flat.copy()
    return out.reshape(shape)


def tree_allreduce(rank: int, n: int, x: np.ndarray, codec: ChunkCodec,
                   link, name: str, codec_name=None) -> np.ndarray:
    """The small-tensor latency play: leaves send to the root, the root
    reduces (ascending rank order — deterministic) and broadcasts. Two
    hops end to end at any n; one quantization per leg."""
    flat = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if n == 1:
        return flat.copy().reshape(np.shape(x))
    root = ring_mod.tree_root(n)
    if rank != root:
        # codec_name is the caller's per-peer negotiated pick
        # (group._codec_for); this free function never chooses a codec.
        # tpulint: allow(negotiation)
        meta, blob = codec.encode(f"{name}#leaf", flat, codec_name)
        link.send(root, "tr", rank, 0, meta, blob)
        _idx, rmeta, rblob = link.recv("trb", 0)
        return codec.decode(rmeta, rblob).reshape(np.shape(x))
    acc = flat.copy()
    for src in ring_mod.tree_gather_srcs(n):
        _idx, rmeta, rblob = link.recv("tr", src)
        acc += codec.decode(rmeta, rblob)
    # Same as the leaf leg: the root echoes the caller-negotiated
    # codec_name.  tpulint: allow(negotiation)
    meta, blob = codec.encode(f"{name}#root", acc, codec_name)
    for dst in ring_mod.tree_gather_srcs(n):
        link.send(dst, "trb", 0, 0, meta, blob)
    # Adopt the broadcast form: members must agree bit-for-bit.
    return codec.decode(meta, blob).reshape(np.shape(x))


def ring_allgather(rank: int, n: int, x: np.ndarray, codec: ChunkCodec,
                   link, name: str, codec_name=None,
                   frag_elems: int = DEFAULT_FRAG_ELEMS
                   ) -> List[np.ndarray]:
    """Gather every member's ``x`` -> list indexed by rank. Each
    contribution is quantized ONCE at its source and forwarded verbatim
    (pure data movement — re-quantizing a forward would add error for
    nothing); the contributor adopts its own dequantized form so all
    members hold identical lists. Contributions may differ in shape:
    fragment 0's metadata carries the sender's shape and fragment count
    (``oshape``/``src``/``nfrags``), which is all a receiver needs."""
    if n == 1:
        return [np.ascontiguousarray(x, dtype=np.float32)]
    flat = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    succ = (rank + 1) % n
    shape = list(np.shape(x))
    out: List[Optional[np.ndarray]] = [None] * n
    own_frags = codec.encode_chunk(f"{name}#ag", flat, codec_name,
                                   frag_elems)
    own_frags[0] = (dict(own_frags[0][0], oshape=shape, src=rank,
                         nfrags=len(own_frags)), own_frags[0][1])
    own_parts = [codec.decode(meta, blob) for meta, blob in own_frags]
    out[rank] = np.concatenate(own_parts).reshape(shape) if own_parts \
        else np.zeros(shape, np.float32)
    done = {rank}
    fwd = own_frags
    for s in range(n - 1):
        try:
            for f, (meta, blob) in enumerate(fwd):
                link.send(succ, "ag", s, int(fwd[0][0]["src"]), meta,
                          blob, frag=f, nfrags=len(fwd))
            _idx, rmeta0, rblob0 = link.recv("ag", s, frag=0)
            nfrags = int(rmeta0.get("nfrags", 1))
            parts = [codec.decode(rmeta0, rblob0)]
            nxt = [(rmeta0, _detach_u8(rblob0))]
            for f in range(1, nfrags):
                _idx, rmeta, rblob = link.recv("ag", s, frag=f)
                parts.append(codec.decode(rmeta, rblob))
                nxt.append((rmeta, _detach_u8(rblob)))
        except CollectiveAborted as e:
            e.done = {i: ((0, 0), out[i]) for i in sorted(done)}
            raise
        src = int(rmeta0["src"])
        out[src] = np.concatenate(parts).reshape(
            rmeta0.get("oshape", [-1]))
        done.add(src)
        fwd = nxt
    return out  # type: ignore[return-value]


class Mailbox:
    """Keyed rendezvous between the transport's deposit side (RPC
    handlers / queue feeders) and the algorithm's ``recv`` — one slot
    per ``(op, seq, phase, step)``, idempotent deposit (a paced retry
    redelivers the same bytes), abortable waits."""

    _TOMBSTONES = 256  # dropped-op prefixes remembered (bounded)

    def __init__(self):
        self._mu = threading.Lock()
        self._cond = threading.Condition(self._mu)
        self._slots: Dict[tuple, tuple] = {}
        # Tombstones for dropped ops: a peer's in-flight chunk can land
        # AFTER the op aborted and drop_op() ran — without this, that
        # late deposit (op seqs never reuse, so nobody will take it)
        # strands its detached copy in the mailbox for the transport's
        # lifetime, one chunk per abort.
        self._dropped: "OrderedDict[tuple, None]" = OrderedDict()

    def deposit(self, key: tuple, value: tuple) -> None:
        with self._mu:
            for n in range(1, len(key)):
                if key[:n] in self._dropped:
                    return  # late chunk for an aborted/finished op
            self._slots[key] = value  # idempotent: retries overwrite
            self._cond.notify_all()

    def take(self, key: tuple, deadline: float,
             abort_event: Optional[threading.Event] = None,
             now=None) -> tuple:
        """Wait for ``key`` until monotonic ``deadline``; raises
        :class:`MemberLeft` when ``abort_event`` fires first,
        :class:`CollectiveTimeout` at the deadline."""
        import time as _time
        clock = now if now is not None else _time.monotonic
        with self._mu:
            while True:
                v = self._slots.pop(key, None)
                if v is not None:
                    return v
                if abort_event is not None and abort_event.is_set():
                    raise MemberLeft("member-left", key[2], key[3])
                remaining = deadline - clock()
                if remaining <= 0:
                    raise CollectiveTimeout("timeout", key[2], key[3])
                # Bounded waits so an abort_event set between checks is
                # seen promptly (the event is set by a watcher thread
                # that cannot reach this condition variable).
                self._cond.wait(min(remaining, 0.05))

    def drop_op(self, op_prefix: tuple) -> int:
        """GC every slot whose key starts with ``op_prefix`` and
        tombstone the prefix — an aborted op must not strand chunks
        that are ALREADY here, and ones still in flight must be
        discarded on arrival (op seqs never reuse, so a tombstone can
        never swallow a live op's chunk)."""
        with self._mu:
            dead = [k for k in self._slots
                    if k[:len(op_prefix)] == op_prefix]
            for k in dead:
                self._slots.pop(k, None)
            self._dropped[op_prefix] = None
            while len(self._dropped) > self._TOMBSTONES:
                self._dropped.popitem(last=False)
            return len(dead)
