"""CollectiveGroup — ring/tree collectives over the fleet's tensor wire.

The port of brpc_tpu/collectives/group.py, over the port's own native
server, tensor service, arenas, channels, registry, pacer and tracing. It
speaks the JAX group's wire (Hello, groupwire-framed Chunk calls, the
same epoch digest and error codes), so members of both packages form one
ring under one registry tag and reduce to the same bytes.

The verbs take a numpy array or a torch tensor. A CUDA tensor costs one
D2H on the calling thread; the result comes back as a tensor on the
input's device (CPU for numpy input). The reduction itself runs on host
fp32 buffers, as the JAX package's does.

Membership IS the registry (the ShardMap discipline): every member runs
a ``CollectiveService`` on its own native server, registers the address
under one tag, and derives the SAME ring order from the sorted
membership list — ``sync()`` freezes a ``(members, epoch)`` pair (epoch
= the registry's membership index), and every chunk on the wire is
stamped with that epoch so two members that froze different rings fail
fast (E_COLL_EPOCH) instead of mis-reducing.

Each hop is a chunked transfer over a per-peer ``TensorChannel`` +
``PipelineWindow``: the sender frames the hop's chunk(s) with the
groupwire manifest (the PushQ shape — per-chunk metadata, concatenated
payload runs), stamps BULK QoS after the peer's Hello advertised it
(the codec-negotiation discipline), and paces on overload answers (the
OverloadPacer brake; a paced retry is safe because mailbox deposits are
idempotent). Quantization rides ``quant.ChunkCodec`` per chunk per hop
— dequant -> reduce -> requant with per-block scales and error-feedback
accumulators preserved across reduction steps (EQuARX, PAPERS.md) —
negotiated per PEER via Hello, so a mixed ring degrades hop by hop, raw
included, while the self-describing metadata keeps every decode honest.

Failure is clean, never wedged: a member leaving mid-collective is
detected by the registry watch (or a dead-peer transport error) and the
op raises :class:`~brpc_tpu.collectives.core.MemberLeft` carrying the
per-chunk salvage (``.done``); the caller re-``sync()``\\ s and retries
on the surviving ring. One rpcz trace per collective: the op opens a
root span and every chunk RPC parents under it, fleet-assembled like a
pull_all.
"""

from __future__ import annotations

import json
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from brpc_tpu_torch.collectives import core, ring as ring_mod
from brpc_tpu_torch.collectives.quant import ChunkCodec
from brpc_tpu_torch.fleet import registry
from brpc_tpu_torch.observability import tracing
from brpc_tpu_torch.runtime import codec as codec_mod
from brpc_tpu_torch.runtime import groupwire, native
from brpc_tpu_torch.runtime.param_server import E_NO_SUCH, OverloadPacer
from brpc_tpu_torch.runtime.tensor import (E_UNDECODABLE, PipelineWindow,
                                           TensorArena, TensorChannel,
                                           add_tensor_service)

E_COLL_EPOCH = core.E_COLL_EPOCH


_metrics_cache = None


def collective_metrics():
    """Process-wide collective recorders — native tbvar series with the
    port's ``torch_`` prefix (one registry per process, shared with the
    JAX package's ``collective_*``)."""
    global _metrics_cache
    if _metrics_cache is None:
        from brpc_tpu_torch.observability import metrics as obs

        _metrics_cache = {
            "allreduce": obs.latency("torch_collective_allreduce"),
            "allgather": obs.latency("torch_collective_allgather"),
            "reduce_scatter": obs.latency(
                "torch_collective_reduce_scatter"),
            "broadcast": obs.latency("torch_collective_broadcast"),
            "ops": obs.counter("torch_collective_ops"),
            "aborts": obs.counter("torch_collective_aborts"),
            # Logical vs wire: the quantized-collective bandwidth win
            # reads straight off these two.
            "logical_bytes": obs.counter("torch_collective_logical_bytes"),
            "wire_bytes": obs.counter("torch_collective_wire_bytes"),
        }
    return _metrics_cache


class _RpcLink:
    """One op's view of the wire: per-destination PipelineWindow over the
    group's per-thread channels, groupwire-framed sends, mailbox recv."""

    def __init__(self, group: "CollectiveGroup", op: str, seq: int,
                 deadline: float):
        self.g = group
        self.op = op
        self.seq = seq
        self.deadline = deadline
        self._wins: Dict[str, PipelineWindow] = {}
        self._chans: Dict[str, TensorChannel] = {}  # checked out per op
        # Fragment payloads still in flight, per destination, keyed by
        # the fragment's (phase, step, frag) tag: an overload error from
        # the window belongs to the OLDEST in-flight fragment (submit
        # drains before staging), so the retry must resend THAT
        # fragment's bytes, not whatever the caller is currently
        # sending. Entries drop as acks drain.
        self._inflight: Dict[str, Dict[tuple, tuple]] = {}
        self.wire_bytes = 0

    def _chan(self, addr: str) -> TensorChannel:
        ch = self._chans.get(addr)
        if ch is None:
            ch = self._chans[addr] = self.g._checkout(addr)
        return ch

    def _window(self, addr: str) -> PipelineWindow:
        win = self._wins.get(addr)
        if win is None:
            pending = self._inflight.setdefault(addr, {})

            def on_reply(tag, _payload, view, _p=pending):
                view.release()
                _p.pop(tag, None)

            win = PipelineWindow(self._chan(addr), self.g.window,
                                 on_reply=on_reply)
            self._wins[addr] = win
        return win

    def _resend_paced(self, addr: str, tag: tuple,
                      first_err: "native.RpcError") -> None:
        """Redeliver one shed fragment directly (outside the window),
        paced on the server's retry-after hints — mailbox deposits are
        idempotent, so resending a frame that DID land is safe."""
        manifest, concat = self._inflight[addr][tag]
        self.g.pacer.note(first_err)
        while True:
            if time.monotonic() >= self.deadline:
                raise core.CollectiveTimeout("timeout (overloaded peer)",
                                             tag[0], tag[1])
            self.g.pacer.pace()
            try:
                with self.g._qos_for(addr):
                    self._chan(addr).call(
                        "CollectiveService/Chunk",
                        array=concat if concat.nbytes else None,
                        request=manifest)
                self.g.pacer.clear()
                self._inflight[addr].pop(tag, None)
                return
            except native.RpcError as e:
                if not e.overloaded:
                    raise self.g._map_rpc_error(e, tag[0], tag[1])
                self.g.pacer.note(e)

    def send(self, dst_rank: int, phase: str, step: int, idx: int,
             meta: dict, blob: np.ndarray, frag: int = 0,
             nfrags: int = 1) -> None:
        addr = self.g._members[dst_rank]
        entry = dict(meta, idx=int(idx))
        manifest, concat = groupwire.pack_group(
            [entry], [blob],
            extra={"op": self.op, "seq": self.seq, "ph": phase,
                   "step": int(step), "frag": int(frag),
                   "ep": self.g._epoch, "src": self.g.rank})
        self.wire_bytes += int(concat.nbytes)
        if self.g.emulate_wire_gbps:
            # Bench-only link emulation: serialize this fragment's BYTES
            # through a modeled uplink (loopback shm runs at memcpy
            # speed, which no real cross-host fleet link does — this is
            # how the wire-BOUND regime is measured on a one-box CI).
            time.sleep(concat.nbytes / (self.g.emulate_wire_gbps * 1e9))
        win = self._window(addr)
        tag = (phase, int(step), int(frag))
        self._inflight[addr][tag] = (manifest, concat)
        while True:
            try:
                with self.g._qos_for(addr):
                    win.submit("CollectiveService/Chunk",
                               array=concat if concat.nbytes else None,
                               request=manifest, tag=tag)
                return
            except native.RpcError as e:
                if not e.overloaded:
                    raise self.g._map_rpc_error(e, phase, step)
                # Shed-before-queue answer from draining the OLDEST
                # in-flight fragment (its tag rides e.pipeline_tag):
                # redeliver THOSE bytes paced, then resubmit the
                # current fragment (still staged in _inflight, never
                # accepted by the window when submit raised).
                shed = getattr(e, "pipeline_tag", None)
                if shed is None or shed not in self._inflight[addr]:
                    shed = tag
                self._resend_paced(addr, shed, e)
                if shed == tag:
                    return

    _DRAIN_GRACE_S = 2.5  # stall time before draining our own window

    def recv(self, phase: str, step: int,
             frag: int = 0) -> Tuple[int, dict, np.ndarray]:
        # A fragment we SENT can fail while we sit here — the window is
        # async and submit only drains when full, so without this the
        # error (shed, dead peer, mismatched ring) stays invisible and
        # both sides of the ring stall until op timeout. A recv that
        # waits past the grace drains its own outbound window: failures
        # surface now (shed fragments redeliver paced, anything else
        # aborts the op promptly), and a healthy-but-slow wire just pays
        # one flush on an already-stalled path.
        key = (self.op, self.seq, phase, int(step), int(frag))
        while True:
            slice_dl = min(time.monotonic() + self._DRAIN_GRACE_S,
                           self.deadline)
            try:
                return self.g._mailbox.take(key, slice_dl,
                                            abort_event=self.g._left)
            except core.CollectiveTimeout:
                if time.monotonic() >= self.deadline:
                    raise
            self._drain_stalled()

    def _drain_stalled(self) -> None:
        for addr, win in list(self._wins.items()):
            while win.inflight():
                try:
                    win.flush()
                except native.RpcError as e:
                    if not e.overloaded:
                        raise self.g._map_rpc_error(e, "drain", -1)
                    shed = getattr(e, "pipeline_tag", None)
                    if shed is not None and \
                            shed in self._inflight.get(addr, {}):
                        self._resend_paced(addr, shed, e)
                    else:
                        self.g.pacer.note(e)

    def close(self, ok: bool) -> None:
        try:
            for addr, win in self._wins.items():
                while True:
                    try:
                        if ok:
                            win.flush()
                        else:
                            win.abort()
                        break
                    except native.RpcError as e:
                        if not (ok and e.overloaded):
                            if ok:
                                raise
                            break
                        # A shed surfacing at the end-of-op flush is
                        # the same overload as mid-op: redeliver that
                        # fragment paced, keep draining the rest.
                        shed = getattr(e, "pipeline_tag", None)
                        if shed is not None and shed in \
                                self._inflight.get(addr, {}):
                            self._resend_paced(addr, shed, e)
                        else:
                            self.g.pacer.note(e)
        finally:
            self._wins.clear()
            self._inflight.clear()
            chans, self._chans = self._chans, {}
            for addr, ch in chans.items():
                self.g._checkin(addr, ch)


class CollectiveGroup:
    """One member of a registry-defined collective ring.

    ``codec="int8"`` (or ``"fp8e4m3"``) quantizes every hop against
    peers that advertise it; ``ef=False`` is the naive requantizer (the
    pinned negative control — linearly compounding error, bench/test
    only). ``tree_max_bytes`` routes tensors at or below it through the
    2-hop tree instead of the 2(n-1)-hop ring (the latency/bandwidth
    crossover for small tensors)."""

    def __init__(self, registry_hostport: str, tag: str = "collective",
                 listen: str = "127.0.0.1:0", codec: Optional[str] = None,
                 ef: bool = True, block: int = codec_mod.DEFAULT_BLOCK,
                 window: int = 4, op_timeout_s: float = 20.0,
                 tree_max_bytes: int = 64 << 10,
                 frag_bytes: int = 1 << 20,
                 arena_bytes: int = 64 << 20,
                 client_arena_bytes: int = 32 << 20,
                 ttl_s: int = 5, tenant: str = "",
                 emulate_wire_gbps: Optional[float] = None,
                 name: Optional[str] = None):
        self._registry = registry_hostport
        self.tag = tag
        self.window = max(1, window)
        self.op_timeout_s = op_timeout_s
        self.tree_max_bytes = tree_max_bytes
        # ~1MB wire fragments measured fastest on this transport (bigger
        # single attachments LOSE throughput — 8MB monoliths ran ~0.5x).
        self.frag_elems = max(1, frag_bytes // 4)
        # Bench-only: emulate a bounded cross-host link (GB/s) by
        # serializing each fragment's wire bytes at the sender. None =
        # the real transport. Never set in production paths.
        self.emulate_wire_gbps = emulate_wire_gbps
        self._client_arena_bytes = client_arena_bytes
        self._tenant = tenant
        self._codec_name = codec
        self.chunk_codec = ChunkCodec(ef=ef, block=block)
        self.name = name
        self._m = collective_metrics()
        self.pacer = OverloadPacer()

        self.server = native.Server()
        self.arena = add_tensor_service(self.server, "CollectiveService",
                                        self._handle,
                                        TensorArena(arena_bytes))
        port = self.server.start(listen)
        host = listen.rsplit(":", 1)[0] or "127.0.0.1"
        self.addr = f"{host}:{port}"

        self._mailbox = core.Mailbox()
        self._mu = threading.Lock()
        self._presync: List[tuple] = []  # chunks held before sync()
        self._members: Tuple[str, ...] = ()
        self._epoch: Optional[int] = None
        self.rank: Optional[int] = None
        self._left = threading.Event()
        self.left_members: List[str] = []
        self._seq: Dict[str, int] = {}
        self._peer_caps: Dict[str, dict] = {}
        # Per-peer channel CHECKOUT pool (not per-thread: the step
        # driver's wire-lane threads are fresh every step, and a
        # thread-keyed cache would mint a new channel + client arena
        # per lane per step — a ~32MB native leak per step). An op
        # checks a channel out for its duration and returns it; the
        # pool high-water mark is the number of concurrent ops per
        # peer (the driver's wire_lanes).
        self._chan_pool: Dict[str, List[TensorChannel]] = {}
        self._closed = False

        self._reg = registry.Registration(registry_hostport, self.addr,
                                          tag, ttl_s).start()
        self._watcher = registry.RegistryWatcher(
            registry_hostport, tag, self._on_membership).start()

    # ---- membership / ring wiring ----

    def _on_membership(self, _index: int, addrs: List[str]) -> None:
        with self._mu:
            if not self._members:
                return
            gone = [a for a in self._members if a not in addrs]
            if gone:
                self.left_members = gone
                self._left.set()

    def sync(self, expect: Optional[int] = None,
             timeout_s: float = 10.0) -> int:
        """Freeze the ring at the current registry membership: returns
        this member's rank. ``expect`` waits (bounded) until exactly that
        many members are registered — the barrier every member calls
        before the first collective (and after a membership edge)."""
        deadline = time.monotonic() + timeout_s
        while True:
            _index, addrs = registry.list_servers(self._registry, self.tag)
            members = tuple(ring_mod.ring_order(addrs))
            if self.addr in members and (expect is None
                                         or len(members) == expect):
                break
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"sync: registry shows {len(members)} member(s) "
                    f"{list(members)}, want "
                    f"{'self registered' if expect is None else expect}")
            time.sleep(0.05)
        with self._mu:
            if members != self._members:
                # Ring roles shift with membership: every hop-position
                # residual keys to the OLD ring — drop them all (costing
                # at most one quant step per position on streams that
                # just ended) rather than compensate the wrong chunk.
                self.chunk_codec.prune(lambda _k: False)
            self._members = members
            # The epoch is a digest of the membership CONTENT, not the
            # registry's version counter: that counter is global across
            # tags, so two members listing the SAME ring at different
            # moments (another group registering in between) would
            # freeze different numbers and reject each other's chunks.
            # Same sorted member list => same ring => same epoch, on
            # every member, with no coordination.
            self._epoch = zlib.crc32("|".join(members).encode())
            self.rank = members.index(self.addr)
            self._left.clear()
            self.left_members = []
            held, self._presync = self._presync, []
        if held:
            self._replay_presync(held)
        return self.rank

    @property
    def members(self) -> Tuple[str, ...]:
        return self._members

    @property
    def epoch(self) -> Optional[int]:
        return self._epoch

    @property
    def world(self) -> int:
        return len(self._members)

    # ---- per-peer plumbing ----

    def _checkout(self, addr: str) -> TensorChannel:
        with self._mu:
            if self._closed:
                raise RuntimeError("collective group is closed")
            pool = self._chan_pool.get(addr)
            if pool:
                return pool.pop()
        return TensorChannel(f"tpu://{addr}",
                             TensorArena(self._client_arena_bytes),
                             timeout_ms=int(self.op_timeout_s * 1000))

    def _checkin(self, addr: str, ch: TensorChannel) -> None:
        with self._mu:
            if not self._closed:
                self._chan_pool.setdefault(addr, []).append(ch)
                return
        ch.close()  # group closed while we held it

    def _caps(self, addr: str) -> dict:
        with self._mu:
            caps = self._peer_caps.get(addr)
        if caps is not None:
            return caps
        cache = True
        ch = self._checkout(addr)
        try:
            payload, _ = ch.call("CollectiveService/Hello")
            caps = json.loads(payload.decode())
        except native.RpcError as e:
            # A pre-collective peer answers "no such method"
            # DETERMINISTICALLY — cache the raw/unstamped degrade. A
            # transport/overload failure is transient: serve degraded
            # caps for THIS call but retry the Hello next time, or a
            # startup hiccup would silently cost the peer its codec and
            # QoS stamp for the group's whole lifetime.
            caps = {"qos": 0, "codecs": []}
            cache = e.code == E_NO_SUCH  # genuinely pre-collective
        except ValueError:
            caps = {"qos": 0, "codecs": []}  # malformed Hello: cache —
        finally:                             # a rebuild won't fix bytes
            self._checkin(addr, ch)
        if cache:
            with self._mu:
                self._peer_caps[addr] = caps
        return caps

    def _qos_for(self, addr: str):
        import contextlib

        if self._caps(addr).get("qos"):
            return native.qos(native.PRIORITY_BULK, self._tenant)
        return contextlib.nullcontext()

    def _codec_for(self, addr: str) -> Optional[str]:
        """Per-peer negotiation (the Meta-advertisement discipline): the
        requested codec only if this peer's Hello advertised it."""
        return codec_mod.choose(self._codec_name,
                                tuple(self._caps(addr).get("codecs", ())))

    def _ring_codec(self, members) -> Optional[str]:
        """Ring-wide negotiation: allgather-phase fragments are encoded
        ONCE and forwarded VERBATIM around the whole ring, so the codec
        engages only when EVERY other member advertised it — a
        successor-only handshake would forward bytes a later hop cannot
        decode (mixed-build rollout). Caps are cached per peer, so a
        warm ring costs no RPCs here."""
        if self._codec_name is None:
            return None
        for peer in members:
            if peer != self.addr and self._codec_for(peer) is None:
                return None
        return self._codec_name

    def _map_rpc_error(self, e: "native.RpcError", phase: str,
                       step: int) -> core.CollectiveAborted:
        if e.code == core.E_COLL_EPOCH:
            return core.CollectiveAborted(f"epoch: {e.text}", phase, step)
        # Transport-shaped errors against a frozen member usually mean it
        # died before the registry TTL noticed; surface as MemberLeft so
        # the caller's recovery path (re-sync, retry) is uniform.
        return core.MemberLeft(f"peer error: [{e.code}] {e.text}",
                               phase, step)

    # ---- service handler (runs on the callback pool) ----

    def _handle(self, method: str, request: bytes, att):
        if method == "Hello":
            return json.dumps(
                {"qos": 1, "codecs": list(codec_mod.supported_codecs()),
                 "addr": self.addr}).encode(), None
        if method == "Chunk":
            man = groupwire.parse_group(request)
            with self._mu:
                epoch = self._epoch
                hold = epoch is None
            if hold:
                # Pre-sync: this member registered (so peers can resolve
                # it) but hasn't frozen its ring yet — a faster peer's
                # first send can land in that window at every phase/ring
                # boundary. Rejecting would deadlock the ring until op
                # timeout (the sender's window never drains the error
                # while it blocks in recv), so HOLD the chunk and let
                # sync() replay it against the epoch it freezes.
                self._stash_presync(man, att)
                return b"ok", None
            if man.get("ep") != epoch:
                raise native.RpcError(
                    E_COLL_EPOCH,
                    f"collective epoch mismatch: chunk stamped "
                    f"{man.get('ep')}, member frozen at {epoch}")
            payload = att
            if payload is not None and not isinstance(payload, np.ndarray):
                payload = np.asarray(payload)
            try:
                pairs = list(groupwire.split_group(man, payload))
            except ValueError as ve:
                raise native.RpcError(
                    E_UNDECODABLE, f"undecodable collective chunk: {ve}")
            key = (man["op"], int(man["seq"]), man["ph"],
                   int(man["step"]), int(man.get("frag", 0)))
            for entry, run in pairs:
                # Detach NOW: the attachment view dies with the handler.
                blob = (np.array(run) if run is not None
                        else np.empty(0, np.uint8))
                self._mailbox.deposit(key, (int(entry.get("idx", 0)),
                                            entry, blob))
            return b"ok", None
        raise native.RpcError(E_NO_SUCH, f"no such method: {method}")

    _PRESYNC_MAX = 256  # held chunks, bounded (oldest dropped)

    def _stash_presync(self, man: dict, att) -> None:
        payload = att
        if payload is not None and not isinstance(payload, np.ndarray):
            payload = np.asarray(payload)
        # Detach NOW: the attachment view dies with the handler.
        blob = np.array(payload) if payload is not None else None
        with self._mu:
            self._presync.append((man, blob))
            while len(self._presync) > self._PRESYNC_MAX:
                self._presync.pop(0)

    def _replay_presync(self, held: list) -> None:
        """Deposit held pre-sync chunks whose stamp matches the epoch
        sync() just froze; drop the rest (they keyed a ring this member
        never joined — deciding that is exactly what the hold deferred)."""
        for man, blob in held:
            if man.get("ep") != self._epoch:
                continue
            try:
                pairs = list(groupwire.split_group(man, blob))
            except ValueError:
                continue  # undecodable held chunk: op-level abort covers it
            key = (man["op"], int(man["seq"]), man["ph"],
                   int(man["step"]), int(man.get("frag", 0)))
            for entry, run in pairs:
                self._mailbox.deposit(
                    key, (int(entry.get("idx", 0)), entry,
                          run if run is not None else np.empty(0, np.uint8)))

    # ---- the collectives ----

    def _next_seq(self, name: str) -> int:
        with self._mu:
            s = self._seq.get(name, 0)
            self._seq[name] = s + 1
            return s

    def _pre_op(self, name: str):
        with self._mu:
            if self._closed:
                raise RuntimeError("collective group is closed")
            if self._epoch is None:
                raise RuntimeError("collective group not sync()ed")
            members = self._members
        if self._left.is_set():
            raise core.MemberLeft(
                f"member(s) left before op: {self.left_members} "
                "(re-sync() to rebuild the ring)")
        return members

    def allreduce(self, name: str, array, timeout_s: Optional[float] = None,
                  algo: str = "auto", on_chunk=None) -> torch.Tensor:
        """Sum ``array`` across the frozen ring -> fp32 tensor on the
        input's device; every member returns identical values.
        ``algo``: ``"ring"``, ``"tree"``, or ``"auto"`` (tree at or below
        ``tree_max_bytes``).
        All members must call with the same ``name`` in the same order
        (the sequence number that pairs the ops derives from it).

        ``on_chunk(idx, (offset, length), values)`` — per-chunk finality
        trigger over the flattened array (:func:`core.ring_allreduce`'s
        T3 hook). Only the ring schedule has sub-array finality; the
        tree (and n==1) path fires the trigger ONCE with the whole span
        at completion, so callers get a uniform contract either way. The
        hook's ``values`` are host fp32 arrays."""
        members = self._pre_op(name)
        n = len(members)
        host = core.host_array(array)
        if algo == "auto":
            algo = "tree" if host.nbytes <= self.tree_max_bytes else "ring"
        seq = self._next_seq(name)
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self.op_timeout_s)
        if n == 1:
            codec_name = None
        elif algo == "tree":
            # Tree peers are NOT the ring successor: leaves send to the
            # root (negotiate with it), the root broadcasts ONE encode
            # to every leaf (quantize only if every leaf advertised the
            # codec — else that single encode would be undecodable at
            # the weakest member).
            root = members[ring_mod.tree_root(n)]
            if self.addr == root:
                codec_name = self._ring_codec(members)
            else:
                codec_name = self._codec_for(root)
        else:
            codec_name = self._ring_codec(members)
        link = _RpcLink(self, name, seq, deadline)
        t0 = time.monotonic()
        ok = False
        with tracing.trace_span("collective/allreduce"):
            tracing.annotate(f"op={name} seq={seq} algo={algo} n={n} "
                             f"bytes={host.nbytes}")
            try:
                if algo == "tree":
                    out = core.tree_allreduce(self.rank, n, host,
                                              self.chunk_codec, link,
                                              name, codec_name)
                    if on_chunk is not None and out.size:
                        on_chunk(0, (0, out.size),
                                 out.reshape(-1).copy())
                elif algo == "ring":
                    out = core.ring_allreduce(self.rank, n, host,
                                              self.chunk_codec, link,
                                              name, codec_name,
                                              frag_elems=self.frag_elems,
                                              on_chunk=on_chunk)
                else:
                    raise ValueError(f"unknown algo {algo!r}")
                ok = True
            finally:
                try:
                    link.close(ok)
                except native.RpcError as e:
                    raise self._map_rpc_error(e, "close", -1)
                finally:
                    self._mailbox.drop_op((name, seq))
                    if not ok:
                        self._m["aborts"].add(1)
                        tracing.annotate("aborted")
        self._m["allreduce"].record_s(time.monotonic() - t0)
        self._m["ops"].add(1)
        # Ring moves 2(n-1)/n logical chunks per member; count what THIS
        # member put on the wire vs the fp32 bytes it would have been.
        self._m["wire_bytes"].add(link.wire_bytes)
        self._m["logical_bytes"].add(
            int(host.nbytes * 2 * (n - 1) / n) if algo == "ring"
            else host.nbytes * (2 if self.rank == 0 else 1))
        return core.like_input(out.reshape(np.shape(host)), array)

    def allgather(self, name: str, array,
                  timeout_s: Optional[float] = None) -> List[torch.Tensor]:
        """Gather every member's ``array`` -> list of tensors on the
        input's device, indexed by rank (all members hold identical
        lists)."""
        members = self._pre_op(name)
        n = len(members)
        host = core.host_array(array)
        seq = self._next_seq(name)
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self.op_timeout_s)
        codec_name = self._ring_codec(members) if n > 1 else None
        link = _RpcLink(self, name, seq, deadline)
        t0 = time.monotonic()
        ok = False
        with tracing.trace_span("collective/allgather"):
            tracing.annotate(f"op={name} seq={seq} n={n} "
                             f"bytes={host.nbytes}")
            try:
                out = core.ring_allgather(self.rank, n, host,
                                          self.chunk_codec, link, name,
                                          codec_name,
                                          frag_elems=self.frag_elems)
                ok = True
            finally:
                try:
                    link.close(ok)
                except native.RpcError as e:
                    raise self._map_rpc_error(e, "close", -1)
                finally:
                    self._mailbox.drop_op((name, seq))
                    if not ok:
                        self._m["aborts"].add(1)
        self._m["allgather"].record_s(time.monotonic() - t0)
        self._m["ops"].add(1)
        self._m["wire_bytes"].add(link.wire_bytes)
        self._m["logical_bytes"].add(int(host.nbytes * (n - 1)))
        return [core.like_input(o, array) for o in out]

    def reduce_scatter(self, name: str, array,
                       timeout_s: Optional[float] = None):
        """Sum ``array`` across the ring, keeping only this member's
        owned chunk -> ``((offset, length), fp32 tensor)`` over the
        flattened input (every member derives the same span layout from
        ``ring.chunk_spans``). Half an allreduce's bytes; the verb for
        consumers that shard the reduced result anyway. Per-successor
        codec negotiation — each hop re-encodes."""
        members = self._pre_op(name)
        n = len(members)
        host = core.host_array(array)
        seq = self._next_seq(name)
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self.op_timeout_s)
        codec_name = self._codec_for(members[(self.rank + 1) % n]) \
            if n > 1 else None
        link = _RpcLink(self, name, seq, deadline)
        t0 = time.monotonic()
        ok = False
        with tracing.trace_span("collective/reduce_scatter"):
            tracing.annotate(f"op={name} seq={seq} n={n} "
                             f"bytes={host.nbytes}")
            try:
                span, chunk = core.ring_reduce_scatter(
                    self.rank, n, host, self.chunk_codec, link, name,
                    codec_name, frag_elems=self.frag_elems)
                ok = True
            finally:
                try:
                    link.close(ok)
                except native.RpcError as e:
                    raise self._map_rpc_error(e, "close", -1)
                finally:
                    self._mailbox.drop_op((name, seq))
                    if not ok:
                        self._m["aborts"].add(1)
        self._m["reduce_scatter"].record_s(time.monotonic() - t0)
        self._m["ops"].add(1)
        self._m["wire_bytes"].add(link.wire_bytes)
        self._m["logical_bytes"].add(int(host.nbytes * (n - 1) / n))
        return span, core.like_input(chunk, array)

    def broadcast(self, name: str, array=None, root: int = 0,
                  timeout_s: Optional[float] = None) -> torch.Tensor:
        """One-to-all: rank ``root`` supplies ``array``; every member
        (root included, which adopts its own dequantized encode) returns
        the bitwise-identical fp32 result, on the input's device (CPU
        where this member passed none). The root quantizes only when
        EVERY member advertised the codec (one encode serves all — the
        tree-allreduce broadcast-leg rule)."""
        members = self._pre_op(name)
        n = len(members)
        host = None
        if array is not None:
            host = core.host_array(array)
        if self.rank == root and host is None:
            raise ValueError("broadcast root must supply the array")
        seq = self._next_seq(name)
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self.op_timeout_s)
        codec_name = self._ring_codec(members) \
            if n > 1 and self.rank == root else None
        link = _RpcLink(self, name, seq, deadline)
        t0 = time.monotonic()
        ok = False
        with tracing.trace_span("collective/broadcast"):
            tracing.annotate(f"op={name} seq={seq} n={n} root={root}")
            try:
                out = core.tree_broadcast(self.rank, n, host,
                                          self.chunk_codec, link, name,
                                          codec_name, root=root,
                                          frag_elems=self.frag_elems)
                ok = True
            finally:
                try:
                    link.close(ok)
                except native.RpcError as e:
                    raise self._map_rpc_error(e, "close", -1)
                finally:
                    self._mailbox.drop_op((name, seq))
                    if not ok:
                        self._m["aborts"].add(1)
        self._m["broadcast"].record_s(time.monotonic() - t0)
        self._m["ops"].add(1)
        self._m["wire_bytes"].add(link.wire_bytes)
        if self.rank == root:
            self._m["logical_bytes"].add(int(host.nbytes * (n - 1)))
        return core.like_input(out, array)

    # ---- lifecycle ----

    def close(self) -> None:
        with self._mu:
            if self._closed:
                return
            self._closed = True
            pool, self._chan_pool = self._chan_pool, {}
            if not self.left_members:
                self.left_members = ["<closed>"]
        # Fail concurrent ops NOW: a thread blocked in Mailbox.take must
        # not sit out its full op deadline waiting for chunks that can
        # never arrive once the server below stops. (Channels still
        # checked out by such an op close at their _checkin.)
        self._left.set()
        self._watcher.stop()
        self._reg.stop()
        for chans in pool.values():
            for ch in chans:
                try:
                    ch.close()
                except Exception:  # noqa: BLE001 — best-effort teardown
                    pass
        self.server.stop()

    def __enter__(self):
        return self

    def __exit__(self, *_exc):
        self.close()
