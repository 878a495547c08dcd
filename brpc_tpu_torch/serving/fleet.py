"""Serving fleet: registry-membered ServingServers with roles, live
session migration over the tensor wire, and prefill/decode
disaggregation.

The JAX package's ``serving/fleet.py`` in the port. Every byte a
migration moves is host state: the KV rows leave the source's arena
pages through ``export_session`` (numpy), ride the tensor wire or a
one-sided read, and land in the destination's arena pages through
``import_session``; the destination engine's next step copies them to
the card like any other session's. A member's device work is its
``DecodeEngine``; ``device`` (default CUDA; raises when CUDA is missing)
goes through to it.

A :class:`FleetServingServer` is a ServingServer that:

  * REGISTERS in the watch-mode registry: decode-capable roles
    ("decode", "both") under the fleet tag (the ring session opens route
    on) and prefill-only members under "<tag>-prefill";
  * hosts a ``MigrateService`` tensor service whose ``Install`` RPC is
    the receiving half of a session move: manifest JSON (prompt,
    position, last token, emitted-token replay list, tenant/priority/
    deadline) + the filled KV rows, either as the RPC's tensor
    attachment or as a ONE-SIDED read: when the source publishes its KV
    pages (``publish_kv=True``), the manifest carries the window
    descriptor and the destination memory-reads the planes out of the
    source's arena; ``Probe`` answers which paged blocks the
    destination's prefix cache misses, so a paged source ships only
    those;
  * migrates with the reshard discipline applied to KV state: freeze
    (decode pauses, the engine parks the lane at its next step boundary,
    after the step's device-to-host copy has landed), ship, install (the
    destination holds the session PARKED until the client re-attaches),
    retire (the source closes the stream with an E_SESSION_MOVED-coded
    CLOSE + a "moved:<addr>" E-frame and answers ``Gen/Locate`` from its
    forwarding table), so a client never sees a torn or duplicated
    token: the destination replays ``out_tokens[have:]`` at
    ``Gen/Resume``;
  * DRAINS: ``drain()`` sheds new opens with E_DRAINING, leaves the
    membership, and ships every live session to the surviving decode
    members through one bounded PipelineWindow per destination link that
    takes refusals per call: a refused Install resumes only that session
    locally, while the sessions already installed are retired;
  * disaggregates: a ``role="prefill"`` member admits sessions on the
    BULK lane, runs the prompt, and freezes each session the moment its
    first token is computed; the handoff rides the same transfer path as
    a drain migration, and the decode member replays that token as its
    first emission.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from brpc_tpu_torch.fleet import registry
from brpc_tpu_torch.models.decoder import DecoderParams
from brpc_tpu_torch.runtime import native
from brpc_tpu_torch.runtime.param_server import (E_EXISTS, E_MIGRATING,
                                                 E_NO_SUCH, OverloadPacer)
from brpc_tpu_torch.runtime.tensor import (OnesideGone, OnesideMiss,
                                           OnesideReader, PipelineWindow,
                                           TensorArena, TensorChannel,
                                           add_tensor_service)
from brpc_tpu_torch.serving.router import ServingRouter
from brpc_tpu_torch.serving.server import ServingServer
from brpc_tpu_torch.serving.session import (ACTIVE, FRAME_TOKEN, FROZEN,
                                            QUEUED, StreamSink,
                                            serving_metrics)
from brpc_tpu_torch.utils.device import resolve_device

# Bound on the source's forwarding table (sid -> dest): old entries age
# out FIFO; a resume that misses it still finds the session by probing
# the ring (the fleet client's fallback).
_MOVED_CAP = 4096


class FleetServingServer(ServingServer):
    """One member of a serving fleet. ``role``: "both" (default —
    prefill + decode), "decode", or "prefill" (runs prompts, hands
    sessions off to decode members at first-token time). ``device`` and
    the other ``serving_kw`` go to ``ServingServer``; a member that
    cannot reach its device raises before it opens anything."""

    def __init__(self, registry_hostport: str,
                 params: Optional[DecoderParams] = None, *,
                 tag: str = "serving", role: str = "both",
                 listen_host: str = "127.0.0.1", reg_ttl_s: int = 5,
                 migrate_window: int = 4,
                 migrate_arena_bytes: int = 32 << 20,
                 publish_kv: bool = False, **serving_kw):
        if role not in ("both", "decode", "prefill"):
            raise ValueError(f"unknown role {role!r}")
        serving_kw["device"] = resolve_device(serving_kw.get("device"))
        super().__init__(params, publish_kv=publish_kv, **serving_kw)
        self._registry = registry_hostport
        self.tag = tag
        self.role = role
        self._listen_host = listen_host
        self._reg_ttl_s = reg_ttl_s
        self._migrate_window = migrate_window
        # Bounds the receiving arena and each outbound link's staging
        # arena alike: a link's window stages up to migrate_window
        # sessions' KV rows at once.
        self._migrate_arena_bytes = migrate_arena_bytes
        self._draining = False
        self._drain_mu = threading.Lock()  # one drain at a time
        self.addr: Optional[str] = None
        self._reg: Optional[registry.Registration] = None
        # The decode ring this member ships sessions onto (drain dest /
        # prefill handoff dest) — sticky by session id, like the client.
        self._decode_ring = ServingRouter(registry_hostport, tag=tag)
        self._moved: "OrderedDict[str, str]" = OrderedDict()
        self._moved_mu = threading.Lock()
        self._chan_mu = threading.Lock()
        self._chans: Dict[str, TensorChannel] = {}
        self._readers: Dict[tuple, OnesideReader] = {}
        self._m = serving_metrics()
        self._pacer = OverloadPacer()
        # Receiving half: Install manifests + KV attachments land here.
        self.migrate_arena = add_tensor_service(
            self.server, "MigrateService", self._migrate_handle,
            TensorArena(migrate_arena_bytes))
        # Prefill handoffs: the engine freezes at first-token time and
        # enqueues; this worker ships (wire work must never run on the
        # engine thread).
        self._handoff_q: "queue.Queue" = queue.Queue()
        self._handoff_stop = threading.Event()
        self._handoff_thread: Optional[threading.Thread] = None
        if role == "prefill":
            self.engine.on_session_frozen = self._handoff_q.put

    # ---- lifecycle ----

    def start(self, addr: str = None) -> int:  # type: ignore[override]
        port = super().start(addr or f"{self._listen_host}:0")
        self.addr = f"{self._listen_host}:{port}"
        reg_tag = self.tag if self.role != "prefill" \
            else f"{self.tag}-prefill"
        self._reg = registry.Registration(self._registry, self.addr,
                                          reg_tag, self._reg_ttl_s).start()
        if self.role == "prefill":
            self._handoff_thread = threading.Thread(
                target=self._handoff_loop, daemon=True,
                name="serving-handoff")
            self._handoff_thread.start()
        return port

    def stop(self) -> None:
        self._handoff_stop.set()
        if self._handoff_thread is not None:
            self._handoff_q.put(None)  # wake
            self._handoff_thread.join(timeout=10)
            self._handoff_thread = None
        if self._reg is not None:
            self._reg.stop()
            self._reg = None
        self._decode_ring.close()
        with self._chan_mu:
            chans, self._chans = self._chans, {}
            readers, self._readers = self._readers, {}
        for ch in chans.values():
            ch.close()
        for rd in readers.values():
            rd.close()
        super().stop()

    # ---- admission (the drain gate + prefill marking) ----

    def _admit_open(self, prompt, max_tokens, sink, **kw):
        if self._draining:
            raise native.RpcError(
                native.E_DRAINING,
                f"server {self.addr} draining (retry_after_ms=100)")
        if self.role == "prefill":
            # Throughput-shaped: prefill sessions ride the BULK lane and
            # freeze for handoff the moment their first token exists.
            kw["priority"] = native.PRIORITY_BULK
            kw["prefill_handoff"] = True
        return self.manager.open(prompt, max_tokens, sink, **kw)

    # ---- Gen service extensions ----

    def _handle(self, method: str, request: bytes, attachment: bytes):
        if method == "Resume":
            return self._resume(request)
        if method == "Locate":
            doc = json.loads(request.decode() or "{}")
            return json.dumps({"moved": self.forwarded_to(
                str(doc.get("session", "")))}).encode(), b""
        if method == "Drain":
            # Admin trigger (bench/tests drive cross-process drains with
            # it): runs async — the response must not wait out the ship.
            threading.Thread(target=self.drain, daemon=True,
                             name="serving-drain").start()
            return json.dumps({"draining": True}).encode(), b""
        return super()._handle(method, request, attachment)

    def forwarded_to(self, sid: str) -> Optional[str]:
        with self._moved_mu:
            dest = self._moved.get(sid)
        if dest:
            return dest
        sess = self.manager.get(sid)
        if sess is not None:
            return native.parse_moved(sess.shed_reason)
        return None

    def _resume(self, request: bytes):
        # Parse + validate EVERYTHING before accept_stream (the Gen/Open
        # leak discipline: an accepted stream not handed to a session
        # must be closed on every failure path).
        try:
            doc = json.loads(request.decode() or "{}")
            sid = str(doc.get("session", ""))
            have = int(doc.get("have", 0))
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            raise native.RpcError(native.TRPC_EREQUEST,
                                  f"bad Gen/Resume request: {e}")
        sess = self.manager.get(sid)
        if sess is None or sess.state not in (QUEUED, FROZEN):
            dest = self.forwarded_to(sid)
            if dest:
                raise native.RpcError(
                    native.E_SESSION_MOVED, f"session {sid} moved:{dest}")
            raise native.RpcError(E_NO_SUCH, f"no such session: {sid}")
        if sess.state == FROZEN:
            # Mid-OUTBOUND migration from here: by the time the client
            # retries, the forwarding table answers.
            raise native.RpcError(
                E_MIGRATING, f"session {sid} migrating "
                             f"(retry_after_ms=100)")
        if sess.sink is not None:
            raise native.RpcError(
                E_EXISTS, f"session {sid} already has an attached stream")
        stream = native.accept_stream(self.stream_window)
        if stream is None:
            raise native.RpcError(
                native.TRPC_EREQUEST,
                "Gen/Resume requires a stream (use open_stream)")
        try:
            replayed = self.manager.attach_sink(sess, StreamSink(stream),
                                               have)
        except Exception:
            stream.close()
            raise
        self.engine.notify()
        return json.dumps({"session": sid, "replay": replayed}).encode(), b""

    # ---- MigrateService (the receiving half) ----

    def _migrate_handle(self, method: str, request: bytes, att):
        if method == "Probe":
            # Migration pre-flight (paged KV): the source sends the
            # manifest's block digests; we answer the slot indices OUR
            # prefix cache misses — the source then ships only those.
            doc = json.loads(request.decode() or "{}")
            need = self.manager.probe_prefix(
                list(doc.get("blocks", [])),
                int(doc.get("block_rows", 0)))
            return json.dumps({"need": need}).encode(), None
        if method != "Install":
            raise native.RpcError(E_NO_SUCH,
                                  f"no such method: MigrateService/{method}")
        if self._draining:
            raise native.RpcError(
                native.E_DRAINING,
                f"server {self.addr} draining (retry_after_ms=100)")
        manifest = json.loads(request.decode())
        if "oneside" in manifest:
            kv = self._read_kv_oneside(manifest)
        elif att is not None:
            # The attachment is a view of the sender's pages that dies
            # with the handler: copy it out (on the host; the engine's
            # next step copies the rows to the card).
            kv = np.array(att, dtype=np.float32)
        else:
            kv = np.zeros((2, 0, int(manifest["dim"])), np.float32)
        sess = self.manager.import_session(manifest, kv)
        return json.dumps({"ok": 1, "session": sess.id}).encode(), None

    def _read_kv_oneside(self, manifest: dict) -> np.ndarray:
        """The one-sided consumer: memory-read the source's published KV
        planes instead of paying the RPC data path. Any miss (window
        gone, version raced a republish, off-host shm) answers E_NO_SUCH
        so the SOURCE falls back to shipping bytes."""
        desc = manifest["oneside"]
        sid = str(manifest["session"])
        pos = int(manifest["pos"])
        dim = int(manifest["dim"])
        key = (str(desc.get("shm")), int(desc.get("token", 0)))
        with self._chan_mu:
            reader = self._readers.get(key)
        if reader is None:
            reader = OnesideReader.map(desc)
            if reader is None:
                raise native.RpcError(
                    E_NO_SUCH, "oneside window unmappable (off-host?)")
            with self._chan_mu:
                self._readers[key] = reader
        if manifest.get("blocks") is not None:
            # Paged source: per-block slots "kv:<sid>:k:<j>" (version =
            # rows filled in block j). Digest-bearing slots short-circuit
            # through OUR prefix cache — a shared-prefix migration reads
            # almost nothing off the source.
            r = int(manifest["block_rows"])
            k = np.zeros((pos, dim), np.float32)
            v = np.zeros((pos, dim), np.float32)
            for j, d in enumerate(manifest["blocks"]):
                lo, hi = j * r, min(pos, j * r + r)
                if d is not None:
                    local = self.manager.prefix_rows(d)
                    if local is not None:
                        k[lo:hi] = local[0][:hi - lo]
                        v[lo:hi] = local[1][:hi - lo]
                        continue
                try:
                    vk, kb = reader.read_np(f"kv:{sid}:k:{j}")
                    vv, vb = reader.read_np(f"kv:{sid}:v:{j}")
                except OnesideGone:
                    with self._chan_mu:
                        self._readers.pop(key, None)
                    reader.close()
                    raise native.RpcError(E_NO_SUCH, "oneside window gone")
                except OnesideMiss as e:
                    raise native.RpcError(E_NO_SUCH, f"oneside miss: {e}")
                want = hi - lo
                if vk != want or vv != want:
                    raise native.RpcError(
                        E_NO_SUCH, f"oneside block {j} version skew: "
                                   f"k={vk} v={vv} want={want}")
                k[lo:hi] = np.array(
                    kb.view(np.float32).reshape(-1, dim)[:want])
                v[lo:hi] = np.array(
                    vb.view(np.float32).reshape(-1, dim)[:want])
            return np.stack([k, v])
        try:
            vk, k_plane = reader.read_np(f"kv:{sid}:k")
            vv, v_plane = reader.read_np(f"kv:{sid}:v")
        except OnesideGone:
            with self._chan_mu:
                self._readers.pop(key, None)
            reader.close()
            raise native.RpcError(E_NO_SUCH, "oneside window gone")
        except OnesideMiss as e:
            raise native.RpcError(E_NO_SUCH, f"oneside miss: {e}")
        if vk != pos or vv != pos:
            # A republish raced the export snapshot: the bytes path is
            # the consistent one.
            raise native.RpcError(
                E_NO_SUCH, f"oneside version skew: k={vk} v={vv} pos={pos}")
        k = k_plane.view(np.float32).reshape(-1, dim)[:pos]
        v = v_plane.view(np.float32).reshape(-1, dim)[:pos]
        return np.stack([np.array(k), np.array(v)])

    # ---- shipping (the sending half) ----

    def _chan(self, addr: str) -> TensorChannel:
        with self._chan_mu:
            ch = self._chans.get(addr)
            if ch is None:
                ch = TensorChannel(f"tpu://{addr}",
                                   TensorArena(self._migrate_arena_bytes),
                                   timeout_ms=10000)
                self._chans[addr] = ch
            return ch

    def _ship_qos(self, sess):
        # Prefill handoff is throughput-shaped (BULK); a drain migration
        # is the latency path — the client is waiting out the gap (HIGH).
        prio = native.PRIORITY_BULK if self.role == "prefill" \
            else native.PRIORITY_HIGH
        # Migration peers are serving fleet members (same build,
        # Gen-era): QoS-native by construction, nothing to
        # advertise.  tpulint: allow(negotiation)
        return native.qos(prio, sess.tenant)

    def _wait_exportable(self, sess, timeout_s: float = 5.0) -> bool:
        """A frozen session leaves its engine lane at the next step
        boundary; export only then (no step can be mid-write)."""
        deadline = time.monotonic() + timeout_s
        while not self.manager.exportable(sess):
            if sess.state != FROZEN or time.monotonic() >= deadline:
                return False
            self.engine.notify()
            time.sleep(0.002)  # tpulint: allow(py-blocking)
        return True

    def _retire(self, sess, dest: str) -> None:
        with self._moved_mu:
            self._moved[sess.id] = dest
            while len(self._moved) > _MOVED_CAP:
                self._moved.popitem(last=False)
        # The coded close (E_SESSION_MOVED on the credit-exempt CLOSE
        # frame) + the best-effort "moved:<addr>" E-frame: the client
        # resumes at dest even when its window was full.
        self.manager.finish(sess, shed_reason=f"moved:{dest}",
                            shed_code=native.E_SESSION_MOVED)
        self._m["migrated_out"].add(1)

    def _install_oneside(self, manifest: dict, dest: str) -> bool:
        """Descriptor-only Install (the destination reads the planes
        one-sided). False => fall back to shipping bytes."""
        if self.manager.oneside is None:
            return False
        m = dict(manifest, oneside=self.manager.oneside.describe())
        try:
            self._chan(dest).call("MigrateService/Install",
                                  request=json.dumps(m).encode())
            return True
        except native.RpcError as e:
            if e.code == E_NO_SUCH:
                return False  # any one-sided miss: ship the bytes
            raise

    def _slim_ship(self, dest: str, manifest: dict, kv: np.ndarray):
        """Minimal-move bytes ship (paged KV): probe the destination's
        prefix cache with the manifest's block digests and keep only the
        rows it misses (``kv_blocks`` names the slots shipped). Any probe
        failure — mono peer, old peer, dead link — falls back to the full
        payload. Accounts every shipped KV byte in
        ``serving_migrated_kv_bytes`` (both modes: the A/B counter)."""
        blocks = manifest.get("blocks")
        if not blocks or not any(d is not None for d in blocks):
            self._m["migrated_kv_bytes"].add(int(kv.nbytes))
            return manifest, kv
        try:
            reply, _ = self._chan(dest).call(
                "MigrateService/Probe",
                request=json.dumps(
                    {"blocks": blocks,
                     "block_rows": manifest.get("block_rows", 0)}).encode())
            need = sorted(int(j) for j in json.loads(reply.decode())["need"])
        except (native.RpcError, RuntimeError, OSError,
                ValueError, KeyError):
            self._m["migrated_kv_bytes"].add(int(kv.nbytes))
            return manifest, kv
        if len(need) >= len(blocks):
            self._m["migrated_kv_bytes"].add(int(kv.nbytes))
            return manifest, kv
        r = int(manifest["block_rows"])
        pos = int(manifest["pos"])
        if need:
            slim = np.concatenate(
                [kv[:, j * r:min(pos, j * r + r), :] for j in need], axis=1)
        else:
            slim = kv[:, :0, :]
        slim = np.ascontiguousarray(slim)
        self._m["migrated_kv_bytes"].add(int(slim.nbytes))
        return dict(manifest, kv_blocks=need), slim

    def _ship_bytes(self, dest: str, manifest: dict, kv: np.ndarray) -> None:
        """Bytes-path Install with the missed-blocks-only optimization;
        a destination whose cache raced an eviction between Probe and
        Install answers E_NO_SUCH — retry once with the full payload."""
        slim_m, slim_kv = self._slim_ship(dest, manifest, kv)
        try:
            self._chan(dest).push_device(
                "MigrateService/Install", slim_kv,
                request=json.dumps(slim_m).encode())
        except native.RpcError as e:
            if slim_m is manifest or e.code != E_NO_SUCH:
                raise
            self._m["migrated_kv_bytes"].add(int(kv.nbytes))
            self._chan(dest).push_device(
                "MigrateService/Install", kv,
                request=json.dumps(manifest).encode())

    def migrate_session(self, sess, dest: str) -> bool:
        """Freeze/ship/retire ONE session to ``dest``; False (and the
        session resumes locally) when the ship fails."""
        self.manager.freeze(sess)
        if not self._wait_exportable(sess):
            self.manager.unfreeze(sess)
            return False
        try:
            manifest, kv = self.manager.export_session(sess)
            with self._ship_qos(sess):
                if sess.paged or not self._install_oneside(manifest, dest):
                    self._ship_bytes(dest, manifest, kv)
        except (native.RpcError, RuntimeError, OSError):
            self._resume_local(sess)
            return False
        self._retire(sess, dest)
        return True

    def _resume_local(self, sess) -> None:
        """Ship failed: decode continues HERE. A prefill-handoff session
        holds exactly one generated-but-unstreamed token — queue its
        frame so the client still receives every token once."""
        if sess.prefill_handoff and sess.out_tokens and sess.sink \
                is not None and not sess.pending:
            frame = FRAME_TOKEN + str(sess.out_tokens[-1]).encode()
            sess.pending.append(frame)
            sess.pending_bytes += len(frame)
        sess.prefill_handoff = False
        self.manager.unfreeze(sess)
        self.engine.notify()

    def _pick_dest(self, sid: str) -> Optional[str]:
        try:
            self._decode_ring.refresh()
            for addr in self._decode_ring.candidates(sid):
                if addr != self.addr:
                    return addr
        except (native.RpcError, LookupError, OSError):
            return None
        return None

    def _handoff_loop(self) -> None:
        """Prefill role: ship frozen first-token sessions to decode
        members (paced on overload answers; a dead/missing ring falls
        back to local decode so the client is never stranded)."""
        while not self._handoff_stop.is_set():
            sess = self._handoff_q.get()
            if sess is None:
                continue
            dest = self._pick_dest(sess.id)
            if dest is None:
                self._resume_local(sess)
                continue
            if not self._wait_exportable(sess):
                self._resume_local(sess)
                continue
            try:
                manifest, kv = self.manager.export_session(sess)
                with self._ship_qos(sess):
                    if sess.paged or not self._install_oneside(manifest,
                                                               dest):
                        self._ship_bytes(dest, manifest, kv)
            except native.RpcError as e:
                if e.overloaded:
                    self._pacer.note(e)
                    self._pacer.pace()
                self._resume_local(sess)
                continue
            except (RuntimeError, OSError):
                self._resume_local(sess)
                continue
            self._pacer.clear()
            self._retire(sess, dest)

    # ---- drain (the live-migration acceptance path) ----

    def drain(self, deadline_s: float = 30.0) -> int:
        """Shed new opens (E_DRAINING), leave the membership, and ship
        every live session to the surviving decode members — one bounded
        PipelineWindow per (src, dst) link, sessions retired one by one
        as their Install confirms (a client's gap is its own session's
        freeze->confirm span, not the whole drain's). Returns sessions
        migrated; the ones that could not ship resume decoding here.
        Reentrant calls (a second Gen/Drain) no-op with 0."""
        if not self._drain_mu.acquire(blocking=False):
            return 0  # a drain is already running
        try:
            return self._drain_locked(deadline_s)
        finally:
            self._drain_mu.release()

    def _drain_locked(self, deadline_s: float) -> int:
        self._draining = True
        if self._reg is not None:
            self._reg.stop()  # leave membership: routers stop sending
            self._reg = None
        deadline = time.monotonic() + deadline_s
        try:
            # A drain routes on the membership as it is now, not on a
            # map cached within the router's refresh TTL (a member that
            # joined just before would be missed).
            self._decode_ring.refresh(force=True)
        except (native.RpcError, OSError):
            pass  # _pick_dest retries; no ring means local resume
        sessions = [s for s in self.manager.live()
                    if s.state in (QUEUED, ACTIVE)]
        for sess in sessions:
            self.manager.freeze(sess)
        # Group by destination link (sticky: the same ketama walk every
        # router instance derives — the client's resume probe finds the
        # session at its first candidate).
        links: Dict[str, List] = {}
        for sess in sessions:
            if not self._wait_exportable(
                    sess, timeout_s=max(0.0, deadline - time.monotonic())):
                self._resume_local(sess)
                continue
            dest = self._pick_dest(sess.id)
            if dest is None:
                self._resume_local(sess)
                continue
            links.setdefault(dest, []).append(sess)
        moved = 0
        for dest, group in links.items():
            moved += self._drain_link(dest, group, deadline)
        return moved

    def _drain_link(self, dest: str, group: List, deadline: float) -> int:
        """Ship ``group`` to ``dest`` through one bounded PipelineWindow.
        Refusals are taken per call: a refused Install (the destination's
        arena full, a Probe/Install cache race) resumes THAT session here
        while every other call goes on, so a session the destination
        already installed is retired, never left live on both members."""
        moved = 0
        retired_or_failed = set()

        def on_reply(sess, _payload, view) -> None:
            nonlocal moved
            view.release()
            self._retire(sess, dest)
            retired_or_failed.add(sess.id)
            moved += 1

        def on_error(sess, _err) -> None:
            self._resume_local(sess)
            retired_or_failed.add(sess.id)

        try:
            with PipelineWindow(self._chan(dest), self._migrate_window,
                                on_reply=on_reply,
                                on_error=on_error) as win:
                for sess in group:
                    if time.monotonic() >= deadline:
                        self._resume_local(sess)
                        retired_or_failed.add(sess.id)
                        continue
                    try:
                        manifest, kv = self.manager.export_session(sess)
                    except native.RpcError:
                        self._resume_local(sess)
                        retired_or_failed.add(sess.id)
                        continue
                    with self._ship_qos(sess):
                        try:
                            oneside = not sess.paged and \
                                self._install_oneside(manifest, dest)
                        except (native.RpcError, RuntimeError, OSError):
                            on_error(sess, None)  # refused: stays here
                            continue
                        if oneside:
                            self._retire(sess, dest)
                            retired_or_failed.add(sess.id)
                            moved += 1
                            continue
                        slim_m, slim_kv = self._slim_ship(dest, manifest,
                                                          kv)
                        win.submit("MigrateService/Install", array=slim_kv,
                                   request=json.dumps(slim_m).encode(),
                                   tag=sess)
        except (native.RpcError, RuntimeError, OSError):
            pass  # fall through: un-retired sessions resume locally
        for sess in group:
            if sess.id not in retired_or_failed:
                self._resume_local(sess)
        return moved
