"""A parameter server whose traffic rides the RPC framework as tensors.

The served state is torch tensors in device memory (CUDA by default), and
every pull/push crosses the framework's ``tpu://`` transport as a
by-reference TensorArena attachment (brpc_tpu_torch/runtime/tensor.py):

  PULL:  device param --D2H--> server arena --by-ref--> client maps the
         same pages --H2D--> device tensor
  PUSH:  device grad --D2H--> client arena --by-ref--> server copies H2D
         (a quantized push: the codes, then the dequantize kernel widens
         them) and applies the fused momentum-update kernel OUT OF PLACE,
         then bumps the version.

Methods served: Meta, Epoch, Pull, PullQ, Push, PushQ, the one-sided
mapping handshake (Oneside) and the live-resharding handshake a fleet
Migrator drives (Handoff, Install, Retire, Commit) — the JAX package's
wire, byte for byte, so either package's client, fleet client or
migrator talks to either server.

Per-name migration states (absent = serving):

  frozen   Handoff exported it: pulls still served, pushes refused with
           E_MOVED so no update lands that the export missed
  pending  Installed here, not committed: pulls served at the version the
           old owner still serves, pushes refused with E_MIGRATING
  retired  gone from this server: pulls and pushes answer E_MOVED
           "moved:<dest>" so a client on a stale shard map re-routes
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import struct
import threading
import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from brpc_tpu_torch.observability import tracing
from brpc_tpu_torch.ops.fused_update import fused_momentum_update
from brpc_tpu_torch.runtime import codec as codec_mod
from brpc_tpu_torch.runtime import groupwire, native
from brpc_tpu_torch.runtime.state import PSState, state_from_numpy
from brpc_tpu_torch.runtime.tensor import (E_UNDECODABLE, OnesideGone,
                                           OnesideMiss, OnesideReader,
                                           OnesideWindow, PipelineWindow,
                                           TensorArena, TensorChannel,
                                           WireTensor, _as_host_array,
                                           _dequant_widen,
                                           _detach_device_put_batch,
                                           _device_put_from_view, _metrics,
                                           _stage, add_tensor_service,
                                           consume_oneside_payload,
                                           consume_pull_reply, np_dtype,
                                           pad_header64)
from brpc_tpu_torch.utils.device import resolve_device

# App-level error codes, disjoint from trpc/errno.h (E_UNDECODABLE = 2044
# lives in tensor.py). E_MOVED's text carries the forwarding address as
# "moved:<host:port>"; E_MIGRATING means installed but not committed yet.
E_NO_SUCH = 2040
E_MOVED = 2041
E_MIGRATING = 2042
E_EXISTS = 2043  # install over a serving parameter

_METHODS = ("Meta", "Epoch", "Pull", "PullQ", "Push", "PushQ", "Oneside",
            "Handoff", "Install", "Retire", "Commit")

_MOVED_RE = re.compile(r"moved:(\S+)")


def moved_dest(err: "native.RpcError") -> Optional[str]:
    """The forwarding address an E_MOVED redirect carries, or None."""
    if err.code != E_MOVED:
        return None
    m = _MOVED_RE.search(err.text or "")
    return m.group(1) if m else None


class OverloadPacer:
    """Client-side brake for shed storms: an ELIMIT/EOVERCROWDED answer
    holds the NEXT call back until its retry-after hint elapses (or an
    exponential floor when sheds repeat without a hint); the first
    success clears it. Thread-safe; ``sheds`` counts overload answers."""

    _MIN_DELAY_S = 0.005
    _MAX_DELAY_S = 0.5

    def __init__(self):
        self._mu = threading.Lock()
        self._until = 0.0   # monotonic time before which calls pace
        self._delay = 0.0   # current backoff floor
        self.sheds = 0

    def note(self, err) -> float:
        """Record an error; returns the pacing delay now owed."""
        if not getattr(err, "overloaded", False):
            return 0.0
        hint_s = (getattr(err, "retry_after_ms", None) or 0) / 1000.0
        with self._mu:
            self.sheds += 1
            self._delay = min(max(self._delay * 2, self._MIN_DELAY_S),
                              self._MAX_DELAY_S)
            delay = max(hint_s, self._delay)
            self._until = max(self._until, time.monotonic() + delay)
            return max(0.0, self._until - time.monotonic())

    def clear(self) -> None:
        with self._mu:
            self._delay = 0.0
            self._until = 0.0

    def pace(self) -> None:
        """Sleep out any pacing debt (on the caller's thread)."""
        with self._mu:
            wait = self._until - time.monotonic()
        if wait > 0:
            time.sleep(wait)  # tpulint: allow(py-blocking)


class PartialPullError(native.RpcError):
    """A ``pull_all`` that delivered SOME tensors before a per-name
    failure: ``partial`` holds ``{name: (version, value)}``, ``missing``
    the names not delivered."""

    def __init__(self, cause: "native.RpcError",
                 partial: Dict[str, tuple], missing: List[str]):
        super().__init__(cause.code, cause.text)
        self.partial = partial
        self.missing = missing


class PartialPushError(native.RpcError):
    """A ``push_all`` that APPLIED some gradients before a per-name
    failure: ``applied`` holds ``{name: new_version}``, ``unpushed`` the
    names with no confirmed apply (re-pushing an applied gradient is not
    idempotent)."""

    def __init__(self, cause: "native.RpcError",
                 applied: Dict[str, int], unpushed: List[str]):
        super().__init__(cause.code, cause.text)
        self.applied = applied
        self.unpushed = unpushed


# Process-wide recorders: every ParameterServer feeds the same series.
_metrics_cache = None
_metrics_mu = threading.Lock()
_SERVERS: "weakref.WeakSet[ParameterServer]" = weakref.WeakSet()


def _max_version_lag() -> int:
    """Largest (max - min) version spread across live servers, read from
    the lock-free mirror each Push maintains."""
    return max((srv._version_spread for srv in list(_SERVERS)), default=0)


def _server_metrics():
    global _metrics_cache
    with _metrics_mu:
        if _metrics_cache is None:
            from brpc_tpu_torch.observability import metrics as obs

            _metrics_cache = {
                # Handler-body time only; the trampoline's tensor_handler
                # recorder adds the response staging.
                "pull": obs.latency("torch_param_server_pull"),
                "pull_group": obs.latency("torch_param_server_pull_group"),
                "push": obs.latency("torch_param_server_push"),
                "push_group": obs.latency("torch_param_server_push_group"),
                "push_bytes": obs.counter("torch_param_server_push_bytes"),
                "lag": obs.gauge("torch_param_server_version_lag",
                                 _max_version_lag),
            }
        return _metrics_cache


def _per_server_lag_gauge(name: str, srv: "ParameterServer") -> None:
    """This server's version spread as its own gauge,
    ``torch_param_server_version_lag_<name>`` (a fleet names it per
    shard). Re-pointable (the newest server claiming the name wins) and
    weakly bound, so a re-created server neither collides nor leaks."""
    from brpc_tpu_torch.observability import metrics as obs

    safe = re.sub(r"[^a-zA-Z0-9_]", "_", name)
    ref = weakref.ref(srv)
    obs.repointable_gauge(
        f"torch_param_server_version_lag_{safe}",  # tpulint: allow(metric-name)
        lambda: getattr(ref(), "_version_spread", 0))


class ParameterServer:
    """Serves named tensors over RPC; Push applies momentum SGD.

    ``params`` is a ``{name: array or tensor}`` dict — placed on
    ``device`` (default CUDA; raises when CUDA is absent) with zero
    momenta — or a :class:`PSState` from :func:`state_from_numpy`, used as
    it is (its tensors' device).

    ``name`` adds a per-server version-lag gauge. ``oneside=True``
    publishes every committed version into a seqlock-stamped window of
    the service arena, so a same-host client reads it without an RPC;
    ``oneside_codec`` (a codec this server serves) publishes eligible
    tensors in that wire form instead of raw.
    """

    def __init__(self, params, lr: float = 0.01, momentum: float = 0.9,
                 arena: Optional[TensorArena] = None, device=None,
                 name: Optional[str] = None, oneside: bool = False,
                 oneside_codec: Optional[str] = None):
        if isinstance(params, PSState):
            state = params
            devices = {t.device for t in state.params.values()}
            if len(devices) > 1:
                raise ValueError(f"state spans devices {devices}")
            self.device = (devices.pop() if devices
                           else resolve_device(device))
        else:
            state = state_from_numpy(params, device=device)
            self.device = resolve_device(device)
        self._params = dict(state.params)
        self._momenta = dict(state.momenta)
        self._version = dict(state.versions)
        self._lr = lr
        self._momentum = momentum
        # Per-parameter update locks: pushes to the SAME name serialize
        # (momentum reads its own previous write); pushes to different
        # names are independent. An update lock is taken BEFORE _mu.
        self._update_locks = {k: threading.Lock() for k in self._params}
        # Update admission: caps concurrent update computations, so a
        # client's whole window of pushes does not fan out at once.
        self._update_sem = threading.BoundedSemaphore(
            min(4, max(2, os.cpu_count() or 2)))
        self._mu = threading.Lock()  # handlers run on callback-pool threads
        self._version_spread = 0  # lock-free mirror for the lag gauge
        self._recompute_spread_locked()
        # Schema epoch: bumps when the parameter SET changes (Install,
        # Retire), never on a plain update — the client Meta cache key.
        self._schema_epoch = 1
        self._state: Dict[str, str] = {}         # absent == "serving"
        self._handoff_dest: Dict[str, str] = {}  # frozen name -> dest addr
        self._moved: Dict[str, str] = {}         # retired name -> dest addr
        # Codecs this server encodes pulls with / decodes pushes from,
        # advertised in Meta.
        self._codecs = tuple(codec_mod.supported_codecs())
        # Quantize once, serve many: name -> {codec: (version, meta,
        # wire uint8, logical bytes)}, replaced when the version moves.
        self._enc_cache: Dict[str, Dict[str, tuple]] = {}
        self.name = name
        if name is not None:
            _per_server_lag_gauge(name, self)
        _SERVERS.add(self)
        self._m = _server_metrics()
        # The handlers' device work (H2D, K2, K1, D2H staging) runs on a
        # stream of this server's own, never on the legacy default stream
        # a trainer in the same process computes on: one stream for every
        # handler, so a pull's D2H still queues after the update that made
        # its version. It first waits for the copies that placed the
        # initial state.
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            for t in (*self._params.values(), *self._momenta.values()):
                t.record_stream(self._stream)
        self.server = native.Server()
        self.arena = add_tensor_service(self.server, "ParamService",
                                        self._handle, arena,
                                        device_ctx=self._device_ctx)
        self._oneside_window: Optional[OnesideWindow] = None
        self._oneside_codec = (oneside_codec
                               if oneside_codec in self._codecs else None)
        if oneside:
            self._oneside_window = OnesideWindow(self.arena)
            with self._device_ctx():
                for k in list(self._params):
                    with self._update_locks[k]:
                        self._publish_oneside(k)
        self.port: Optional[int] = None

    def _device_ctx(self):
        """Enters this server's CUDA stream (nothing on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def start(self, addr: str = "127.0.0.1:0") -> int:
        self.port = self.server.start(addr)
        return self.port

    def stop(self) -> None:
        self.server.stop()

    def state(self) -> PSState:
        """A consistent snapshot of (params, momenta, versions). Tensors
        are never updated in place, so the snapshot stays valid. On CUDA
        the snapshot is complete on return (this waits for the server's
        stream) and its tensors are marked in use by the caller's."""
        with self._mu:
            snap = PSState(dict(self._params), dict(self._momenta),
                           dict(self._version))
        if self._stream is not None:
            self._stream.synchronize()
            caller = torch.cuda.current_stream(self.device)
            for t in (*snap.params.values(), *snap.momenta.values()):
                t.record_stream(caller)
        return snap

    def _missing_locked(self, name: str) -> "native.RpcError":
        """The answer for a name this server does not hold: E_MOVED with
        the forwarding address once it was retired here, else E_NO_SUCH.
        Call under _mu."""
        dest = self._moved.get(name)
        if dest is not None:
            return native.RpcError(E_MOVED, f"parameter {name} moved:{dest}")
        return native.RpcError(E_NO_SUCH, f"no such parameter: {name}")

    # ---- handler (runs on a callback-pool thread) ----
    def _handle(self, method: str, request: bytes, att):
        if method not in _METHODS:
            raise native.RpcError(E_NO_SUCH, f"no such method: {method}")
        if method == "Meta":
            with self._mu:
                meta = {}
                for k, v in self._params.items():
                    entry = {"shape": list(v.shape),
                             "dtype": np_dtype(v.dtype).name,
                             "version": self._version[k]}
                    state = self._state.get(k)
                    if state is not None:  # frozen/pending: the
                        entry["state"] = state  # migrator's repair pass
                    meta[k] = entry
                epoch = self._schema_epoch
            # "qos"/"codecs"/"pushq"/"oneside" are the negotiation
            # advertisements: clients stamp QoS fields, quantize, group
            # pushes or ask for the window only after seeing them.
            doc = {"epoch": epoch, "params": meta, "qos": 1,
                   "codecs": list(self._codecs), "pushq": 1}
            if self._oneside_window is not None:
                doc["oneside"] = 1
            return json.dumps(doc).encode(), None
        if method == "Epoch":
            with self._mu:
                epoch = self._schema_epoch
            return json.dumps({"epoch": epoch}).encode(), None
        if method == "PullQ":
            return self._handle_pull_group(request)
        if method == "PushQ":
            return self._handle_push_group(request, att)
        if method == "Oneside":
            # The mapping handshake: one RPC hands out the descriptor;
            # every read after it is a memory read.
            if self._oneside_window is None:
                raise native.RpcError(E_NO_SUCH, "one-sided reads disabled")
            desc = self._oneside_window.describe()
            # A decimal string on the wire: a double-typed JSON parser
            # would round a u64 token above 2^53.
            desc["token"] = str(desc["token"])
            return json.dumps(desc).encode(), None
        if method == "Handoff":
            return self._handle_handoff(request)
        if method == "Install":
            return self._handle_install(request, att)
        if method == "Retire":
            return self._handle_retire(request)
        if method == "Commit":
            return self._handle_commit(request)
        # Per-call codec marker: "<name>\x00<codec>" (only from clients
        # that saw the codec advertised), else the bare name.
        name_b, _, want_b = request.partition(b"\x00")
        name = name_b.decode()
        want = want_b.decode()
        if method == "Pull":
            t0 = time.monotonic()
            with self._mu:
                p = self._params.get(name)
                version = self._version.get(name)
                if p is None:
                    raise self._missing_locked(name)
            out = str(version).encode(), self._encode_pull(name, p, version,
                                                           want)
            self._m["pull"].record_s(time.monotonic() - t0)
            return out
        # Push
        if att is None:
            raise native.RpcError(native.TRPC_EREQUEST,
                                  "push without gradient")
        t0 = time.monotonic()
        self._update_sem.acquire()
        try:
            version = self._apply_update(name, att)
        finally:
            self._update_sem.release()
        self._m["push"].record_s(time.monotonic() - t0)
        self._m["push_bytes"].add(att.nbytes)
        return str(version).encode(), None

    # ---- quantized pull encode (quantize once, serve many) ----

    def _encoded_entry(self, name: str, p: torch.Tensor, version: int,
                       want: str):
        """-> (meta dict, flat uint8 wire bytes) for one pull response:
        the block-quantized codes when ``want`` is an enabled codec and
        the tensor is eligible (cached per (version, codec)), else the raw
        bytes (meta without codec — the per-call degrade)."""
        if want and want in self._codecs and codec_mod.eligible(p):
            with self._mu:
                ent = self._enc_cache.get(name, {}).get(want)
            if ent is None or ent[0] != version:
                host = _as_host_array(p)  # one D2H
                enc = codec_mod.encode(host, want)
                meta = {"dtype": host.dtype.str, "shape": list(host.shape),
                        "codec": want, "block": enc.block}
                ent = (version, meta, enc.wire, int(host.nbytes))
                with self._mu:
                    # A Retire that raced this encode popped the name (and
                    # its cache): serve this response, cache nothing.
                    if name in self._params:
                        self._enc_cache.setdefault(name, {})[want] = ent
            codec_mod.note(name, want, ent[3], int(ent[2].nbytes))
            return ent[1], ent[2]
        host = _as_host_array(p)
        return ({"dtype": host.dtype.str, "shape": list(host.shape)},
                host.reshape(-1).view(np.uint8))

    def _encode_pull(self, name: str, p: torch.Tensor, version: int,
                     want: str):
        """The single-Pull response tensor: the tensor itself (raw — the
        trampoline stages it D2H into the arena with the raw header) or
        the cached quantized bytes as a WireTensor."""
        if (not want or want not in self._codecs
                or not codec_mod.eligible(p)):
            return p
        meta, data = self._encoded_entry(name, p, version, want)
        return WireTensor(data, codec_mod.pack_header(meta))

    def _handle_pull_group(self, request: bytes):
        """PullQ: ONE RPC carrying many pull responses behind a JSON
        manifest (``groupwire`` shape); per-name misses (a name moved
        mid-reshard) ride the manifest as ``{"name", "code", "error"}``
        entries instead of failing the group."""
        t0 = time.monotonic()
        req = json.loads(request.decode())
        want = req.get("codec", "")
        entries, blobs, total = [], [], 0
        for name in req["names"]:
            with self._mu:
                p = self._params.get(name)
                version = self._version.get(name)
                miss = self._missing_locked(name) if p is None else None
            if miss is not None:
                entries.append({"name": name, "code": miss.code,
                                "error": miss.text})
                continue
            meta, data = self._encoded_entry(name, p, version, want)
            e = dict(meta)
            e["name"] = name
            e["version"] = version
            e["nbytes"] = int(data.nbytes)
            entries.append(e)
            blobs.append(data)
            total += int(data.nbytes)
        # Write each encoded tensor straight into the service arena and
        # hand the trampoline the pre-placed range (no concat buffer).
        placed = (0, 0)  # all-miss group: manifest only, no attachment
        if total:
            arena_off = self.arena.alloc(total)
            try:
                view = self.arena.view(arena_off, total)
                off = 0
                for b in blobs:
                    view[off:off + b.nbytes] = b.reshape(-1)
                    off += b.nbytes
            except BaseException:
                self.arena.free(arena_off)
                raise
            placed = (arena_off, total)
        self._m["pull_group"].record_s(time.monotonic() - t0)
        return (json.dumps({"tensors": entries}).encode(),
                WireTensor(None, b"", placed=placed))

    def _handle_push_group(self, request: bytes, att):
        """PushQ: ONE RPC carrying many gradient pushes behind a groupwire
        manifest; each entry applies exactly like a per-tensor Push, and
        per-name failures ride the result manifest."""
        t0 = time.monotonic()
        man = groupwire.parse_group(request)
        payload = None
        if att is not None:
            payload = np.ascontiguousarray(att).reshape(-1).view(np.uint8)
        try:
            pairs = list(groupwire.split_group(man, payload))
        except ValueError as ve:
            raise native.RpcError(E_UNDECODABLE,
                                  f"undecodable push group: {ve}")
        results = []
        for entry, run in pairs:
            name = entry.get("name", "?")
            try:
                if "codec" in entry:
                    grad = codec_mod.QuantizedView(entry, run)
                    logical = grad.nbytes
                else:
                    grad = run.view(np.dtype(entry["dtype"])).reshape(
                        tuple(entry["shape"]))
                    logical = int(grad.nbytes)
                self._update_sem.acquire()
                try:
                    version = self._apply_update(name, grad)
                finally:
                    self._update_sem.release()
                self._m["push_bytes"].add(logical)
                results.append({"name": name, "version": version})
            except native.RpcError as e:
                results.append({"name": name, "code": e.code,
                                "error": e.text})
            except ValueError as ve:
                results.append({
                    "name": name, "code": E_UNDECODABLE,
                    "error": f"undecodable tensor payload for {name}: "
                             f"{ve}"})
        self._m["push_group"].record_s(time.monotonic() - t0)
        return json.dumps({"results": results}).encode(), None

    # ---- one-sided publication ----

    def _publish_oneside(self, name: str) -> None:
        """Publish ``name``'s committed version into the one-sided window
        as ``[self-describing header|bytes]`` — raw, or the encoded wire
        form when ``oneside_codec`` engages — written into a fresh arena
        range the window takes over (the displaced version's range is
        reclaimed once no reader holds it). Callers hold the name's update
        lock, so publish order is version order; the D2H is a blocking
        copy on the stream the update kernel ran on, so it reads the
        finished tensor. A full arena skips the publish: readers of this
        name fall back to the RPC path, which serves the same state."""
        win = self._oneside_window
        if win is None:
            return
        with self._mu:
            if name not in self._params:
                return
            p = self._params[name]
            version = self._version[name]
        c = self._oneside_codec
        if c and codec_mod.eligible(p):
            # The PullQ encode cache: one D2H and one encode per version
            # serve both the publication and every quantized RPC pull.
            meta, data = self._encoded_entry(name, p, version, c)
            header = pad_header64(codec_mod.pack_header(meta))
        else:
            header = pad_header64(codec_mod.pack_header(
                {"dtype": np_dtype(p.dtype).str, "shape": list(p.shape)}))
            data = None
        nbytes = p.numel() * p.element_size() if data is None \
            else int(data.nbytes)
        total = len(header) + nbytes
        try:
            off = self.arena.alloc(total)
        except MemoryError:
            return  # unpublished version: one-sided readers fall back
        view = self.arena.view(off, total)
        view[:len(header)] = np.frombuffer(header, dtype=np.uint8)
        if data is not None:
            view[len(header):] = data.reshape(-1)
        elif nbytes:
            # Raw: one D2H straight into the arena pages.
            torch.from_numpy(view[len(header):]).copy_(
                p.detach().contiguous().reshape(-1).view(torch.uint8))
        try:
            win.publish(name, off, total, version)
        except (ValueError, RuntimeError):
            self.arena.free(off)

    # ---- live-resharding handshake (driven by fleet.Migrator) ----

    def _recompute_spread_locked(self) -> None:
        vs = self._version.values()
        self._version_spread = max(vs) - min(vs) if vs else 0

    def _handle_handoff(self, request: bytes):
        """Freeze ``name`` for export: pushes refuse with E_MOVED from
        here on; pulls keep serving the frozen version until Retire.
        Returns {"version"} and the stacked [param, momentum] tensor.
        Idempotent: a migrator retry re-exports the same frozen state."""
        req = json.loads(request.decode())
        name, dest = req["name"], req.get("dest", "")
        with self._mu:
            lock = self._update_locks.get(name)
            if lock is None:
                raise self._missing_locked(name)
        with lock:  # an in-flight push completes (or sees frozen) first
            with self._mu:
                if name not in self._params:  # retired while we waited
                    raise self._missing_locked(name)
                self._state[name] = "frozen"
                if dest:
                    self._handoff_dest[name] = dest
                p = self._params[name]
                m = self._momenta[name]
                version = self._version[name]
        # Frozen names take no more updates and tensors are never written
        # in place, so stacking outside the locks reads stable tensors;
        # the trampoline stages the stack with one blocking D2H.
        return (json.dumps({"name": name, "version": version}).encode(),
                torch.stack([p, m]))

    def _handle_install(self, request: bytes, att):
        """Adopt a handed-off tensor in ``pending`` state: pulls serve it,
        pushes refuse with E_MIGRATING until Commit. Re-installing a
        pending or frozen name is recovery (a migrator retry, a remap
        back), not a conflict; only a serving copy refuses (E_EXISTS)."""
        req = json.loads(request.decode())
        name = req["name"]
        version = int(req.get("version", 0))
        if not isinstance(att, np.ndarray):
            raise native.RpcError(native.TRPC_EREQUEST,
                                  "install without a raw tensor payload")
        if att.ndim < 1 or att.shape[0] != 2:
            raise native.RpcError(
                native.TRPC_EREQUEST,
                f"install expects stacked [param, momentum], "
                f"got shape {tuple(att.shape)}")
        # Detach from the sender's arena pages before the handler returns:
        # blocking copies onto this server's device.
        param = _device_put_from_view(att[0], self.device)
        mom = _device_put_from_view(att[1], self.device)
        with self._mu:
            if name in self._params and self._state.get(name) not in (
                    "pending", "frozen"):
                raise native.RpcError(
                    E_EXISTS, f"install over live parameter: {name}")
            self._params[name] = param
            self._momenta[name] = mom
            self._version[name] = version
            self._enc_cache.pop(name, None)  # encoded for the old bytes
            self._update_locks.setdefault(name, threading.Lock())
            self._state[name] = "pending"
            self._moved.pop(name, None)  # keys can migrate back later
            self._handoff_dest.pop(name, None)  # any old freeze is void
            self._schema_epoch += 1
            self._recompute_spread_locked()
        # Pending names refuse pushes until Commit, so no concurrent
        # publish races this one out of version order.
        self._publish_oneside(name)
        return json.dumps({"name": name, "version": version}).encode(), None

    def _handle_retire(self, request: bytes):
        """Drop a handed-off tensor and remember its forwarding address:
        later pulls/pushes answer E_MOVED "moved:<dest>". Idempotent."""
        req = json.loads(request.decode())
        name, dest = req["name"], req.get("dest", "")
        with self._mu:
            lock = self._update_locks.get(name)
        if lock is not None:
            with lock:
                with self._mu:
                    self._params.pop(name, None)
                    self._momenta.pop(name, None)
                    self._version.pop(name, None)
                    self._enc_cache.pop(name, None)
                    self._update_locks.pop(name, None)
                    self._state.pop(name, None)
                    self._handoff_dest.pop(name, None)
                    if dest:  # an empty dest would forward into "moved:"
                        self._moved[name] = dest
                    self._schema_epoch += 1
                    self._recompute_spread_locked()
                if self._oneside_window is not None:
                    # Mapped clients miss here and re-route via E_MOVED.
                    self._oneside_window.unpublish(name)
        else:
            with self._mu:
                if dest and self._moved.get(name) != dest:
                    # A new redirect is a schema change too: a warm Meta
                    # cache must not keep validating the old set.
                    self._moved[name] = dest
                    self._schema_epoch += 1
        return json.dumps({"name": name}).encode(), None

    def _handle_commit(self, request: bytes):
        """pending -> serving: the write-side commit point, ordered by the
        Migrator after the old owner retired."""
        name = request.decode()
        with self._mu:
            if name not in self._params:
                raise self._missing_locked(name)
            self._state.pop(name, None)
            # A stale forwarding hint must not outlive the commit.
            self._handoff_dest.pop(name, None)
        return b"ok", None

    def _check_writable_locked(self, name: str) -> None:
        """Raise the refusal a push to ``name`` gets now: E_MOVED for a
        retired or frozen name, E_MIGRATING for a pending one. Call under
        _mu."""
        if name not in self._params:
            raise self._missing_locked(name)
        state = self._state.get(name)
        if state == "frozen":
            dest = self._handoff_dest.get(name)
            raise native.RpcError(
                E_MOVED, f"parameter {name} handed off"
                + (f"; moved:{dest}" if dest else ""))
        if state == "pending":
            raise native.RpcError(
                E_MIGRATING, f"parameter {name} migrating in; retry shortly")

    def _apply_update(self, name: str, att) -> int:
        """Detach the gradient from the request pages onto the device
        (the copy completes before the handler returns and the view is
        released), then apply the fused update out of place. A push the
        server will refuse is refused before it costs a copy or a kernel;
        the check under the update lock is the one that decides."""
        with self._mu:
            self._check_writable_locked(name)
        if isinstance(att, codec_mod.QuantizedView):
            codec_mod.note(name, att.codec, att.nbytes, att.wire_nbytes)
            with tracing.stage("device_put"):
                q_dev, s_dev = _detach_device_put_batch(
                    [(att.q, att.scales)], self.device)
            with tracing.stage("dequant"):
                grad = _dequant_widen(q_dev, s_dev, att.codec, att.block,
                                      att.n, att.shape)
        else:
            with tracing.stage("device_put"):
                grad = _device_put_from_view(att, self.device)
        with self._mu:
            lock = self._update_locks.get(name)
            if lock is None:  # retired since the check above
                raise self._missing_locked(name)
        with lock:
            with self._mu:
                self._check_writable_locked(name)
                p = self._params[name]
                m = self._momenta[name]
            with tracing.stage("fused_update"):
                # Out of place: a Pull stages the tensor it was handed
                # after dropping _mu, so tensors stay immutable once
                # handed out. Launched on the server's stream (the same
                # on every handler thread): later pulls' D2H copies order
                # after it without a sync here.
                p2, m2 = fused_momentum_update(
                    p, m, grad.to(p.dtype), lr=self._lr,
                    beta=self._momentum)
            with self._mu:
                self._params[name] = p2
                self._momenta[name] = m2
                self._version[name] += 1
                version = self._version[name]
                self._recompute_spread_locked()
            # Inside the update lock: publish order == version order, so
            # a mapped reader's versions never go backwards.
            self._publish_oneside(name)
        return version


class ParameterClient:
    """Pulls params into device tensors / pushes gradients, all over the
    framework (one TensorChannel per client).

    ``device`` is where pulled tensors land (default CUDA; raises when
    CUDA is absent). ``codec="int8"`` (or ``"fp8e4m3"``) asks for the
    quantized wire, engaged only after the server advertises it in Meta;
    pushes quantize with error feedback. ``oneside=True`` reads committed
    versions straight from the server's published window once its Meta
    advertises one and the window maps (same host), and takes the RPC
    path transparently otherwise."""

    def __init__(self, addr: str, arena: Optional[TensorArena] = None,
                 codec: Optional[str] = None, device=None,
                 oneside: bool = False):
        self.device = resolve_device(device)
        self.addr = addr
        self.channel = TensorChannel(addr, arena)
        # Meta cache keyed by the server's schema epoch.
        self._meta_epoch: Optional[int] = None
        self._meta_cache: Optional[dict] = None
        self._codec = codec
        self._srv_codecs: Optional[tuple] = None  # unknown until Meta
        self._srv_pushq = False
        self._ef = codec_mod.ErrorFeedback()
        self.pacer = OverloadPacer()
        # QoS negotiation: None until the first Meta; True when the
        # server advertised "qos": 1.
        self._srv_qos: Optional[bool] = None
        # One-sided reads: _oneside_reader is None until tried, False once
        # this client is parked on the RPC path for good (off-host,
        # disabled, gone), else the mapping.
        self._oneside = oneside
        self._oneside_reader = None
        self._srv_oneside: Optional[bool] = None

    def _dev(self, device) -> torch.device:
        return self.device if device is None else resolve_device(device)

    # ---- QoS lanes (native/trpc/qos.h): control calls ride HIGH, bulk
    # tensor traffic BULK — stamped only after the server's Meta carried
    # "qos": 1; Meta itself always rides unstamped.

    def _qos(self, priority: int):
        if self._srv_qos is None:
            try:
                self.meta()
            except native.RpcError:
                pass  # unknown stays unknown: this call rides unstamped
        if not self._srv_qos:
            return contextlib.nullcontext()
        return native.qos(priority)

    def _qos_high(self):
        return self._qos(native.PRIORITY_HIGH)

    def _qos_bulk(self):
        return self._qos(native.PRIORITY_BULK)

    def meta(self) -> dict:
        payload, _ = self.channel.call("ParamService/Meta")
        doc = json.loads(payload.decode())
        self._meta_epoch = doc["epoch"]
        self._meta_cache = doc["params"]
        self._srv_codecs = tuple(doc.get("codecs", ()))
        self._srv_qos = bool(doc.get("qos", 0))
        self._srv_oneside = bool(doc.get("oneside", 0))
        self._srv_pushq = bool(doc.get("pushq", 0))
        return doc["params"]

    def epoch(self) -> int:
        """The server's schema epoch (a tiny call)."""
        with self._qos_high():
            payload, _ = self.channel.call("ParamService/Epoch")
        return json.loads(payload.decode())["epoch"]

    def cached_meta(self) -> dict:
        """The Meta map through the epoch-validated cache."""
        if self._meta_cache is not None and self.epoch() == self._meta_epoch:
            return self._meta_cache
        return self.meta()

    # ---- per-call codec negotiation ----

    def negotiated_codec(self) -> Optional[str]:
        """The codec this client/server pair agreed on, or None (raw);
        the advertisement is fetched once (one Meta RPC)."""
        if self._codec is None:
            return None
        if self._srv_codecs is None:
            self.meta()
        return codec_mod.choose(self._codec, self._srv_codecs)

    # ---- one-sided reads ----

    def _ensure_oneside_reader(self):
        """The mapped window, established on first use: one Meta RPC for
        the advertisement, one Oneside RPC for the descriptor, one map.
        Any failure parks this client on the RPC path for good."""
        r = self._oneside_reader
        if r is not None:
            return r if r is not False else None
        if self._srv_oneside is None:
            try:
                self.meta()
            except native.RpcError:
                return None  # unknown stays unknown: retry next call
        if not self._srv_oneside:
            self._oneside_reader = False
            return None
        try:
            payload, _ = self.channel.call("ParamService/Oneside")
            r = OnesideReader.map(json.loads(payload.decode()))
        except (native.RpcError, ValueError):
            r = None
        self._oneside_reader = r if r is not None else False
        return r

    def _drop_oneside_reader(self) -> None:
        r = self._oneside_reader
        self._oneside_reader = False  # permanent fallback
        if r not in (None, False):
            r.close()

    def _oneside_read(self, name: str, device):
        """-> (version, value) straight from the peer's published window,
        or None when this pull should ride the RPC path (each such miss
        counts as a fallback; the RPC path serves the same committed
        state)."""
        m = _metrics()
        r = self._ensure_oneside_reader()
        if r is None:
            m["oneside_fallbacks"].add(1)
            return None
        try:
            version, payload = r.read_np(name)
        except OnesideGone:
            self._drop_oneside_reader()
            m["oneside_fallbacks"].add(1)
            return None
        except OnesideMiss:
            m["oneside_fallbacks"].add(1)
            return None
        try:
            value = consume_oneside_payload(payload, device, note_name=name)
        except (ValueError, KeyError, struct.error):
            m["oneside_fallbacks"].add(1)  # undecodable publication
            return None
        m["oneside_hits"].add(1)
        return int(version), value

    def prune_residuals(self, keep) -> int:
        """Drop error-feedback residuals for names failing ``keep(name)``
        — the fleet's reshard hook: a name now owned by another shard is
        never pushed through this client again."""
        return self._ef.prune(keep)

    def _pull_request(self, name: str) -> bytes:
        c = self.negotiated_codec()
        return name.encode() + (b"\x00" + c.encode() if c else b"")

    def _grad_encoder(self, name: str):
        """The per-tensor encoder for a quantized gradient push (None when
        riding raw): error-feedback compensate, quantize, settle."""
        c = self.negotiated_codec()
        if c is None:
            self._ef.clear(name)
            return None

        def enc(host: np.ndarray):
            if not codec_mod.eligible(host):
                self._ef.clear(name)  # nothing quantized, nothing owed
                return None
            x = self._ef.compensate(name, host)
            e = codec_mod.encode(x, c)
            self._ef.settle(name, x, e.dequantized())
            codec_mod.note(name, c, e.logical_bytes, e.wire_bytes)
            return e.wire, e.header

        return enc

    def pull(self, name: str, device=None):
        """-> (version, tensor on the client's device). A client made with
        ``oneside=True`` reads the published window first."""
        dev = self._dev(device)
        if self._oneside:
            got = self._oneside_read(name, dev)
            if got is not None:
                return got
        self.pacer.pace()
        try:
            with self._qos_bulk():
                rest, t = self.channel.pull_device(
                    "ParamService/Pull", request=self._pull_request(name),
                    device=dev, note_name=name)
        except native.RpcError as e:
            self.pacer.note(e)
            raise
        self.pacer.clear()
        return int(rest.decode()), t

    def push_grad(self, name: str, grad) -> int:
        """Send a gradient tensor; returns the server's new version."""
        self.pacer.pace()
        try:
            with self._qos_bulk():
                payload = self.channel.push_device(
                    "ParamService/Push", grad, request=name.encode(),
                    encoder=self._grad_encoder(name))
        except native.RpcError as e:
            self.pacer.note(e)
            raise
        self.pacer.clear()
        return int(payload.decode())

    # ---- live-resharding handshake (used by fleet.Migrator) ----

    def handoff(self, name: str, dest: str = ""):
        """Freeze and export ``name`` -> (version, stacked [param,
        momentum] host array). The server refuses pushes to it from now
        on."""
        req = json.dumps({"name": name, "dest": dest}).encode()
        with self._qos_high():  # the handshake is the control plane
            payload, stacked = self.channel.call("ParamService/Handoff",
                                                 request=req)
        return json.loads(payload.decode())["version"], stacked

    def install(self, name: str, stacked, version: int,
                commit: bool = False) -> None:
        """Adopt a stacked [param, momentum] tensor at ``version`` in
        pending state; ``commit=True`` also opens it for pushes."""
        req = json.dumps({"name": name, "version": int(version)}).encode()
        with self._qos_high():
            self.channel.call("ParamService/Install", array=stacked,
                              request=req)
        if commit:
            self.commit(name)

    def retire(self, name: str, dest: str = "") -> None:
        req = json.dumps({"name": name, "dest": dest}).encode()
        with self._qos_high():
            self.channel.call("ParamService/Retire", request=req)

    def commit(self, name: str) -> None:
        with self._qos_high():
            self.channel.call("ParamService/Commit", request=name.encode())

    # ---- pipelined multi-tensor hot path (PipelineWindow) ----

    def pull_all(self, names=None, device=None, window: int = 4,
                 group: int = 8) -> Dict[str, tuple]:
        """Pull many parameters through one bounded pipeline window ->
        ``{name: (version, tensor)}``; ``names=None`` pulls every name
        Meta lists.

        One-sided first (a client made with ``oneside=True``): every name
        the mapped window serves skips the RPC plane; the rest ride the RPC
        path. Raw: one Pull RPC per tensor, each copied to the device
        straight from its response view. Negotiated codec: eligible names
        ride ``PullQ`` in groups of ``group`` per RPC (codes cross, the
        dequantize kernel widens on the device); names Meta predicts
        ineligible stay per-tensor raw in the same window.
        """
        dev = self._dev(device)
        self.pacer.pace()
        listed_meta = None
        if names is None:
            listed_meta = self.cached_meta()
            names = sorted(listed_meta)
        names = list(names)
        m = _metrics()
        out: Dict[str, tuple] = {}
        if self._oneside and names:
            rest = []
            for n in names:
                got = self._oneside_read(n, dev)
                if got is not None:
                    out[n] = got
                else:
                    rest.append(n)
            if not rest:
                return out
            names = rest
        c = self.negotiated_codec()

        def on_single(name, payload, view):
            rest, t, nbytes = consume_pull_reply(payload, view, dev,
                                                 note_name=name)
            m["pull_bytes"].add(nbytes)
            out[name] = (int(rest.decode()), t)

        if c is None:
            try:
                with self._qos_bulk(), PipelineWindow(
                        self.channel, window, on_reply=on_single) as win:
                    for name in names:
                        win.submit("ParamService/Pull",
                                   request=self._pull_request(name),
                                   tag=name)
            except native.RpcError as e:
                self.pacer.note(e)
                if out:
                    raise PartialPullError(
                        e, dict(out),
                        [n for n in names if n not in out]) from e
                raise
            self.pacer.clear()
            return out

        # Codec-ineligible names gain nothing from PullQ: Meta predicts
        # them and they stay per-tensor raw (same window).
        try:
            meta_map = (listed_meta if listed_meta is not None
                        else self.cached_meta())
        except native.RpcError:
            meta_map = {}

        def predict_eligible(n: str) -> bool:
            e = meta_map.get(n)
            if e is None:
                return True  # unknown: the group reports it per name
            return (e["dtype"] == "float32"
                    and int(np.prod(e["shape"], dtype=np.int64)) * 4
                    >= codec_mod.MIN_QUANT_BYTES)

        singles = [n for n in names if not predict_eligible(n)]
        single_set = set(singles)
        grouped = [n for n in names if n not in single_set]

        def on_group(_tag, payload, view):
            # Every tensor of the group crosses to the device while the
            # view is held (the bytes live in the peer's pages); the
            # dequantize kernels then write fresh outputs.
            quant, raws = [], []
            err: Optional[native.RpcError] = None
            with view:
                man = json.loads(payload.decode())
                buf = view.ndarray()
                off = 0
                for t in man["tensors"]:
                    if "error" in t:
                        # After the groupmates decode: a moved tensor
                        # must not poison them.
                        if err is None:
                            err = native.RpcError(t["code"], t["error"])
                        continue
                    nb = t["nbytes"]
                    sub = buf[off:off + nb]
                    off += nb
                    try:
                        if "codec" in t:
                            codec_mod.note(
                                t["name"], t["codec"],
                                int(np.prod(t["shape"], dtype=np.int64))
                                * np.dtype(t["dtype"]).itemsize, nb)
                            quant.append((t, *codec_mod.split_wire(t, sub)))
                        else:
                            raws.append((t, sub.view(np.dtype(
                                t["dtype"])).reshape(tuple(t["shape"]))))
                    except ValueError as ve:
                        if err is None:
                            err = native.RpcError(
                                E_UNDECODABLE, "undecodable tensor "
                                f"payload for {t['name']}: {ve}")
                with _stage("device_put"):
                    qdevs = _detach_device_put_batch(
                        [(q, s) for _t, q, s in quant], dev)
                    rdevs = [_device_put_from_view(a, dev) for _t, a in raws]
            with _stage("dequant"):
                for i, (t, _q, _s) in enumerate(quant):
                    n = int(np.prod(t["shape"], dtype=np.int64))
                    val = _dequant_widen(qdevs[2 * i], qdevs[2 * i + 1],
                                         t["codec"], t["block"], n,
                                         t["shape"], want=t["dtype"])
                    out[t["name"]] = (int(t["version"]), val)
                    m["pull_bytes"].add(n * np.dtype(t["dtype"]).itemsize)
            for (t, a), val in zip(raws, rdevs):
                m["pull_bytes"].add(int(a.nbytes))
                out[t["name"]] = (int(t["version"]), val)
            if err is not None:
                raise err

        def on_reply(tag, payload, view):
            if isinstance(tag, tuple):
                return on_group(tag, payload, view)
            return on_single(tag, payload, view)

        try:
            with self._qos_bulk(), PipelineWindow(
                    self.channel, window, on_reply=on_reply) as win:
                for name in singles:
                    win.submit("ParamService/Pull",
                               request=self._pull_request(name), tag=name)
                step = max(1, group)
                for i in range(0, len(grouped), step):
                    g = grouped[i:i + step]
                    req = json.dumps({"names": g, "codec": c}).encode()
                    win.submit("ParamService/PullQ", request=req,
                               tag=tuple(g))
        except native.RpcError as e:
            self.pacer.note(e)
            if out:
                raise PartialPullError(
                    e, dict(out),
                    [n for n in names if n not in out]) from e
            raise
        self.pacer.clear()
        return out

    def push_all(self, grads: Dict[str, object], window: int = 4,
                 group: int = 8) -> Dict[str, int]:
        """Push many gradients through one bounded pipeline window ->
        ``{name: new_version}``.

        Raw: one Push RPC per tensor. Negotiated codec against a
        PushQ-advertising server: eligible gradients quantize (with error
        feedback) into groups of ``group`` per PushQ RPC; ineligible ones
        ride per-tensor raw in the same window. A refused call does not
        cancel the others in flight (a cancelled push may have been
        applied, and re-sending it would apply it twice): the window
        drains, and :class:`PartialPushError` then carries the confirmed
        versions and the refused names.
        """
        m = _metrics()
        versions: Dict[str, int] = {}
        per_name_err: Dict[str, native.RpcError] = {}
        c = self.negotiated_codec()
        use_group = c is not None and self._srv_pushq and group > 1

        def on_reply(tag, payload, view):
            view.release()  # push responses carry no tensor
            if isinstance(tag, tuple):
                for r in json.loads(payload.decode())["results"]:
                    if "error" in r:
                        per_name_err[r["name"]] = native.RpcError(
                            int(r["code"]), r["error"])
                    else:
                        versions[r["name"]] = int(r["version"])
            else:
                versions[tag] = int(payload.decode())

        def on_error(tag, err):
            self.pacer.note(err)
            for n in (tag if isinstance(tag, tuple) else (tag,)):
                per_name_err[n] = err

        self.pacer.pace()
        try:
            with self._qos_bulk(), PipelineWindow(
                    self.channel, window, on_reply=on_reply,
                    on_error=on_error) as win:
                if not use_group:
                    for name, grad in grads.items():
                        win.submit("ParamService/Push", array=grad,
                                   request=name.encode(), tag=name,
                                   encoder=self._grad_encoder(name))
                        m["push_bytes"].add(int(grad.nbytes))
                else:
                    # Split by metadata (no D2H needed), then copy to the
                    # host one group at a time: never a full host replica.
                    grouped = [n for n in grads
                               if codec_mod.eligible(grads[n])]
                    gset = set(grouped)
                    for name in grads:
                        if name in gset:
                            continue
                        self._ef.clear(name)  # raw hop: nothing owed
                        win.submit("ParamService/Push", array=grads[name],
                                   request=name.encode(), tag=name)
                        m["push_bytes"].add(int(grads[name].nbytes))
                    for i in range(0, len(grouped), group):
                        entries, blobs = [], []
                        for n in grouped[i:i + group]:
                            host = _as_host_array(grads[n])
                            x = self._ef.compensate(n, host)
                            e = codec_mod.encode(x, c)
                            self._ef.settle(n, x, e.dequantized())
                            codec_mod.note(n, c, e.logical_bytes,
                                           e.wire_bytes)
                            entries.append(
                                {"name": n, "dtype": host.dtype.str,
                                 "shape": list(host.shape),
                                 "codec": c, "block": e.block})
                            blobs.append(e.wire)
                            m["push_bytes"].add(host.nbytes)
                        manifest, concat = groupwire.pack_group(entries,
                                                                blobs)
                        win.submit("ParamService/PushQ", array=concat,
                                   request=manifest,
                                   tag=tuple(e["name"] for e in entries))
        except native.RpcError as e:
            self.pacer.note(e)
            if versions:
                raise PartialPushError(
                    e, dict(versions),
                    [n for n in grads if n not in versions]) from e
            raise
        if per_name_err:
            cause = next(iter(per_name_err.values()))
            raise PartialPushError(
                cause, dict(versions),
                [n for n in grads if n not in versions])
        self.pacer.clear()
        return versions

    def close(self) -> None:
        self._drop_oneside_reader()
        self.channel.close()
