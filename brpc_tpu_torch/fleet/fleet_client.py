"""FleetClient: one parameter-server interface over N shards.

`pull_all`/`push_all` become cross-shard scatter/gather: names group by
their ketama owner (shard_map.py — computed locally from the registry's
membership list), each shard's group rides its OWN `ParameterClient`
(own TensorChannel + arena) through its own `PipelineWindow` on its own
thread, so aggregate bandwidth scales with shard count instead of
serializing behind one endpoint.

Mid-reshard correctness is a routing protocol, not luck:

  * the client keeps the CURRENT map and the PREVIOUS one; a miss at the
    new owner falls back to the old owner (reads are served by the old
    owner until a tensor's handoff commits);
  * E_MOVED redirects carry "moved:<addr>" — the forwarding chain is
    followed without a registry round trip;
  * E_MIGRATING (installed but not yet committed) and connection errors
    back off and retry under a deadline, refreshing membership between
    rounds;
  * a name answering E_NO_SUCH everywhere with stable membership raises
    KeyError fast (vs. spinning out the deadline) — the kill-a-shard
    data-loss signal, repaired by `install()` reseeding.

Per-shard Meta traffic rides `ParameterClient.cached_meta()` (the
epoch-validated cache), so a warm fleet meta() costs one tiny Epoch RPC
per shard, not N full Meta payloads.

A push the old owner refuses mid-reshard is re-sent once: the shard
client's `push_all` lets its window drain on a refusal, so every push it
does not report as refused has been applied and is never re-sent.
"""

from __future__ import annotations

import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from brpc_tpu_torch.fleet import gauges, registry
from brpc_tpu_torch.fleet.shard_map import ShardMap
from brpc_tpu_torch.observability import tracing
from brpc_tpu_torch.runtime import native
from brpc_tpu_torch.runtime.param_server import (E_MIGRATING, E_MOVED,
                                                 E_NO_SUCH, ParameterClient,
                                                 PartialPullError,
                                                 PartialPushError,
                                                 moved_dest)
from brpc_tpu_torch.runtime.tensor import TensorArena, _as_host_array
from brpc_tpu_torch.utils.device import resolve_device


class FleetClient:
    """Scatter/gather parameter access across a registered shard fleet.
    Pulled tensors land on ``device`` (default CUDA; raises when CUDA is
    absent). ``arena_bytes`` sizes each shard client's arena, which must
    hold the largest quantized push group ``window`` times over.
    ``tenant`` is stamped on every shard client's calls (the servers'
    per-tenant quota key). ``oneside=True`` reads each shard's published
    window where it maps (same host) and its Meta advertises one; other
    shards stay on the RPC path, shard by shard."""

    def __init__(self, registry_hostport: str, tag: str = "param",
                 window: int = 4, arena_bytes: int = 64 << 20,
                 device=None, op_deadline_s: float = 15.0,
                 overrides: Optional[Dict[str, str]] = None,
                 codec: Optional[str] = None, tenant: str = "",
                 oneside: bool = False):
        self._registry = registry_hostport
        self._tag = tag
        self.window = window
        self._arena_bytes = arena_bytes
        self._device = resolve_device(device)
        self._deadline_s = op_deadline_s
        self._overrides = dict(overrides or {})
        # Quantized tensor wire: negotiated PER SHARD STREAM — each
        # shard's ParameterClient checks its own server's Meta
        # advertisement, so a mixed fleet (some shards codec-enabled,
        # some not) serves each stream in the best format that shard
        # speaks, raw included.
        self._codec = codec
        # Overload protection: every shard client stamps this tenant id;
        # control calls ride the HIGH lane, pulls and pushes BULK (the
        # per-method lanes live in ParameterClient).
        self._tenant = tenant
        # One-sided reads, routed per shard by locality: each shard's
        # client maps that server's window only where it can.
        self._oneside = oneside
        self._mu = threading.Lock()
        self._clients: Dict[str, ParameterClient] = {}
        self._map: Optional[ShardMap] = None
        self._prev_map: Optional[ShardMap] = None
        # Weakly bound: the repointable-gauge holder table is immortal,
        # and a strongly-captured self would pin a closed client and its
        # per-shard arenas (64MB each) for the process lifetime.
        ref = weakref.ref(self)

        def _shards() -> int:
            c = ref()
            return len(c._map.shards) if c is not None and \
                c._map is not None else 0

        def _epoch() -> int:
            c = ref()
            return c._map.epoch if c is not None and \
                c._map is not None else 0

        gauges.publish("shards", _shards)
        gauges.publish("map_epoch", _epoch)
        self.refresh()

    # ---- membership / routing ----

    def refresh(self) -> None:
        """Re-derive the shard map from the registry's membership list.
        The map epoch IS the registry index, so every fleet participant
        derives the same (map, epoch) pair with no coordination RPC."""
        index, addrs = registry.list_servers(self._registry, self._tag)
        with self._mu:
            if self._map is not None:
                if self._map.shards == tuple(sorted(set(addrs))):
                    return  # membership unchanged; keep both maps as-is
                self._prev_map = self._map
                self._map = self._map.with_shards(addrs, index)
            else:
                self._map = ShardMap(addrs, epoch=index,
                                     overrides=self._overrides)
            live = set(self._map.shards)
            if self._prev_map is not None:
                live |= set(self._prev_map.shards)
            for addr in [a for a in self._clients if a not in live]:
                self._clients.pop(addr).close()
            # Reshard edge: drop error-feedback residuals for names a
            # surviving shard client no longer owns — they are
            # full-gradient-sized fp32 buffers, and without this hook N
            # reshards leave every shard client holding residuals
            # approaching the full parameter set. An in-flight push may
            # re-settle a just-moved name once; the next edge prunes it.
            cur = self._map
            for addr, pc in self._clients.items():
                def _still_ours(n, a=addr):
                    try:
                        return cur.owner(n) == a
                    except LookupError:
                        return False
                pc.prune_residuals(_still_ours)

    @property
    def map(self) -> ShardMap:
        with self._mu:
            if self._map is None:
                raise RuntimeError("fleet client is closed")
            return self._map

    def _client(self, addr: str) -> ParameterClient:
        with self._mu:
            pc = self._clients.get(addr)
            if pc is None:
                pc = ParameterClient(f"tpu://{addr}",
                                     TensorArena(self._arena_bytes),
                                     codec=self._codec, tenant=self._tenant,
                                     device=self._device,
                                     oneside=self._oneside)
                self._clients[addr] = pc
            return pc

    def _candidates(self, name: str) -> List[str]:
        """Owner under the current map, then under the previous one —
        mid-reshard reads are served by the OLD owner until the handoff
        commits, so both generations are live routing targets."""
        with self._mu:
            maps = [m for m in (self._map, self._prev_map) if m is not None]
        out: List[str] = []
        for m in maps:
            try:
                addr = m.owner(name)
            except LookupError:
                continue
            if addr not in out:
                out.append(addr)
        return out

    def _with_retry(self, name: str, op):
        """Run `op(ParameterClient)` against the candidate owners,
        following E_MOVED forwarding, backing off on E_MIGRATING and
        transport errors, refreshing membership between rounds.

        Overload answers (ELIMIT/EOVERCROWDED — `RpcError.overloaded`)
        are classified APART from the reshard signals: retriable with
        backoff paced by the server's retry_after_ms hint, but NEVER
        counted as moved/migrating evidence — an overloaded-only round
        skips the registry refresh (a shed storm must not also become a
        registry-poll storm), can never trip the not-in-fleet KeyError,
        and never reads as shard death."""
        deadline = time.monotonic() + self._deadline_s
        delay = 0.01
        last_err: Optional[Exception] = None
        while True:
            # One consistent snapshot per round: a concurrent close()
            # nulls self._map, and unsnapshotted check-then-use would
            # surface as AttributeError instead of the clean error below.
            with self._mu:
                smap = self._map
            if smap is None:
                raise RuntimeError("fleet client is closed")
            retriable = False
            overload_only = True  # no non-overload signal seen this round
            overload_hint_s = 0.0
            tried = set()
            queue = self._candidates(name)
            while queue:
                addr = queue.pop(0)
                if addr in tried:
                    continue
                tried.add(addr)
                try:
                    return op(self._client(addr))
                except native.RpcError as e:
                    last_err = e
                    if e.overloaded:
                        # Shed-before-queue answer: the parameter is
                        # where the map says — the owner is just over
                        # capacity. Pace on its hint and try again.
                        retriable = True
                        overload_hint_s = max(
                            overload_hint_s,
                            (e.retry_after_ms or 0) / 1000.0)
                        continue
                    overload_only = False
                    dest = moved_dest(e)
                    if dest and dest not in tried:
                        queue.append(dest)  # follow the forwarding chain
                    if e.code == E_NO_SUCH:
                        continue
                    if e.code == E_MOVED:
                        # A forward to a live member (or a mid-handshake
                        # freeze with no dest yet) resolves shortly; a
                        # forward to a DEPARTED shard means the tensor
                        # died with it — don't spin out the deadline.
                        if not dest or dest in smap:
                            retriable = True
                        continue
                    # Transport errors from a CURRENT member retry (TTL
                    # lag, a joiner warming up); from a departed shard
                    # (prev-map fallback) they don't — its data either
                    # migrated (the live owner answers) or died with it
                    # (KeyError is the truth).
                    if e.code == E_MIGRATING or addr in smap:
                        retriable = True
            if retriable and overload_only:
                # Pure overload: membership is not in question — skip the
                # registry round trip and just pace out the shed.
                if time.monotonic() >= deadline:
                    assert last_err is not None
                    raise last_err
                time.sleep(max(delay, overload_hint_s))
                delay = min(delay * 2, 0.25)
                continue
            self.refresh()
            with self._mu:
                changed = (self._map is not None
                           and self._map.epoch != smap.epoch)
            if not retriable and not changed:
                # Every live candidate disowns it and membership is
                # stable: the name is not in the fleet (lost with a dead
                # shard, or never seeded). install() repairs data loss.
                raise KeyError(f"parameter {name!r} not in fleet") \
                    from last_err
            if time.monotonic() >= deadline:
                assert last_err is not None
                raise last_err
            time.sleep(max(delay, overload_hint_s))
            delay = min(delay * 2, 0.25)

    # ---- metadata ----

    def meta(self) -> dict:
        """Merged fleet meta: {name: {shape, dtype, version, shard}}.
        Mid-handoff duplicates (frozen at the old owner, pending at the
        new) collapse to the higher-version entry."""
        with self._mu:
            if self._map is None:
                raise RuntimeError("fleet client is closed")
            shards = self._map.shards
        merged: Dict[str, Tuple[str, dict]] = {}
        for addr in shards:
            try:
                m = self._client(addr).cached_meta()
            except native.RpcError:
                continue  # dead shard: TTL expiry will drop it from the map
            for k, v in m.items():
                cur = merged.get(k)
                if cur is None or v.get("version", 0) >= cur[1].get(
                        "version", 0):
                    merged[k] = (addr, v)
        return {k: dict(v, shard=addr) for k, (addr, v) in merged.items()}

    # ---- single-tensor ops ----

    def pull(self, name: str, device=None):
        """-> (version, tensor), routed/redirected to the live owner."""
        dev = device if device is not None else self._device
        return self._with_retry(name,
                                lambda pc: pc.pull(name, device=dev))

    def push_grad(self, name: str, grad) -> int:
        return self._with_retry(name,
                                lambda pc: pc.push_grad(name, grad))

    def install(self, name: str, array, version: int = 0,
                refresh: bool = True) -> str:
        """Seed (or re-seed after a shard died with its data) a parameter
        at its current ketama owner; returns the owning shard.
        `refresh=False` skips the registry round trip — for seeding loops
        that already refreshed once (one list call, not one per tensor)."""
        arr = _as_host_array(array)
        stacked = np.stack([arr, np.zeros_like(arr)])
        if refresh:
            self.refresh()
        addr = self.map.owner(name)
        self._client(addr).install(name, stacked, version, commit=True)
        return addr

    # ---- cross-shard scatter/gather ----

    def pull_all(self, names: Optional[Iterable[str]] = None, device=None,
                 window: Optional[int] = None,
                 on_missing: str = "error") -> Dict[str, tuple]:
        """Pull many parameters fleet-wide -> {name: (version, tensor)}.

        Scatter: each owning shard's name group streams through that
        shard's own PipelineWindow on its own thread (aggregate bandwidth
        = sum of shard streams). Gather: one merged dict. Shard-level
        failures (mid-reshard misses, a killed shard) fall back to
        per-name routed retries; `on_missing`: "error" raises KeyError for
        names the fleet no longer holds, "skip" drops them from the
        result.
        """
        if on_missing not in ("error", "skip"):
            raise ValueError(f"on_missing must be error|skip: {on_missing!r}")
        # One span covers the whole scatter/gather; the per-shard client
        # legs (and through the wire, every shard's server span) parent
        # here, so the fleet observer assembles a pull_all into ONE
        # cross-process trace. No-op cost while rpcz is off/unsampled.
        with tracing.trace_span("FleetClient/pull_all"):
            return self._pull_all_traced(names, device, window, on_missing)

    def _pull_all_traced(self, names, device, window, on_missing):
        win = window if window is not None else self.window
        dev = device if device is not None else self._device
        if names is None:
            names = sorted(self.meta())
        names = list(names)
        tracing.annotate(f"tensors={len(names)}")
        results: Dict[str, tuple] = {}
        res_mu = threading.Lock()

        def pull_group(addr: str, group: List[str]) -> List[str]:
            # Each shard stream lands its tensors on the device itself:
            # one H2D per raw tensor, and quantized codes cross and widen
            # through the dequantize kernel, as a single client's do.
            try:
                got = self._client(addr).pull_all(group, device=dev,
                                                  window=win)
            except PartialPullError as e:
                # The shard delivered the groupmates before a per-name
                # miss (mid-reshard move): keep them, re-route ONLY the
                # stragglers — never pay a second full group RPC.
                with res_mu:
                    results.update(e.partial)
                return list(e.missing)
            except (native.RpcError, OSError, RuntimeError):
                return group  # salvage path re-routes the whole group
            with res_mu:
                results.update(got)
            return []

        failed = self._scatter(names, pull_group)
        # Salvage: re-group under refreshed membership once (a whole-shard
        # miss is usually one stale map), then per-name routed retries.
        if failed:
            self.refresh()
            failed = self._scatter(failed, pull_group)
        for name in failed:
            try:
                results[name] = self._with_retry(
                    name, lambda pc, n=name: pc.pull(n, device=dev))
            except KeyError:
                if on_missing == "error":
                    raise
        return results

    def push_all(self, grads: Dict[str, object],
                 window: Optional[int] = None) -> Dict[str, int]:
        """Push many gradients fleet-wide -> {name: new_version}; same
        scatter/gather + salvage shape as pull_all."""
        with tracing.trace_span("FleetClient/push_all"):
            tracing.annotate(f"tensors={len(grads)}")
            return self._push_all_traced(grads, window)

    def _push_all_traced(self, grads, window):
        win = window if window is not None else self.window
        versions: Dict[str, int] = {}
        res_mu = threading.Lock()

        def push_group(addr: str, group: List[str]) -> List[str]:
            try:
                got = self._client(addr).push_all(
                    {n: grads[n] for n in group}, window=win)
            except PartialPushError as e:
                # The shard APPLIED the groupmates before a per-name
                # failure: keep their versions and re-route ONLY the
                # unconfirmed names — a whole-group retry would apply
                # the confirmed gradients a second time (double
                # momentum step), which no amount of retrying undoes.
                with res_mu:
                    versions.update(e.applied)
                return list(e.unpushed)
            except (native.RpcError, OSError, RuntimeError):
                return group  # nothing confirmed: whole group re-routes
            with res_mu:
                versions.update(got)
            return []

        failed = self._scatter(list(grads), push_group)
        if failed:
            self.refresh()
            failed = self._scatter(failed, push_group)
        for name in failed:
            versions[name] = self._with_retry(
                name, lambda pc, n=name: pc.push_grad(n, grads[n]))
        return versions

    def _scatter(self, names: List[str], shard_op) -> List[str]:
        """Run `shard_op(addr, group)` per owning shard concurrently;
        returns the names the ops reported as failed."""
        groups = self.map.assignment(names)
        if not groups:
            return list(names)
        failed: List[str] = []
        if len(groups) == 1:
            (addr, group), = groups.items()
            return shard_op(addr, group)
        # Hand the caller's trace context into the shard threads: the
        # native context rides a PER-THREAD slot, so without this each
        # shard stream's RPCs would mint their own (independently
        # sampled) root traces instead of parenting under the pull_all/
        # push_all span — and the assembled fleet trace would shatter
        # into N unlinked pieces.
        ctx = tracing.current_trace()

        def run_with_ctx(addr: str, group: List[str]) -> List[str]:
            if ctx != (0, 0):
                tracing.set_trace(*ctx)
            try:
                return shard_op(addr, group)
            finally:
                if ctx != (0, 0):
                    tracing.clear_trace()  # pooled thread: don't leak ctx

        with ThreadPoolExecutor(max_workers=len(groups),
                                thread_name_prefix="fleet-io") as pool:
            futs = [pool.submit(run_with_ctx, addr, group)
                    for addr, group in groups.items()]
            wait(futs)
        for f in futs:
            failed.extend(f.result())
        return failed

    def close(self) -> None:
        with self._mu:
            clients, self._clients = self._clients, {}
            self._map = None
            self._prev_map = None
        for pc in clients.values():
            pc.close()
