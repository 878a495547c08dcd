"""Live resharding: the planner + background migrator.

A registry watch event (shard joined / left) triggers a reshard. The
planner treats it the way PAPERS.md "Memory-efficient array
redistribution" treats a sharding change — an explicitly planned,
bandwidth-bounded transfer schedule, never an ad-hoc copy loop:

  1. OBSERVE actual placement: every reachable shard's Meta (which tensor
     physically lives where, at what version, in which migration state) —
     not the nominal old ring, so aborted/partial migrations replan from
     truth.
  2. PLAN the minimal movement set: exactly the names whose observed
     holder differs from their owner under the NEW ketama map (ketama's
     zero-collateral remap makes this ~1/(N+1) of keys on a join). Moves
     group into (src, dst) links; links execute concurrently up to
     `max_links`, each link a bounded `PipelineWindow` stream — window x
     tensor bytes caps in-flight bytes per link, max_links caps fleet-wide
     migration bandwidth so foreground traffic keeps its share.
  3. EXECUTE per tensor, versions preserved, with the two-phase commit
     the ParameterServer enforces:
         Handoff(src)  freeze: src stops taking pushes, keeps serving reads
         Install(dst)  pending: dst serves reads at the SAME version,
                       refuses pushes
         Retire(src)   src answers "moved:<dst>" from now on
         Commit(dst)   dst opens for pushes — reads and writes can never
                       disagree across the two owners at any interleaving
  4. REPAIR + CONVERGE: leftover frozen/pending states whose tensor now
     sits where it belongs are committed in place; the plan loop re-runs
     until a pass finds nothing to move (or no progress — e.g. a source
     died mid-stream and its keys are simply gone; pull_all reports those
     as missing and FleetClient.install reseeds them).

Progress is observable the whole way: torch_fleet_resharding,
torch_fleet_migration_moving, torch_fleet_migration_moved_total and
torch_fleet_migration_bytes_total on /vars and /brpc_metrics.

The migrator moves host bytes only (a Handoff reply is staged to the
host, an Install request is sent from it), so it needs no device: its
shard clients are CPU clients. The servers put what they install on
their own devices.
"""

from __future__ import annotations

import json
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from brpc_tpu_torch.fleet import gauges, registry
from brpc_tpu_torch.fleet.shard_map import ShardMap
from brpc_tpu_torch.observability import tracing
from brpc_tpu_torch.runtime import native
from brpc_tpu_torch.runtime.param_server import ParameterClient
from brpc_tpu_torch.runtime.tensor import (PipelineWindow, TensorArena,
                                           _decode_meta_ex)


@dataclass
class Move:
    name: str
    src: str
    dst: str
    nbytes: int = 0


@dataclass
class ReshardPlan:
    """One pass's transfer schedule: moves grouped by (src, dst) link,
    in-place repairs (frozen/pending tensors already at their owner), and
    stale-duplicate retires (a crash between Install and Retire leaves
    the superseded copy on its old shard — holding memory, serving stale
    prev-map reads, and blocking any later move back with E_EXISTS)."""
    target: ShardMap
    links: Dict[Tuple[str, str], List[Move]] = field(default_factory=dict)
    repairs: List[Tuple[str, str]] = field(default_factory=list)  # (addr, name)
    stale: List[Tuple[str, str, str]] = field(
        default_factory=list)  # (addr, name, best_holder)

    @property
    def moves(self) -> List[Move]:
        return [m for link in self.links.values() for m in link]

    @property
    def total_bytes(self) -> int:
        return sum(m.nbytes for m in self.moves)


def _stage_layers(n_layers: int, stages: int) -> List[Tuple[int, int]]:
    """Balanced contiguous layer partition -> ``[(lo, hi), ...]`` per
    stage, the remainder front-loaded (the pipeline scheduler's rule)."""
    if not 1 <= stages <= n_layers:
        raise ValueError(f"need 1 <= stages <= layers, "
                         f"got {stages} stages / {n_layers} layers")
    base, extra = divmod(n_layers, stages)
    out, lo = [], 0
    for s in range(stages):
        hi = lo + base + (1 if s < extra else 0)
        out.append((lo, hi))
        lo = hi
    return out


def regime_assignment(names: List[str],
                      stage_owners: List[str]) -> Dict[str, str]:
    """The stage-aligned override map for a parallelism-regime switch:
    pipeline stage ``s`` owns the contiguous slice of ``names`` the
    balanced partition assigns it, so every name the stage's trainer
    pulls lives on that stage's parameter server — the map
    ``Migrator.switch_regime`` converges placement onto."""
    spans = _stage_layers(len(names), len(stage_owners))
    out: Dict[str, str] = {}
    for s, (lo, hi) in enumerate(spans):
        for n in names[lo:hi]:
            out[n] = stage_owners[s]
    return out


def plan_reshard(placement: Dict[str, dict], target: ShardMap) -> ReshardPlan:
    """Minimal movement set from OBSERVED placement.

    `placement`: {addr: meta_dict} per reachable shard (a ParameterServer
    Meta `params` map — shape/dtype/version[/state] per name). A name
    observed on several shards mid-handoff plans from its highest-version
    holder (ties prefer the target owner); the superseded copies become
    `stale` retires so an interrupted handoff cannot strand them."""
    plan = ReshardPlan(target=target)
    best: Dict[str, Tuple[str, dict]] = {}
    for addr, meta in placement.items():
        for name, entry in meta.items():
            cur = best.get(name)
            if cur is None:
                best[name] = (addr, entry)
                continue
            v, cv = entry.get("version", 0), cur[1].get("version", 0)
            try:
                owner = target.owner(name)
            except LookupError:
                owner = None
            if v > cv or (v == cv and addr == owner and cur[0] != owner):
                best[name] = (addr, entry)
    for addr, meta in placement.items():
        for name in meta:
            holder = best[name][0]
            if addr != holder:
                plan.stale.append((addr, name, holder))
    for name, (addr, entry) in sorted(best.items()):
        try:
            owner = target.owner(name)
        except LookupError:
            continue  # no shards at all; nothing to plan
        if owner == addr:
            if entry.get("state") in ("frozen", "pending"):
                plan.repairs.append((addr, name))
            continue
        nbytes = int(np.prod(entry.get("shape", [])) *
                     np.dtype(entry.get("dtype", "f4")).itemsize)
        plan.links.setdefault((addr, owner), []).append(
            Move(name, addr, owner, nbytes))
    return plan


class Migrator:
    """Watches the fleet's registry tag and keeps placement converged to
    the ketama map of the live membership. One reshard runs at a time
    (watch events serialize through the watcher thread); membership
    changes landing mid-stream are observed by the next pass.
    ``arena_bytes`` sizes each shard client's arena: an Install stages
    the whole stacked [param, momentum] pair of the largest tensor."""

    def __init__(self, registry_hostport: str, tag: str = "param",
                 window: int = 4, max_links: int = 2,
                 arena_bytes: int = 128 << 20, max_rounds: int = 5,
                 overrides: Optional[Dict[str, str]] = None,
                 on_reshard=None):
        self._registry = registry_hostport
        self._tag = tag
        self.window = window
        self.max_links = max_links
        self._arena_bytes = arena_bytes
        self._max_rounds = max_rounds
        self._overrides = dict(overrides or {})
        self._on_reshard = on_reshard  # (epoch, moved_count) after a pass
        self._mu = threading.Lock()          # guards the clients dict
        self._reshard_mu = threading.Lock()  # serializes reshard passes
        self._progress_mu = threading.Lock()  # _moving decrements (N links)
        self._clients: Dict[str, ParameterClient] = {}
        self._watcher: Optional[registry.RegistryWatcher] = None
        self._known: List[str] = []  # last shard list we converged onto
        # Progress vars (torch_fleet_resharding / _migration_moving).
        self._moving = 0
        self._resharding = 0
        self.reshards = 0  # completed passes (tests)
        self.stuck_moves = 0  # moves the last pass could NOT complete
        # Weakly bound: the repointable-gauge holder table is immortal,
        # and a strongly-captured self would pin a stopped Migrator (and
        # its per-shard clients/arenas) for the process lifetime.
        ref = weakref.ref(self)
        gauges.publish("resharding",
                       lambda: getattr(ref(), "_resharding", 0))
        gauges.publish("migration_moving",
                       lambda: getattr(ref(), "_moving", 0))
        self._moved_total = gauges.counter("migration_moved_total")
        self._bytes_total = gauges.counter("migration_bytes_total")

    # ---- lifecycle ----

    def start(self) -> "Migrator":
        self._watcher = registry.RegistryWatcher(
            self._registry, self._tag, self._on_change).start()
        return self

    def stop(self) -> None:
        if self._watcher is not None:
            self._watcher.stop()
            self._watcher = None
        with self._mu:
            clients, self._clients = self._clients, {}
        for pc in clients.values():
            pc.close()

    def _on_change(self, index: int, addrs: List[str]) -> None:
        self.reshard(index, addrs)

    def _client(self, addr: str) -> ParameterClient:
        with self._mu:
            pc = self._clients.get(addr)
            if pc is None:
                pc = ParameterClient(f"tpu://{addr}",
                                     TensorArena(self._arena_bytes),
                                     device="cpu")
                self._clients[addr] = pc
            return pc

    # ---- one reshard (possibly multiple convergence rounds) ----

    def reshard(self, index: Optional[int] = None,
                addrs: Optional[List[str]] = None) -> int:
        """Converge placement onto the ketama map of `addrs` (fetched from
        the registry when omitted). Returns tensors moved. Reentrant-safe:
        passes serialize on an internal lock."""
        if index is None or addrs is None:
            index, addrs = registry.list_servers(self._registry, self._tag)
        if not addrs:
            return 0  # an empty fleet has nowhere to put anything
        target = ShardMap(addrs, epoch=index, overrides=self._overrides)
        with self._reshard_mu:
            # One root span per reshard: every Handoff/Install/Retire/
            # Commit leg (and each touched shard's server spans) parents
            # here, so a reshard reads as ONE cross-process trace in the
            # fleet observer instead of a scatter of unlinked moves.
            with tracing.trace_span("Migrator/reshard") as sp:
                tracing.annotate(
                    f"epoch={index} shards={len(addrs)}")
                moved = self._reshard_locked(index, addrs, target)
                tracing.annotate(f"moved={moved} stuck={self.stuck_moves}")
                if self.stuck_moves:
                    sp.set_error(1)
                return moved

    def _reshard_locked(self, index: int, addrs: List[str],
                        target: ShardMap) -> int:
        moved = 0
        self._resharding = 1
        try:
            with self._mu:
                known = set(self._clients)
            probe = sorted(set(addrs) | known)
            remaining = 0
            for _round in range(self._max_rounds):
                plan = self._observe_and_plan(probe, target)
                # Stale duplicates retire FIRST (protocol order: the old
                # copy forwards before the surviving one opens), then
                # in-place repairs commit.
                for addr, name, holder in plan.stale:
                    try:
                        self._client(addr).retire(name, dest=holder)
                    except native.RpcError:
                        pass  # replanned next round if still stuck
                for addr, name in plan.repairs:
                    try:
                        self._client(addr).commit(name)
                    except native.RpcError:
                        pass  # replanned next round if still stuck
                remaining = len(plan.moves)
                if not plan.moves:
                    break
                self._moving = remaining
                done = self._execute(plan)
                moved += done
                remaining -= done
                if done == 0:
                    break  # no progress (failing link?) — don't spin
            # An exhausted/stalled pass must not read as converged: the
            # moving gauge stays at the stuck count (nonzero on /tensorz
            # = operator signal) until a later pass drains it.
            self.stuck_moves = remaining
            self._known = sorted(addrs)
            self.reshards += 1
            if self._on_reshard is not None:
                try:
                    self._on_reshard(index, moved)
                except Exception:  # noqa: BLE001 — observer must not kill
                    pass           # the watch loop
        finally:
            self._resharding = 0
            self._moving = self.stuck_moves
        return moved

    def switch_regime(self, assignment: Dict[str, str],
                      index: Optional[int] = None,
                      addrs: Optional[List[str]] = None) -> int:
        """Live parallelism-regime switch: repoint ownership
        to a name->addr map (``regime_assignment`` builds the
        stage-aligned one) and converge placement onto it. Returns
        tensors moved.

        Deliberately NOT a new redistribution protocol: the map becomes
        this Migrator's standing overrides (later watch-triggered
        reshards keep honoring it — a member bounce mid-regime must not
        silently revert to ketama placement), and the move itself is an
        ordinary ``reshard`` pass — minimal owner-diff plan, per-link
        ``PipelineWindow`` streams, the two-phase
        Handoff/Install/Retire/Commit the ParameterServer enforces. A
        Handoff ships the stacked ``[param, momentum]`` pair at its
        version, so optimizer state rides the switch for free and the
        post-switch trajectory stays on the pre-switch one. Training
        steps lost =
        however many steps the caller pauses around this call — the
        freeze is per tensor inside the stream, so pushes racing the
        switch fail fast with "frozen"/"moved:<dst>" rather than
        landing on a stale owner."""
        self._overrides = dict(assignment)
        return self.reshard(index, addrs)

    def _observe_and_plan(self, probe: List[str],
                          target: ShardMap) -> ReshardPlan:
        placement: Dict[str, dict] = {}
        for addr in probe:
            try:
                placement[addr] = self._client(addr).meta()
            except (native.RpcError, RuntimeError):
                continue  # unreachable (left / crashed): nothing to stream
        return plan_reshard(placement, target)

    def _execute(self, plan: ReshardPlan) -> int:
        """Run the schedule: up to `max_links` (src, dst) streams at once,
        each a bounded-window pipelined handoff stream."""
        links = sorted(plan.links.items())
        moved = 0
        if not links:
            return 0
        if len(links) == 1 or self.max_links <= 1:
            for link, moves in links:
                moved += self._migrate_link(link[0], link[1], moves)
            return moved
        # Link threads carry the reshard span's context (the native trace
        # context is per-thread — see FleetClient._scatter): every move's
        # RPC legs stay inside the one reshard trace.
        ctx = tracing.current_trace()

        def run_link(src, dst, moves):
            if ctx != (0, 0):
                tracing.set_trace(*ctx)
            try:
                return self._migrate_link(src, dst, moves)
            finally:
                if ctx != (0, 0):
                    tracing.clear_trace()

        with ThreadPoolExecutor(max_workers=min(self.max_links, len(links)),
                                thread_name_prefix="fleet-migrate") as pool:
            futs = [pool.submit(run_link, src, dst, moves)
                    for (src, dst), moves in links]
            wait(futs)
        for f in futs:
            moved += f.result()
        return moved

    def _migrate_link(self, src: str, dst: str, moves: List[Move]) -> int:
        """Stream one link's tensors src -> dst. Handoffs of tensor k+1
        ride the wire while tensor k installs at dst (the PipelineWindow
        overlap); the per-tensor Handoff/Install/Retire/Commit order is
        what keeps clients consistent at every interleaving. A failure
        aborts the remaining stream — the convergence loop replans from
        observed state."""
        spc = self._client(src)
        dpc = self._client(dst)
        done = 0

        def on_reply(name: str, payload: bytes, view) -> None:
            nonlocal done
            with view:
                meta, rest = _decode_meta_ex(payload)
                stacked = np.array(view.ndarray().view(
                    np.dtype(meta["dtype"])).reshape(tuple(meta["shape"])))
            version = json.loads(rest.decode())["version"]
            dpc.install(name, stacked, version)
            spc.retire(name, dest=dst)
            dpc.commit(name)
            done += 1
            with self._progress_mu:  # concurrent links both decrement
                self._moving = max(0, self._moving - 1)
            self._moved_total.add(1)
            self._bytes_total.add(stacked.nbytes // 2)  # param bytes, not 2x

        try:
            with PipelineWindow(spc.channel, self.window,
                                on_reply=on_reply) as win:
                for mv in moves:
                    win.submit("ParamService/Handoff",
                               request=json.dumps(
                                   {"name": mv.name, "dest": dst}).encode(),
                               tag=mv.name)
        except (native.RpcError, RuntimeError, OSError):
            pass  # partial link: next convergence round replans the rest
        return done
