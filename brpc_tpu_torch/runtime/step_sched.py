"""Dependency-tracked step scheduler — the pure core of the overlapped
training step.

The port's own copy of brpc_tpu/runtime/step_sched.py. A training step
decomposes into per-tensor nodes (forward, backward-k, push-k,
optimizer-k, pull-k) with explicit dependencies; this module executes
such a graph on two kinds of lane:

  * ``compute`` nodes run on the CALLER's thread, in deterministic
    priority order. That thread issues every forward and backward kernel,
    in insertion order, on its current CUDA stream, so each compute node
    reads finished inputs in stream order without extra events; a tensor
    a compute node hands to a wire lane is complete before the lane sees
    it (``runtime.handoff``);
  * ``wire`` nodes run on worker threads — RPC submissions, reply drains
    and pulls, whose wall time is exactly what the overlap is meant to
    hide behind the compute lane. There is ONE worker per NAMED wire
    lane: ``"wire"`` (the default single lane) plus any number of
    ``"wire:<name>"`` lanes, each its own thread. Multiple lanes exist
    for work that BLOCKS on a peer mid-node — a collective hop waiting
    for its ring predecessor parks its lane, and layer k+1's collective
    must keep flowing on another (the per-peer wire lanes).

``overlap=False`` runs every node on the caller's thread in insertion
order instead — the serial A/B baseline, same nodes, same results, all
wire time exposed.

Scheduling is DETERMINISTIC: dependencies must already exist when a node
is added (so the graph is a DAG by construction and insertion order is a
valid topological order), and among ready nodes of a lane the
lowest-insertion-index one runs first. Two runs of the same graph
execute the same per-lane sequences; only the cross-lane interleaving
varies with timing.

Failure semantics (the no-deadlock contract): a node that raises marks
itself failed, transitively CANCELS its dependents (they never run), and
every independent branch keeps running to completion — partial salvage,
the :class:`PartialPushError` discipline one level up. The run then
raises :class:`StepFailure` carrying ``failed``/``cancelled``/``done``,
with the wire thread always joined first.

Pure Python on purpose: no native library, no torch — the topology,
failure-propagation and serial==overlapped equivalence units run with
nothing else installed.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

COMPUTE = "compute"
WIRE = "wire"
_LANES = (COMPUTE, WIRE)  # the closed set PLUS "wire:<name>" extensions

_thread_lane = threading.local()


def current_lane() -> Optional[str]:
    """The wire lane the calling thread runs for ``run_graph`` (set
    before the thread enters ``wire_ctx``); None on any other thread."""
    return getattr(_thread_lane, "lane", None)


def _union_s(spans) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def _valid_lane(lane: str) -> bool:
    """``compute``, ``wire``, or a named wire lane ``wire:<suffix>`` —
    anything else is a typo, rejected exactly as before the lanes
    generalized (the one-lane topology contracts stay pinned)."""
    return lane in _LANES or (isinstance(lane, str)
                              and lane.startswith("wire:")
                              and len(lane) > len("wire:"))


class Node:
    """One schedulable unit: ``fn(done)`` receives the results-so-far
    mapping (read-only by convention) and its return value becomes
    ``results[name]``."""

    __slots__ = ("name", "fn", "deps", "lane", "index")

    def __init__(self, name: str, fn: Callable, deps: Tuple[str, ...],
                 lane: str, index: int):
        self.name = name
        self.fn = fn
        self.deps = deps
        self.lane = lane
        self.index = index


class StepGraph:
    """A DAG of named nodes. Dependencies must be added BEFORE their
    dependents — cycles are impossible by construction and insertion
    order doubles as the deterministic serial schedule."""

    def __init__(self):
        self._nodes: Dict[str, Node] = {}
        self._order: List[Node] = []

    def add(self, name: str, fn: Callable, deps=(), lane: str = COMPUTE
            ) -> str:
        if not _valid_lane(lane):
            raise ValueError(f"unknown lane {lane!r} "
                             f"(use {_LANES} or 'wire:<name>')")
        if name in self._nodes:
            raise ValueError(f"duplicate node name {name!r}")
        deps = tuple(deps)
        for d in deps:
            if d not in self._nodes:
                raise ValueError(
                    f"node {name!r} depends on unknown node {d!r} "
                    "(dependencies must be added first)")
        node = Node(name, fn, deps, lane, len(self._order))
        self._nodes[name] = node
        self._order.append(node)
        return name

    def __len__(self) -> int:
        return len(self._order)

    def __contains__(self, name: str) -> bool:
        return name in self._nodes

    def nodes(self) -> List[Node]:
        return list(self._order)

    def serial_order(self) -> List[str]:
        """The deterministic single-thread schedule (insertion order —
        a valid topological order by the add-deps-first construction)."""
        return [n.name for n in self._order]


class StepFailure(RuntimeError):
    """One or more nodes failed; every runnable branch still completed.

    ``failed``: {node: exception}; ``cancelled``: nodes never run because
    a transitive dependency failed; ``done``: {node: result} for the
    salvaged branches. ``cause`` is the first failure in schedule order.
    """

    def __init__(self, failed: Dict[str, BaseException],
                 cancelled: List[str], done: Dict[str, object]):
        names = ", ".join(f"{n}: {e}" for n, e in failed.items())
        super().__init__(f"{len(failed)} step node(s) failed ({names}); "
                         f"{len(cancelled)} cancelled, {len(done)} done")
        self.failed = failed
        self.cancelled = cancelled
        self.done = done
        self.cause = next(iter(failed.values()))


class RunTrace:
    """Per-node execution record + the lane-time accounting the
    step-breakdown metrics read.

    ``events``: ``[(name, lane, start_s, end_s), ...]`` in completion
    order (monotonic clock). ``wire_busy_s`` is the time at least one
    wire lane was running a node: the union of every wire lane's node
    intervals, so two lanes busy at once count once (with one lane it is
    the sum of its node times; the JAX package sums over lanes).
    ``lane_busy_s`` holds each named lane's own sum. ``exposed_wait_s``
    is the time the CALLER's thread spent blocked with no compute node
    ready (including the end-of-step join) — the step's EXPOSED
    communication. Overlapped communication
    is ``wire_busy_s - exposed_wait_s`` clamped at zero: wire time that
    ran in compute's shadow.

    ``exposed_wait_s`` further splits into ``exposed_stall_s`` (mid-step:
    the compute lane parked in ``cond.wait`` with nothing ready) plus
    ``exposed_join_s`` (the end-of-step barrier: wire work still draining
    after the last compute node). The split matters because they have
    different cures — a stall means a dependency chain is too eager, a
    join tail means the LAST wire ops have nothing left to hide behind;
    track-and-trigger fusion attacks exactly the join tail,
    and only this split makes its delta attributable. ``lane_join_s``
    attributes the join tail per wire lane: how far past the barrier each
    lane's last node ended.
    """

    def __init__(self, overlap: bool):
        self.overlap = overlap
        self.events: List[Tuple[str, str, float, float]] = []
        self.wire_busy_s = 0.0
        self.lane_busy_s: Dict[str, float] = {}
        self.exposed_wait_s = 0.0
        self.exposed_stall_s = 0.0
        self.exposed_join_s = 0.0
        self.lane_join_s: Dict[str, float] = {}
        self.compute_busy_s = 0.0
        self.wall_s = 0.0

    def span(self, name: str) -> Optional[Tuple[float, float]]:
        for n, _lane, s, e in self.events:
            if n == name:
                return (s, e)
        return None

    def overlapped(self, a: str, b: str) -> bool:
        """True when node ``a``'s execution interval intersects ``b``'s
        — the schedule-level proof two nodes really ran concurrently."""
        sa, sb = self.span(a), self.span(b)
        if sa is None or sb is None:
            return False
        return sa[0] < sb[1] and sb[0] < sa[1]

    def overlapped_comm_s(self) -> float:
        return max(0.0, self.wire_busy_s - self.exposed_wait_s)

    def order(self) -> List[str]:
        return [e[0] for e in sorted(self.events, key=lambda e: e[2])]


def run_graph(graph: StepGraph, overlap: bool = True,
              wire_ctx: Optional[Callable] = None
              ) -> Tuple[Dict[str, object], RunTrace]:
    """Execute ``graph``; returns ``(results, trace)`` or raises
    :class:`StepFailure` (wire thread always joined first).

    ``wire_ctx()`` (optional) must return a context manager; it is
    entered around EACH wire lane's thread (one fresh instance per
    lane) — the driver hands the rpcz trace context and the QoS stamp
    across the thread boundary through it (the FleetClient
    worker-thread discipline). In serial mode it wraps the whole run,
    so the A/B stamps identical wire metadata.
    """
    trace = RunTrace(overlap)
    t_start = time.monotonic()
    ctx = wire_ctx if wire_ctx is not None else contextlib.nullcontext
    if not overlap:
        try:
            with ctx():
                results = _run_serial(graph, trace)
        finally:
            trace.wall_s = time.monotonic() - t_start
        return results, trace

    lock = threading.Lock()
    cond = threading.Condition(lock)
    done: Dict[str, object] = {}
    failed: Dict[str, BaseException] = {}
    cancelled: set = set()
    # One worker thread per DISTINCT wire lane present in the graph
    # (first-appearance order — deterministic). A graph that only ever
    # says lane=WIRE gets exactly one worker.
    wire_lanes: List[str] = []
    for n in graph.nodes():
        if n.lane != COMPUTE and n.lane not in wire_lanes:
            wire_lanes.append(n.lane)
    ready: Dict[str, List[Node]] = {ln: [] for ln in [COMPUTE] + wire_lanes}
    pending = {n.name: len(n.deps) for n in graph.nodes()}
    children: Dict[str, List[Node]] = {n.name: [] for n in graph.nodes()}
    lane_total = {ln: 0 for ln in ready}
    lane_done = {ln: 0 for ln in ready}
    aborted = [False]
    for n in graph.nodes():
        lane_total[n.lane] += 1
        for d in n.deps:
            children[d].append(n)
        if not n.deps:
            ready[n.lane].append(n)

    def _cancel_dependents_locked(name: str) -> None:
        stack = list(children[name])
        while stack:
            c = stack.pop()
            if c.name in done or c.name in failed or c.name in cancelled:
                continue
            cancelled.add(c.name)
            lane_done[c.lane] += 1
            stack.extend(children[c.name])

    def _finish_locked(node: Node, result, exc) -> None:
        lane_done[node.lane] += 1
        if exc is not None:
            failed[node.name] = exc
            _cancel_dependents_locked(node.name)
        else:
            done[node.name] = result
            for c in children[node.name]:
                if c.name in cancelled:
                    continue
                pending[c.name] -= 1
                if pending[c.name] == 0:
                    ready[c.lane].append(c)
        cond.notify_all()

    def _pop_ready_locked(lane: str) -> Optional[Node]:
        q = ready[lane]
        if not q:
            return None
        best = min(range(len(q)), key=lambda i: q[i].index)
        return q.pop(best)

    def _run_lane(lane: str, count_wait: bool) -> None:
        while True:
            with lock:
                # An abort (BaseException on the caller) stops the lane
                # BEFORE the next node, not merely when the ready queue
                # happens to drain — each wire completion readies the
                # next push/confirm/pull in its chain, so checking only
                # on empty would run the whole remaining wire schedule
                # (blocking reply waits included) under a Ctrl-C.
                node = None if aborted[0] else _pop_ready_locked(lane)
                while node is None:
                    if lane_done[lane] >= lane_total[lane] or aborted[0]:
                        return
                    t0 = time.monotonic()
                    cond.wait()
                    if count_wait:
                        dt = time.monotonic() - t0
                        trace.exposed_wait_s += dt
                        trace.exposed_stall_s += dt
                    node = (None if aborted[0]
                            else _pop_ready_locked(lane))
            t0 = time.monotonic()
            exc = result = None
            try:
                result = node.fn(done)
            except Exception as e:  # noqa: BLE001 — failure IS the contract
                exc = e
            t1 = time.monotonic()
            with lock:
                trace.events.append((node.name, lane, t0, t1))
                if lane != COMPUTE:
                    trace.lane_busy_s[lane] = (
                        trace.lane_busy_s.get(lane, 0.0) + (t1 - t0))
                else:
                    trace.compute_busy_s += t1 - t0
                _finish_locked(node, result, exc)

    def _wire_main(lane: str) -> None:
        _thread_lane.lane = lane
        try:
            with ctx():
                _run_lane(lane, count_wait=False)
        except BaseException as e:  # noqa: BLE001 — a dead wire lane
            # must surface, never read as success: wire_ctx enter/exit
            # raising (or a BaseException escaping a wire node) would
            # otherwise leave every remaining node of THIS lane unrun
            # with `failed` empty — run_graph would RETURN normally
            # while zero pushes/pulls happened (and a graph with a
            # compute node downstream of a wire node would hang in
            # cond.wait). Other lanes keep draining their independent
            # branches — partial salvage applies across lanes too.
            with lock:
                failed[f"<{lane}-lane>"] = e
                for n in graph.nodes():
                    if (n.lane == lane and n.name not in done
                            and n.name not in failed
                            and n.name not in cancelled):
                        cancelled.add(n.name)
                        lane_done[lane] += 1
                        _cancel_dependents_locked(n.name)
                cond.notify_all()

    wire_threads = [threading.Thread(target=_wire_main, args=(ln,),
                                     name=f"step-{ln}", daemon=True)
                    for ln in wire_lanes]
    for t in wire_threads:
        t.start()
    try:
        _run_lane(COMPUTE, count_wait=True)
    except BaseException:
        # KeyboardInterrupt & friends: stop handing out new nodes and
        # get the wire threads back before unwinding — a daemon thread
        # left touching a half-torn-down driver is a wedge.
        with lock:
            aborted[0] = True
            cond.notify_all()
        for t in wire_threads:
            t.join()
        raise
    # The end-of-step barrier: whatever wire work is still running/queued
    # is EXPOSED communication by definition — nothing computes under it.
    t_join = time.monotonic()
    for t in wire_threads:
        t.join()
    trace.exposed_join_s = time.monotonic() - t_join
    trace.exposed_wait_s += trace.exposed_join_s
    for ln in wire_lanes:
        ends = [e for (_n, lane, _s, e) in trace.events if lane == ln]
        trace.lane_join_s[ln] = max(0.0, (max(ends) if ends else t_join)
                                    - t_join)
    trace.wire_busy_s = _union_s([(s, e) for (_n, lane, s, e)
                                  in trace.events if lane != COMPUTE])
    trace.wall_s = time.monotonic() - t_start
    if failed:
        raise StepFailure(failed, sorted(cancelled),
                          dict(done))
    return done, trace


def _run_serial(graph: StepGraph, trace: RunTrace) -> Dict[str, object]:
    done: Dict[str, object] = {}
    failed: Dict[str, BaseException] = {}
    cancelled: List[str] = []
    dead: set = set()
    for node in graph.nodes():
        if any(d in failed or d in dead for d in node.deps):
            dead.add(node.name)
            cancelled.append(node.name)
            continue
        t0 = time.monotonic()
        try:
            result = node.fn(done)
        except Exception as e:  # noqa: BLE001 — failure IS the contract
            failed[node.name] = e
            dead.add(node.name)
            t1 = time.monotonic()
        else:
            done[node.name] = result
            t1 = time.monotonic()
        trace.events.append((node.name, node.lane, t0, t1))
        if node.lane != COMPUTE:
            trace.wire_busy_s += t1 - t0
            trace.lane_busy_s[node.lane] = (
                trace.lane_busy_s.get(node.lane, 0.0) + (t1 - t0))
        else:
            trace.compute_busy_s += t1 - t0
    # Serial mode hides nothing: every wire second is exposed step time,
    # all of it inline stall (there is no join barrier to attribute).
    trace.exposed_wait_s = trace.wire_busy_s
    trace.exposed_stall_s = trace.wire_busy_s
    trace.exposed_join_s = 0.0
    if failed:
        raise StepFailure(failed, cancelled, done)
    return done
