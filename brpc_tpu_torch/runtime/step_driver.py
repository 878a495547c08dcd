"""Overlapped training step drivers — hide the tensor wire behind compute.

The port of brpc_tpu/runtime/step_driver.py. A training step decomposes
into per-tensor nodes

    forward -> bwd:k (compute lane, top layer first)
    bwd:k   -> push:k (wire lane)
    push:k  -> opt:k -> pull:k (the ``wire:pull`` lane)

scheduled by :mod:`step_sched`, so the gradient push of layer k (int8
encode included — ``client.submit_push`` quantizes at arena-stage time
on the wire lane) overlaps backward compute of the next layer, and the
confirm and next-step pull of layer k overlap the backward and the
pushes of the layers below it (the JAX package runs the three on one
wire lane; there the pulls wait for the last push). Pushes go through
one bounded :class:`PipelineWindow` per step, which both wire lanes
drain; pulls through ``client.pull`` (one-sided when mapped, quantized
when negotiated, QoS-stamped, paced). ``overlap=False`` runs the SAME
nodes serially on one thread — the A/B baseline.

On CUDA the compute lane runs on the caller's current stream and each
wire lane on a stream of its own, the same one every step
(``handoff.LaneStreams``); gradients, pulled weights and masters
cross between them through ``runtime.handoff`` (the compute lane waits
for its stream after each backward, as the JAX package blocks on each
gradient; ``record_stream`` on every tensor that changes streams). A
wire lane's D2H therefore never queues behind backward kernels enqueued
after the gradient it copies.

Over a mesh (``LayeredMLP(mesh=...)``, one process per rank) only the
wire rank (the harness's ``is_wire``) holds a client; every other rank
runs the same driver with ``client=None``: the same ``place`` and
``backward`` calls in the same order on its compute lane, no wire lane.
Every collective of the harness therefore runs on the caller's thread, in
program order on every rank, and the server takes one push per name per
step.

Failure semantics: a mid-step push failure cancels only its dependents,
every other branch completes, and the step raises
:class:`~brpc_tpu_torch.runtime.param_server.PartialPushError` with the
versions that DID land (``applied``) vs the names with no confirmed
apply (``unpushed``) — re-pushing an applied gradient double-steps the
server's momentum, so salvage must be per-name.

Instrumented: one ``train_step`` rpcz root span per step with a child
span per node (each also a profiler range while a torch profiler runs),
plus ``torch_step_exposed_comm`` / ``torch_step_overlapped_comm``
latency recorders on /vars (samples in microseconds).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from brpc_tpu_torch.observability import tracing
from brpc_tpu_torch.ops.fused_update import fused_momentum_update
from brpc_tpu_torch.runtime import handoff, native
from brpc_tpu_torch.runtime.param_server import PartialPushError
from brpc_tpu_torch.runtime.state import to_tensor
from brpc_tpu_torch.runtime.step_sched import (COMPUTE, WIRE, StepFailure,
                                               StepGraph, run_graph)
from brpc_tpu_torch.runtime.tensor import PipelineWindow, d2h

_metrics_cache = None

# The wire lane of each step's confirms and pulls.
_PULL_LANE = "wire:pull"

_STAT_KEYS = ("wall_ms", "compute_ms", "wire_busy_ms", "exposed_comm_ms",
              "overlapped_comm_ms")


def _trace_handoff_ctx(tid: int, sid: int, stream=None):
    """The wire-lane context factory both drivers hand to ``run_graph``:
    each lane's thread inherits the step's rpcz trace context, and its
    lane's CUDA stream when ``stream`` (``LaneStreams.ctx``) is given.
    QoS is not the lane's: the client and the collective stamp their own
    calls. Restore, don't clear, on exit: in serial mode this wraps the
    CALLER's own thread, whose ambient context must survive the step."""

    @contextlib.contextmanager
    def wire_ctx():
        had_t, had_s = tracing.current_trace()
        if tid:
            tracing.set_trace(tid, sid)
        try:
            with (stream() if stream is not None
                  else contextlib.nullcontext()):
                yield
        finally:
            if tid:
                if had_t or had_s:
                    tracing.set_trace(had_t, had_s)
                else:
                    tracing.clear_trace()

    return wire_ctx


def _metrics():
    global _metrics_cache
    if _metrics_cache is None:
        from brpc_tpu_torch.observability import metrics as obs

        _metrics_cache = {
            # Full step wall time (us, the standard recorder unit).
            "step": obs.latency("torch_step_driver_step"),
            # The compute lane's wait on the wire, and the wire time
            # hidden under compute, per step (us).
            "exposed": obs.latency("torch_step_exposed_comm"),
            "overlapped": obs.latency("torch_step_overlapped_comm"),
            "steps": obs.counter("torch_step_driver_steps"),
            "partial": obs.counter("torch_step_driver_partial_failures"),
        }
    return _metrics_cache


def _traced(span_name, fn):
    def run(done):
        with tracing.trace_span(span_name):
            return fn(done)
    return run


class _Recorder:
    """The per-step accounting both drivers share: ``last_stats``,
    ``last_trace``, running ``totals`` and the ``torch_step_*`` series."""

    def _init_stats(self) -> None:
        self._m = _metrics()
        self.last_stats: Optional[dict] = None
        self.last_trace = None  # RunTrace of the last SUCCESSFUL step
        self.totals = dict({"steps": 0}, **{k: 0.0 for k in _STAT_KEYS})

    def _record(self, loss: float, trace, t0: float) -> None:
        stats = {
            "loss": loss, "overlap": self.overlap,
            "wall_ms": trace.wall_s * 1e3,
            "compute_ms": trace.compute_busy_s * 1e3,
            "wire_busy_ms": trace.wire_busy_s * 1e3,
            "exposed_comm_ms": trace.exposed_wait_s * 1e3,
            "overlapped_comm_ms": trace.overlapped_comm_s() * 1e3,
        }
        self.last_stats = stats
        self.last_trace = trace
        self.totals["steps"] += 1
        for k in _STAT_KEYS:
            self.totals[k] += stats[k]
        self._m["steps"].add(1)
        self._m["step"].record_s(time.monotonic() - t0)
        self._m["exposed"].record_s(trace.exposed_wait_s)
        self._m["overlapped"].record_s(trace.overlapped_comm_s())


def _annotate(trace) -> None:
    if not tracing.rpcz_enabled():
        return
    tracing.annotate(f"exposed_comm={int(trace.exposed_wait_s * 1e6)}us")
    tracing.annotate(
        f"overlapped_comm={int(trace.overlapped_comm_s() * 1e6)}us")
    tracing.annotate(f"compute={int(trace.compute_busy_s * 1e6)}us")


class OverlappedStepDriver(_Recorder):
    """Drive an RPC training loop over a layered harness.

    ``client``: a :class:`ParameterClient` (pushes ride one
    ``PipelineWindow`` per step over its channel) or any fleet-shaped
    object with ``pull``/``push_grad``/``pull_all`` (pushes confirm
    synchronously per name); None on a mesh harness's ranks other than
    the wire rank, which run forward and backward only. A failed step on
    the wire rank is not salvaged across ranks: the others wait at the
    next collective, so the run ends.

    ``harness`` protocol (see ``models.tensor_service.LayeredMLP``):
      * ``names``: parameter names in FORWARD order;
      * ``device``: where its tensors live;
      * ``place(name, tensor)``: apply the harness's placement (called
        for every name in forward order each step);
      * ``forward(params, x, y) -> ctx``;
      * ``backward(ctx, name) -> grad`` (called top layer first; None
        off the wire rank);
      * ``loss(ctx) -> float``;
      * ``is_wire`` (optional, default True): whether this rank drives
        the wire.
    """

    def __init__(self, client, harness, overlap: bool = True,
                 window: int = 4):
        if (client is None) == getattr(harness, "is_wire", True):
            raise ValueError(
                "the wire rank's driver takes a client and every other "
                "mesh rank's takes client=None (harness.is_wire is "
                f"{getattr(harness, 'is_wire', True)}, client {client!r})")
        self.client = client
        self.harness = harness
        self.overlap = overlap
        self.window = max(1, window)
        self.device = getattr(harness, "device", None)
        self._params: Dict[str, torch.Tensor] = {}  # placed tensors
        self._raw: Dict[str, torch.Tensor] = {}     # pulled, not placed
        self.versions: Dict[str, int] = {}           # last confirmed
        self._lanes = handoff.LaneStreams(self.device)
        self._init_stats()

    # ---- setup ----

    def prime(self) -> None:
        """Fetch the full parameter set once (the step-0 pull the overlap
        then amortizes into every later step's shadow); nothing off the
        wire rank."""
        if self.client is None:
            return
        got = self.client.pull_all(list(self.harness.names),
                                   window=self.window)
        for name, (version, arr) in got.items():
            self._raw[name] = arr
            self.versions[name] = version

    # ---- one step ----

    def step(self, x, y) -> float:
        """One training step; returns the loss. Overlapped mode pulls each
        parameter's NEXT version inside this step's shadow, so the next
        call starts compute immediately."""
        t0 = time.monotonic()
        pacer = getattr(self.client, "pacer", None)
        if pacer is not None:
            pacer.pace()  # honor any shed-storm retry-after debt
        names: List[str] = list(self.harness.names)
        rev = list(reversed(names))
        grads: Dict[str, torch.Tensor] = {}
        step_versions: Dict[str, int] = {}
        push_failed: Dict[str, BaseException] = {}
        ctx_box: Dict[str, object] = {}
        channel = getattr(self.client, "channel", None)

        # A reply recorded on one wire lane wakes a confirm waiting on the
        # other (it cannot drain a reply another lane is waiting on).
        landed = threading.Condition()

        def on_push_reply(tag, payload, view):
            view.release()  # push responses carry no tensor
            step_versions[tag] = int(payload.decode())

        win = (PipelineWindow(channel, self.window, on_reply=on_push_reply)
               if channel is not None else None)

        def fn_forward(done):
            # Forward order on every rank: a mesh harness's place is a
            # collective. A name with no pull since its last placement
            # keeps that placement.
            for name in names:
                if self.client is None:
                    self._params[name] = self.harness.place(name, None)
                elif name in self._raw:
                    self._params[name] = self.harness.place(
                        name, handoff.adopt(self._raw.pop(name)))
            ctx_box["ctx"] = self.harness.forward(self._params, x, y)
            return None

        def make_bwd(name):
            def fn(done):
                g = self.harness.backward(ctx_box["ctx"], name)
                grads[name] = None if g is None else handoff.publish(g)
                return None
            return fn

        def drain_one_recording() -> bool:
            """One complete_one() with per-tag failure recording — the
            single home of the drain discipline, so a failed reply is
            always attributed to ITS tag and the client's push-side heal
            runs (the step still surfaces the failure)."""
            try:
                return win.complete_one()
            except Exception as e:  # noqa: BLE001 — ANY reply failure
                tag = getattr(e, "pipeline_tag", None)
                push_failed.setdefault(tag if tag is not None else "?", e)
                if isinstance(e, native.RpcError):
                    self.client.note_push_error(e)
                return True
            finally:
                with landed:
                    landed.notify_all()

        def make_push(name):
            def fn(done):
                if win is None:
                    step_versions[name] = self.client.push_grad(
                        name, handoff.adopt(grads[name]))
                    return None
                # Drain a full window HERE (recording per tag), not inside
                # submit: submit's internal drain would raise an EARLIER
                # push's reply error out of THIS node.
                while win.inflight() >= win.window:
                    if not drain_one_recording():
                        break
                self.client.submit_push(win, name, handoff.adopt(grads[name]))
                return None
            return fn

        def make_opt(name):
            def fn(done):
                # Drain the window until THIS push's reply lands (the
                # server applied its momentum step and bumped the
                # version); later pushes stay in flight.
                while (name not in step_versions
                       and name not in push_failed and win is not None):
                    if not drain_one_recording():
                        # The push lane took this reply off the window
                        # and records it when it lands: within the
                        # channel's timeout of the call, which began
                        # before this wait.
                        with landed:
                            landed.wait_for(
                                lambda: (name in step_versions
                                         or name in push_failed),
                                timeout=channel.timeout_ms / 1e3)
                        break
                if name in step_versions:
                    self.versions[name] = step_versions[name]
                    return step_versions[name]
                err = push_failed.get(name)
                if err is None:
                    err = native.RpcError(
                        native.TRPC_EEOF,
                        f"push reply for {name} never arrived")
                raise err
            return fn

        def make_pull(name):
            def fn(done):
                version, arr = self.client.pull(name)
                handoff.settle(self.device)
                self._raw[name] = arr
                self.versions[name] = version
                return version
            return fn

        graph = StepGraph()
        # Insertion order IS the serial schedule: forward, every
        # backward, every push, then each name's confirm and pull.
        # Pushes ride the wire lane; confirms and pulls a second one, so
        # a layer's next version comes back while lower layers still
        # compute and push.
        graph.add("fwd", _traced("step/fwd", fn_forward), lane=COMPUTE)
        prev = "fwd"
        for name in rev:
            prev = graph.add(f"bwd:{name}",
                             _traced(f"step/bwd:{name}", make_bwd(name)),
                             deps=(prev,), lane=COMPUTE)
        if self.client is not None:
            for name in rev:
                graph.add(f"push:{name}",
                          _traced(f"step/push:{name}", make_push(name)),
                          deps=(f"bwd:{name}",), lane=WIRE)
            for name in rev:
                for stage, before, make in (("opt", "push", make_opt),
                                            ("pull", "opt", make_pull)):
                    graph.add(f"{stage}:{name}",
                              _traced(f"step/{stage}:{name}", make(name)),
                              deps=(f"{before}:{name}",), lane=_PULL_LANE)

        failure: Optional[StepFailure] = None
        trace = None
        with tracing.trace_span("train_step"):
            tid, sid = tracing.current_trace()
            wire_ctx = _trace_handoff_ctx(
                tid, sid, stream=self._lanes.ctx if self.overlap else None)
            try:
                _results, trace = run_graph(graph, overlap=self.overlap,
                                            wire_ctx=wire_ctx)
            except StepFailure as sf:
                failure = sf
            except BaseException:
                # Ctrl-C and friends: the scheduler aborted promptly — do
                # NOT drain in-flight replies (each blocks up to the
                # channel timeout); cancel and free the staged window.
                if win is not None:
                    win.abort()
                raise
            # Late replies still count: a push whose confirm was
            # cancelled may have landed server-side — drain the window so
            # `applied` is accurate before salvage math.
            if win is not None:
                while drain_one_recording():
                    pass
            if failure is not None:
                for name, v in step_versions.items():
                    self.versions[name] = max(self.versions.get(name, 0), v)
            if trace is not None:
                _annotate(trace)

        if failure is not None:
            raise self._salvage(failure, names, step_versions, push_failed)

        if pacer is not None:
            pacer.clear()  # a whole step landed: the server is admitting
        loss = float(self.harness.loss(ctx_box["ctx"]))
        self._record(loss, trace, t0)
        return loss

    def _salvage(self, sf: StepFailure, names, step_versions,
                 push_failed) -> BaseException:
        """Map a StepFailure onto the per-name push salvage contract."""
        wire_fail = {n: e for n, e in sf.failed.items()
                     if n.startswith(("push:", "opt:"))}
        if not wire_fail:
            # Compute- or pull-side failure: nothing ambiguous about the
            # pushes — surface the original cause.
            return sf.cause
        self._m["partial"].add(1)
        cause = None
        for e in list(wire_fail.values()) + list(push_failed.values()):
            if isinstance(e, native.RpcError):
                cause = e
                break
        if cause is None:
            cause = native.RpcError(native.TRPC_EEOF, str(next(iter(
                wire_fail.values()))))
        unpushed = [n for n in names if n not in step_versions]
        err = PartialPushError(cause, dict(step_versions), unpushed)
        err.step_failure = sf
        return err

    def run(self, batches) -> List[float]:
        """Convenience loop: ``batches`` yields ``(x, y)`` pairs."""
        return [self.step(x, y) for x, y in batches]


class CollectiveStepDriver(_Recorder):
    """Data-parallel training where the gradient exchange is a ring
    allreduce over a
    :class:`~brpc_tpu_torch.collectives.group.CollectiveGroup` (or any
    group with ``world``/``allreduce``, e.g. ``tp_layers.LocalMember``):
    every member holds the full parameter set, computes gradients on its
    own batch, and each layer's exchange is an ``allreduce:k`` node on a
    NAMED wire lane —

        forward -> bwd:k (compute lane, top layer first)
        bwd:k   -> allreduce:k (lane ``wire:ar<k % wire_lanes>``)
        allreduce:k -> opt:k (compute lane: the momentum update)

    A collective hop BLOCKS waiting for its ring predecessor, so per-peer
    wire lanes let layer k's hops hide behind layer k+1's backward and
    behind each other. ``overlap=False`` runs the same nodes serially.

    Masters and momenta live on the harness's device. ``opt:k`` copies
    the reduced host buffer to the device (one H2D) and launches
    ``fused_momentum_update`` — K1 on the card — out of place.

    Failure: a hop failure (member left, timeout) cancels exactly that
    layer's ``opt:k`` while every other layer completes; the step raises
    the triggering
    :class:`~brpc_tpu_torch.collectives.core.CollectiveAborted` with the
    graph post-mortem on ``.step_failure``.

    No mesh harness: each member is one full replica, and its gradient
    exchange is the group's ring. A ``LayeredMLP(mesh=...)`` rank holds a
    shard and a wire-rank role, which only :class:`OverlappedStepDriver`
    drives (the JAX package drives no mesh harness here either); this
    driver refuses one.

    ``track=True`` — T3 track-and-trigger (arXiv 2401.16677): the
    momentum update rides the collective's per-chunk finality hook
    (``on_chunk``) instead of an ``opt:k`` node. The wire lane copies the
    layer's masters on the device when its op starts, and for each
    landed span copies the span's values to the device (one H2D) and
    launches K1 over the matching contiguous slices of those copies; it
    waits for its stream and installs the copies when the op ends (a
    failed op leaves the masters untouched). No compute node reads the
    copies, so the wire lane's launches need no ordering against the
    compute lane's. K1 is elementwise and does not contract to FMA, so
    the tracked trajectory equals the untracked one bit for bit; the
    average is the same fp32 division in both.
    """

    def __init__(self, group, harness, overlap: bool = True,
                 wire_lanes: int = 2, lr: float = 0.01,
                 momentum: float = 0.9, average: bool = True,
                 track: bool = False):
        if getattr(harness, "mesh", None) is not None:
            raise ValueError("CollectiveStepDriver drives full replicas; "
                             "a mesh harness rides OverlappedStepDriver")
        self.group = group
        self.harness = harness
        self.overlap = overlap
        self.wire_lanes = max(1, wire_lanes)
        self.lr = lr
        self.momentum = momentum
        self.average = average
        self.track = track
        self.device = harness.device
        self._params: Dict[str, torch.Tensor] = {}   # fp32 masters
        self._momenta: Dict[str, torch.Tensor] = {}
        self._lanes = handoff.LaneStreams(self.device)
        # track mode: {name: [(chunk_idx, (offset, length)), ...]} of the
        # last step, in firing order.
        self.last_chunk_log: Dict[str, list] = {}
        self._init_stats()

    def prime(self, params: Optional[Dict[str, object]] = None,
              momenta: Optional[Dict[str, object]] = None) -> None:
        """Adopt the initial parameter set (and momenta, zero by default)
        as masters on the harness's device. All members must start
        identical — ``harness.init_params()`` is deterministic per seed."""
        src = params if params is not None else self.harness.init_params()
        for name in self.harness.names:
            p = to_tensor(src[name], self.device).to(torch.float32)
            self._params[name] = p
            self._momenta[name] = (
                torch.zeros_like(p) if momenta is None
                else to_tensor(momenta[name], self.device).to(torch.float32))

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self._params)

    def momenta(self) -> Dict[str, torch.Tensor]:
        return dict(self._momenta)

    def _average(self, red: np.ndarray, world: int) -> np.ndarray:
        if self.average:
            red /= np.float32(world)
        return red

    def step(self, x, y) -> float:
        t0 = time.monotonic()
        names: List[str] = list(self.harness.names)
        rev = list(reversed(names))
        world = max(1, self.group.world)
        grads: Dict[str, torch.Tensor] = {}
        reduced: Dict[str, np.ndarray] = {}
        ctx_box: Dict[str, object] = {}

        def fn_forward(done):
            placed = {n: self.harness.place(n, handoff.adopt(self._params[n]))
                      for n in names}
            ctx_box["ctx"] = self.harness.forward(placed, x, y)
            return None

        def make_bwd(name):
            def fn(done):
                grads[name] = handoff.publish(
                    self.harness.backward(ctx_box["ctx"], name))
                return None
            return fn

        def host_grad(name) -> np.ndarray:
            g = grads[name]
            handoff.adopt(g)
            return d2h(g.detach()).numpy()  # D2H on the wire lane

        def make_allreduce(name):
            def fn(done):
                red = self.group.allreduce(name, host_grad(name))
                reduced[name] = self._average(red.numpy(), world)
                return None
            return fn

        def make_allreduce_tracked(name):
            def fn(done):
                g = host_grad(name)
                shape = self._params[name].shape
                # Copy-on-write: update fresh copies, install when the op
                # lands — a failed op leaves params/momenta untouched.
                pf = self._params[name].detach().clone().reshape(-1)
                mf = self._momenta[name].detach().clone().reshape(-1)
                chunk_log = self.last_chunk_log.setdefault(name, [])
                chunk_log.clear()

                def on_chunk(idx, span, vals):
                    off, ln = span
                    gc = torch.from_numpy(np.ascontiguousarray(
                        self._average(vals, world))).to(self.device)
                    p2, m2 = fused_momentum_update(
                        pf[off:off + ln], mf[off:off + ln], gc,
                        lr=self.lr, beta=self.momentum)
                    pf[off:off + ln].copy_(p2)
                    mf[off:off + ln].copy_(m2)
                    chunk_log.append((idx, span))

                red = self.group.allreduce(name, g, on_chunk=on_chunk)
                reduced[name] = self._average(red.numpy(), world)
                handoff.settle(self.device)
                self._momenta[name] = mf.view(shape)
                self._params[name] = pf.view(shape)
                return None
            return fn

        def make_opt(name):
            def fn(done):
                p = self._params[name]
                g = torch.from_numpy(reduced[name]).to(self.device)
                p2, m2 = fused_momentum_update(
                    p, self._momenta[name], g.view(p.shape), lr=self.lr,
                    beta=self.momentum)
                self._params[name] = p2
                self._momenta[name] = m2
                return None
            return fn

        graph = StepGraph()
        graph.add("fwd", _traced("step/fwd", fn_forward), lane=COMPUTE)
        prev = "fwd"
        for name in rev:
            prev = graph.add(f"bwd:{name}",
                             _traced(f"step/bwd:{name}", make_bwd(name)),
                             deps=(prev,), lane=COMPUTE)
        mk_ar = make_allreduce_tracked if self.track else make_allreduce
        for k, name in enumerate(rev):
            # track=True launches K1 on this lane by design: the update
            # rides the collective's per-chunk finality hook, on the
            # lane's own stream; one launch per landed chunk.
            # tpulint: allow(regime-graph-torch)
            graph.add(f"allreduce:{name}",
                      _traced(f"step/allreduce:{name}", mk_ar(name)),
                      deps=(f"bwd:{name}",),
                      lane=f"wire:ar{k % self.wire_lanes}")
        if not self.track:
            # Track mode has no opt nodes: the update already happened
            # per chunk inside each allreduce as spans landed.
            for name in rev:
                graph.add(f"opt:{name}",
                          _traced(f"step/opt:{name}", make_opt(name)),
                          deps=(f"allreduce:{name}",), lane=COMPUTE)

        with tracing.trace_span("train_step"):
            tid, sid = tracing.current_trace()
            wire_ctx = _trace_handoff_ctx(
                tid, sid,
                stream=self._lanes.ctx if self.overlap else None)
            try:
                _results, trace = run_graph(graph, overlap=self.overlap,
                                            wire_ctx=wire_ctx)
            except StepFailure as sf:
                self._m["partial"].add(1)
                cause = sf.cause
                try:
                    cause.step_failure = sf
                except Exception:  # noqa: BLE001 — exotic exception
                    pass
                raise cause
            _annotate(trace)

        loss = float(self.harness.loss(ctx_box["ctx"]))
        self._record(loss, trace, t0)
        return loss

    def run(self, batches) -> List[float]:
        return [self.step(x, y) for x, y in batches]
