"""Pipeline-parallel stage scheduling — 1F1B as a ``step_sched`` graph.

The port of brpc_tpu/runtime/pp_sched.py. Layers partition CONTIGUOUSLY
across S stages, a step splits into M microbatches, and each stage runs
the 1F1B (one-forward-one-backward) schedule — ``S-1-stage`` warmup
forwards, a steady phase alternating forward/backward, then the cooldown
backwards. Activations flow to the next stage and activation-grads back
to the previous one as tensors; each direction of each link is its own
named wire lane so a recv parked on a slow peer never blocks the sends
that keep the OTHER stages fed.

Schedule-shaped and pure: the closed-form bubble accounting, the slot
simulator the closed form is pinned against, the per-stage ``StepGraph``
builder, and ``MemoryPipe`` (the in-process transport). ``WirePipe`` is
the fleet-real transport — stages discovered via the registry, device
tensors shipped over per-link ``TensorChannel`` + ``PipelineWindow``: the
D2H at ship and the H2D at receive run on the link's own wire lane (its
own CUDA stream).

Bubble accounting rides :class:`~brpc_tpu_torch.runtime.step_sched.RunTrace`:
a stage's pipeline bubble IS its compute lane's exposed wait (stall
while the peer's activation/grad is in flight + the end-of-step join).
The closed form it converges to: with fwd and bwd each one slot, a
(S, M) pipeline idles ``2*S*(S-1)`` slots total — fraction
``(S-1)/(M+S-1)``.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from brpc_tpu_torch.ops.fused_update import fused_momentum_update
from brpc_tpu_torch.runtime import handoff
from brpc_tpu_torch.runtime.step_sched import (COMPUTE, RunTrace, StepGraph,
                                               run_graph)

# One lane per link DIRECTION: a blocking recv parks only its own lane.
LANE_ACT_IN = "wire:pp_act_in"
LANE_ACT_OUT = "wire:pp_act_out"
LANE_GRAD_IN = "wire:pp_grad_in"
LANE_GRAD_OUT = "wire:pp_grad_out"


# ---------------------------------------------------------------------------
# Schedule math (pure).
# ---------------------------------------------------------------------------

def stage_layers(n_layers: int, stages: int) -> List[Tuple[int, int]]:
    """Balanced CONTIGUOUS layer partition -> ``[(lo, hi), ...]`` per
    stage (contiguous because the backward recurrence threads a delta
    through adjacent layers — a strided split would ship every layer
    boundary)."""
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


def warmup_count(stage: int, stages: int, microbatches: int) -> int:
    """Forwards a stage runs before its first backward: the pipeline
    depth still ahead of it (capped by the microbatch count)."""
    return min(microbatches, stages - 1 - stage)


def stage_schedule(stage: int, stages: int,
                   microbatches: int) -> List[Tuple[str, int]]:
    """This stage's 1F1B compute order: ``[("fwd"|"bwd", mb), ...]`` —
    warmup forwards, the steady fwd/bwd alternation, cooldown backwards.
    The LAST stage has zero warmup (bwd 0 immediately follows fwd 0 —
    the 1F1B property that caps live activations at ``warmup+1``)."""
    if stage < 0 or stage >= stages:
        raise ValueError(f"stage {stage} out of range for {stages}")
    if microbatches < 1:
        raise ValueError("need at least one microbatch")
    w = warmup_count(stage, stages, microbatches)
    sched = [("fwd", m) for m in range(w)]
    nf, nb = w, 0
    while nf < microbatches:
        sched.append(("fwd", nf))
        nf += 1
        sched.append(("bwd", nb))
        nb += 1
    while nb < microbatches:
        sched.append(("bwd", nb))
        nb += 1
    return sched


def bubble_slots(stages: int, microbatches: int) -> int:
    """Closed-form total idle slots across ALL stages (fwd = bwd = one
    slot): makespan is ``2*(M+S-1)`` slots, each stage computes ``2*M``
    of them -> ``S*2*(M+S-1) - S*2*M = 2*S*(S-1)``. Pinned against
    :func:`simulate_slots` in the unit tests."""
    return 2 * stages * (stages - 1)


def bubble_fraction(stages: int, microbatches: int) -> float:
    """Idle fraction of the pipeline: ``(S-1)/(M+S-1)``."""
    return (stages - 1) / (microbatches + stages - 1)


def simulate_slots(stages: int, microbatches: int) -> dict:
    """Slot-time simulation of the full (S, M) pipeline: every op takes
    one slot, each stage executes its :func:`stage_schedule` in order,
    cross-stage deps are ``fwd(s,m) after fwd(s-1,m)`` and ``bwd(s,m)
    after bwd(s+1,m)``. Returns makespan + per-stage busy/idle — the
    ground truth the closed form is pinned against."""
    scheds = [stage_schedule(s, stages, microbatches)
              for s in range(stages)]
    end: Dict[Tuple[str, int, int], int] = {}
    free = [0] * stages
    idx = [0] * stages
    total = sum(len(sc) for sc in scheds)
    ndone = 0
    while ndone < total:
        progressed = False
        for s in range(stages):
            while idx[s] < len(scheds[s]):
                kind, m = scheds[s][idx[s]]
                deps = [("fwd", s, m)] if kind == "bwd" else []
                if kind == "fwd" and s > 0:
                    deps.append(("fwd", s - 1, m))
                if kind == "bwd" and s < stages - 1:
                    deps.append(("bwd", s + 1, m))
                if not all(d in end for d in deps):
                    break
                start = max([free[s]] + [end[d] for d in deps])
                end[(kind, s, m)] = start + 1
                free[s] = start + 1
                idx[s] += 1
                ndone += 1
                progressed = True
        if not progressed:
            raise RuntimeError("1F1B schedule deadlocked (builder bug)")
    makespan = max(end.values())
    busy = [len(sc) for sc in scheds]
    idle = [makespan - b for b in busy]
    return {"makespan": makespan, "busy": busy, "idle": idle,
            "total_idle": sum(idle)}


def bubble_time_s(trace: RunTrace) -> float:
    """A stage's measured pipeline bubble: its compute lane's exposed
    wait (mid-step stall on peer tensors + the end-of-step join)."""
    return trace.exposed_wait_s


# ---------------------------------------------------------------------------
# Per-stage graph builder (pure).
# ---------------------------------------------------------------------------

def stage_node_order(stage: int, stages: int,
                     microbatches: int) -> List[str]:
    """The stage's full serial node order — compute ops in 1F1B order
    with their send/recv nodes interleaved at first use. This IS the
    graph's insertion order, so ``StepGraph.serial_order()`` (and the
    ``overlap=False`` execution order) equals it by construction."""
    last = stage == stages - 1
    order: List[str] = []
    for kind, m in stage_schedule(stage, stages, microbatches):
        if kind == "fwd":
            if stage > 0:
                order.append(f"recv_act:{m}")
            order.append(f"fwd:{m}")
            if not last:
                order.append(f"send_act:{m}")
        else:
            if not last:
                order.append(f"recv_grad:{m}")
            order.append(f"bwd:{m}")
            if stage > 0:
                order.append(f"send_grad:{m}")
    return order


def build_stage_graph(stage: int, stages: int, microbatches: int, *,
                      fwd: Callable, bwd: Callable,
                      send_act: Optional[Callable] = None,
                      recv_act: Optional[Callable] = None,
                      send_grad: Optional[Callable] = None,
                      recv_grad: Optional[Callable] = None) -> StepGraph:
    """One stage's step as a :class:`StepGraph`.

    ``fwd(mb, act_in)`` / ``bwd(mb, grad_in)`` run on the compute lane
    in exact 1F1B order (consecutive compute ops are chained — the stage
    is serial on its device, and the chain is what makes insertion order
    the serial schedule). ``send_*(mb, value)`` / ``recv_*(mb)`` run on
    the four per-direction wire lanes; a failed node cancels exactly its
    transitive dependents (``step_sched`` semantics), so a dead peer
    still salvages every microbatch that never needed it.

    Boundary stages drop the callbacks they have no link for: stage 0
    never receives activations or sends grads (``fwd`` gets ``act_in=
    None`` — its input is the harness's own microbatch), the last stage
    never sends activations or receives grads (``bwd`` gets ``grad_in=
    None`` — its delta comes from the loss head).
    """
    last = stage == stages - 1
    g = StepGraph()
    prev_compute: Optional[str] = None
    prev_recv = {LANE_ACT_IN: None, LANE_GRAD_IN: None}

    def _recv(name: str, lane: str, fn: Callable, m: int) -> str:
        deps = (prev_recv[lane],) if prev_recv[lane] else ()
        g.add(name, lambda done, m=m: fn(m), deps=deps, lane=lane)
        prev_recv[lane] = name
        return name

    for kind, m in stage_schedule(stage, stages, microbatches):
        if kind == "fwd":
            deps: List[str] = []
            if stage > 0:
                deps.append(_recv(f"recv_act:{m}", LANE_ACT_IN,
                                  recv_act, m))
            if prev_compute:
                deps.append(prev_compute)
            src = f"recv_act:{m}"

            def _fwd(done, m=m, src=src):
                return fwd(m, done[src] if stage > 0 else None)

            g.add(f"fwd:{m}", _fwd, deps=deps, lane=COMPUTE)
            prev_compute = f"fwd:{m}"
            if not last:
                g.add(f"send_act:{m}",
                      lambda done, m=m: send_act(m, done[f"fwd:{m}"]),
                      deps=(f"fwd:{m}",), lane=LANE_ACT_OUT)
        else:
            deps = [f"fwd:{m}"]
            if not last:
                deps.append(_recv(f"recv_grad:{m}", LANE_GRAD_IN,
                                  recv_grad, m))
            if prev_compute:
                deps.append(prev_compute)
            src = f"recv_grad:{m}"

            def _bwd(done, m=m, src=src):
                return bwd(m, done[src] if not last else None)

            g.add(f"bwd:{m}", _bwd, deps=tuple(deps), lane=COMPUTE)
            prev_compute = f"bwd:{m}"
            if stage > 0:
                g.add(f"send_grad:{m}",
                      lambda done, m=m: send_grad(m, done[f"bwd:{m}"]),
                      deps=(f"bwd:{m}",), lane=LANE_GRAD_OUT)
    return g


# ---------------------------------------------------------------------------
# Transports: one port per stage, four verbs.
# ---------------------------------------------------------------------------

class PipeTimeout(RuntimeError):
    """A peer tensor did not arrive in time — the stage's recv node
    fails with this and ``step_sched`` cancels its dependents."""


class _Box:
    """Minimal keyed rendezvous (deposit-then-take, single consumer per
    key) — the pure-Python sibling of ``collectives.core.Mailbox``."""

    def __init__(self):
        self._cv = threading.Condition()
        self._slots: Dict[tuple, object] = {}

    def put(self, key: tuple, value) -> None:
        with self._cv:
            self._slots[key] = value
            self._cv.notify_all()

    def take(self, key: tuple, timeout_s: float):
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while key not in self._slots:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise PipeTimeout(
                        f"pipe recv timed out waiting for {key!r}")
                self._cv.wait(min(left, 0.5))
            return self._slots.pop(key)


class MemoryPipe:
    """In-process transport: S stages in one process (threads), tensors
    pass by reference. The unit tests and trajectory-parity pins run on
    this; the port protocol is exactly :class:`WirePipe`'s."""

    def __init__(self, stages: int, timeout_s: float = 30.0):
        self.stages = stages
        self.timeout_s = timeout_s
        self._acts = [_Box() for _ in range(stages)]
        self._grads = [_Box() for _ in range(stages)]

    def port(self, stage: int) -> "MemoryPipePort":
        return MemoryPipePort(self, stage)


class MemoryPipePort:
    def __init__(self, pipe: MemoryPipe, stage: int):
        self._pipe = pipe
        self.stage = stage

    def send_act(self, step: int, mb: int, arr) -> None:
        self._pipe._acts[self.stage + 1].put((step, mb), arr)

    def recv_act(self, step: int, mb: int):
        return self._pipe._acts[self.stage].take((step, mb),
                                                 self._pipe.timeout_s)

    def send_grad(self, step: int, mb: int, arr) -> None:
        self._pipe._grads[self.stage - 1].put((step, mb), arr)

    def recv_grad(self, step: int, mb: int):
        return self._pipe._grads[self.stage].take((step, mb),
                                                  self._pipe.timeout_s)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class WirePipe:
    """Cross-process transport for one stage: a native tensor server +
    registry membership (stages discover each other like fleet members —
    register under the job tag, Hello maps address -> stage), activations
    and activation-grads shipped as typed fp32 tensors over per-link
    ``TensorChannel`` + ``PipelineWindow`` (one window per direction, so
    the D2H staging of microbatch k+1 overlaps microbatch k's wire time).
    A send stages the device tensor straight into the arena (D2H on the
    sending lane's stream); a recv copies the received bytes onto
    ``device`` (H2D on the receiving lane's stream, complete on return).
    Its wire is the JAX package's. ``emulate_wire_gbps`` (benchmarks only)
    holds every send for its bytes' time on a link of that rate."""

    def __init__(self, registry_hostport: str, stage: int, stages: int,
                 tag: str = "pp", listen: str = "127.0.0.1:0",
                 window: int = 4, timeout_s: float = 30.0,
                 arena_bytes: int = 64 << 20,
                 client_arena_bytes: int = 32 << 20, ttl_s: int = 5,
                 emulate_wire_gbps: Optional[float] = None, device=None):
        from brpc_tpu_torch.fleet import registry
        from brpc_tpu_torch.runtime import native
        from brpc_tpu_torch.runtime.tensor import (TensorArena,
                                                   add_tensor_service)
        from brpc_tpu_torch.utils.device import resolve_device

        self.stage = stage
        self.stages = stages
        self.tag = tag
        self.timeout_s = timeout_s
        self.window = window
        self.emulate_wire_gbps = emulate_wire_gbps
        self.device = resolve_device(device)
        self._client_arena_bytes = client_arena_bytes
        self._registry = registry_hostport
        self._box = _Box()
        self._mu = threading.Lock()
        self.server = native.Server()
        self.arena = add_tensor_service(self.server, "PipeStage",
                                        self._handle,
                                        TensorArena(arena_bytes))
        port = self.server.start(listen)
        host = listen.rsplit(":", 1)[0] or "127.0.0.1"
        self.addr = f"{host}:{port}"
        self._reg = registry.Registration(registry_hostport, self.addr,
                                          tag, ttl_s).start()
        self._stage_addr: Dict[int, str] = {}
        self._wins: Dict[str, object] = {}  # "up"/"down" -> PipelineWindow
        self._chans: List[object] = []

    # -- service handler (runs on the callback pool) --

    def _handle(self, method: str, request: bytes, att):
        if method == "Hello":
            return json.dumps({"stage": self.stage,
                               "addr": self.addr}).encode(), None
        if method == "Ship":
            req = json.loads(request.decode())
            payload = att
            if payload is not None and not isinstance(payload,
                                                      np.ndarray):
                payload = np.asarray(payload)
            # Detach NOW: the attachment view dies with the handler.
            arr = np.array(payload) if payload is not None else None
            self._box.put((req["kind"], int(req["step"]),
                           int(req["mb"])), arr)
            return b"ok", None
        from brpc_tpu_torch.runtime import native
        from brpc_tpu_torch.runtime.param_server import E_NO_SUCH
        raise native.RpcError(E_NO_SUCH, f"no such method: {method}")

    # -- membership --

    def sync(self, timeout_s: float = 10.0) -> None:
        """Wait until all S stages are registered, Hello-map stage ->
        address, and open the neighbour links."""
        from brpc_tpu_torch.fleet import registry
        from brpc_tpu_torch.runtime.tensor import (PipelineWindow,
                                                   TensorArena,
                                                   TensorChannel)

        deadline = time.monotonic() + timeout_s
        while True:
            _idx, addrs = registry.list_servers(self._registry, self.tag)
            if self.addr in addrs and len(addrs) == self.stages:
                break
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"pipe sync: registry shows {len(addrs)} stage(s), "
                    f"want {self.stages}")
            time.sleep(0.05)
        stage_addr = {self.stage: self.addr}
        for a in addrs:
            if a == self.addr:
                continue
            ch = TensorChannel(f"tpu://{a}", TensorArena(1 << 20),
                               timeout_ms=int(timeout_s * 1000))
            try:
                payload, _ = ch.call("PipeStage/Hello")
                stage_addr[int(json.loads(payload.decode())["stage"])] = a
            finally:
                ch.close()
        if len(stage_addr) != self.stages:
            raise RuntimeError(
                f"pipe sync: {len(stage_addr)} distinct stages mapped, "
                f"want {self.stages} (duplicate stage index?)")
        self._stage_addr = stage_addr

        def _open(peer_stage: int):
            ch = TensorChannel(f"tpu://{stage_addr[peer_stage]}",
                               TensorArena(self._client_arena_bytes),
                               timeout_ms=int(self.timeout_s * 1000))
            self._chans.append(ch)
            return PipelineWindow(ch, self.window,
                                  on_reply=lambda _t, _p, v: v.release())

        if self.stage + 1 < self.stages:
            self._wins["up"] = _open(self.stage + 1)
        if self.stage > 0:
            self._wins["down"] = _open(self.stage - 1)

    # -- the four verbs + lifecycle --

    def _ship(self, direction: str, kind: str, step: int, mb: int,
              arr) -> None:
        req = json.dumps({"kind": kind, "step": step, "mb": mb}).encode()
        t = (arr.detach().to(torch.float32) if isinstance(arr, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(arr, np.float32)))
        if self.emulate_wire_gbps:
            # Link emulation for benchmarks: this tensor's bytes cross a
            # modeled uplink (loopback shared memory runs at memcpy speed,
            # which no cross-host stage link does). It sleeps on the
            # sending lane, never in a handler.
            time.sleep(  # tpulint: allow(py-blocking)
                t.numel() * 4 / (self.emulate_wire_gbps * 1e9))
        with self._mu:
            self._wins[direction].submit("PipeStage/Ship", array=t,
                                         request=req,
                                         tag=(kind, step, mb))

    def _take(self, kind: str, step: int, mb: int) -> torch.Tensor:
        arr = self._box.take((kind, step, mb), self.timeout_s)
        return torch.from_numpy(arr).to(self.device)

    def send_act(self, step: int, mb: int, arr) -> None:
        self._ship("up", "act", step, mb, arr)

    def recv_act(self, step: int, mb: int) -> torch.Tensor:
        return self._take("act", step, mb)

    def send_grad(self, step: int, mb: int, arr) -> None:
        self._ship("down", "grad", step, mb, arr)

    def recv_grad(self, step: int, mb: int) -> torch.Tensor:
        return self._take("grad", step, mb)

    def flush(self) -> None:
        with self._mu:
            for win in self._wins.values():
                win.flush()

    def close(self) -> None:
        with self._mu:
            for win in self._wins.values():
                try:
                    win.abort()
                except Exception:  # noqa: BLE001 — best-effort teardown
                    pass
            self._wins.clear()
        for ch in self._chans:
            try:
                ch.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        self._chans = []
        try:
            self._reg.stop()
        finally:
            self.server.stop()


# ---------------------------------------------------------------------------
# The per-stage driver.
# ---------------------------------------------------------------------------

class PipelineStageDriver:
    """Drives ONE stage of the pipeline: builds the stage's 1F1B graph
    each step, runs it overlapped (or serial for the A/B), accumulates
    the stage's layer grads across microbatches, optionally averages
    them across a within-stage DP group (the PP x DP regime: ``dp_group``
    is a plain ``CollectiveGroup`` whose members are the replicas of
    THIS stage), then applies the momentum update on the caller's thread
    after the graph: one ``fused_momentum_update`` per layer (K1 on the
    card), ``m2 = mu*m + g; p2 = p - lr*m2`` out of place.

    On CUDA each wire lane runs on its own stream; a stage's outputs
    cross to its send lanes and received tensors to its compute lane
    through ``runtime.handoff``.

    The stage harness contract (see ``models/pipeline.StagedMLP``):
    ``names`` (this stage's layer names, forward order), ``device``,
    ``params()`` -> {name: tensor}, ``set_param(name, tensor)``,
    ``set_batch``, ``fwd(mb, a_in)`` -> activation to ship (stage 0 gets
    ``a_in=None`` and reads the microbatch staged via ``set_batch``),
    ``bwd(mb, grad_in)`` -> grad to ship (``None`` from the last stage's
    loss head), ``take_grads()`` -> {name: summed grad} (cleared), and
    for the last stage ``take_loss()`` -> summed microbatch loss.
    """

    def __init__(self, stage: int, stages: int, harness, port,
                 microbatches: int, lr: float = 0.01,
                 momentum: float = 0.9, overlap: bool = True,
                 dp_group=None, dp_average: bool = True):
        if microbatches < 1:
            raise ValueError("need at least one microbatch")
        self.stage = stage
        self.stages = stages
        self.harness = harness
        self.port = port
        self.microbatches = microbatches
        self.lr = lr
        self.momentum = momentum
        self.overlap = overlap
        self.dp_group = dp_group
        self.dp_average = dp_average
        self._momenta = {n: torch.zeros_like(p)
                         for n, p in harness.params().items()}
        self._step = 0
        self.last_trace: Optional[RunTrace] = None
        self.last_stats: Dict[str, float] = {}

    def momenta(self) -> Dict[str, torch.Tensor]:
        return dict(self._momenta)

    def step(self, x=None, y=None) -> Optional[float]:
        """One training step. Stage 0 supplies ``x`` (the full local
        batch; the driver slices M equal microbatches), the last stage
        supplies ``y``; middle stages pass neither. Returns the mean
        microbatch loss on the last stage, ``None`` elsewhere."""
        sid = self._step
        self._step += 1
        if self.stage == 0:
            if x is None:
                raise ValueError("stage 0 needs x")
            self.harness.set_batch(x=x, microbatches=self.microbatches)
        if self.stage == self.stages - 1:
            if y is None:
                raise ValueError("last stage needs y")
            self.harness.set_batch(y=y, microbatches=self.microbatches)
        port = self.port
        h = self.harness

        def run_out(fn):
            # Compute lane: adopt what a wire lane received, publish
            # what a send lane will read.
            def run(m, t_in):
                if t_in is not None:
                    handoff.adopt(t_in)
                out = fn(m, t_in)
                return None if out is None else handoff.publish(out)
            return run

        def ship(send):
            def run(m, out):
                send(sid, m, handoff.adopt(out))
            return run

        g = build_stage_graph(
            self.stage, self.stages, self.microbatches,
            fwd=run_out(h.fwd), bwd=run_out(h.bwd),
            send_act=ship(port.send_act),
            recv_act=lambda m: port.recv_act(sid, m),
            send_grad=ship(port.send_grad),
            recv_grad=lambda m: port.recv_grad(sid, m))
        _results, trace = run_graph(
            g, overlap=self.overlap,
            wire_ctx=handoff.lane_stream(h.device) if self.overlap else None)
        port.flush()
        self.last_trace = trace

        grads = h.take_grads()
        inv_m = 1.0 / self.microbatches
        for name in h.names:
            grad = grads[name] * inv_m
            if self.dp_group is not None:
                red = self.dp_group.allreduce(f"pp{self.stage}:{name}",
                                              grad)
                if self.dp_average:
                    red = red / self.dp_group.world
                grad = red
            p2, m2 = fused_momentum_update(
                h.params()[name], self._momenta[name], grad.contiguous(),
                lr=self.lr, beta=self.momentum)
            self._momenta[name] = m2
            h.set_param(name, p2)

        self.last_stats = {
            "wall_s": trace.wall_s,
            "bubble_s": bubble_time_s(trace),
            "exposed_stall_s": trace.exposed_stall_s,
            "exposed_join_s": trace.exposed_join_s,
            "bubble_frac_theory": bubble_fraction(self.stages,
                                                  self.microbatches),
        }
        if self.stage == self.stages - 1:
            loss = h.take_loss() / self.microbatches
            self.last_stats["loss"] = loss
            return loss
        return None
