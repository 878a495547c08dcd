"""Tensor-parallel layer wrappers riding the standalone collective verbs.

The port of brpc_tpu/models/tp_layers.py. Megatron-style sharding of the
``LayeredMLP`` stack: even layers shard columns (each rank computes a
column block of ``z = a @ W``, an allgather rebuilds the full
activation), odd layers shard rows (each rank computes a partial product
from its input slice, a reduce-scatter + allgather — :func:`tp_allreduce`
— sums the partials). The backward pass mirrors it: the column layer's
input-gradient is a sum of per-rank partials (allreduce), the row
layer's is a column block (allgather). One collective per layer per
direction, every one of them the ``reduce_scatter``/``allgather`` verbs
of ``brpc_tpu_torch.collectives`` — so over a real
:class:`~brpc_tpu_torch.collectives.group.CollectiveGroup` each hop gets
the int8 codec + error feedback exactly as the DP ring does.

Shards and matmuls live on the device (default CUDA); the verbs run on
the host (each costs a D2H of its argument and an H2D of its result), as
the JAX package's do. The wrappers are duck-typed over ``group``:
anything with ``rank``/``world``/``reduce_scatter``/``allgather`` works —
a real wire group, or the in-process :class:`LocalRing` below (the same
``collectives.core`` algorithms over a Mailbox transport).

Sharding layout is ``ring.chunk_spans(dim, world)`` by RANK INDEX — the
same balanced-spans helper the ring schedule uses, so shard math and
chunk math can't drift apart.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from brpc_tpu_torch.collectives import core, ring
from brpc_tpu_torch.collectives.quant import ChunkCodec
from brpc_tpu_torch.ops.fused_update import fused_momentum_update
from brpc_tpu_torch.runtime.state import to_tensor
from brpc_tpu_torch.utils.device import resolve_device


# ---------------------------------------------------------------------------
# Allreduce as the verb composition (rs + ag), reassembled by span.
# ---------------------------------------------------------------------------

def tp_allreduce(group, name: str, x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` across ``group`` via reduce_scatter + allgather.

    ``group.allgather`` indexes results by RANK while the scattered
    chunks are owned by ``ring.owned_chunk(rank, n)`` — the reassembly
    places rank ``r``'s gathered chunk at its owned span."""
    flat = x.reshape(-1).to(torch.float32)
    n = group.world
    if n == 1:
        return flat.clone().reshape(x.shape)
    _span, chunk = group.reduce_scatter(name + "/rs", flat)
    parts = group.allgather(name + "/ag", chunk)
    spans = ring.chunk_spans(flat.numel(), n)
    out = torch.empty_like(flat)
    for r in range(n):
        off, ln = spans[ring.owned_chunk(r, n)]
        if ln:
            out[off:off + ln] = parts[r].reshape(-1)
    return out.reshape(x.shape)


def shard_span(dim: int, rank: int, world: int):
    """This rank's (offset, length) slice of a sharded dimension."""
    return ring.chunk_spans(dim, world)[rank]


def shard_axis(k: int) -> int:
    """The axis layer ``k`` of the stack is sharded on: columns for even
    layers, rows for odd ones."""
    return 1 if k % 2 == 0 else 0


# ---------------------------------------------------------------------------
# The sharded layers.
# ---------------------------------------------------------------------------

class _ShardedLinear:
    axis = 1

    def __init__(self, name: str, w_full, group, device):
        self.name = name
        self.group = group
        w = to_tensor(w_full, device).to(torch.float32)
        self.span = shard_span(w.shape[self.axis], group.rank, group.world)
        lo, ln = self.span
        self.w = w.narrow(self.axis, lo, ln).contiguous()
        self.m = torch.zeros_like(self.w)
        self.g: Optional[torch.Tensor] = None
        self._a: Optional[torch.Tensor] = None

    def gather_full(self) -> torch.Tensor:
        parts = self.group.allgather(self.name + "/gp", self.w)
        return torch.cat(parts, dim=self.axis)


class ColumnShardedLinear(_ShardedLinear):
    """``z = a @ W`` with ``W`` column-sharded: local matmul yields a
    column block of ``z``; allgather rebuilds the full activation.
    Backward: the weight grad ``a.T @ delta[:, cols]`` is already local;
    the input grad ``delta[:, cols] @ W_loc.T`` is a per-rank PARTIAL sum
    — :func:`tp_allreduce` completes it."""

    axis = 1

    def fwd(self, a: torch.Tensor) -> torch.Tensor:
        self._a = a
        return torch.cat(self.group.allgather(self.name + "/fz",
                                              a @ self.w), dim=1)

    def bwd(self, delta: torch.Tensor) -> torch.Tensor:
        lo, ln = self.span
        d_loc = delta[:, lo:lo + ln]
        self.g = self._a.T @ d_loc
        return tp_allreduce(self.group, self.name + "/bu", d_loc @ self.w.T)


class RowShardedLinear(_ShardedLinear):
    """``z = a @ W`` with ``W`` row-sharded: each rank multiplies its
    input slice by its row block — a partial sum tp_allreduce completes.
    Backward: the input grad ``delta @ W_loc.T`` is a COLUMN block of
    ``dL/da`` (exact, no reduction) — allgather rebuilds it."""

    axis = 0

    def fwd(self, a: torch.Tensor) -> torch.Tensor:
        self._a = a
        lo, ln = self.span
        return tp_allreduce(self.group, self.name + "/fz",
                            a[:, lo:lo + ln] @ self.w)

    def bwd(self, delta: torch.Tensor) -> torch.Tensor:
        lo, ln = self.span
        self.g = self._a[:, lo:lo + ln].T @ delta
        return torch.cat(self.group.allgather(self.name + "/bu",
                                              delta @ self.w.T), dim=1)


class TPShardedMLP:
    """The ``LayeredMLP`` stack sharded across ``group``: layers
    alternate column/row sharding (the column layer's gathered output
    feeds the row layer's sliced input). ``params_full`` is the UNSHARDED
    init (arrays or tensors; every rank slices the same dict), so
    TP-vs-baseline parity starts from identical weights; the forward and
    backward are the same fp32 chain as ``LayeredMLP`` with the batched
    matmuls split per rank, and the documented parity tolerance is fp32
    reassociation of the split partial sums (~1e-5 relative) — zero when
    ``world == 1``. The update is one ``fused_momentum_update`` per layer
    (K1 on the card)."""

    def __init__(self, sizes, group, params_full: Dict[str, object],
                 lr: float = 0.01, momentum: float = 0.9, device=None):
        if len(sizes) < 2:
            raise ValueError("need at least one layer (two sizes)")
        self.sizes = list(sizes)
        self.group = group
        self.lr = lr
        self.momentum = momentum
        self.device = resolve_device(device)
        self.names = [f"layer{k:02d}" for k in range(len(sizes) - 1)]
        self.layers: List[_ShardedLinear] = []
        for k, name in enumerate(self.names):
            cls = (ColumnShardedLinear if shard_axis(k) == 1
                   else RowShardedLinear)
            self.layers.append(cls(name, params_full[name], group,
                                   self.device))

    def forward(self, x):
        a = to_tensor(x, self.device).to(torch.float32)
        zs = []
        last = len(self.layers) - 1
        for k, layer in enumerate(self.layers):
            z = layer.fwd(a)
            zs.append(z)
            a = z if k == last else torch.relu(z)
        return a, zs

    def backward(self, pred: torch.Tensor, y, zs) -> float:
        r = pred - to_tensor(y, self.device).to(torch.float32)
        loss = float(torch.mean(torch.square(r)))
        delta = (2.0 / r.numel()) * r
        for k in range(len(self.layers) - 1, -1, -1):
            u = self.layers[k].bwd(delta)
            if k > 0:
                delta = u * (zs[k - 1] > 0)
        return loss

    def grads(self, x, y):
        """Local grad shards (+ loss) without an update."""
        pred, zs = self.forward(x)
        loss = self.backward(pred, y, zs)
        return {l.name: l.g for l in self.layers}, loss

    def train_step(self, x, y) -> float:
        pred, zs = self.forward(x)
        loss = self.backward(pred, y, zs)
        for layer in self.layers:
            layer.w, layer.m = fused_momentum_update(
                layer.w, layer.m, layer.g.contiguous(), lr=self.lr,
                beta=self.momentum)
        return loss

    def gather_params(self) -> Dict[str, torch.Tensor]:
        return {l.name: l.gather_full() for l in self.layers}


# ---------------------------------------------------------------------------
# LocalRing: the in-process group (tests, single-process runs).
# ---------------------------------------------------------------------------

class _MemLink:
    """One op's transport over the ring's Mailboxes — the same contract
    ``group._RpcLink`` gives ``collectives.core`` on the wire."""

    def __init__(self, ring_obj, rank: int, op_key: tuple,
                 deadline: float):
        self._ring = ring_obj
        self._rank = rank
        self._op = op_key
        self._deadline = deadline

    def send(self, dst, ph, step, idx, meta, blob, frag=0, nfrags=1):
        detached = np.array(np.asarray(blob).reshape(-1).view(np.uint8))
        self._ring._boxes[dst].deposit(
            self._op + (ph, int(step), int(frag)),
            (idx, dict(meta), detached))

    def recv(self, ph, step, frag=0):
        return self._ring._boxes[self._rank].take(
            self._op + (ph, int(step), int(frag)), self._deadline)


class LocalRing:
    """An in-process collective group: the REAL ``collectives.core`` ring
    algorithms (and codec, when asked) over ``core.Mailbox`` rendezvous
    instead of RPC. Members run on caller threads — one thread per rank.
    ``codec="int8"`` exercises the same quantization + per-member
    error-feedback path the wire takes."""

    def __init__(self, world: int, codec: Optional[str] = None,
                 ef: bool = True, timeout_s: float = 30.0):
        self.world = world
        self.codec = codec
        self.timeout_s = timeout_s
        self._boxes = [core.Mailbox() for _ in range(world)]
        self._members = [LocalMember(self, r, ChunkCodec(ef=ef))
                         for r in range(world)]

    def member(self, rank: int) -> "LocalMember":
        return self._members[rank]


class LocalMember:
    """One rank's handle on a :class:`LocalRing` — duck-compatible with
    ``CollectiveGroup`` for the verbs the TP layers and the DP driver
    use; like it, the verbs take arrays or tensors and return tensors on
    the input's device."""

    def __init__(self, ring_obj: LocalRing, rank: int, codec: ChunkCodec):
        self._ring = ring_obj
        self.rank = rank
        self.world = ring_obj.world
        self._codec = codec
        self._seq: Dict[str, int] = {}
        self._mu = threading.Lock()

    def _link(self, name: str) -> _MemLink:
        with self._mu:
            seq = self._seq.get(name, 0)
            self._seq[name] = seq + 1
        return _MemLink(self._ring, self.rank, (name, seq),
                        time.monotonic() + self._ring.timeout_s)

    def reduce_scatter(self, name: str, array):
        span, chunk = core.ring_reduce_scatter(
            self.rank, self.world, core.host_array(array), self._codec,
            self._link(name), name, self._ring.codec)
        return span, core.like_input(chunk, array)

    def allgather(self, name: str, array) -> List[torch.Tensor]:
        parts = core.ring_allgather(
            self.rank, self.world, core.host_array(array), self._codec,
            self._link(name), name, self._ring.codec)
        return [core.like_input(p, array) for p in parts]

    def allreduce(self, name: str, array, on_chunk=None) -> torch.Tensor:
        host = core.host_array(array)
        out = core.ring_allreduce(
            self.rank, self.world, host, self._codec, self._link(name),
            name, self._ring.codec, on_chunk=on_chunk)
        return core.like_input(out, array)
