"""TensorService — the flagship workload: a sharded parameter server whose
traffic is the RPC framework's reason to exist, on the port's mesh.

The port of brpc_tpu/models/tensor_service.py. bRPC's headline deployment
is parameter-server fan-out/fan-in (ParallelChannel merging sub-call
responses, PartitionChannel sharding state "N/M"); here that traffic runs
over a ``client`` x ``shard`` DeviceMesh, one process per rank:

- served state (MLP parameters) is tensor-sharded over ``shard``,
- request batches are data-sharded over ``client``,
- gradient fan-in is an all_reduce over ``client`` (ResponseMerger),
- partial-activation fan-in is an all_reduce over ``shard``,
- a point-to-point ring relays running stats (Streaming RPC's relay).

``train_step``/``flagship_entry`` are the single-device step (the momentum
updates on the hand-written kernel K1, ops/fused_update.py);
``dryrun_multichip`` runs ONE sharded step and the ring attention of the
long-context path (kernel K3) on n ranks.

Matmuls: bf16 operands, fp32 products and sums, as the JAX package's
``preferred_element_type=f32`` dots. They are computed as fp32 matmuls of
the bf16-rounded operands (``_mm_bf16``), which are exact products; on
CUDA that needs TF32 off (``torch.backends.cuda.matmul.allow_tf32`` False,
the default, and float32 matmul precision "highest"). Autograd of the
rounding casts rounds the operands' gradients to bf16 and back, as JAX's
gradient of the same dot does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from brpc_tpu_torch.ops.fused_update import (fused_momentum_update,
                                             momentum_update_reference)
from brpc_tpu_torch.parallel.collectives import ring_shift
from brpc_tpu_torch.parallel.launch import one_rank_group, run_ranks
from brpc_tpu_torch.parallel.mesh import CLIENT_AXIS, SHARD_AXIS, make_mesh
from brpc_tpu_torch.utils.device import resolve_device


class PSState(NamedTuple):
    w1: torch.Tensor  # (din, dh)   sharded on columns (shard axis)
    b1: torch.Tensor  # (dh,)
    w2: torch.Tensor  # (dh, dout)  sharded on rows (shard axis)
    b2: torch.Tensor  # (dout,)
    m_w1: torch.Tensor
    m_w2: torch.Tensor
    stats: torch.Tensor  # (dout,) running output stats, relayed on the ring


def init_state(generator: torch.Generator, din: int, dh: int, dout: int,
               device=None) -> PSState:
    """Random weights (normal / sqrt(fan-in)) from ``generator``, which
    must live on ``device``; zero biases, momenta and stats."""
    dev = resolve_device(device)
    w1 = torch.randn(din, dh, generator=generator, device=dev) / np.sqrt(din)
    w2 = torch.randn(dh, dout, generator=generator, device=dev) / np.sqrt(dh)
    zeros = lambda *s: torch.zeros(*s, dtype=torch.float32, device=dev)  # noqa: E731
    return PSState(w1=w1, b1=zeros(dh), w2=w2, b2=zeros(dout),
                   m_w1=torch.zeros_like(w1), m_w2=torch.zeros_like(w2),
                   stats=zeros(dout))


def _mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 operands, fp32 output: ``jnp.dot(a.astype(bf16),
    b.astype(bf16), preferred_element_type=f32)``."""
    return torch.matmul(a.to(torch.bfloat16).float(),
                        b.to(torch.bfloat16).float())


def _forward(state: PSState, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(_mm_bf16(x, state.w1) + state.b1)
    return _mm_bf16(h, state.w2) + state.b2


def _loss(state: PSState, x: torch.Tensor,
          target: torch.Tensor) -> torch.Tensor:
    y = _forward(state, x)
    return torch.mean(torch.square(y - target))


def train_step(state: PSState, x: torch.Tensor, target: torch.Tensor):
    """Single-device step: forward, autograd, then the momentum update of
    w1 and w2 through ``fused_momentum_update`` (the kernel K1 on CUDA),
    out of place. Returns (new_state, loss)."""
    leaves = [t.detach().requires_grad_() for t in
              (state.w1, state.b1, state.w2, state.b2)]
    with torch.enable_grad():
        loss = _loss(state._replace(w1=leaves[0], b1=leaves[1],
                                    w2=leaves[2], b2=leaves[3]), x, target)
        g_w1, g_b1, g_w2, g_b2 = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        w1, m_w1 = fused_momentum_update(state.w1, state.m_w1, g_w1)
        w2, m_w2 = fused_momentum_update(state.w2, state.m_w2, g_w2)
        new_stats = 0.9 * state.stats + 0.1 * torch.mean(
            _forward(state, x), dim=0)
        new_state = PSState(w1=w1, b1=state.b1 - 0.01 * g_b1,
                            w2=w2, b2=state.b2 - 0.01 * g_b2,
                            m_w1=m_w1, m_w2=m_w2, stats=new_stats)
    return new_state, loss.detach()


def flagship_entry(batch: int = 64, din: int = 256, dh: int = 512,
                   dout: int = 256, device=None):
    """(step fn, example args) of the single-device step on ``device``
    (default CUDA), random from seeds 0 (state), 1 (x) and 2 (target)."""
    dev = resolve_device(device)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)  # noqa: E731
    state = init_state(gen(0), din, dh, dout, device=dev)
    x = torch.randn(batch, din, generator=gen(1), device=dev)
    t = torch.randn(batch, dout, generator=gen(2), device=dev)
    return train_step, (state, x, t)


# ---------------------------------------------------------------------------
# Sharded step: client (dp) x shard (tp) mesh + ring relay.
# ---------------------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    """all_reduce(sum) whose gradient is all_reduce(sum) of the gradient —
    the transpose JAX takes of ``psum`` inside ``shard_map``. With the loss
    replicated over the group, every gradient flowing back through it comes
    out multiplied by the group size, as in the JAX package."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def shard_state(state: PSState, mesh: DeviceMesh) -> PSState:
    """This rank's blocks of a full ``PSState``: w1, b1, m_w1 by columns
    and w2, m_w2 by rows over ``shard``; b2 and stats whole."""
    n = mesh[SHARD_AXIS].size()
    i = mesh.get_local_rank(SHARD_AXIS)
    cols = lambda t: t.chunk(n, dim=-1)[i].contiguous()  # noqa: E731
    rows = lambda t: t.chunk(n, dim=0)[i].contiguous()  # noqa: E731
    return PSState(w1=cols(state.w1), b1=cols(state.b1), w2=rows(state.w2),
                   b2=state.b2.clone(), m_w1=cols(state.m_w1),
                   m_w2=rows(state.m_w2), stats=state.stats.clone())


def shard_batch(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's rows of a batch, data-sharded over ``client``."""
    n = mesh[CLIENT_AXIS].size()
    return x.chunk(n, dim=0)[mesh.get_local_rank(CLIENT_AXIS)].contiguous()


def make_sharded_train_step(mesh: DeviceMesh):
    """The distributed step, called on every rank with its blocks
    (``shard_state``, ``shard_batch``) -> (new local state, loss).

    all_reduce over SHARD for the partial activations (differentiable),
    all_reduce over CLIENT for the gradient fan-in, a point-to-point ring
    over SHARD for the stats relay. As in the JAX package, the gradients of
    w1, b1 and w2 pass back through the SHARD all_reduce and come out
    n_shard times the single-device gradient; b2's does not.
    """
    shard_group = mesh.get_group(SHARD_AXIS)
    client_group = mesh.get_group(CLIENT_AXIS)
    nc = mesh[CLIENT_AXIS].size()

    def client_mean(t: torch.Tensor) -> torch.Tensor:
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=client_group)
        return t / nc

    def step(state: PSState, x: torch.Tensor, target: torch.Tensor):
        leaves = [t.detach().requires_grad_() for t in
                  (state.w1, state.b1, state.w2, state.b2)]
        w1, b1, w2, b2 = leaves
        with torch.enable_grad():
            h = torch.relu(_mm_bf16(x, w1) + b1)
            # Merge the partition partials (PartitionChannel fan-in).
            y = _AllReduceSum.apply(_mm_bf16(h, w2), shard_group) + b2
            loss = torch.mean(torch.square(y - target))
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            # Gradient fan-in over clients (ResponseMerger = average).
            g_w1, g_b1, g_w2, g_b2 = (client_mean(g) for g in grads)
            w1n, m_w1 = momentum_update_reference(state.w1, state.m_w1, g_w1)
            w2n, m_w2 = momentum_update_reference(state.w2, state.m_w2, g_w2)
            # The batch mean is over the client-sharded batch: average over
            # clients first so every replica relays the same stats.
            batch_mean = client_mean(torch.mean(y, dim=0))
            stats = 0.9 * state.stats + 0.1 * batch_mean
            (stats,) = ring_shift([stats], shard_group)
            loss = client_mean(loss.detach())
            new_state = PSState(w1=w1n, b1=state.b1 - 0.01 * g_b1,
                                w2=w2n, b2=state.b2 - 0.01 * g_b2,
                                m_w1=m_w1, m_w2=m_w2, stats=stats)
        return new_state, loss

    return step


# ---------------------------------------------------------------------------
# The layered step (single device): the per-layer forward and top-down
# backward the overlapped step driver schedules.
# ---------------------------------------------------------------------------

def _layer_fwd(a: torch.Tensor, w: torch.Tensor, last: bool):
    z = torch.matmul(a, w)
    return (z if last else torch.relu(z)), z


def _loss_and_head_delta(pred: torch.Tensor, y: torch.Tensor):
    r = pred - y
    return torch.mean(torch.square(r)), (2.0 / r.numel()) * r


def _grad_w(a_prev: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a_prev.T, delta)


def _delta_prev(delta: torch.Tensor, w: torch.Tensor,
                z_prev: torch.Tensor) -> torch.Tensor:
    return torch.matmul(delta, w.T) * (z_prev > 0)


class LayeredMLP:
    """An L-layer MLP whose training step decomposes per layer: ``forward``
    runs the whole stack saving activations, then ``backward(ctx, name)``
    is called TOP LAYER FIRST, yielding that layer's weight gradient and
    propagating the delta one layer down. fp32 throughout; the manual
    backward equals autograd of the same stack.

    Single device only (``mesh=None``): the mesh form goes with the step
    drivers of the training plane (ROADMAP A9).
    """

    def __init__(self, sizes, mesh=None, seed: int = 0, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "LayeredMLP over a mesh is not ported yet: it comes with "
                "the training plane's step drivers (ROADMAP A9)")
        if len(sizes) < 2:
            raise ValueError("need at least one layer (two sizes)")
        self.sizes = list(sizes)
        self.mesh = None
        self.seed = seed
        self.device = resolve_device(device)
        self.names = [f"layer{k:02d}" for k in range(len(sizes) - 1)]

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            self.device)

    def init_params(self) -> dict:
        """normal / sqrt(fan-in) weights from a numpy generator seeded
        with ``seed``."""
        rng = np.random.default_rng(self.seed)
        return {name: self._tensor(
                    rng.standard_normal((self.sizes[k], self.sizes[k + 1]))
                    / np.sqrt(self.sizes[k]))
                for k, name in enumerate(self.names)}

    def data(self, batch: int, seed: int = 1):
        """A standard-normal (x, y) pair shaped for this stack, from a numpy
        generator seeded with ``seed``."""
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((batch, self.sizes[0]))
        y = rng.standard_normal((batch, self.sizes[-1]))
        return self._tensor(x), self._tensor(y)

    def place(self, name: str, arr):
        return arr

    def forward(self, params, x, y) -> dict:
        acts, zs = [x], []
        a = x
        for k, name in enumerate(self.names):
            a, z = _layer_fwd(a, params[name],
                              last=(k == len(self.names) - 1))
            zs.append(z)
            acts.append(a)
        loss, delta = _loss_and_head_delta(a, y)
        return {"acts": acts, "zs": zs, "loss": loss, "delta": delta,
                "params": dict(params), "next": len(self.names) - 1}

    def backward(self, ctx: dict, name: str):
        k = self.names.index(name)
        if k != ctx["next"]:
            raise ValueError(
                f"backward order violated: expected layer {ctx['next']}"
                f", got {name} — deltas propagate top-down only")
        delta = ctx["delta"]
        g = _grad_w(ctx["acts"][k], delta)
        if k > 0:
            ctx["delta"] = _delta_prev(delta, ctx["params"][name],
                                       ctx["zs"][k - 1])
        ctx["next"] = k - 1
        return g

    def loss(self, ctx: dict) -> float:
        return float(ctx["loss"])

    def grads(self, params, x, y):
        """The whole gradient dict in one call (the serial reference)."""
        ctx = self.forward(params, x, y)
        return {name: self.backward(ctx, name)
                for name in reversed(self.names)}, float(ctx["loss"])


# ---------------------------------------------------------------------------
# The multi-rank dry run.
# ---------------------------------------------------------------------------

def _dryrun_rank(device_type: str) -> dict:
    """One sharded step, then the single-head and the GQA causal ring, on
    this rank of the initialised group. Returns what it checked."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    mesh = make_mesh()
    n_shard = mesh[SHARD_AXIS].size()
    n_client = mesh[CLIENT_AXIS].size()
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)  # noqa: E731
    # Tiny but shard-divisible shapes.
    din, dh, dout = 16, 8 * n_shard, 8
    batch = 4 * n_client
    state = init_state(gen(0), din, dh, dout, device=dev)
    x = torch.randn(batch, din, generator=gen(1), device=dev)
    t = torch.randn(batch, dout, generator=gen(2), device=dev)
    step = make_sharded_train_step(mesh)
    new_state, loss = step(shard_state(state, mesh), shard_batch(x, mesh),
                           shard_batch(t, mesh))
    if not bool(torch.isfinite(loss)):
        raise RuntimeError("sharded step produced a non-finite loss")

    # Sequence parallelism: ring attention over the shard ring, kv blocks
    # making n_shard - 1 hops; this rank holds rows [i*s/n, (i+1)*s/n).
    i = mesh.get_local_rank(SHARD_AXIS)
    seq = 4 * n_shard
    qkv = torch.randn(3, 2, seq, 8, generator=gen(3), device=dev)
    loc = lambda a: a.chunk(n_shard, dim=-2)[i].contiguous()  # noqa: E731
    from brpc_tpu_torch.ops.ring_attention import ring_attention
    attn = ring_attention(mesh)(loc(qkv[0]), loc(qkv[1]), loc(qkv[2]))
    if not bool(torch.isfinite(attn).all()):
        raise RuntimeError("ring attention non-finite")

    # Multi-head causal ring (the LLM shape) with GQA: 4 q heads, 2 kv.
    seq = 8 * n_shard
    q_mh = torch.randn(2, 4, seq, 8, generator=gen(4), device=dev)
    kv_mh = torch.randn(2, 2, 2, seq, 8, generator=gen(5), device=dev)
    attn_mh = ring_attention(mesh, causal=True)(
        loc(q_mh), loc(kv_mh[0]), loc(kv_mh[1]))
    if tuple(attn_mh.shape) != (2, 4, seq // n_shard, 8):
        raise RuntimeError(f"mh ring shape {tuple(attn_mh.shape)}")
    if not bool(torch.isfinite(attn_mh).all()):
        raise RuntimeError("mh ring non-finite")
    return {"loss": float(loss), "attn": attn.cpu().numpy(),
            "attn_mh": attn_mh.cpu().numpy(), "mesh": (n_client, n_shard)}


def dryrun_multichip(n_devices: int, device=None) -> None:
    """ONE sharded step and the ring attention of the long-context path on
    tiny shapes over n ranks.

    Inside an initialised group of n ranks it runs on this rank. Otherwise
    it makes the group: on the CPU (``device="cpu"``) n spawned gloo ranks,
    as the JAX package fakes n devices; on CUDA (the default) one rank per
    card over NCCL — this process alone for n == 1 — and it raises when
    fewer than n cards are visible.
    """
    dev = resolve_device(device)
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) inside a group "
                             f"of {dist.get_world_size()} ranks")
        _dryrun_rank(dev.type)
        return
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs "
                           f"{n_devices} CUDA cards, "
                           f"{torch.cuda.device_count()} visible")
    if n_devices == 1:
        with one_rank_group(dev.type):
            _dryrun_rank(dev.type)
        return
    run_ranks(n_devices, _dryrun_rank, (dev.type,), device_type=dev.type)
