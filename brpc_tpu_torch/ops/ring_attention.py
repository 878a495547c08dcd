"""Ring attention: exact attention over a sequence-sharded mesh dimension.

The long-context primitive. Sequence length S is sharded S/N per rank on
the ``shard`` dimension; queries stay resident while key/value blocks
rotate around the ring by point-to-point sends (``batch_isend_irecv``, the
port of ``jax.lax.ppermute``). After N-1 hops every query has attended to
every key, and only one S/N-sized kv block is in flight per rank.

The reference's schedule: its unrolled loop lets XLA run each hop's
permute beside the previous fold, since the permute reads only the block
the last hop delivered. Here the send of hop t+1 is started
(``ring_shift_start``) before fold t is enqueued and waited on after it,
so the transfer runs under the fold; n-1 shifts in all, the last block
folded where it lands. A rank's K and V block travel packed in one
buffer (``pack_kv``: V's half on a 256-byte boundary), so a hop is one
send and one receive, into two buffers made once a call and used in
turn: besides its own block a rank holds at most two kv blocks, the one
it folds and the one arriving, as under XLA's asynchronous permute.

The reference jits the whole ring into one program. Its counterpart here
is a CUDA graph: on an NCCL group the function ``ring_attention`` returns
runs a shape's first call eagerly (which also makes NCCL's
communicators), captures the whole program on the second (the packing,
n-1 shifts, n folds and the finalize) and replays it from then on, one
host call for the ring. It keeps the graph of the last shape only. CPU
tensors, gloo groups (ranks sharing a card) and one-rank groups run the
eager schedule (``_ring_eager``).

Each hop is one ``flash_attention_carry`` (ops/flash_attention.py; the
hand-written kernel K3 on the card): the visiting kv block is folded into
the resident queries' fp32 (m, l, acc) carries, with the global q and kv
offsets of the hop from ``hop_offsets``, so causal masks stay globally
correct across shards. Numerically exact attention, not an approximation
(blockwise/ring attention, Liu et al.; the flash online softmax, Dao et
al.).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from brpc_tpu_torch.ops import flash_attention as _fa
from brpc_tpu_torch.ops.flash_attention import (flash_attention_carry,
                                                flash_finalize, flash_init)
from brpc_tpu_torch.parallel.collectives import (SHIFTS, HostStage,
                                                 ring_shift_start,
                                                 stages_through_host)
from brpc_tpu_torch.parallel.mesh import SHARD_AXIS

# V's half of a packed kv buffer starts on this boundary.
KV_ALIGN = 256


def hop_offsets(rank: int, hop: int, n: int, sq: int) -> tuple:
    """(q_off, kv_off) of ring hop ``hop`` on ``rank`` of an n-rank ring
    with sq rows per shard: after ``hop`` rotations the rank holds the kv
    block of rank (rank - hop) mod n."""
    return rank * sq, ((rank - hop) % n) * sq


def ring_replay(q, blocks, rank: int, n: int, *, causal: bool = False,
                block_q: int = 1024, block_k: int = 1024) -> torch.Tensor:
    """The folds of ``ring_attention`` on ``rank`` of an n-rank ring:
    ``q`` is the rank's [batch, heads, seq/n, d] query block, ``blocks``
    yields the (k, v) block of each hop in hop order (hop t's is rank
    (rank - t) % n's). Given the blocks in one process, with no transfer,
    it is the serialized replay the ring equals bit for bit."""
    b, h, sq, d = q.shape
    m, l, acc = flash_init(b, h, sq, d, device=q.device)
    for hop, (k_blk, v_blk) in enumerate(blocks):
        m, l, acc = flash_attention_carry(
            q, k_blk, v_blk, m, l, acc, hop_offsets(rank, hop, n, sq),
            causal=causal, block_q=min(block_q, sq),
            block_k=min(block_k, sq))
    return flash_finalize(l, acc, q.dtype)


def pack_kv(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """k and v ([b, hkv, s, d], one dtype) copied into one flat buffer
    [2, half]: K's elements first, V's from element ``half``, the first
    multiple of ``KV_ALIGN`` bytes past K's, so both halves are as aligned
    as the buffer (the caching allocator's 512 bytes) whatever k's size.
    ``unpack_kv`` gives the two contiguous views."""
    per = KV_ALIGN // k.element_size()
    half = -(-k.numel() // per) * per
    kv = torch.empty((2, half), dtype=k.dtype, device=k.device)
    for i, t in enumerate((k, v)):
        kv[i, :t.numel()].view(t.shape).copy_(t)
    return kv


def unpack_kv(kv: torch.Tensor, shape) -> tuple:
    """The K and V views of a ``pack_kv`` buffer, each of ``shape``."""
    numel = math.prod(shape)
    return kv[0, :numel].view(shape), kv[1, :numel].view(shape)


def _arriving(kv, shape, group, n: int):
    """The (k, v) views of each hop's block, in hop order. Hop 0 is the
    resident block. Each hop's shift starts before the block is handed to
    its fold and is waited on when the next block is asked for, after
    that fold is enqueued; the last block is folded where it lands (n-1
    shifts). Hop t+1 receives into buffer t % 2. Hop t+2's receive reuses
    the buffer hop t+1 sent and fold t+1 read: it is issued after fold
    t+1 is enqueued and after hop t+1's transfer was waited on, and the
    transfer is ordered after the caller's stream (``ring_shift_start``);
    staged, its copy back runs on a side stream that waited on the
    caller's when the shift started."""
    slots = [torch.empty_like(kv) for _ in range(min(n - 1, 2))]
    stage = (HostStage([kv]) if n > 1 and stages_through_host(
        dist.get_backend(group), kv.device) else None)
    for hop in range(n):
        shift = (ring_shift_start([kv], group, out=[slots[hop % 2]],
                                  stage=stage) if hop + 1 < n else None)
        yield unpack_kv(kv, shape)
        if shift is not None:
            (kv,) = shift.wait()


def _ring_eager(q, k, v, group, rank: int, n: int, *, causal: bool = False,
                block_q: int = 1024, block_k: int = 1024) -> torch.Tensor:
    """One rank's ring, run eagerly: q [b, h, seq/n, d], k and v [b, hkv,
    seq/n, d], contiguous. Every rank of ``group`` calls it together."""
    return ring_replay(q, _arriving(pack_kv(k, v), k.shape, group, n), rank,
                       n, causal=causal, block_q=block_q, block_k=block_k)


# The counts a ring's replay adds: what its capture recorded.
_COUNTERS = (_fa.LAUNCHES, _fa.LAUNCHES_TF32X3, SHIFTS)


class _RingGraph:
    """One shape's ring captured as a CUDA graph: static inputs, the
    program recorded once on them, and the launch counts that recording
    made. Capturing launches nothing, so the counts it made are taken back
    and each replay, which launches those kernels, adds them. Nothing
    here falls back to the eager schedule: a capture or a replay that
    fails raises."""

    def __init__(self, program, q, k, v):
        self.inputs = [t.clone() for t in (q, k, v)]
        before = [c.value for c in _COUNTERS]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph,
                              capture_error_mode="thread_local"):
            self.out = program(*self.inputs)
        self.counts = [c.value - b for c, b in zip(_COUNTERS, before)]
        for c, d in zip(_COUNTERS, self.counts):
            c.add(-d)

    def __call__(self, q, k, v) -> torch.Tensor:
        for dst, src in zip(self.inputs, (q, k, v)):
            dst.copy_(src)
        self.graph.replay()
        for c, d in zip(_COUNTERS, self.counts):
            c.add(d)
        return self.out.clone()


class _LastRing:
    """The last key a ring closure was called with on NCCL, and its
    captured ring (None until that key's second call)."""

    key = None
    graph: _RingGraph | None = None


def ring_attention(mesh: DeviceMesh, axis: str = SHARD_AXIS, *,
                   causal: bool = False, block_q: int = 1024,
                   block_k: int = 1024):
    """Builds ``fn(q, k, v) -> out`` for sequence-sharded exact attention,
    called on every rank with its local blocks.

    Local blocks: [batch, seq/n, d] (single-head) or [batch, heads, seq/n,
    d]; kv may carry fewer heads (GQA: kv_heads | heads). Rank i of the
    ``axis`` ring holds sequence rows [i*seq/n, (i+1)*seq/n). causal=True
    masks by GLOBAL position.

    On an NCCL group of two or more ranks with CUDA tensors, ``fn`` keeps a
    CUDA graph of the ring for the last key (shapes, dtype, device) it was
    called with: a key's first call runs eagerly, the second captures and
    replays, later ones copy the inputs into the graph's and replay; each
    returns a fresh tensor. A call with another key drops the graph, and
    the memory pool it holds, and starts over with that key, so shapes
    called in turn run eagerly. Every rank calls ``fn`` in the same order,
    as for any collective, so the ranks capture together. ``fn.cache``
    holds the last key and its ``_RingGraph`` (None until captured).
    """
    group = mesh.get_group(axis)
    n = mesh[axis].size()
    rank = mesh.get_local_rank(axis)
    cache = _LastRing()

    def program(q, k, v):
        return _ring_eager(q, k, v, group, rank, n, causal=causal,
                           block_q=block_q, block_k=block_k)

    def _ring4(q, k, v):  # local blocks: [b, h, seq/n, d]
        if (n == 1 or q.device.type != "cuda"
                or dist.get_backend(group) != "nccl"):
            return program(q, k, v)
        key = (tuple(q.shape), tuple(k.shape), q.dtype, q.device)
        if key != cache.key:
            cache.key, cache.graph = key, None
            return program(q, k, v)
        if cache.graph is None:
            cache.graph = _RingGraph(program, q, k, v)
        return cache.graph(q, k, v)

    def run(q, k, v):
        if q.dim() == 3:  # single-head convenience: [b, s, d]
            return _ring4(q[:, None], k[:, None], v[:, None])[:, 0]
        return _ring4(q.contiguous(), k.contiguous(), v.contiguous())

    run.cache = cache
    return run


def dense_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """Single-device full softmax attention, [b, s, d] — the oracle."""
    scale = 1.0 / torch.sqrt(torch.tensor(q.shape[-1], dtype=q.dtype))
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale.to(q.device)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v)
