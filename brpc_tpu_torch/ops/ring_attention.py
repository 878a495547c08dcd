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
folded where it lands. Besides its own block a rank holds at most two kv
blocks, the one it folds and the one arriving, as under XLA's
asynchronous permute.

Each hop is one ``flash_attention_carry`` (ops/flash_attention.py; the
hand-written kernel K3 on the card): the visiting kv block is folded into
the resident queries' fp32 (m, l, acc) carries, with the global q and kv
offsets of the hop from ``hop_offsets``, so causal masks stay globally
correct across shards. Numerically exact attention, not an approximation
(blockwise/ring attention, Liu et al.; the flash online softmax, Dao et
al.).
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from brpc_tpu_torch.ops.flash_attention import (flash_attention_carry,
                                                flash_finalize, flash_init)
from brpc_tpu_torch.parallel.collectives import ring_shift_start
from brpc_tpu_torch.parallel.mesh import SHARD_AXIS


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


def ring_attention(mesh: DeviceMesh, axis: str = SHARD_AXIS, *,
                   causal: bool = False, block_q: int = 1024,
                   block_k: int = 1024):
    """Builds ``fn(q, k, v) -> out`` for sequence-sharded exact attention,
    called on every rank with its local blocks.

    Local blocks: [batch, seq/n, d] (single-head) or [batch, heads, seq/n,
    d]; kv may carry fewer heads (GQA: kv_heads | heads). Rank i of the
    ``axis`` ring holds sequence rows [i*seq/n, (i+1)*seq/n). causal=True
    masks by GLOBAL position.
    """
    group = mesh.get_group(axis)
    n = mesh[axis].size()
    rank = mesh.get_local_rank(axis)

    def arriving(k_blk, v_blk):
        # Hop 0 is the resident block. Each hop's shift starts before the
        # block is handed to its fold and is waited on when the next
        # block is asked for, after that fold is enqueued; the last block
        # is folded where it lands (n-1 shifts).
        for hop in range(n):
            shift = (ring_shift_start([k_blk, v_blk], group)
                     if hop + 1 < n else None)
            yield k_blk, v_blk
            if shift is not None:
                k_blk, v_blk = shift.wait()

    def _ring4(q, k, v):  # local blocks: [b, h, seq/n, d]
        return ring_replay(q, arriving(k, v), rank, n, causal=causal,
                           block_q=block_q, block_k=block_k)

    def run(q, k, v):
        if q.dim() == 3:  # single-head convenience: [b, s, d]
            return _ring4(q[:, None], k[:, None], v[:, None])[:, 0]
        return _ring4(q.contiguous(), k.contiguous(), v.contiguous())

    return run


def dense_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """Single-device full softmax attention, [b, s, d] — the oracle."""
    scale = 1.0 / torch.sqrt(torch.tensor(q.shape[-1], dtype=q.dtype))
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale.to(q.device)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v)
