"""Collective transfer programs over a mesh dimension — the NCCL data plane.

The port of brpc_tpu/parallel/collectives.py. The JAX package shard_maps a
program over a global array; here each rank calls the returned function on
its own block, and the collective runs over the process group of one mesh
dimension (``mesh.get_group(axis)``): NCCL between cards, gloo on the CPU.

- ParallelChannel broadcast + ResponseMerger -> ``fanout_gather`` (all_gather)
  / ``fanout_reduce`` (all_reduce)
- the bandwidth-optimal half of that merge    -> ``reduce_scatter``
- Streaming RPC's windowed relay              -> ``ring_stream`` (point-to-
  point ring by ``batch_isend_irecv``)
- DynamicPartitionChannel's regrouping        -> ``all_to_all_reshard``
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from brpc_tpu_torch.parallel.mesh import CLIENT_AXIS, SHARD_AXIS


def ring_shift(tensors, group) -> list:
    """Each rank of ``group`` sends its tensors to the next rank and
    receives the previous rank's (block i moves to (i + 1) % n), all in one
    ``batch_isend_irecv``. Returns fresh tensors."""
    n = dist.get_world_size(group)
    tensors = [t.contiguous() for t in tensors]
    if n == 1:
        return [t.clone() for t in tensors]
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    out = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, r in zip(tensors, out):
        ops.append(dist.P2POp(dist.isend, t, nxt, group))
        ops.append(dist.P2POp(dist.irecv, r, prv, group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def fanout_gather(mesh: DeviceMesh, axis: str = SHARD_AXIS):
    """Every rank of ``axis`` contributes its block; every rank gets the
    blocks concatenated along dim 0 in rank order — ParallelChannel with a
    concatenating ResponseMerger."""
    group = mesh.get_group(axis)

    def _gather(x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        n = dist.get_world_size(group)
        out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    return _gather


def fanout_reduce(mesh: DeviceMesh, axis: str = CLIENT_AXIS):
    """Fan-out with a summing ResponseMerger: every rank of ``axis``
    contributes its block, all see the sum (gradient aggregation shape)."""
    group = mesh.get_group(axis)

    def _reduce(x: torch.Tensor) -> torch.Tensor:
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    return _reduce


def reduce_scatter(mesh: DeviceMesh, axis: str = CLIENT_AXIS):
    """Sum the blocks of ``axis`` but leave the sum split along dim 0: rank
    i keeps rows [i*r/n, (i+1)*r/n) — merge once, deliver shard-local."""
    group = mesh.get_group(axis)

    def _rs(x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        n = dist.get_world_size(group)
        if x.shape[0] % n:
            raise ValueError(f"reduce_scatter: {x.shape[0]} rows over {n} "
                             "ranks")
        out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, x, group=group)
        return out

    return _rs


def ring_stream(mesh: DeviceMesh, hops: int = 1, axis: str = SHARD_AXIS):
    """Move each rank's block ``hops`` steps around the ring of ``axis``:
    after k hops rank i holds rank (i - k) % n's block."""
    group = mesh.get_group(axis)

    def _stream(x: torch.Tensor) -> torch.Tensor:
        for _ in range(hops):
            (x,) = ring_shift([x], group)
        return x

    return _stream


def all_to_all_reshard(mesh: DeviceMesh, axis: str = SHARD_AXIS):
    """Repartition: each rank splits its [r, c] block into n column pieces
    and trades them, ending with the [n*r, c/n] block of the pieces it was
    sent, stacked in rank order — one all_to_all."""
    group = mesh.get_group(axis)

    def _a2a(x: torch.Tensor) -> torch.Tensor:
        n = dist.get_world_size(group)
        r, c = x.shape[0], x.shape[1]
        if c % n:
            raise ValueError(f"all_to_all_reshard: {c} columns over {n} "
                             "ranks")
        pieces = x.reshape(r, n, c // n, *x.shape[2:]).transpose(0, 1)
        pieces = pieces.contiguous()  # [n, r, c/n, ...]: piece j -> rank j
        out = torch.empty_like(pieces)
        dist.all_to_all_single(out, pieces, group=group)
        return out.reshape(n * r, c // n, *x.shape[2:])

    return _a2a
