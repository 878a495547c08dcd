"""Collective transfer programs over a mesh dimension — the NCCL data plane.

The port of brpc_tpu/parallel/collectives.py. The JAX package shard_maps a
program over a global array; here each rank calls the returned function on
its own block, and the collective runs over the process group of one mesh
dimension (``mesh.get_group(axis)``): NCCL between cards, gloo on the CPU
and between ranks that share one card (``launch.run_ranks(...,
share_card=True)``). gloo takes CUDA tensors for every verb here (torch
2.11: all_reduce, broadcast, gather, all_gather_into_tensor,
reduce_scatter_tensor, checked on an H100 host) and stages them through
the host inside the backend, so no verb moves a tensor itself.

- ParallelChannel broadcast + ResponseMerger -> ``fanout_gather`` (all_gather)
  / ``fanout_reduce`` (all_reduce)
- the same merge delivered to one caller       -> ``gather_to`` (gather)
- one rank's reply fanned out to every rank   -> ``broadcast_from``
- the bandwidth-optimal half of that merge    -> ``reduce_scatter``
- Streaming RPC's windowed relay              -> ``ring_stream`` (point-to-
  point ring by ``batch_isend_irecv``)
- DynamicPartitionChannel's regrouping        -> ``all_to_all_reshard``
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from brpc_tpu_torch.collectives.ring import chunk_spans
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


def gather_to(mesh: DeviceMesh, axis: str = SHARD_AXIS, dst: int = 0):
    """Every rank of ``axis`` contributes its block of a tensor split
    along ``dim`` by the ``chunk_spans`` layout of ``total`` (the first
    ``total % n`` blocks one longer); global rank ``dst`` (a member of
    this rank's ``axis`` group) gets the blocks concatenated in rank
    order, every other rank None — the merge delivered to the one caller
    that needs it. Each block is padded to the longest for the transfer
    and trimmed after."""
    group = mesh.get_group(axis)

    def _gather(x: torch.Tensor, dim: int, total: int):
        n = dist.get_world_size(group)
        lengths = [ln for _off, ln in chunk_spans(total, n)]
        if x.shape[dim] != lengths[dist.get_rank(group)]:
            raise ValueError(f"gather_to: block of {x.shape[dim]} along "
                             f"dim {dim}, the layout gives "
                             f"{lengths[dist.get_rank(group)]}")
        longest = max(lengths)
        x = x.contiguous()
        if x.shape[dim] < longest:
            pad = list(x.shape)
            pad[dim] = longest - x.shape[dim]
            x = torch.cat([x, x.new_zeros(pad)], dim=dim)
        parts = ([torch.empty_like(x) for _ in range(n)]
                 if dist.get_rank() == dst else None)
        dist.gather(x, parts, dst=dst, group=group)
        if parts is None:
            return None
        return torch.cat([p.narrow(dim, 0, ln)
                          for p, ln in zip(parts, lengths)], dim=dim)

    return _gather


def broadcast_from(mesh: DeviceMesh, src: int = 0):
    """Global rank ``src``'s tensor to every rank of the mesh, which spans
    the whole process group (``make_mesh``): each rank passes a tensor of
    the same shape and dtype, filled in place on all but ``src``."""
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"broadcast_from: the mesh holds {mesh.size()} of "
                         f"{dist.get_world_size()} ranks")

    def _bcast(x: torch.Tensor) -> torch.Tensor:
        if not x.is_contiguous():
            raise ValueError("broadcast_from: fills a contiguous tensor")
        dist.broadcast(x, src=src)
        return x

    return _bcast


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
