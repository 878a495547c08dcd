"""Collective transfer programs over a mesh dimension — the NCCL data plane.

The port of brpc_tpu/parallel/collectives.py. The JAX package shard_maps a
program over a global array; here each rank calls the returned function on
its own block, and the collective runs over the process group of one mesh
dimension (``mesh.get_group(axis)``): NCCL between cards, gloo on the CPU
and between ranks that share one card (``launch.run_ranks(...,
share_card=True)``). gloo takes CUDA tensors for the collective verbs
(torch 2.11: all_reduce, broadcast, gather, all_gather_into_tensor,
reduce_scatter_tensor, checked on an H100 host) and stages them through
the host inside the backend. Its point-to-point verbs hand the tensor's
data pointer to the transport as it is, so ``ring_shift_start`` stages
CUDA tensors on a gloo group through pinned host buffers itself.

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
from brpc_tpu_torch.ops._build import LaunchCounter
from brpc_tpu_torch.parallel.mesh import CLIENT_AXIS, SHARD_AXIS


class RingShift:
    """A ring shift in flight (``ring_shift_start``). It holds the tensors
    being sent until ``wait()``: none goes back to the caching allocator
    while a transfer may still read it, whatever the backend does about
    recording streams."""

    def __init__(self, out, keep, works=(), copy_back=None):
        self._out, self._keep, self._works = out, keep, list(works)
        self._copy_back = copy_back  # staged: (side stream, host buffers)

    def wait(self) -> list:
        """The received tensors, ready on the caller's current stream. On
        NCCL that stream waits for NCCL's and the host does not block; on
        gloo the host blocks until the transfer is done and, staged, the
        current stream waits for the copy back to the card."""
        if self._out is None:
            raise RuntimeError("RingShift.wait() called twice")
        for work in self._works:
            work.wait()
        if self._copy_back is not None:
            side, recv = self._copy_back
            with torch.cuda.stream(side):
                for o, r in zip(self._out, recv):
                    o.copy_(r, non_blocking=True)
            torch.cuda.current_stream(side.device).wait_stream(side)
        out = self._out
        self._out = self._keep = self._works = self._copy_back = None
        return out


# Shifts started in this process (``ring_shift_start``), read as the
# kernels' launch counts are.
SHIFTS = LaunchCounter("ring_shift_start")


def stages_through_host(backend: str, device: torch.device) -> bool:
    """Whether ``ring_shift_start`` copies the tensors through pinned host
    buffers: CUDA tensors on a gloo group (ranks that share one card).
    NCCL, and gloo on CPU tensors, move the tensors themselves."""
    return backend == "gloo" and device.type == "cuda"


def _p2p_ops(send, recv, nxt, prv, group) -> list:
    ops = []
    for t, r in zip(send, recv):
        ops.append(dist.P2POp(dist.isend, t, nxt, group))
        ops.append(dist.P2POp(dist.irecv, r, prv, group))
    return ops


class HostStage:
    """What a staged shift (``stages_through_host``) copies through: a
    side stream and one pinned host buffer a tensor each way, shaped like
    ``like``. Made once, it serves shift after shift of tensors of those
    shapes: a shift's copy out waits on the side stream behind the last
    shift's copy back, and the host waits for the copy out before the
    receive is posted."""

    def __init__(self, like):
        self.side = torch.cuda.Stream(like[0].device)
        self.send = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in like]
        self.recv = [torch.empty_like(h, pin_memory=True) for h in self.send]


def ring_shift_start(tensors, group, *, out=None,
                     stage: HostStage | None = None) -> RingShift:
    """Each rank of ``group`` sends its tensors to the next rank and
    receives the previous rank's (block i moves to (i + 1) % n), all in one
    ``batch_isend_irecv``, and returns without waiting for the transfer;
    ``wait()`` on the handle gives the received tensors: ``out`` when
    given (contiguous, shaped like ``tensors``), else fresh ones. Work the
    caller enqueues before ``wait()`` runs beside the transfer. On NCCL the
    transfer is ordered after the work already on the caller's stream
    (ProcessGroupNCCL makes its stream wait on the caller's at issue), so
    ``out`` may be a buffer that earlier work on that stream still reads.
    CUDA tensors on a gloo group (``stages_through_host``) are copied to
    the pinned buffers of ``stage`` (fresh ones if None) on its side stream
    once the caller's stream reaches the shift (the host waits for that
    copy), the host buffers are exchanged, and ``wait()`` copies the
    received ones back on the side stream."""
    n = dist.get_world_size(group)
    tensors = [t.contiguous() for t in tensors]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"ring_shift_start: tensors on {devices}")
    SHIFTS.add()
    out = ([torch.empty_like(t) for t in tensors] if out is None
           else list(out))
    if n == 1:
        for o, t in zip(out, tensors):
            o.copy_(t)
        return RingShift(out, tensors)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    dev = tensors[0].device
    if not stages_through_host(dist.get_backend(group), dev):
        works = dist.batch_isend_irecv(_p2p_ops(tensors, out, nxt, prv,
                                                group))
        return RingShift(out, tensors, works)
    stage = HostStage(tensors) if stage is None else stage
    side = stage.side
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for h, t in zip(stage.send, tensors):
            h.copy_(t, non_blocking=True)
    side.synchronize()
    works = dist.batch_isend_irecv(_p2p_ops(stage.send, stage.recv, nxt,
                                            prv, group))
    return RingShift(out, tensors + stage.send, works,
                     copy_back=(side, stage.recv))


def ring_shift(tensors, group) -> list:
    """``ring_shift_start(tensors, group).wait()``: block i moves to
    (i + 1) % n; returns fresh tensors."""
    return ring_shift_start(tensors, group).wait()


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
