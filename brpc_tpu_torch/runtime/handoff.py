"""Device tensors crossing between a step's compute lane and its wire lanes.

``step_sched.run_graph`` runs compute nodes on the caller's thread and
wire nodes on worker threads. On CUDA each wire lane runs on a stream of
its own (``LaneStreams``), so a D2H a wire node issues never queues
behind the backward kernels the compute lane enqueues after it. A
driver keeps its lanes' streams for its lifetime: the caching allocator
keeps freed blocks per stream, so a lane on a new stream every step
finds none of the last step's blocks and allocates its tensors (the
pulled weights) with fresh ``cudaMalloc`` calls, which hold up the
other threads' CUDA calls while they run. A tensor crosses lanes
explicitly:

  * ``publish(t)`` — compute lane, after producing ``t``: waits for the
    current stream, so ``t`` is complete before any wire lane can see it
    and the compute node's span is its kernels' time (what
    ``jax.block_until_ready`` does in the JAX package's drivers; the
    step accounting in ``step_sched.RunTrace`` is lane time on the host,
    and this keeps it so). A wire lane therefore needs no event: what it
    is handed is already done;
  * ``adopt(t)`` — the other lane, before reading ``t`` (a wire lane's
    copy of a gradient, the compute lane's use of a pulled or received
    tensor or of masters a wire lane installed): marks ``t`` in use by
    the current stream (``record_stream``), so the allocator never hands
    its memory to another stream while that stream may still read it;
  * ``settle()`` — wire lane, after producing device tensors: waits for
    the lane's stream, so a tensor the lane hands over is complete.

On the CPU each of these is a no-op.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from brpc_tpu_torch.runtime.step_sched import current_lane


def _cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


class LaneStreams:
    """The CUDA streams of one driver's wire lanes: one per lane name,
    created on first use and kept for the driver's lifetime (nothing on
    a CPU device)."""

    def __init__(self, device):
        self.device = torch.device(device) if _cuda(device) else None
        self._streams = {}  # lane name -> torch.cuda.Stream
        self._mu = threading.Lock()

    def ctx(self):
        """A context manager for ``run_graph``'s ``wire_ctx``: on a wire
        lane's thread it enters that lane's stream
        (``step_sched.current_lane()``); ``nullcontext`` on the CPU."""
        if self.device is None:
            return contextlib.nullcontext()
        lane = current_lane()
        with self._mu:
            stream = self._streams.get(lane)
            if stream is None:
                stream = self._streams[lane] = torch.cuda.Stream(self.device)
        return torch.cuda.stream(stream)


def publish(t: torch.Tensor) -> torch.Tensor:
    """Wait for the current stream of ``t``'s device (a compute lane's),
    so ``t`` is complete; returns it."""
    if t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()
    return t


def adopt(t: torch.Tensor) -> torch.Tensor:
    """Mark a tensor another stream produced or will read as in use by
    the current one; returns it."""
    if t.device.type == "cuda":
        t.record_stream(torch.cuda.current_stream(t.device))
    return t


def settle(device) -> None:
    """Wait for the current stream of ``device`` (a wire lane's)."""
    if _cuda(device):
        torch.cuda.current_stream(torch.device(device)).synchronize()
