"""Device tensors crossing between a step's compute lane and its wire lanes.

``step_sched.run_graph`` runs compute nodes on the caller's thread and
wire nodes on worker threads. On CUDA each wire lane runs on a stream of
its own (``lane_stream``), so a D2H a wire node issues never queues
behind the backward kernels the compute lane enqueues after it. A tensor
crosses lanes explicitly:

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

import torch


def _cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def lane_stream(device):
    """A zero-arg factory of context managers: each call enters a fresh
    stream of ``device`` (from torch's stream pool) when it is a CUDA
    device, and nothing otherwise — one per wire lane."""
    if not _cuda(device):
        return contextlib.nullcontext
    dev = torch.device(device)

    def ctx():
        return torch.cuda.stream(torch.cuda.Stream(dev))
    return ctx


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
