"""Dequantize kernel for the quantized tensor wire format.

The receive side of the codec (brpc_tpu_torch/runtime/codec.py): codes
(int8, or fp8 e4m3 as ``torch.float8_e4m3fn``) + per-block fp32 scales ->
the logical fp32 tensor, ``out[i] = float(q[i]) * scales[i // block]``.
``dequantize_blocks`` launches the hand-written CUDA kernels
``brpc_dequant_int8`` / ``brpc_dequant_fp8e4m3`` (csrc/quantize.cu) for
CUDA tensors, replacing the Pallas kernel of brpc_tpu/ops/quantize.py;
for CPU tensors — and only for them — it computes the plain PyTorch
version, ``dequantize_reference``.
"""

from __future__ import annotations

import ctypes

import torch

from brpc_tpu_torch.ops import _build

LAUNCHES_INT8 = _build.LaunchCounter("brpc_dequant_int8")
LAUNCHES_FP8 = _build.LaunchCounter("brpc_dequant_fp8e4m3")

_KERNELS = {torch.int8: ("brpc_dequant_int8", LAUNCHES_INT8),
            torch.float8_e4m3fn: ("brpc_dequant_fp8e4m3", LAUNCHES_FP8)}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_void_p]


def _nblocks(n: int, block: int) -> int:
    return max(1, -(-n // block))


def dequantize_reference(q: torch.Tensor, scales: torch.Tensor, *,
                         block: int, n: int, shape) -> torch.Tensor:
    """Plain PyTorch: widen the codes, then one multiply by the block's
    scale (the partial tail block takes the last scale)."""
    out = q.reshape(-1).to(torch.float32, copy=True)
    nfull = n // block
    if nfull:
        out[:nfull * block].view(nfull, block).mul_(
            scales[:nfull].reshape(nfull, 1))
    if n % block:
        out[nfull * block:].mul_(scales[nfull])
    return out.reshape(tuple(shape))


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor, *, block: int,
                      n: int, shape) -> torch.Tensor:
    """codes (n,) + scales (ceil(n/block),) -> fp32 tensor of ``shape``."""
    if q.device != scales.device:
        raise ValueError(f"codes on {q.device}, scales on {scales.device}")
    if q.numel() != n:
        raise ValueError(f"dequantize_blocks: {q.numel()} codes, n={n}")
    if block <= 0:
        raise ValueError(f"dequantize_blocks: block={block}")
    if scales.numel() != _nblocks(n, block):
        raise ValueError(f"dequantize_blocks: {scales.numel()} scales for "
                         f"{_nblocks(n, block)} blocks")
    if q.device.type == "cpu":
        return dequantize_reference(q, scales, block=block, n=n, shape=shape)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _KERNELS:
        raise TypeError(f"dequantize_blocks: codes are {q.dtype}; the "
                        "kernels take torch.int8 or torch.float8_e4m3fn")
    if scales.dtype != torch.float32:
        raise TypeError(f"dequantize_blocks: scales are {scales.dtype}; "
                        "the kernels take torch.float32")
    if not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError("dequantize_blocks: codes and scales must be "
                         "contiguous")
    name, counter = _KERNELS[q.dtype]
    out = torch.empty(tuple(shape), dtype=torch.float32, device=q.device)
    if out.numel() != n:
        raise ValueError(f"dequantize_blocks: shape {tuple(shape)} does not "
                         f"hold n={n}")
    if n == 0:
        return out
    fn = _build.kernel(name, _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), scales.data_ptr(), out.data_ptr(), n, block,
                stream)
    _build.check(rc, name)
    counter.add()
    return out
