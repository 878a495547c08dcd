"""Fused SGD-with-momentum update — the parameter server's Push kernel.

``fused_momentum_update`` launches the hand-written CUDA kernel
``brpc_fused_momentum`` (csrc/fused_update.cu; ``_f16`` and ``_bf16`` for
half precision) for CUDA tensors: one pass reading (p, m, g) and writing
fresh (p', m') — out of place, so tensors already handed to a concurrent
pull stay immutable. It replaces the Pallas kernel of
brpc_tpu/ops/fused_update.py, which takes any float dtype. For CPU
tensors — and only for them — it computes the plain PyTorch version,
``momentum_update_reference``.

Half precision rounds as the JAX package's parameter server does on its
numpy path (and as its jitted bf16 kernel does): ``lr`` and ``beta`` are
rounded to the parameter dtype, and every operation is rounded to it
before the next one. float64 is refused on CUDA: the JAX package runs
without x64, so its servers never hold it.
"""

from __future__ import annotations

import ctypes

import torch

from brpc_tpu_torch.ops import _build

# One launch count per dtype's kernel.
LAUNCHES = _build.LaunchCounter("brpc_fused_momentum")
LAUNCHES_F16 = _build.LaunchCounter("brpc_fused_momentum_f16")
LAUNCHES_BF16 = _build.LaunchCounter("brpc_fused_momentum_bf16")
_KERNELS = {torch.float32: LAUNCHES, torch.float16: LAUNCHES_F16,
            torch.bfloat16: LAUNCHES_BF16}

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_float,
                                     ctypes.c_float, ctypes.c_void_p]


def _half(dtype: torch.dtype) -> bool:
    return dtype in (torch.float16, torch.bfloat16)


def _constant(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` — the scalar a half-precision update
    multiplies by (exact in the kernel's float argument)."""
    return float(torch.tensor(x, dtype=dtype)) if _half(dtype) else x


def momentum_update_reference(p, m, g, *, lr: float = 0.01,
                              beta: float = 0.9):
    """Plain PyTorch: ``m' = beta*m + g``, ``p' = p - lr*m'`` -> (p', m').
    For fp16/bf16 the constants are 0-dim tensors of the dtype and each
    operation is its own, rounded to the dtype."""
    if _half(p.dtype):
        b = torch.tensor(beta, dtype=p.dtype, device=p.device)
        lr_t = torch.tensor(lr, dtype=p.dtype, device=p.device)
        m2 = torch.add(torch.mul(b, m), g)
        return torch.sub(p, torch.mul(lr_t, m2)), m2
    m2 = beta * m + g
    return p - lr * m2, m2


def fused_momentum_update(p: torch.Tensor, m: torch.Tensor,
                          g: torch.Tensor, *, lr: float = 0.01,
                          beta: float = 0.9):
    """SGD with momentum on tensors of any shape: returns fresh (p', m')."""
    devices = {p.device, m.device, g.device}
    if len(devices) != 1:
        raise ValueError(f"p, m, g on different devices: {devices}")
    dtypes = {p.dtype, m.dtype, g.dtype}
    if len(dtypes) != 1:
        raise TypeError(f"fused_momentum_update: p, m, g have dtypes "
                        f"{p.dtype}, {m.dtype}, {g.dtype}; they must agree")
    if p.device.type == "cpu":
        return momentum_update_reference(p, m, g, lr=lr, beta=beta)
    if p.device.type != "cuda":
        raise ValueError(f"unsupported device {p.device}")
    if p.dtype not in _KERNELS:
        raise TypeError(f"fused_momentum_update: {p.dtype}; the kernel "
                        "takes torch.float32, torch.float16 and "
                        "torch.bfloat16")
    for t, what in ((p, "p"), (m, "m"), (g, "g")):
        if t.shape != p.shape:
            raise ValueError(f"fused_momentum_update: {what} has shape "
                             f"{tuple(t.shape)}, p has {tuple(p.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"fused_momentum_update: {what} is not "
                             "contiguous")
    p_out = torch.empty_like(p)
    m_out = torch.empty_like(m)
    if p.numel() == 0:
        return p_out, m_out
    counter = _KERNELS[p.dtype]
    fn = _build.kernel(counter.name, _ARGTYPES)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    with torch.cuda.device(p.device):
        rc = fn(p.data_ptr(), m.data_ptr(), g.data_ptr(), p_out.data_ptr(),
                m_out.data_ptr(), p.numel(), _constant(lr, p.dtype),
                _constant(beta, p.dtype), stream)
    _build.check(rc, counter.name)
    counter.add()
    return p_out, m_out
