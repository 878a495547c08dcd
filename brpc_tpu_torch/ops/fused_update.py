"""Fused SGD-with-momentum update — the parameter server's Push kernel.

``fused_momentum_update`` launches the hand-written CUDA kernel
``brpc_fused_momentum`` (csrc/fused_update.cu) for CUDA tensors: one pass
reading (p, m, g) and writing fresh (p', m') — out of place, so tensors
already handed to a concurrent pull stay immutable. It replaces the
Pallas kernel of brpc_tpu/ops/fused_update.py. For CPU tensors — and only
for them — it computes the plain PyTorch version,
``momentum_update_reference``.
"""

from __future__ import annotations

import ctypes

import torch

from brpc_tpu_torch.ops import _build

LAUNCHES = _build.LaunchCounter("brpc_fused_momentum")

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_float,
                                     ctypes.c_float, ctypes.c_void_p]


def momentum_update_reference(p, m, g, *, lr: float = 0.01,
                              beta: float = 0.9):
    """Plain PyTorch: ``m' = beta*m + g``, ``p' = p - lr*m'`` -> (p', m')."""
    m2 = beta * m + g
    return p - lr * m2, m2


def fused_momentum_update(p: torch.Tensor, m: torch.Tensor,
                          g: torch.Tensor, *, lr: float = 0.01,
                          beta: float = 0.9):
    """SGD with momentum on tensors of any shape: returns fresh (p', m')."""
    devices = {p.device, m.device, g.device}
    if len(devices) != 1:
        raise ValueError(f"p, m, g on different devices: {devices}")
    if p.device.type == "cpu":
        return momentum_update_reference(p, m, g, lr=lr, beta=beta)
    if p.device.type != "cuda":
        raise ValueError(f"unsupported device {p.device}")
    for t, what in ((p, "p"), (m, "m"), (g, "g")):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_momentum_update: {what} is {t.dtype}; "
                            "the kernel takes torch.float32")
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
    fn = _build.kernel("brpc_fused_momentum", _ARGTYPES)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    with torch.cuda.device(p.device):
        rc = fn(p.data_ptr(), m.data_ptr(), g.data_ptr(), p_out.data_ptr(),
                m_out.data_ptr(), p.numel(), lr, beta, stream)
    _build.check(rc, "brpc_fused_momentum")
    LAUNCHES.add()
    return p_out, m_out
