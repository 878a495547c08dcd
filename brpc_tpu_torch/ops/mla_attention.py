"""Causal attention for multi-head latent attention (MLA): query-key width
192, value width 128, fp32, forward and backward on the tensor cores.

``attention(q, k, v, scale)`` is the attention core of
``models/mla_moe.py``. A call the kernels take (``takes``: CUDA, fp32,
q and k ``[b, h, s, 192]``, v ``[b, h, s, 128]``, unit stride along the
width, 16-byte aligned rows) runs the autograd Function below, whose
forward and backward are the hand-written kernels of
``csrc/mla_attention.cu`` (``brpc_mla_attn_fwd``, ``brpc_mla_attn_bwd``:
3xTF32 ``mma.sync``, the forward saving each row's log-sum-exp for the
backward). Every other call keeps ``scaled_dot_product_attention``: on
CUDA its memory-efficient backend, on the CPU its math path.

The Adders ``torch_mla_attn_kernel_calls`` and ``torch_mla_attn_sdpa_calls``
count each forward and each backward by the path it took; the kernels'
share of them is the engagement rate. ``LAUNCHES_FWD`` / ``LAUNCHES_BWD``
count the launches (the backward's two kernels, D = rowsum(do * o) and
the main one, as one).

``reference`` is the plain version: the same function in plain PyTorch,
``o`` and ``lse`` from the whole score matrix.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from brpc_tpu_torch.observability import metrics
from brpc_tpu_torch.ops import _build

DQK, DV = 192, 128  # the widths the kernels are built for

LAUNCHES_FWD = _build.LaunchCounter("brpc_mla_attn_fwd")
LAUNCHES_BWD = _build.LaunchCounter("brpc_mla_attn_bwd")

_FWD_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
             + [ctypes.c_float, ctypes.c_void_p])
_BWD_ARGS = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
             + [ctypes.c_float, ctypes.c_void_p])

_calls = None


def counters() -> tuple:
    """(``torch_mla_attn_kernel_calls``, ``torch_mla_attn_sdpa_calls``)."""
    global _calls
    if _calls is None:
        _calls = (metrics.counter("torch_mla_attn_kernel_calls"),
                  metrics.counter("torch_mla_attn_sdpa_calls"))
    return _calls


def _fits(t: torch.Tensor, width: int) -> bool:
    return (t.dim() == 4 and t.shape[-1] == width and t.stride(-1) == 1
            and t.data_ptr() % 16 == 0
            and all(st % 4 == 0 for st in t.stride()[:-1]))


def layout_ok(q, k, v) -> bool:
    """The operands' part of the rule: fp32, q and k ``[b, h, s, 192]``,
    v ``[b, h, s, 128]`` of the same b, h and s, each with unit stride
    along the width, a 16-byte aligned start and its other strides whole
    16-byte units."""
    return (all(t.dtype == torch.float32 for t in (q, k, v))
            and _fits(q, DQK) and _fits(k, DQK) and _fits(v, DV)
            and q.shape[:3] == k.shape[:3] == v.shape[:3])


def takes(q, k, v) -> bool:
    """Whether the kernels take this causal call: CUDA tensors whose
    layout passes ``layout_ok``."""
    return q.device.type == "cuda" and layout_ok(q, k, v)


def _strides(*ts) -> ctypes.Array:
    vals = [st for t in ts for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def forward_kernel(q, k, v, scale: float) -> tuple:
    """``brpc_mla_attn_fwd``: (o ``[b, h, s, 128]``, lse ``[b, h, s]``),
    both contiguous fp32."""
    b, h, s, _ = q.shape
    o = q.new_empty(b, h, s, DV)
    lse = q.new_empty(b, h, s)
    fn = _build.kernel("brpc_mla_attn_fwd", _FWD_ARGS)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _strides(q, k, v),
                o.data_ptr(), lse.data_ptr(), b, h, s, scale, _stream(q))
    _build.check(rc, "brpc_mla_attn_fwd")
    LAUNCHES_FWD.add()
    return o, lse


def backward_kernel(q, k, v, o, lse, do, scale: float) -> tuple:
    """``brpc_mla_attn_bwd``: (dq, dk, dv), contiguous fp32. ``o`` and
    ``lse`` are the forward's; ``do`` is taken contiguous where its
    layout does not pass."""
    if not _fits(do, DV):
        do = do.contiguous()
    b, h, s, _ = q.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    delta = lse.new_empty(b, h, s)
    fn = _build.kernel("brpc_mla_attn_bwd", _BWD_ARGS)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), _strides(q, k, v, do),
                delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), b, h, s, scale, _stream(q))
    _build.check(rc, "brpc_mla_attn_bwd")
    LAUNCHES_BWD.add()
    return dq, dk, dv


class _Attention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = forward_kernel(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        counters()[0].add(1)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = backward_kernel(q, k, v, o, lse, do, ctx.scale)
        counters()[0].add(1)
        return dq, dk, dv, None


def _count_sdpa_backward(_grad):
    counters()[1].add(1)


def attention(q, k, v, scale: float) -> torch.Tensor:
    """Causal softmax attention at ``scale``: ``[b, h, s, 192]`` q and k,
    ``[b, h, s, 128]`` v -> ``[b, h, s, 128]``; the kernels where they
    take the call, else SDPA."""
    if takes(q, k, v):
        return _Attention.apply(q, k, v, scale)
    if q.device.type == "cuda":
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            o = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               scale=scale)
    else:
        o = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                           scale=scale)
    counters()[1].add(1)
    if o.requires_grad:
        o.register_hook(_count_sdpa_backward)
    return o


def reference(q, k, v, scale: float) -> tuple:
    """Plain PyTorch: (o, lse) of causal attention at ``scale``, from the
    whole score matrix in q's type."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    n = q.shape[-2]
    keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    return torch.matmul(torch.exp(s - lse[..., None]), v), lse
