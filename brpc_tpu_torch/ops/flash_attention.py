"""Flash attention: block-tiled online softmax with explicit fp32 carries.

The device-side hot op of the long-context path. ``flash_attention_carry``
folds one k/v block into a running (m, l, acc) triple — block max,
normalizer, weighted accumulator — for the queries q, with the global q and
kv positions as runtime offsets, so a ring can fold every visiting kv shard
into the resident queries' state (ops/ring_attention.py). Multi-head
[b, h, s, d], causal masking by global position, grouped-query attention
(kv heads divide q heads).

For CUDA tensors ``flash_attention_carry`` launches the hand-written
kernel ``brpc_flash_carry`` (csrc/flash_attention.cu), which replaces the
Pallas kernel of brpc_tpu/ops/flash_attention.py; for CPU tensors — and
only for them — it computes the plain PyTorch version,
``flash_carry_reference``. Masking uses a large finite negative (not
-inf), so exp(m_prev - m_new) at the never-attended state is exactly 0 and
never NaN, and lanes with no legal key keep p == 0 by an explicit select.
"""

from __future__ import annotations

import ctypes

import torch

from brpc_tpu_torch.ops import _build
from brpc_tpu_torch.utils.device import resolve_device

_NEG = -1e30  # "never attended" sentinel: finite so corrections stay 0, not NaN

LAUNCHES = _build.LaunchCounter("brpc_flash_carry")
# The launches of brpc_flash_carry that went to its fp32 tensor-core kernel
# (each also counts in LAUNCHES).
LAUNCHES_TF32X3 = _build.LaunchCounter("brpc_flash_carry:flash_tf32x3_kernel")

_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
             + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
_DTYPES = (torch.float32, torch.bfloat16)
# brpc_flash_route's answers, in its order.
KERNELS = ("flash_simt_kernel", "flash_ws_kernel", "flash_tf32x3_kernel")
_TF32X3 = KERNELS.index("flash_tf32x3_kernel")


def _ask(name: str, q, k, v, acc, acc_out=None) -> int:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: q is on {q.device}; the kernel's choice "
                         "exists for CUDA tensors only")
    fn = _build.kernel(name, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2)
    # acc stands in for acc_out unless given, which the wrapper allocates
    # fresh (the caching allocator aligns it to 512 bytes).
    out = acc if acc_out is None else acc_out
    return int(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(),
                  out.data_ptr(), q.shape[-1],
                  int(q.dtype == torch.bfloat16)))


def kernel_tile_k(q, k, v, acc) -> int:
    """Keys per tile that the CUDA kernel walks for these operands, as the
    kernel's own dispatch (``brpc_flash_tile_k``) picks it: 128 on its bf16
    tensor-core path, 64 on its fp32 tensor-core path (32 at d > 128), 32
    on its SIMT path. The plain version run with ``block_k`` equal to it
    and ``ragged_tail=True`` steps the running max and rounds p where the
    kernel does. CUDA tensors only: CPU tensors have no kernel."""
    return _ask("brpc_flash_tile_k", q, k, v, acc)


def kernel_name(q, k, v, acc) -> str:
    """The kernel of ``brpc_flash_carry`` that takes these operands, by the
    kernel's own dispatch (``brpc_flash_route``): one of ``KERNELS``. CUDA
    tensors only."""
    return KERNELS[_ask("brpc_flash_route", q, k, v, acc)]


def simt_launches(d: int) -> int:
    """Launches of ``flash_simt_kernel`` one fold at width d takes on the
    current card (``brpc_flash_simt_launches``): 1 while a block's shared
    memory holds Q, K, V and acc at d, else one a column chunk of acc,
    each chunk recomputing the scores."""
    return int(_build.kernel("brpc_flash_simt_launches", [ctypes.c_int])(d))


def _pick_block(seq: int, want: int) -> int:
    b = min(want, seq)
    while seq % b != 0:
        b //= 2
    return max(b, 1)


def _offset_ints(offsets) -> tuple:
    """(q_off, kv_off) as host ints; reads a device tensor back (the plain
    version only: the kernel reads a device tensor on the card)."""
    if isinstance(offsets, torch.Tensor):
        q_off, kv_off = (int(x) for x in offsets.reshape(-1).tolist())
        return q_off, kv_off
    q_off, kv_off = offsets
    return int(q_off), int(kv_off)


def _check(q, k, v, m, l, acc, offsets) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_carry: q, k, v must be "
                         "[b, h, s, d]")
    b, h, sq, d = q.shape
    kb, hkv, sk, kd = k.shape
    if tuple(v.shape) != tuple(k.shape) or kb != b or kd != d:
        raise ValueError(f"flash_attention_carry: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    if hkv == 0 or h % hkv != 0:
        raise ValueError(f"flash_attention_carry: {h} q heads are not a "
                         f"multiple of {hkv} kv heads")
    if tuple(m.shape) != (b, h, sq, 1) or tuple(l.shape) != (b, h, sq, 1):
        raise ValueError(f"flash_attention_carry: m {tuple(m.shape)} and l "
                         f"{tuple(l.shape)} must be {(b, h, sq, 1)}")
    if tuple(acc.shape) != (b, h, sq, d):
        raise ValueError(f"flash_attention_carry: acc {tuple(acc.shape)} "
                         f"must be {(b, h, sq, d)}")
    if isinstance(offsets, torch.Tensor):
        if offsets.numel() != 2:
            raise ValueError("flash_attention_carry: offsets must hold 2 "
                             "values (q position, kv position)")
    elif len(offsets) != 2:
        raise ValueError("flash_attention_carry: offsets must be 2 ints")


def flash_carry_reference(q, k, v, m, l, acc, offsets, *,
                          causal: bool = False, block_q: int = 1024,
                          block_k: int = 1024, ragged_tail: bool = False):
    """Plain PyTorch: the k/v walk of the TPU kernel, block by block.

    ``block_k`` sets where p is rounded and the running max steps, as in
    the TPU kernel, which halves it until it divides sk. With
    ``ragged_tail=True`` the walk takes ``block_k`` keys a block and a
    shorter last one, as the CUDA kernels walk their tiles (for holding a
    kernel against this version). ``block_q`` changes no result (a skipped
    causal block is a no-op on the carries) and is kept for the same
    signature. Blocks wholly after the last query are skipped, as the
    kernels skip them.
    """
    del block_q
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = h // hkv
    bk = max(block_k, 1) if ragged_tail else _pick_block(sk, block_k)
    scale = 1.0 / (d ** 0.5)
    q_off, kv_off = _offset_ints(offsets)
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.repeat_interleave(group, dim=1)
    m = m[..., 0].clone()
    l = l[..., 0].clone()
    acc = acc.clone()
    q_pos = q_off + torch.arange(sq, device=q.device)
    for j0 in range(0, sk, bk):
        if causal and kv_off + j0 > q_off + sq - 1:
            break
        kb = kf[:, :, j0:j0 + bk]
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        if causal:
            k_pos = kv_off + j0 + torch.arange(kb.shape[2], device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            s = torch.where(mask, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        if causal:
            p = torch.where(mask, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.matmul(p.to(v.dtype).float(), vf[:, :, j0:j0 + bk].float())
        acc = acc * corr[..., None] + pv
        m = m_new
    return m[..., None], l[..., None], acc


def flash_attention_carry(q, k, v, m, l, acc, offsets, *,
                          causal: bool = False, block_q: int = 1024,
                          block_k: int = 1024):
    """One flash accumulation pass: fold k/v into (m, l, acc) for q.

    q: [b, h, sq, d] (bf16 or fp32); k, v: [b, hkv, sk, d] of q's type with
    hkv | h (GQA). m, l: [b, h, sq, 1] fp32 (start from the NEG sentinel and
    zeros, ``flash_init``); acc: fp32 [b, h, sq, d]. offsets: the global q
    and kv positions, as an int32[2] tensor on q's device (read by the
    kernel, never by the host) or two Python ints. Returns fresh
    (m, l, acc); finalize with ``flash_finalize``.

    CPU tensors take ``flash_carry_reference`` with ``block_q``/``block_k``
    as in the JAX package. On CUDA the kernel picks its own tiles
    (``kernel_tile_k``: 128 keys on the bf16 tensor-core path, 64 on the
    fp32 one, which runs 3xTF32 and takes d % 4 == 0 up to d = 256 (32
    keys at d > 128), 32 on the SIMT path, which takes the rest, at any d
    and b*h: past the width a block's shared memory holds, one fold is
    ``simt_launches(d)`` launches over column chunks of acc). It takes
    bf16 or fp32, contiguous, and raises TypeError or ValueError on
    anything else.
    """
    _check(q, k, v, m, l, acc, offsets)
    tensors = (q, k, v, m, l, acc)
    devices = {t.device for t in tensors}
    if isinstance(offsets, torch.Tensor):
        devices.add(offsets.device)
    if len(devices) != 1:
        raise ValueError(f"flash_attention_carry: tensors on {devices}")
    if q.device.type == "cpu":
        return flash_carry_reference(q, k, v, m, l, acc, offsets,
                                     causal=causal, block_q=block_q,
                                     block_k=block_k)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_carry: q {q.dtype}, k {k.dtype}, "
                        f"v {v.dtype}; the kernel takes one of {_DTYPES}")
    for t, what in ((m, "m"), (l, "l"), (acc, "acc")):
        if t.dtype != torch.float32:
            raise TypeError(f"flash_attention_carry: {what} is {t.dtype}; "
                            "the carries are torch.float32")
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    for t, what in zip(tensors, ("q", "k", "v", "m", "l", "acc")):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_carry: {what} is not "
                             "contiguous")
    off_ptr, q_off, kv_off = None, 0, 0
    if isinstance(offsets, torch.Tensor):
        if offsets.dtype != torch.int32 or not offsets.is_contiguous():
            raise TypeError("flash_attention_carry: offsets must be a "
                            "contiguous torch.int32 tensor")
        off_ptr = offsets.data_ptr()
    else:
        q_off, kv_off = _offset_ints(offsets)
    m_out, l_out, acc_out = (torch.empty_like(m), torch.empty_like(l),
                             torch.empty_like(acc))
    if q.numel() == 0:
        return m_out, l_out, acc_out
    fn = _build.kernel("brpc_flash_carry", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(),
                l.data_ptr(), acc.data_ptr(), m_out.data_ptr(),
                l_out.data_ptr(), acc_out.data_ptr(), off_ptr, q_off, kv_off,
                b, h, hkv, sq, sk, d, int(q.dtype == torch.bfloat16),
                int(causal), 1.0 / (d ** 0.5), stream)
    _build.check(rc, "brpc_flash_carry")
    LAUNCHES.add()
    if (q.dtype == torch.float32 and _ask("brpc_flash_route", q, k, v, acc,
                                          acc_out) == _TF32X3):
        LAUNCHES_TF32X3.add()
    return m_out, l_out, acc_out


def flash_init(b: int, h: int, sq: int, d: int, *, device=None):
    """Fresh (m, l, acc) carries — the 'attended to nothing yet' state —
    on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    return (torch.full((b, h, sq, 1), _NEG, dtype=torch.float32, device=dev),
            torch.zeros((b, h, sq, 1), dtype=torch.float32, device=dev),
            torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev))


def flash_finalize(l, acc, dtype):
    """acc / l with never-attended rows (l == 0) mapped to 0, not NaN."""
    safe = torch.where(l > 0, l, 1.0)  # l: [b, h, sq, 1] broadcasts over d
    return (acc / safe).to(dtype)


def flash_attention(q, k, v, *, causal: bool = False, block_q: int = 1024,
                    block_k: int = 1024):
    """Full single-device attention, [b, h, s, d] -> [b, h, s, d]."""
    b, h, sq, d = q.shape
    m, l, acc = flash_init(b, h, sq, d, device=q.device)
    m, l, acc = flash_attention_carry(q, k, v, m, l, acc, (0, 0),
                                      causal=causal, block_q=block_q,
                                      block_k=block_k)
    return flash_finalize(l, acc, q.dtype)


def dense_attention_mh(q, k, v, *, causal: bool = False):
    """Dense multi-head reference oracle (materializes [b, h, s, s])."""
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / (d ** 0.5)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(qi >= ki, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)
