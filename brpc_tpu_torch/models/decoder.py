"""The small autoregressive decoder the serving plane batches, in PyTorch.

The JAX package's ``models/decoder.py``, function for function: one
attention layer over a learned embedding and learned positions, greedy
(argmax) decoding, an explicit KV cache that lives outside the model. The
step functions are plain functions on tensors, run eagerly on the device
the parameters live on.

Every step runs over FIXED shapes — ``max_batch`` lanes × ``max_len``
cache rows — so a batch's composition never changes what a lane computes:
the engine (``serving/engine.py``) maps live sessions onto lanes, and a
lane's tokens depend only on its own rows. ``_attend`` is the single home
of the step math: ``decode_step`` runs it once, ``verify_step`` and
``draft_propose`` unroll it over a window (each position writes its row
before the next reads it, so the window's argmax at every position is the
sequential path's), and the paged forms gather a block pool through
per-lane tables into the same dense lanes first.

Where the JAX package updates the cache functionally
(``kv.at[b, lengths].set(row)``), each dispatch here takes one private
copy of the lanes (the paged gather is one already) and writes that copy
in place; the caller's tensors are never written. Out-of-range indices
keep the JAX semantics: a position past the cache drops its row write and
a position past ``max_pos`` reads the last position row.

Rows past a lane's length are scored -1e30, which fp32 softmax turns into
an exact 0.0 weight, so they never perturb the output — while they are
finite (0 x NaN is NaN). Every buffer a caller stages lanes into is
therefore made with ``torch.zeros``.

Indices (``lengths``, ``tokens``, ``window``, ``tables``, ``n_known``)
are int64 tensors on the parameters' device.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence, Tuple

import torch

from brpc_tpu_torch.utils.device import resolve_device


class DecoderParams(NamedTuple):
    embed: torch.Tensor  # (vocab, dim)
    pos: torch.Tensor    # (max_pos, dim) — keeps greedy decoding off a
    wq: torch.Tensor     # (dim, dim)       fixed point
    wk: torch.Tensor     # (dim, dim)
    wv: torch.Tensor     # (dim, dim)
    wo: torch.Tensor     # (dim, dim)


def init_decoder(generator: torch.Generator, vocab: int = 64, dim: int = 32,
                 max_pos: int = 256, device=None) -> DecoderParams:
    """Random parameters drawn from ``generator`` (a CPU generator, so the
    values do not depend on the device), then placed on ``device``
    (default CUDA; raises when CUDA is missing)."""
    dev = resolve_device(device)
    s = 1.0 / math.sqrt(dim)

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32)

    embed = normal(vocab, dim)
    wq, wk, wv, wo = (normal(dim, dim) * s for _ in range(4))
    pos = normal(max_pos, dim)
    return DecoderParams(*(t.to(dev) for t in (embed, pos, wq, wk, wv, wo)))


def _gather_lanes(kv) -> torch.Tensor:
    """The dispatch's private dense ``(B, L, D)`` lanes: a ``(pool,
    tables)`` pair — pool ``(n_blocks, block_rows, dim)``, tables ``(B,
    T)`` — gathers into ``(B, T * block_rows, dim)``; dense lanes are
    copied. A windowed unroll gathers once, then threads these lanes."""
    if isinstance(kv, tuple):
        pool, tables = kv
        return pool[tables].reshape(tables.shape[0], -1, pool.shape[-1])
    return kv.clone()


def _attend(params: DecoderParams, kv_k: torch.Tensor, kv_v: torch.Tensor,
            lengths: torch.Tensor, tokens: torch.Tensor):
    """ONE position of greedy decode for every lane, over private dense
    lanes it writes in place: each lane's new (k, v) row lands at row
    ``lengths[b]`` before the attention reads it, and the length mask
    admits exactly the rows written so far. Returns (next tokens, k_new,
    v_new)."""
    B, L, D = kv_k.shape
    x = params.embed[tokens] + params.pos[
        lengths.clamp(max=params.pos.shape[0] - 1)]
    q = x @ params.wq
    k_new = x @ params.wk
    v_new = x @ params.wv
    # A row past the cache is dropped: its slot keeps its own value.
    b_idx = torch.arange(B, device=kv_k.device)
    rows = lengths.clamp(max=L - 1)
    inside = (lengths < L)[:, None]
    kv_k[b_idx, rows] = torch.where(inside, k_new, kv_k[b_idx, rows])
    kv_v[b_idx, rows] = torch.where(inside, v_new, kv_v[b_idx, rows])
    scores = torch.einsum("bd,bld->bl", q, kv_k) / math.sqrt(D)
    mask = torch.arange(L, device=kv_k.device)[None, :] <= lengths[:, None]
    scores = torch.where(mask, scores, -1e30)
    attn = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bl,bld->bd", attn, kv_v)
    # No input residual into the logits: embed[t] . embed.T peaks at t
    # itself, which would make greedy decoding emit its input forever.
    out = ctx @ params.wo + 0.5 * params.pos[
        lengths.clamp(max=params.pos.shape[0] - 1)]
    logits = out @ params.embed.T
    return torch.argmax(logits, dim=-1), k_new, v_new


def decode_step(params: DecoderParams, kv_k: torch.Tensor,
                kv_v: torch.Tensor, lengths: torch.Tensor,
                tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One batched decode step. ``kv_k``/``kv_v``: (B, L, D), lane b's
    rows [0, lengths[b]) valid; ``tokens``: (B,) each lane's input.
    Returns (next_tokens (B,), k_new (B, D), v_new (B, D)); the caller
    writes k_new/v_new at row lengths[b] of the lane's cache. Inactive
    lanes' outputs are well-defined garbage the caller ignores."""
    return _attend(params, _gather_lanes(kv_k), _gather_lanes(kv_v),
                   lengths, tokens)


def _window(params, kv_k, kv_v, lengths, window, n_known=None):
    """Unroll ``_attend`` over a (B, W) window on one private copy of the
    lanes. With ``n_known``, position j feeds ``window[:, j]`` while j <
    n_known[b] and the previous position's argmax after (the draft's
    autoregressive proposal)."""
    kv_k = _gather_lanes(kv_k)
    kv_v = _gather_lanes(kv_v)
    outs, ks, vs = [], [], []
    prev = window[:, 0]
    for j in range(window.shape[1]):
        inp = window[:, j] if n_known is None else torch.where(
            j < n_known, window[:, j], prev)
        nxt, k_new, v_new = _attend(params, kv_k, kv_v, lengths + j, inp)
        outs.append(nxt)
        ks.append(k_new)
        vs.append(v_new)
        prev = nxt
    return (torch.stack(outs, dim=1), torch.stack(ks, dim=1),
            torch.stack(vs, dim=1))


def verify_step(params: DecoderParams, kv_k: torch.Tensor,
                kv_v: torch.Tensor, lengths: torch.Tensor,
                window: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score a (B, W) window of input tokens in one dispatch: position j
    of lane b consumes ``window[b, j]`` at row ``lengths[b] + j`` and
    yields the argmax ``y[b, j]`` that W ``decode_step`` calls would have.
    Returns (y (B, W), k_rows (B, W, D), v_rows (B, W, D)); the caller
    commits only the rows whose inputs it accepts."""
    return _window(params, kv_k, kv_v, lengths, window)


def decode_step_paged(params: DecoderParams, pool_k: torch.Tensor,
                      pool_v: torch.Tensor, tables: torch.Tensor,
                      lengths: torch.Tensor, tokens: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`decode_step` over a block pool: ``pool_k``/``pool_v``
    ``(n_blocks, block_rows, dim)`` and ``tables`` ``(B, max_len //
    block_rows)`` mapping each lane's rows onto pool blocks. Same
    returns; the caller writes k_new/v_new into the lane's current tail
    block."""
    return _attend(params, _gather_lanes((pool_k, tables)),
                   _gather_lanes((pool_v, tables)), lengths, tokens)


def verify_step_paged(params: DecoderParams, pool_k: torch.Tensor,
                      pool_v: torch.Tensor, tables: torch.Tensor,
                      lengths: torch.Tensor, window: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`verify_step` over a block pool: one gather per dispatch,
    the same outputs as the dense form over the same logical rows."""
    return _window(params, (pool_k, tables), (pool_v, tables), lengths,
                   window)


def draft_propose(params: DecoderParams, kv_k: torch.Tensor,
                  kv_v: torch.Tensor, lengths: torch.Tensor,
                  window: torch.Tensor, n_known: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The draft model's ingest-and-propose window: position j consumes
    ``window[b, j]`` while ``j < n_known[b]`` (committed tokens the draft
    has not seen) and its own previous argmax after. Returns (y, k_rows,
    v_rows) as :func:`verify_step`; the proposals are ``y[b,
    n_known[b]-1:]``."""
    return _window(params, kv_k, kv_v, lengths, window, n_known)


def emit_done(token: int, emitted: int, max_tokens: int,
              eos_id: int) -> bool:
    """The one greedy stop clamp: True once generation stops after
    counting ``token`` as the ``emitted``-th emission (1-based) — the
    token is EOS or the budget is spent. Shared by ``decode_serial``, the
    engine's emission and the speculative acceptance walk."""
    return token == eos_id or emitted >= max_tokens


def ngram_propose(seq: Sequence[int], k: int, max_n: int = 3) -> List[int]:
    """Model-free prompt-lookup draft: the up to ``k`` tokens that
    followed the most recent earlier occurrence of the sequence's
    trailing n-gram (longest n first); [] when nothing repeats."""
    n_seq = len(seq)
    if k <= 0 or n_seq < 2:
        return []
    for n in range(min(max_n, n_seq - 1), 0, -1):
        tail = list(seq[n_seq - n:])
        for i in range(n_seq - n - 1, -1, -1):
            if list(seq[i:i + n]) == tail:
                return [int(t) for t in seq[i + n:i + n + k]]
    return []


def decode_serial(params: DecoderParams, prompt, max_tokens: int,
                  max_len: int, eos_id: int = 0, *, lanes: int = 1) -> list:
    """Reference single-session greedy decode, the parity oracle of the
    batched path: the session alone in lane 0 of ``lanes`` (the others
    stay zero), its cache on the parameters' device. ``lanes`` set to the
    engine's ``max_batch`` runs the engine's own fixed-shape program, so
    the comparison does not depend on how a matmul library orders a sum
    at one row against several."""
    dev = params.embed.device
    dim = params.embed.shape[1]
    kv_k = torch.zeros((lanes, max_len, dim), dtype=torch.float32,
                       device=dev)
    kv_v = torch.zeros_like(kv_k)
    lengths = torch.zeros((lanes,), dtype=torch.int64, device=dev)
    tokens = torch.zeros((lanes,), dtype=torch.int64, device=dev)
    pos = 0
    out = []
    token = None
    for _ in range(len(prompt) + max_tokens):
        lengths[0] = pos
        tokens[0] = prompt[pos] if pos < len(prompt) else token
        nxt, k_new, v_new = decode_step(params, kv_k, kv_v, lengths, tokens)
        kv_k[0, pos] = k_new[0]
        kv_v[0, pos] = v_new[0]
        pos += 1
        if pos < len(prompt):
            continue  # prefill: consume the prompt, emit nothing
        token = int(nxt[0])
        out.append(token)
        if emit_done(token, len(out), max_tokens, eos_id):
            break
    return out
