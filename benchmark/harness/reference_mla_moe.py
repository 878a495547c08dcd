"""The plain reference of the MLA + MoE block stack (DeepSeek-V3's decoder,
as Moonlight-16B-A3B configures it), in plain PyTorch and fp32, written
from the published equations (Hugging Face ``transformers``'
``models/deepseek_v3/modeling_deepseek_v3.py``) and nothing of the
program's (this module imports no ``brpc_tpu_torch`` and no
``transformers``).

Per layer, pre-norm residuals: ``h += o_proj(attn(RMSNorm(h)))``, then
``h += mlp(RMSNorm(h))``; ``RMSNorm(x) = w * x * rsqrt(mean(x^2) + eps)``.

* Attention (``q_lora_rank`` null): ``q = x @ q_proj`` per head ``nope |
  rope``; ``x @ kv_a_proj_with_mqa = c | k_rope`` (``kv_lora_rank``, one
  rope key shared by the heads); ``RMSNorm(c) @ kv_b_proj`` per head
  ``k_nope | v``. RoPE interleaved (``rope_interleave`` true): each vector
  ``x[..., 2i], x[..., 2i + 1]`` becomes halves ``i`` and ``d/2 + i``, then
  ``x cos + rotate_half(x) sin`` with angles ``pos * theta^(-2i/d)``.
  Scores ``q k^T * qk_head_dim^-0.5`` (no mscale: no rope scaling),
  causal, softmax in fp32, times ``v``.
* MLP: ``down(silu(x @ gate) * (x @ up))``; dense in the first
  ``first_k_dense_replace`` layers.
* MoE: scores ``sigmoid(x @ router)`` over all ``n_routed_experts``; the
  top ``num_experts_per_tok`` of ``scores + correction_bias`` (the bias
  only chooses); weights the unbiased scores there, over their sum +
  1e-20 (``norm_topk_prob``), times ``routed_scaling_factor``; each held
  expert's SwiGLU on its tokens, weighted, summed; plus the shared
  experts (one SwiGLU of ``n_shared_experts`` times the expert width).
* Loss: cross-entropy of ``RMSNorm(h) @ lm_head`` against ``y``, the
  mean over every position.

Departures, each for the cut or for memory, none in the arithmetic:

* The expert share: only the experts ``held = (first, count)`` are
  computed; the absent experts' part is left out, as on the program's
  card.
* ``routes``: the reference may be told which experts each token chose
  (the program's recorded choice) and dispatch with them; its own choice
  and the margin between its k-th and (k+1)-th biased scores are returned
  beside, so a near-tie flip is judged apart and does not swamp the
  gradients.
* Attention runs over blocks of ``block`` queries, each block recomputed
  in the backward pass (``torch.utils.checkpoint``), and every layer is
  recomputed likewise: the same values, in the memory three steps of the
  full size leave on one card.
* Weights are ``[in, out]`` (``x @ W``); gate and up are one
  ``gate_up`` tensor, gate first; the held experts are stacked.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from harness import reference


def shapes(cfg: dict, held: tuple) -> dict:
    """Parameter names in forward order and their shapes."""
    d, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    r, w = cfg["kv_lora_rank"], cfg["moe_intermediate_size"]
    ws, di = w * cfg["n_shared_experts"], cfg["intermediate_size"]
    out = {"embed_tokens": (cfg["vocab_size"], d)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out[p + "input_layernorm"] = (d,)
        out[p + "self_attn.q_proj"] = (d, nh * (dn + dr))
        out[p + "self_attn.kv_a_proj_with_mqa"] = (d, r + dr)
        out[p + "self_attn.kv_a_layernorm"] = (r,)
        out[p + "self_attn.kv_b_proj"] = (r, nh * (dn + dv))
        out[p + "self_attn.o_proj"] = (nh * dv, d)
        out[p + "post_attention_layernorm"] = (d,)
        if i < cfg["first_k_dense_replace"]:
            out[p + "mlp.gate_up"] = (d, 2 * di)
            out[p + "mlp.down"] = (di, d)
        else:
            out[p + "mlp.router"] = (d, cfg["n_routed_experts"])
            out[p + "mlp.shared.gate_up"] = (d, 2 * ws)
            out[p + "mlp.shared.down"] = (ws, d)
            out[p + "mlp.experts.gate_up"] = (held[1], d, 2 * w)
            out[p + "mlp.experts.down"] = (held[1], w, d)
    out["norm"] = (d,)
    out["lm_head"] = (d, cfg["vocab_size"])
    return out


def moe_layers(cfg: dict) -> list:
    return list(range(cfg["first_k_dense_replace"],
                      cfg["num_hidden_layers"]))


def rms(x, w, eps):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def mlp(x, gate_up, down):
    gate, up = torch.split(gate_up, gate_up.shape[1] // 2, dim=1)
    return (F.silu(x @ gate) * (x @ up)) @ down


def rope(x, theta):
    """Interleaved RoPE over the last axis of ``x`` ``[..., seq, d]``."""
    s, d = x.shape[-2], x.shape[-1]
    half = torch.arange(0, d, 2, dtype=torch.int64, device=x.device).float()
    inv = 1.0 / (theta ** (half / d))
    ang = torch.arange(s, device=x.device).float()[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    # (2i, 2i+1) -> (i, d/2 + i)
    x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * ang.cos() + rot * ang.sin()


def _attend(q, k, v, start, scale):
    """Queries ``start..start+n`` against keys ``0..k.shape[2]``."""
    n, e = q.shape[2], k.shape[2]
    s = (q @ k.transpose(2, 3)) * scale
    seen = (torch.arange(start, start + n, device=q.device)[:, None]
            >= torch.arange(e, device=q.device)[None, :])
    s = s.masked_fill(~seen, float("-inf"))
    return torch.softmax(s, dim=-1) @ v


def attention(q, k, v, scale, block):
    """Causal softmax attention ``[b, h, s, d]`` over query blocks."""
    s = q.shape[2]
    outs = []
    for a in range(0, s, block):
        e = min(a + block, s)
        outs.append(checkpoint(_attend, q[:, :, a:e], k[:, :, :e],
                               v[:, :, :e], a, scale, use_reentrant=False))
    return torch.cat(outs, dim=2)


def _attn_block(cfg, p, i, h, b, s, block):
    pre = f"layers.{i}."
    eps, nh = cfg["rms_norm_eps"], cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    x = rms(h, p[pre + "input_layernorm"], eps)
    q = (x @ p[pre + "self_attn.q_proj"]).view(b, s, nh, dn + dr)
    q = q.transpose(1, 2)
    ckv = x @ p[pre + "self_attn.kv_a_proj_with_mqa"]
    c, k_rope = ckv[:, :cfg["kv_lora_rank"]], ckv[:, cfg["kv_lora_rank"]:]
    kv = rms(c, p[pre + "self_attn.kv_a_layernorm"], eps) @ \
        p[pre + "self_attn.kv_b_proj"]
    kv = kv.view(b, s, nh, dn + dv).transpose(1, 2)
    k_rope = rope(k_rope.view(b, 1, s, dr), cfg["rope_theta"])
    qs = torch.cat([q[..., :dn], rope(q[..., dn:], cfg["rope_theta"])], -1)
    ks = torch.cat([kv[..., :dn], k_rope.expand(b, nh, s, dr)], -1)
    o = attention(qs, ks, kv[..., dn:], (dn + dr) ** -0.5, block)
    o = o.transpose(1, 2).reshape(b * s, nh * dv)
    return h + o @ p[pre + "self_attn.o_proj"]


def _moe_block(cfg, p, i, x, bias, held, route, own):
    """The MoE of layer ``i`` on normed ``x``; ``route`` the choice to
    dispatch with (None: its own); its own choice and margin go to
    ``own``."""
    pre = f"layers.{i}.mlp."
    k = cfg["num_experts_per_tok"]
    scores = torch.sigmoid(x @ p[pre + "router"])
    top = torch.topk(scores.detach() + bias, k + 1, dim=-1)
    own.setdefault(i, (top.indices[:, :k], top.values[:, k - 1]
                       - top.values[:, k]))
    idx = top.indices[:, :k] if route is None else route
    w = scores.gather(1, idx)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    w = w * cfg["routed_scaling_factor"]
    out = torch.zeros_like(x)
    first, count = held
    for j in range(count):
        tok, slot = torch.where(idx == first + j)
        if tok.numel():
            y = mlp(x[tok], p[pre + "experts.gate_up"][j],
                    p[pre + "experts.down"][j])
            out = out.index_add(0, tok, y * w[tok, slot, None])
    return out + mlp(x, p[pre + "shared.gate_up"], p[pre + "shared.down"])


def _layer(h, cfg, p, i, bias, held, route, own, b, s, block):
    h = _attn_block(cfg, p, i, h, b, s, block)
    x = rms(h, p[f"layers.{i}.post_attention_layernorm"], cfg["rms_norm_eps"])
    if i < cfg["first_k_dense_replace"]:
        return h + mlp(x, p[f"layers.{i}.mlp.gate_up"],
                       p[f"layers.{i}.mlp.down"])
    return h + _moe_block(cfg, p, i, x, bias, held, route, own)


def hidden(p, bias, x, cfg, held, routes=None, own=None, block=1024):
    """The final RMSNorm's output ``[b * s, hidden]``. ``bias``: ``[moe
    layers, n_routed_experts]``; ``routes``: ``{layer: [b * s, k]}`` or
    None; ``own`` (a dict) receives ``{layer: (own choice, margin)}``."""
    b, s = x.shape
    own = {} if own is None else own
    h = p["embed_tokens"][x.reshape(-1)]
    for i in range(cfg["num_hidden_layers"]):
        m = i - cfg["first_k_dense_replace"]
        h = checkpoint(_layer, h, cfg, p, i, bias[m] if m >= 0 else None,
                       held, None if routes is None or m < 0 else routes[i],
                       own, b, s, block, use_reentrant=False)
    return rms(h, p["norm"], cfg["rms_norm_eps"])


def logits(p, bias, x, cfg, held, block=1024) -> torch.Tensor:
    """``[b, s, vocab]``, every choice the reference's own."""
    with torch.no_grad():
        out = hidden(p, bias, x, cfg, held, block=block) @ p["lm_head"]
    return out.view(*x.shape, -1)


def grads(p, bias, x, y, cfg, held, routes=None, block=1024) -> tuple:
    """-> (gradients by name, loss as a float, ``{layer: (own choice,
    margin)}``)."""
    leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
    own = {}
    with torch.enable_grad():
        h = hidden(leaves, bias, x, cfg, held, routes, own, block)
        loss = F.cross_entropy(h @ leaves["lm_head"], y.reshape(-1))
        g = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves, g)), float(loss.detach()), own


def train(weights: dict, bias, batches: list, lr: float, beta: float,
          cfg: dict, held: tuple, routes=None, *, tf32: bool = False,
          rows: int = None, block: int = 1024) -> dict:
    """``len(batches)`` momentum-SGD steps from ``weights``. ``routes``:
    per step ``{layer: [tokens, k]}`` to dispatch with (None: own);
    ``rows`` keeps the first sequences of every batch (a planted fault).
    -> ``{"losses", "m1": the momenta after step 1, "params" and "m":
    after the last step, "own": per step {layer: (own choice,
    margin)}}``."""
    names = list(weights)
    p = {k: weights[k].clone() for k in names}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, m1, owns = [], None, []
    with reference.matmul_precision(tf32):
        for step, (x, y) in enumerate(batches):
            route = None if routes is None else routes[step]
            if rows is not None:
                x, y = x[:rows], y[:rows]
                if route is not None:
                    route = {i: r[:x.numel()] for i, r in route.items()}
            g, loss, own = grads(p, bias, x, y, cfg, held, route, block)
            losses.append(loss)
            owns.append(own)
            for k in names:
                p[k], m[k] = reference.momentum(p[k], m[k], g[k], lr, beta)
            del g
            if m1 is None:
                m1 = dict(m)
    return {"losses": losses, "m1": m1, "params": p, "m": m, "own": owns}


def route_flips(got: list, own: list, width: float) -> int:
    """(token, layer) pairs of every step where ``got`` (per step
    ``{layer: [tokens, k]}``) chose another set of experts than the
    reference's own choice, counted where the reference's margin between
    its k-th and (k+1)-th biased score is at least ``width``."""
    n = 0
    for g_step, o_step in zip(got, own):
        for i, (mine, margin) in o_step.items():
            theirs = g_step[i].to(mine.device)
            t = min(len(theirs), len(mine))  # a half batch: its tokens
            theirs, mine, margin = theirs[:t], mine[:t], margin[:t]
            differ = (torch.sort(theirs, dim=1).values
                      != torch.sort(mine, dim=1).values).any(dim=1)
            n += int((differ & (margin >= width)).sum())
    return n
