"""A stack of DeepSeek-V3 blocks (latent attention and routed experts)
that the overlapped step driver trains against a parameter server.

``MLAMoEStack`` is the decoder of a ``deepseek_v3`` model (Moonlight-16B-
A3B's block): a token embedding over a vocabulary slice, then per layer

    h = h + o_proj(MLA(RMSNorm(h)))          the attention sub-block
    h = h + MLP(RMSNorm(h))                  the MLP sub-block

where the first ``first_k_dense_replace`` layers take a dense SwiGLU MLP
and the rest a mixture of experts, then the final RMSNorm, the LM head
over the slice and next-token cross-entropy (the mean over every
position; ``y`` holds each position's target id).

* MLA (``q_lora_rank`` null): ``q = x @ q_proj`` split per head into
  ``qk_nope | qk_rope``; ``x @ kv_a_proj_with_mqa`` split into the latent
  ``c`` (``kv_lora_rank``) and one shared ``k_rope``; ``RMSNorm(c) @
  kv_b_proj`` split per head into ``k_nope | v``; interleaved RoPE on
  ``q_rope`` and ``k_rope`` (the pairs (2i, 2i+1) de-interleaved into
  halves, then rotated); causal softmax attention at scale ``qk_head_dim
  ** -0.5``; ``o_proj`` over the heads' ``v_head_dim`` outputs.
* The router: ``sigmoid(x @ router)`` over all ``n_routed_experts``; the
  top ``num_experts_per_tok`` chosen by the scores plus a fixed correction
  bias, weighted by the unbiased scores gathered there, normalised to sum
  1 (+1e-20) when ``norm_topk_prob`` and scaled by
  ``routed_scaling_factor``.
* The expert layer holds ``experts_held = (first, count)`` of the routed
  experts: it routes over all of them and computes only its own experts'
  part (tokens sorted by expert, one matmul group per held expert,
  weighted and added back), plus the shared experts (one SwiGLU of width
  ``n_shared_experts * moe_intermediate_size``). What the absent experts
  would add is left out: on one card there is no exchange.

Weights are ``[in, out]`` (``a @ W``); a SwiGLU's ``gate_up`` is ``gate |
up`` along its output; the held experts are stacked, ``experts.gate_up``
``[count, hidden, 2 * width]`` and ``experts.down`` ``[count, width,
hidden]``. The correction bias (``[moe layers, n_routed_experts]``) is
the caller's fixed tensor, not a parameter.

The step decomposes as the driver's harness protocol asks: ``forward``
runs the whole stack and keeps each sub-block's graph, cut at a detached
residual input; ``backward(ctx, name)``, called top layer first, computes
a sub-block's gradients when the first of its names is asked for, hands
them out name by name, and passes the residual gradient to the sub-block
below. Inside a sub-block the MLA core (latent up-projection, RoPE and
attention) and the held experts are cut once more, so that their forward
and backward each run inside one stage: ``mla_attn``, ``moe_route``
(router, top-k, sort, the per-expert counts read back to the host) and
``moe_experts`` (dispatch, matmuls, combine). The Adders
``torch_moe_assignments`` (token-expert pairs routed),
``torch_moe_assignments_held`` (pairs on held experts) and
``torch_moe_held_max_tokens`` (the busiest held expert's tokens) count
every MoE layer's forward.

fp32 throughout; the caller turns TF32 off. The attention core is
``ops/mla_attention.attention``: on CUDA at the widths it is built for
(query-key 192, value 128) a hand-written fp32 forward and backward in
3xTF32, else ``scaled_dot_product_attention`` (its memory-efficient
backend on CUDA, its math path on the CPU).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from brpc_tpu_torch.observability import metrics, tracing
from brpc_tpu_torch.ops import mla_attention
from brpc_tpu_torch.utils.device import resolve_device

_ATTN = ("input_layernorm", "self_attn.q_proj",
         "self_attn.kv_a_proj_with_mqa", "self_attn.kv_a_layernorm",
         "self_attn.kv_b_proj", "self_attn.o_proj")
_DENSE = ("post_attention_layernorm", "mlp.gate_up", "mlp.down")
_MOE = ("post_attention_layernorm", "mlp.router", "mlp.shared.gate_up",
        "mlp.shared.down", "mlp.experts.gate_up", "mlp.experts.down")

_moe_counters = None


def _counters():
    global _moe_counters
    if _moe_counters is None:
        _moe_counters = (metrics.counter("torch_moe_assignments"),
                         metrics.counter("torch_moe_assignments_held"),
                         metrics.counter("torch_moe_held_max_tokens"))
    return _moe_counters


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def swiglu(x: torch.Tensor, gate_up: torch.Tensor,
           down: torch.Tensor) -> torch.Tensor:
    g, u = (x @ gate_up).chunk(2, dim=-1)
    return (F.silu(g) * u) @ down


def rope_tables(seq: int, dim: int, theta: float, device) -> tuple:
    """(cos, sin), each ``[seq, dim]``: angles ``pos * theta ** (-2i /
    dim)`` for i < dim / 2, repeated once along the last axis."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, device=device,
                                        dtype=torch.int64).float() / dim))
    ang = torch.outer(torch.arange(seq, device=device).float(), inv)
    emb = torch.cat([ang, ang], dim=-1)
    return emb.cos(), emb.sin()


def rope_interleaved(x: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor) -> torch.Tensor:
    """RoPE on interleaved pairs: ``x[..., 2i], x[..., 2i + 1]`` moved to
    ``i`` and ``d / 2 + i``, then ``x cos + rotate_half(x) sin``."""
    *lead, d = x.shape
    x = x.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().requires_grad_()


def _grads(outputs: Sequence[torch.Tensor], inputs: Sequence[torch.Tensor],
           grad_outputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``torch.autograd.grad`` with a zero gradient for an input the
    outputs do not reach (a held expert no token chose)."""
    got = torch.autograd.grad(list(outputs), list(inputs),
                              grad_outputs=list(grad_outputs),
                              allow_unused=True)
    return [torch.zeros_like(i) if g is None else g
            for g, i in zip(got, inputs)]


class MLAMoEStack:
    """The block stack above as an ``OverlappedStepDriver`` harness.

    ``config``: the Hugging Face ``deepseek_v3`` keys the block reads
    (``hidden_size``, ``num_attention_heads``, ``kv_lora_rank``,
    ``qk_nope_head_dim``, ``qk_rope_head_dim``, ``v_head_dim``,
    ``intermediate_size``, ``moe_intermediate_size``, ``n_routed_experts``
    (the router's width), ``num_experts_per_tok``, ``n_shared_experts``,
    ``first_k_dense_replace``, ``num_hidden_layers``, ``vocab_size`` (the
    slice held), ``rms_norm_eps``, ``rope_theta``,
    ``routed_scaling_factor``, ``norm_topk_prob``). ``experts_held``:
    ``(first, count)``, default all. ``correction_bias``: ``[moe layers,
    n_routed_experts]``, default zeros. ``device``: default CUDA (raises
    without it).

    ``last_routes`` holds the last forward's chosen experts, one ``[tokens,
    num_experts_per_tok]`` tensor per MoE layer.
    """

    def __init__(self, config: dict, experts_held: Optional[tuple] = None,
                 correction_bias: Optional[torch.Tensor] = None,
                 device=None):
        self.cfg = c = dict(config)
        self.device = resolve_device(device)
        self.is_wire = True
        n_exp = c["n_routed_experts"]
        first, count = experts_held if experts_held is not None \
            else (0, n_exp)
        if not (0 <= first and count >= 1 and first + count <= n_exp):
            raise ValueError(f"experts_held {experts_held!r} outside the "
                             f"router's {n_exp} experts")
        self.experts_held = (first, count)
        self.layers = c["num_hidden_layers"]
        self.moe_layers = [i for i in range(self.layers)
                           if i >= c["first_k_dense_replace"]]
        if correction_bias is None:
            correction_bias = torch.zeros(len(self.moe_layers), n_exp)
        if tuple(correction_bias.shape) != (len(self.moe_layers), n_exp):
            raise ValueError(f"correction_bias {tuple(correction_bias.shape)}"
                             f", want {(len(self.moe_layers), n_exp)}")
        self.correction_bias = correction_bias.to(self.device, torch.float32)
        self.shapes = self._shapes()
        self.names = list(self.shapes)
        self.last_routes: List[torch.Tensor] = []
        # Each sub-block by the first of its names the driver asks for
        # (it asks in reverse forward order): (names, kind, layer).
        self._block_of = {names[-1]: (names, kind, layer)
                          for kind, layer, names in self._block_names()}
        self._index = {n: i for i, n in enumerate(self.names)}

    # ---- shapes and names ----

    def _shapes(self) -> Dict[str, tuple]:
        c = self.cfg
        d, h = c["hidden_size"], c["num_attention_heads"]
        dn, dr, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                      c["v_head_dim"])
        r, w = c["kv_lora_rank"], c["moe_intermediate_size"]
        ws = w * c["n_shared_experts"]
        held = self.experts_held[1]
        out = {"embed_tokens": (c["vocab_size"], d)}
        for i in range(self.layers):
            p = f"layers.{i}."
            out.update({
                p + "input_layernorm": (d,),
                p + "self_attn.q_proj": (d, h * (dn + dr)),
                p + "self_attn.kv_a_proj_with_mqa": (d, r + dr),
                p + "self_attn.kv_a_layernorm": (r,),
                p + "self_attn.kv_b_proj": (r, h * (dn + dv)),
                p + "self_attn.o_proj": (h * dv, d),
                p + "post_attention_layernorm": (d,)})
            if i in self.moe_layers:
                out.update({
                    p + "mlp.router": (d, c["n_routed_experts"]),
                    p + "mlp.shared.gate_up": (d, 2 * ws),
                    p + "mlp.shared.down": (ws, d),
                    p + "mlp.experts.gate_up": (held, d, 2 * w),
                    p + "mlp.experts.down": (held, w, d)})
            else:
                out.update({
                    p + "mlp.gate_up": (d, 2 * c["intermediate_size"]),
                    p + "mlp.down": (c["intermediate_size"], d)})
        out.update({"norm": (d,), "lm_head": (d, c["vocab_size"])})
        return out

    def _block_names(self) -> list:
        """The sub-blocks in forward order: (kind, layer, names)."""
        out = [("embed", None, ["embed_tokens"])]
        for i in range(self.layers):
            p = f"layers.{i}."
            out.append(("attn", i, [p + n for n in _ATTN]))
            out.append(("moe" if i in self.moe_layers else "dense", i,
                        [p + n for n in (_MOE if i in self.moe_layers
                                         else _DENSE)]))
        out.append(("head", None, ["norm", "lm_head"]))
        return out

    def place(self, name: str, t):
        return t

    # ---- forward ----

    def forward(self, params, x, y) -> dict:
        """Token ids ``x`` and targets ``y``, each ``[batch, seq]``."""
        c = self.cfg
        eps = c["rms_norm_eps"]
        b, s = x.shape
        cos, sin = rope_tables(s, c["qk_rope_head_dim"], c["rope_theta"],
                               self.device)
        ctx = {"blocks": {}, "next": len(self.names) - 1, "grads": {},
               "delta": None, "bs": (b, s), "rope": (cos, sin)}
        self.last_routes = []
        with torch.enable_grad():
            w = _leaf(params["embed_tokens"])
            h = F.embedding(x.reshape(-1), w)
            ctx["blocks"]["embed"] = {"out": h, "leaves": [w]}
            h = h.detach()
            for i in range(self.layers):
                h = self._attn_forward(ctx, i, params, h)
                if i in self.moe_layers:
                    h = self._moe_forward(ctx, i, params, h)
                else:
                    h = self._dense_forward(ctx, i, params, h)
            xin = _leaf(h)
            leaves = [_leaf(params["norm"]), _leaf(params["lm_head"])]
            logits = rms_norm(xin, leaves[0], eps) @ leaves[1]
            loss = F.cross_entropy(logits, y.reshape(-1))
        ctx["blocks"]["head"] = {"out": loss, "xin": xin, "leaves": leaves}
        ctx["loss"] = loss.detach()
        return ctx

    def _attn_forward(self, ctx, i, params, h):
        c = self.cfg
        eps = c["rms_norm_eps"]
        hd, dn, dr, dv = (c["num_attention_heads"], c["qk_nope_head_dim"],
                          c["qk_rope_head_dim"], c["v_head_dim"])
        b, s = ctx["bs"]
        cos, sin = ctx["rope"]
        p = [_leaf(params[f"layers.{i}.{n}"]) for n in _ATTN]
        w_in, w_q, w_kva, w_kvn, w_kvb, w_o = p
        xin = _leaf(h)
        xn = rms_norm(xin, w_in, eps)
        q = xn @ w_q
        lat, k_rot = (xn @ w_kva).split([c["kv_lora_rank"], dr], dim=-1)
        lat = rms_norm(lat, w_kvn, eps)
        pre = [q, lat, k_rot]
        core_in = [_leaf(t) for t in pre] + [w_kvb]
        with tracing.stage("mla_attn"):
            qc, latc, krc, _ = core_in
            kv = (latc @ w_kvb).view(b, s, hd, dn + dv).transpose(1, 2)
            k_nope, v = kv.split([dn, dv], dim=-1)
            q_nope, q_rot = qc.view(b, s, hd, dn + dr).transpose(
                1, 2).split([dn, dr], dim=-1)
            k_rot = rope_interleaved(krc.view(b, 1, s, dr), cos, sin)
            qs = torch.cat([q_nope, rope_interleaved(q_rot, cos, sin)],
                           dim=-1)
            ks = torch.cat([k_nope, k_rot.expand(b, hd, s, dr)], dim=-1)
            o = mla_attention.attention(qs, ks, v, (dn + dr) ** -0.5)
            a = o.transpose(1, 2).reshape(b * s, hd * dv)
        a_in = _leaf(a)
        out = xin + a_in @ w_o
        ctx["blocks"][("attn", i)] = {
            "pre": (pre, [xin, w_in, w_q, w_kva, w_kvn]),
            "core": (a, core_in), "post": (out, [a_in, w_o])}
        return out.detach()

    def _dense_forward(self, ctx, i, params, h):
        p = [_leaf(params[f"layers.{i}.{n}"]) for n in _DENSE]
        xin = _leaf(h)
        out = xin + swiglu(rms_norm(xin, p[0], self.cfg["rms_norm_eps"]),
                           p[1], p[2])
        ctx["blocks"][("dense", i)] = {"out": out, "xin": xin, "leaves": p}
        return out.detach()

    def _moe_forward(self, ctx, i, params, h):
        p = [_leaf(params[f"layers.{i}.{n}"]) for n in _MOE]
        w_ln, w_r, w_sgu, w_sd, w_egu, w_ed = p
        xin = _leaf(h)
        xn = rms_norm(xin, w_ln, self.cfg["rms_norm_eps"])
        wts, route = self._router(i, xn, w_r)
        part = xin + swiglu(xn, w_sgu, w_sd)
        ex_in = [_leaf(xn), _leaf(wts), w_egu, w_ed]
        with tracing.stage("moe_experts"):
            routed = self._experts(*ex_in, route)
        ctx["blocks"][("moe", i)] = {
            "rest": ([part, xn, wts], [xin, w_ln, w_r, w_sgu, w_sd]),
            "experts": (routed, ex_in)}
        return (part + routed).detach()

    def moe(self, params, layer: int, x: torch.Tensor) -> tuple:
        """MoE layer ``layer`` on its normed input ``x`` -> (the held
        experts' part, the shared experts' part)."""
        p = f"layers.{layer}.mlp."
        with torch.no_grad():
            wts, route = self._router(layer, x, params[p + "router"])
            with tracing.stage("moe_experts"):
                routed = self._experts(x, wts, params[p + "experts.gate_up"],
                                       params[p + "experts.down"], route)
            return routed, swiglu(x, params[p + "shared.gate_up"],
                                  params[p + "shared.down"])

    def _router(self, i: int, xn, w_r) -> tuple:
        """-> (routing weights ``[tokens, k]``, the held experts' route);
        the choice is appended to ``last_routes``."""
        c = self.cfg
        with tracing.stage("moe_route"):
            scores = torch.sigmoid(xn @ w_r)
            bias = self.correction_bias[self.moe_layers.index(i)]
            idx = torch.topk(scores.detach() + bias,
                             c["num_experts_per_tok"], dim=-1).indices
            wts = scores.gather(1, idx)
            if c["norm_topk_prob"]:
                wts = wts / (wts.sum(dim=-1, keepdim=True) + 1e-20)
            wts = wts * c["routed_scaling_factor"]
            route = self._route(idx)
        self.last_routes.append(idx)
        return wts, route

    def _route(self, idx: torch.Tensor) -> tuple:
        """The held experts' token-expert pairs sorted by expert: (token
        of each pair, its flat index into ``idx``, tokens per held expert
        as host ints)."""
        first, count = self.experts_held
        k = idx.shape[1]
        flat = idx.reshape(-1)
        pair = torch.nonzero((flat >= first) & (flat < first + count))[:, 0]
        local = flat[pair] - first
        order = torch.sort(local, stable=True).indices
        pair = pair[order]
        counts = torch.bincount(local, minlength=count).tolist()
        total, held, busiest = _counters()
        total.add(flat.numel())
        held.add(sum(counts))
        busiest.add(max(counts))
        return pair // k, pair, counts

    def _experts(self, xn, wts, w_gu, w_d, route) -> torch.Tensor:
        tok, pair, counts = route
        xs = xn.index_select(0, tok)
        outs, start = [], 0
        for j, n in enumerate(counts):
            outs.append(swiglu(xs[start:start + n], w_gu[j], w_d[j]))
            start += n
        ys = torch.cat(outs) * wts.reshape(-1).index_select(0, pair)[:, None]
        return torch.zeros_like(xn).index_add(0, tok, ys)

    # ---- backward ----

    def backward(self, ctx: dict, name: str):
        k = self._index[name]
        if k != ctx["next"]:
            raise ValueError(
                f"backward order violated: expected {self.names[ctx['next']]}"
                f", got {name}: gradients propagate top-down only")
        ctx["next"] = k - 1
        block = self._block_of.get(name)
        if block is not None:
            names, kind, layer = block
            with torch.enable_grad():
                grads = getattr(self, f"_{kind}_backward")(ctx, layer)
            ctx["grads"].update(zip(names, grads))
        return ctx["grads"].pop(name)

    def _head_backward(self, ctx, _layer):
        blk = ctx["blocks"].pop("head")
        d_x, *g = _grads([blk["out"]], [blk["xin"]] + blk["leaves"],
                         [torch.ones_like(blk["out"])])
        ctx["delta"] = d_x
        return g

    def _attn_backward(self, ctx, i):
        blk = ctx["blocks"].pop(("attn", i))
        d_out = ctx["delta"]
        out, (a_in, w_o) = blk["post"]
        d_a, g_o = _grads([out], [a_in, w_o], [d_out])
        a, core_in = blk["core"]
        with tracing.stage("mla_attn"):
            d_q, d_lat, d_kr, g_kvb = _grads([a], core_in, [d_a])
        pre, pre_in = blk["pre"]
        d_x, g_in, g_q, g_kva, g_kvn = _grads(pre, pre_in,
                                              [d_q, d_lat, d_kr])
        ctx["delta"] = d_out + d_x
        return [g_in, g_q, g_kva, g_kvn, g_kvb, g_o]

    def _dense_backward(self, ctx, i):
        blk = ctx["blocks"].pop(("dense", i))
        d_x, *g = _grads([blk["out"]], [blk["xin"]] + blk["leaves"],
                         [ctx["delta"]])
        ctx["delta"] = d_x
        return g

    def _moe_backward(self, ctx, i):
        blk = ctx["blocks"].pop(("moe", i))
        d_out = ctx["delta"]
        routed, ex_in = blk["experts"]
        with tracing.stage("moe_experts"):
            d_xn, d_w, g_egu, g_ed = _grads([routed], ex_in, [d_out])
        outs, ins = blk["rest"]
        d_x, g_ln, g_r, g_sgu, g_sd = _grads(outs, ins, [d_out, d_xn, d_w])
        ctx["delta"] = d_x
        return [g_ln, g_r, g_sgu, g_sd, g_egu, g_ed]

    def _embed_backward(self, ctx, _layer):
        blk = ctx["blocks"].pop("embed")
        (g,) = _grads([blk["out"]], blk["leaves"], [ctx["delta"]])
        ctx["delta"] = None
        return [g]

    def loss(self, ctx: dict) -> float:
        return float(ctx["loss"])

    def grads(self, params, x, y) -> Tuple[dict, float]:
        """The whole gradient dict in one call (the serial reference)."""
        ctx = self.forward(params, x, y)
        return ({n: self.backward(ctx, n) for n in reversed(self.names)},
                float(ctx["loss"]))

