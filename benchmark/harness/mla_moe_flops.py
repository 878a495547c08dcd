"""Model FLOPs of one training step of the MLA + MoE block stack
(``models/mla_moe.py``'s ``MLAMoEStack``), counted from the shapes.

What is counted:

* 6 FLOPs per active matmul weight per token (2 forward, 4 backward):
  per layer ``q_proj``, ``kv_a_proj_with_mqa``, ``kv_b_proj`` (the latent
  up-projection) and ``o_proj``; the dense layers' ``gate_up`` and
  ``down``; each MoE layer's router, its shared experts, and its held
  experts at the share of a token they take on average, ``top_k * held /
  n_routed_experts`` experts a token (the routes of a random model are
  near uniform); the LM head.
* The attention core, 3 times its forward (the backward takes two of
  each product): ``QK^T`` at the query-key width and ``PV`` at the value
  width, 2 FLOPs a multiply-add, over the causal pairs ``s (s + 1) / 2``
  of each sequence and head.

Not counted: the embedding lookup (no matmul), norms, RoPE, softmax,
the SwiGLU's elementwise work, the routing's sort and gathers, and the
cross-entropy.
"""

from __future__ import annotations


def active_weights(cfg: dict, held: tuple) -> float:
    """Matmul weights a token passes through, held experts at their
    average share."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    r, w = cfg["kv_lora_rank"], cfg["moe_intermediate_size"]
    attn = d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv) + h * dv * d
    dense = 3 * d * cfg["intermediate_size"]
    expert = 3 * d * w
    share = cfg["num_experts_per_tok"] * held[1] / cfg["n_routed_experts"]
    moe = (d * cfg["n_routed_experts"] + cfg["n_shared_experts"] * expert
           + share * expert)
    n_dense = cfg["first_k_dense_replace"]
    n_moe = cfg["num_hidden_layers"] - n_dense
    return (cfg["num_hidden_layers"] * attn + n_dense * dense + n_moe * moe
            + d * cfg["vocab_size"])


def attention_flops(cfg: dict, batch: int, seq: int) -> float:
    """The attention core's forward and backward over every layer."""
    pairs = seq * (seq + 1) / 2
    width = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
             + cfg["v_head_dim"])
    per_layer = 2.0 * batch * cfg["num_attention_heads"] * pairs * width
    return 3.0 * cfg["num_hidden_layers"] * per_layer


def step_flops(cfg: dict, held: tuple, batch: int, seq: int) -> float:
    return (6.0 * active_weights(cfg, held) * batch * seq
            + attention_flops(cfg, batch, seq))
