"""The MLA + MoE block stack (``models/mla_moe.py``) on the CPU, at a tiny
size, against the benchmark's plain reference
(``benchmark/harness/reference_mla_moe.py``), and that reference against
Hugging Face ``transformers``' ``DeepseekV3ForCausalLM`` (the published
equations; skipped where ``transformers`` is absent).

Tolerances: the program and the reference compute the same fp32
arithmetic in other orders (a fused ``gate | up`` matmul against two,
``scaled_dot_product_attention`` against a blocked softmax, the residual
added before or after the routed experts), so every tensor is held within
2e-5 of its largest reference value; the program's own top-k equals the
reference's choice token for token at these seeds (no near tie).
"""

import math
import os
import sys

import pytest
import torch

from brpc_tpu_torch.models.mla_moe import MLAMoEStack
from brpc_tpu_torch.observability import metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness import reference_mla_moe as ref  # noqa: E402

CFG = dict(hidden_size=32, num_attention_heads=2, kv_lora_rank=16,
           qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8,
           intermediate_size=48, moe_intermediate_size=16,
           n_routed_experts=16, num_experts_per_tok=6, n_shared_experts=2,
           first_k_dense_replace=1, num_hidden_layers=3, vocab_size=64,
           rms_norm_eps=1e-5, rope_theta=50000.0,
           routed_scaling_factor=2.446, norm_topk_prob=True)
RTOL = 2e-5
LR, BETA = 0.01, 0.9


def _params(held, seed=1, std=0.2):
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.ones(s) if len(s) == 1 else std * torch.randn(
        s, generator=g)) for k, s in ref.shapes(CFG, held).items()}


def _bias(seed=2):
    g = torch.Generator().manual_seed(seed)
    n = len(ref.moe_layers(CFG))
    return 0.01 * torch.randn(n, CFG["n_routed_experts"], generator=g)


def _batch(seed=3, rows=2, seq=16):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, CFG["vocab_size"], (rows, seq + 1), generator=g)
    return ids[:, :-1], ids[:, 1:]


def _close(got, want, what):
    scale = float(want.abs().max()) or 1.0
    err = float((got - want).abs().max()) / scale
    assert err <= RTOL, f"{what}: max error {err:.3g} of its largest value"


def _routes(stack):
    return dict(zip(stack.moe_layers, stack.last_routes))


def test_names_and_shapes_at_the_configuration():
    full = dict(CFG, hidden_size=2048, num_attention_heads=16,
                kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
                v_head_dim=128, intermediate_size=11264,
                moe_intermediate_size=1408, n_routed_experts=64,
                num_hidden_layers=5, vocab_size=20480)
    stack = MLAMoEStack(full, experts_held=(0, 8), device="cpu")
    assert len(stack.names) == 60
    assert stack.names[0] == "embed_tokens"
    assert stack.names[-2:] == ["norm", "lm_head"]
    assert stack.shapes["layers.1.mlp.experts.gate_up"] == (8, 2048, 2816)
    assert stack.shapes["layers.1.mlp.experts.down"] == (8, 1408, 2048)
    assert stack.shapes == ref.shapes(full, (0, 8))
    n = sum(math.prod(s) for s in stack.shapes.values())
    assert n == 568_484_352
    with pytest.raises(ValueError, match="experts_held"):
        MLAMoEStack(full, experts_held=(60, 8), device="cpu")


@pytest.mark.parametrize("held", [(0, 16), (4, 8)])
def test_loss_and_every_gradient_match_the_reference(held):
    p, bias, (x, y) = _params(held), _bias(), _batch()
    stack = MLAMoEStack(CFG, experts_held=held, correction_bias=bias,
                        device="cpu")
    got, loss = stack.grads(p, x, y)
    routes = _routes(stack)
    want, ref_loss, own = ref.grads(p, bias, x, y, CFG, held, routes,
                                    block=5)
    assert abs(loss - ref_loss) <= RTOL * abs(ref_loss)
    assert list(got) == list(reversed(stack.names))
    for k in stack.names:
        _close(got[k], want[k], k)
    assert ref.route_flips([routes], [own], 0.0) == 0


def test_backward_runs_top_down_only():
    p, (x, y) = _params((0, 16)), _batch()
    stack = MLAMoEStack(CFG, device="cpu")
    ctx = stack.forward(p, x, y)
    stack.backward(ctx, "lm_head")
    with pytest.raises(ValueError, match="top-down"):
        stack.backward(ctx, "embed_tokens")


def test_expert_shares_sum_to_the_uncut_layer():
    """The 4 shares' MoE outputs of a layer, the shared experts counted
    once, sum to the uncut layer's (and to the reference's whole layer)."""
    n = CFG["n_routed_experts"]
    full = _params((0, n))
    bias = _bias()
    x = torch.randn(40, CFG["hidden_size"],
                    generator=torch.Generator().manual_seed(4))
    layer = 1
    whole = MLAMoEStack(CFG, correction_bias=bias, device="cpu")
    routed, shared = whole.moe(full, layer, x)
    total = shared.clone()
    for first in range(0, n, 4):
        p = dict(full)
        for k in ("experts.gate_up", "experts.down"):
            name = f"layers.{layer}.mlp.{k}"
            p[name] = full[name][first:first + 4]
        share = MLAMoEStack(CFG, experts_held=(first, 4),
                            correction_bias=bias, device="cpu")
        part, sh = share.moe(p, layer, x)
        torch.testing.assert_close(sh, shared, rtol=0, atol=0)
        total += part
    _close(total, routed + shared, "shares summed")
    want = ref._moe_block(CFG, full, layer, x, bias[0], (0, n), None, {})
    _close(total, want, "the reference's uncut layer")


def test_three_driver_steps_match_the_reference_training():
    """3 overlapped steps against an in-process ParameterServer equal the
    reference's momentum training dispatched with the recorded routes."""
    from brpc_tpu_torch.runtime.param_server import (ParameterClient,
                                                     ParameterServer)
    from brpc_tpu_torch.runtime.step_driver import OverlappedStepDriver

    held = (4, 8)
    p, bias = _params(held, std=0.1), _bias()
    feed = [_batch(seed=10 + i) for i in range(3)]
    stack = MLAMoEStack(CFG, experts_held=held, correction_bias=bias,
                        device="cpu")
    ps = ParameterServer({k: v.clone() for k, v in p.items()}, lr=LR,
                         momentum=BETA, device="cpu")
    cl = ParameterClient(f"tpu://127.0.0.1:{ps.start()}", device="cpu")
    try:
        driver = OverlappedStepDriver(cl, stack, overlap=True, window=4)
        driver.prime()
        losses, routes = [], []
        for x, y in feed:
            losses.append(driver.step(x, y))
            routes.append(_routes(stack))
        st = ps.state()
    finally:
        cl.close()
        ps.stop()
        ps.server.close()
    assert set(driver.versions.values()) == {3}
    want = ref.train(p, bias, feed, LR, BETA, CFG, held, routes, block=7)
    for a, b in zip(losses, want["losses"]):
        assert abs(a - b) <= RTOL * abs(b)
    eps = torch.finfo(torch.float32).eps
    for k in stack.names:
        _close(st.momenta[k], want["m"][k], k)
        # The change is lr x the momenta, under the parameters' rounding.
        change = float((want["params"][k] - p[k]).abs().max())
        err = float((st.params[k] - want["params"][k]).abs().max())
        assert err <= RTOL * change + 4 * eps * float(p[k].abs().max()), k
    assert ref.route_flips(routes, want["own"], 0.0) == 0


def _var(name):
    return metrics.counter(name).value()


def test_stages_and_adders_count_on_vars():
    held = (4, 8)
    p, bias, (x, y) = _params(held), _bias(), _batch()
    stack = MLAMoEStack(CFG, experts_held=held, correction_bias=bias,
                        device="cpu")
    names = ("torch_stage_mla_attn_calls", "torch_stage_moe_route_calls",
             "torch_stage_moe_experts_calls", "torch_moe_assignments",
             "torch_moe_assignments_held", "torch_moe_held_max_tokens")
    before = {n: _var(n) for n in names}
    stack.grads(p, x, y)
    d = {n: _var(n) - before[n] for n in names}
    layers, moe = CFG["num_hidden_layers"], len(stack.moe_layers)
    tokens, k = x.numel(), CFG["num_experts_per_tok"]
    assert d["torch_stage_mla_attn_calls"] == 2 * layers
    assert d["torch_stage_moe_route_calls"] == moe
    assert d["torch_stage_moe_experts_calls"] == 2 * moe
    assert d["torch_moe_assignments"] == moe * tokens * k
    held_pairs = busiest = 0
    for r in stack.last_routes:
        on = (r >= held[0]) & (r < held[0] + held[1])
        held_pairs += int(on.sum())
        busiest += max(int((r == e).sum())
                       for e in range(held[0], held[0] + held[1]))
    assert d["torch_moe_assignments_held"] == held_pairs
    assert d["torch_moe_held_max_tokens"] == busiest
    assert "torch_stage_moe_route_us" in metrics.dump_vars("torch_stage_moe")


def test_reference_logits_equal_transformers():
    """The reference's logits against ``DeepseekV3ForCausalLM`` (eager
    attention) at a tiny config with the same weights: what ties the
    reference to the published equations."""
    tf = pytest.importorskip("transformers")
    conf = tf.DeepseekV3Config(
        vocab_size=CFG["vocab_size"], hidden_size=CFG["hidden_size"],
        intermediate_size=CFG["intermediate_size"],
        moe_intermediate_size=CFG["moe_intermediate_size"],
        num_hidden_layers=CFG["num_hidden_layers"],
        num_attention_heads=CFG["num_attention_heads"],
        num_key_value_heads=CFG["num_attention_heads"],
        n_shared_experts=CFG["n_shared_experts"],
        n_routed_experts=CFG["n_routed_experts"],
        routed_scaling_factor=CFG["routed_scaling_factor"],
        kv_lora_rank=CFG["kv_lora_rank"], q_lora_rank=None,
        qk_rope_head_dim=CFG["qk_rope_head_dim"],
        v_head_dim=CFG["v_head_dim"],
        qk_nope_head_dim=CFG["qk_nope_head_dim"], n_group=1, topk_group=1,
        num_experts_per_tok=CFG["num_experts_per_tok"],
        first_k_dense_replace=CFG["first_k_dense_replace"],
        norm_topk_prob=True, max_position_embeddings=64,
        rms_norm_eps=CFG["rms_norm_eps"], rope_theta=CFG["rope_theta"],
        rope_interleave=True, attention_bias=False, tie_word_embeddings=False,
        attn_implementation="eager")
    held = (0, CFG["n_routed_experts"])
    p, bias, (x, _y) = _params(held, std=0.3), _bias(), _batch()
    p = {k: v if v.dim() != 1 else 1 + 0.1 * torch.randn(v.shape)
         for k, v in p.items()}
    torch.manual_seed(0)
    model = tf.DeepseekV3ForCausalLM(conf).eval()
    sd = {"model.embed_tokens.weight": p["embed_tokens"],
          "model.norm.weight": p["norm"], "lm_head.weight": p["lm_head"].T}
    for i in range(CFG["num_hidden_layers"]):
        a, m = f"layers.{i}.", f"model.layers.{i}."
        sd[m + "input_layernorm.weight"] = p[a + "input_layernorm"]
        sd[m + "post_attention_layernorm.weight"] = \
            p[a + "post_attention_layernorm"]
        for n in ("q_proj", "kv_a_proj_with_mqa", "kv_b_proj", "o_proj"):
            sd[m + f"self_attn.{n}.weight"] = p[a + f"self_attn.{n}"].T
        sd[m + "self_attn.kv_a_layernorm.weight"] = \
            p[a + "self_attn.kv_a_layernorm"]

        def mlp(dst, gate_up, down):
            g, u = gate_up.chunk(2, dim=1)
            sd[dst + "gate_proj.weight"] = g.T
            sd[dst + "up_proj.weight"] = u.T
            sd[dst + "down_proj.weight"] = down.T

        if i < CFG["first_k_dense_replace"]:
            mlp(m + "mlp.", p[a + "mlp.gate_up"], p[a + "mlp.down"])
            continue
        sd[m + "mlp.gate.weight"] = p[a + "mlp.router"].T
        sd[m + "mlp.gate.e_score_correction_bias"] = \
            bias[i - CFG["first_k_dense_replace"]]
        mlp(m + "mlp.shared_experts.", p[a + "mlp.shared.gate_up"],
            p[a + "mlp.shared.down"])
        for e in range(CFG["n_routed_experts"]):
            mlp(m + f"mlp.experts.{e}.", p[a + "mlp.experts.gate_up"][e],
                p[a + "mlp.experts.down"][e])
    missing, unexpected = model.load_state_dict(
        {k: v.contiguous() for k, v in sd.items()}, strict=False)
    assert not unexpected and not [k for k in missing
                                   if "rotary" not in k], missing
    with torch.no_grad():
        want = model(input_ids=x).logits
    got = ref.logits(p, bias, x, CFG, held, block=5)
    _close(got, want, "logits")
