"""The plain reference against the port at a tiny size on the CPU: the
MLP step, the optimizer and the int8 wire agree bit for bit."""

import math

import numpy as np
import pytest
import torch

from harness import gen, reference


def test_mlp_grads_equal_layered_mlp():
    from brpc_tpu_torch.models.tensor_service import LayeredMLP

    sizes = [16, 48, 16, 48, 16]
    w = gen.mlp_weights(5, sizes, "cpu")
    (x, y), = gen.batches(5, 1, 32, sizes[0], sizes[-1], "cpu")
    h = LayeredMLP(sizes, device="cpu")
    assert list(h.names) == list(w) == list(gen.mlp_shapes(sizes))
    want, want_loss = h.grads(w, x, y)
    got, loss = reference.mlp_grads(list(w.values()), x, y)
    assert loss == want_loss
    for k, g in zip(w, got):
        assert torch.equal(g, want[k]), k


def test_momentum_equals_the_port_plain_update():
    from brpc_tpu_torch.ops import fused_update as fu

    g = torch.Generator().manual_seed(1)
    p, m, d = (torch.randn(1000, generator=g) for _ in range(3))
    want = fu.momentum_update_reference(p, m, d, lr=0.01, beta=0.9)
    got = reference.momentum(p, m, d, 0.01, 0.9)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("n", [1024, 256 * 7 + 13, 4096 + 1])
def test_int8_encode_equals_the_codec(n):
    from brpc_tpu_torch.runtime import codec

    x = torch.randn(n, generator=torch.Generator().manual_seed(n)) * 3e-3
    x[256:512] = 0.0  # an all-zero block keeps zero codes and scale
    enc = codec.encode(x.numpy(), "int8")
    q, s = reference.int8_encode(x)
    want_q, want_s = codec.split_wire(
        {"shape": [n], "codec": "int8", "block": enc.block}, enc.wire)
    assert enc.block == reference.BLOCK
    assert np.array_equal(q.numpy(), want_q)
    assert np.array_equal(s.numpy(), want_s)
    assert np.array_equal(reference.int8_widen(q, s, (n,)).numpy(),
                          enc.dequantized())


def test_int8_widen_equals_the_port_plain_dequantize():
    from brpc_tpu_torch.ops import quantize as qz

    x = torch.randn(3000, generator=torch.Generator().manual_seed(2))
    q, s = reference.int8_encode(x)
    want = qz.dequantize_reference(q, s, block=reference.BLOCK, n=3000,
                                   shape=(3000,))
    assert torch.equal(reference.int8_widen(q, s, (3000,)), want)


def test_error_feedback_follows_the_codec_over_rounds():
    from brpc_tpu_torch.runtime import codec

    port, ref = codec.ErrorFeedback(), reference.ErrorFeedback()
    for r in range(4):
        g = gen.grad(7, 0, r, 3, (40, 70), 1e-3, "cpu")
        x = port.compensate("t", g.numpy())
        e = codec.encode(x, "int8")
        port.settle("t", x, e.dequantized())
        q, s = ref.push(g)
        assert np.array_equal(reference.int8_widen(q, s, g.shape).numpy(),
                              e.dequantized())
    assert np.array_equal(ref.residual.numpy(), port.residual("t"))


def test_eligibility_follows_the_codec():
    from brpc_tpu_torch.runtime import codec

    for shape in [(768,), (1024,), (1023,), (768, 3072)]:
        t = torch.zeros(shape)
        assert reference.eligible(shape) == codec.eligible(t)


def test_ps_tensor_replays_pushes_in_order():
    p0 = torch.randn(10, generator=torch.Generator().manual_seed(3))
    gs = [torch.full((10,), float(i)) for i in range(1, 4)]
    p, m, views = reference.ps_tensor(p0, gs, 0.01, 0.9, seen={0, 2})
    pp, mm = p0, torch.zeros(10)
    for i, g in enumerate(gs, start=1):
        pp, mm = reference.momentum(pp, mm, g, 0.01, 0.9)
        if i == 2:
            assert torch.equal(views[2], pp)
    assert torch.equal(views[0], p0) and torch.equal(p, pp)
    assert torch.equal(m, mm)


def test_gpt2_set_is_the_published_one():
    shapes = gen.gpt2_shapes(12, 768, 1024, 50257)
    assert len(shapes) == 148
    assert sum(math.prod(s) for s in shapes.values()) == 124_439_808
    assert 4 * max(math.prod(s) for s in shapes.values()) == 154_389_504


def test_generation_is_seeded():
    a = gen.param_set(2**31 + 11, {"a": (3, 5), "b": (7,)}, 0.02, "cpu")
    b = gen.param_set(2**31 + 11, {"a": (3, 5), "b": (7,)}, 0.02, "cpu")
    c = gen.param_set(2**31 + 12, {"a": (3, 5), "b": (7,)}, 0.02, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["a"], c["a"])
    assert gen.subseed(2**40, "x") != gen.subseed(2**40, "y")
