"""The port's kernel modules against the JAX package's.

Each CUDA kernel of brpc_tpu_torch has a plain PyTorch version beside it;
these tests hold that plain version — which the wrappers take for CPU
tensors — against the JAX package's Pallas kernel run in interpret mode
and against its jnp reference, on the same numpy inputs made from a seed.
Tolerance is 0 (bit-exact) wherever both sides round each float32
operation once; the one exception, the interpreted momentum kernel that
XLA:CPU compiles into FMAs, is bounded by the roundings the FMA drops.
The CUDA kernels themselves are held against the plain versions on the
card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from brpc_tpu.ops import fused_update as jfu
from brpc_tpu.ops import quantize as jq
from brpc_tpu.runtime import codec as jcodec
from brpc_tpu_torch.ops import fused_update as tfu
from brpc_tpu_torch.ops import quantize as tq
from brpc_tpu_torch.runtime import codec as tcodec

LR, BETA = 0.05, 0.8


def _pmg(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", [(1000,), (64, 256), (37, 300)])
def test_momentum_plain_matches_jax_kernel(shape):
    p, m, g = _pmg(shape, seed=sum(shape))
    tfu.LAUNCHES.reset()
    tp, tm = tfu.fused_momentum_update(
        torch.from_numpy(p), torch.from_numpy(m), torch.from_numpy(g),
        lr=LR, beta=BETA)
    assert tfu.LAUNCHES.value == 0  # CPU tensors take the plain version
    rp, rm = jfu.momentum_update_reference(
        jnp.asarray(p), jnp.asarray(m), jnp.asarray(g), lr=LR, beta=BETA)
    # Tolerance 0 against the jnp reference: two roundings per line, on
    # both sides.
    np.testing.assert_array_equal(tp.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(rm))
    assert tp.shape == torch.Size(shape)

    jp, jm = jfu.fused_momentum_update(
        jnp.asarray(p), jnp.asarray(m), jnp.asarray(g), lr=LR, beta=BETA,
        interpret=True)
    # The interpreted Pallas kernel is compiled by XLA:CPU, which
    # contracts each line into one FMA (one rounding): it equals the
    # FMA model exactly ...
    b, lr = np.float64(np.float32(BETA)), np.float64(np.float32(LR))
    fma_m = (b * m.astype(np.float64) + g).astype(np.float32)
    fma_p = (p.astype(np.float64) - lr * fma_m).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jm), fma_m)
    np.testing.assert_array_equal(np.asarray(jp), fma_p)
    # ... and the port (two roundings, like the CUDA kernel, which forbids
    # contraction) differs from it by the dropped rounding of the product
    # (half an ulp of beta*m) plus one ulp of m' where the two sums round
    # to neighbours; for p' that error scaled by lr, half an ulp of lr*m',
    # and one ulp of p'.
    e_m = (0.5 * np.spacing(np.abs(np.float32(BETA) * m))
           + np.spacing(np.abs(tm.numpy())))
    assert (np.abs(tm.numpy() - np.asarray(jm)) <= e_m).all()
    e_p = (0.5 * np.spacing(np.abs(np.float32(LR) * tm.numpy()))
           + np.float32(LR) * e_m + np.spacing(np.abs(tp.numpy())))
    assert (np.abs(tp.numpy() - np.asarray(jp)) <= e_p).all()


def test_momentum_is_out_of_place():
    p, m, g = (torch.from_numpy(a) for a in _pmg((513,), seed=3))
    p0, m0 = p.clone(), m.clone()
    p2, m2 = tfu.fused_momentum_update(p, m, g, lr=LR, beta=BETA)
    assert torch.equal(p, p0) and torch.equal(m, m0)
    assert p2.data_ptr() != p.data_ptr() and m2.data_ptr() != m.data_ptr()


def _codes(codec, n, block, seed):
    """Wire codes + scales for n values, made by the JAX package's codec
    (the bytes a quantized push or pull carries)."""
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    enc = jcodec.encode(x, codec, block=block, min_bytes=0)
    meta = {"dtype": "<f4", "shape": [n], "codec": codec, "block": block}
    q, scales = jcodec.split_wire(meta, enc.wire)
    return meta, enc.wire, q, scales


@pytest.mark.parametrize("codec", ["int8", "fp8e4m3"])
@pytest.mark.parametrize("block,n", [(256, 256 * 40), (256, 256 * 40 + 77),
                                     (128, 128 * 33 + 5)])
def test_dequant_plain_matches_jax_kernel(codec, block, n):
    meta, wire, q, scales = _codes(codec, n, block, seed=n)
    tq.LAUNCHES_INT8.reset()
    tq.LAUNCHES_FP8.reset()
    tq_codes, t_scales = tcodec.split_wire(meta, wire)
    q_t = torch.from_numpy(np.array(tq_codes))
    if codec == "fp8e4m3":
        q_t = q_t.view(torch.float8_e4m3fn)
    got = tq.dequantize_blocks(q_t, torch.from_numpy(np.array(t_scales)),
                               block=block, n=n, shape=(n,))
    assert tq.LAUNCHES_INT8.value == tq.LAUNCHES_FP8.value == 0
    want = jq.dequantize_blocks(jnp.asarray(q), jnp.asarray(scales),
                                block=block, n=n, shape=(n,),
                                interpret=True)
    ref = jq.dequantize_reference(jnp.asarray(q), jnp.asarray(scales),
                                  block=block, n=n, shape=(n,))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_dequant_plain_reshapes_and_checks_sizes():
    meta, wire, _q, _s = _codes("int8", 37 * 300, 256, seed=1)
    q, s = tcodec.split_wire(meta, wire)
    out = tq.dequantize_blocks(torch.from_numpy(np.array(q)),
                               torch.from_numpy(np.array(s)), block=256,
                               n=37 * 300, shape=(37, 300))
    assert out.shape == (37, 300)
    with pytest.raises(ValueError):
        tq.dequantize_blocks(torch.from_numpy(np.array(q)),
                             torch.from_numpy(np.array(s[:-1])), block=256,
                             n=37 * 300, shape=(37, 300))


# ---- K1 in half precision -------------------------------------------------
#
# The JAX package applies the update in the parameters' own dtype. Its
# server's numpy path (no TPU; brpc_tpu/runtime/param_server.py:896-906)
# computes ``momentum * m + g`` and ``p - lr * m2`` on float16 arrays with
# Python-float constants: NEP 50 rounds the constants to float16 and every
# operation rounds to float16. Its Pallas kernel in interpret mode does the
# same for bfloat16. The port's plain version (and the CUDA kernel, which
# runs each operation in fp32 and rounds it) follows that order, so both
# comparisons are bit for bit.

HALF_SHAPES = [(1000,), (64, 256), (37, 300)]


def _bits(x):
    """Raw 16-bit patterns of a half tensor or array, for exact equality."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


@pytest.mark.parametrize("shape", HALF_SHAPES)
def test_momentum_fp16_plain_matches_jax_server_numpy_update(shape):
    p, m, g = (a.astype(np.float16) for a in _pmg(shape, seed=7 + sum(shape)))
    tfu.LAUNCHES_F16.reset()
    tp, tm = tfu.fused_momentum_update(
        torch.from_numpy(p), torch.from_numpy(m), torch.from_numpy(g),
        lr=LR, beta=BETA)
    assert tfu.LAUNCHES_F16.value == 0  # CPU tensors take the plain version
    assert tp.dtype == tm.dtype == torch.float16
    # The JAX server's numpy update, as it is written there.
    m2 = BETA * m + g
    p2 = p - LR * m2
    assert m2.dtype == p2.dtype == np.float16
    np.testing.assert_array_equal(_bits(tm), _bits(m2))
    np.testing.assert_array_equal(_bits(tp), _bits(p2))


@pytest.mark.parametrize("shape", HALF_SHAPES)
def test_momentum_bf16_plain_matches_jax_kernel_interpreted(shape):
    p, m, g = _pmg(shape, seed=11 + sum(shape))
    tp, tm = tfu.fused_momentum_update(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (p, m, g)),
        lr=LR, beta=BETA)
    jp, jm = jfu.fused_momentum_update(
        *(jnp.asarray(a, jnp.bfloat16) for a in (p, m, g)), lr=LR,
        beta=BETA, interpret=True)
    assert tp.dtype == torch.bfloat16 and jp.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bits(tm), _bits(jm))
    np.testing.assert_array_equal(_bits(tp), _bits(jp))


@pytest.mark.parametrize("shape", HALF_SHAPES)
def test_momentum_fp16_plain_against_jax_jitted(shape):
    """The jitted JAX function (XLA:CPU) computes fp16 elementwise work in
    fp32 and rounds a fused expression once: m' = rnd(beta*m + g) with the
    product unrounded, p' = rnd(p - lr*m'). The port rounds beta*m and
    lr*m' to fp16 first, as the JAX server's numpy path does. So the two
    differ by at most one dropped half-ulp rounding of each product plus
    one ulp of the result they round to (m': 1/2 ulp(beta*m) + 1 ulp(m');
    p': that error scaled by lr, 1/2 ulp(lr*m') and 1 ulp(p')) — within
    one fp16 ulp at the rounded product and one at the result. Measured in
    fp16 ulps of the result alone the gap is unbounded, because beta*m + g
    can cancel to a value far smaller than the product."""
    p, m, g = (a.astype(np.float16) for a in _pmg(shape, seed=3 + sum(shape)))
    tp, tm = (t.numpy().astype(np.float32) for t in tfu.fused_momentum_update(
        torch.from_numpy(p), torch.from_numpy(m), torch.from_numpy(g),
        lr=LR, beta=BETA))
    jp, jm = (np.asarray(a).astype(np.float32) for a in
              jfu.fused_momentum_update(jnp.asarray(p), jnp.asarray(m),
                                        jnp.asarray(g), lr=LR, beta=BETA))

    def ulp(x):
        return np.spacing(np.abs(x).astype(np.float16)).astype(np.float32)

    b16, lr16 = np.float32(np.float16(BETA)), np.float32(np.float16(LR))
    e_m = 0.5 * ulp(b16 * m.astype(np.float32)) + ulp(tm)
    assert (np.abs(tm - jm) <= e_m).all()
    e_p = lr16 * e_m + 0.5 * ulp(lr16 * tm) + ulp(tp)
    assert (np.abs(tp - jp) <= e_p).all()
    assert (tm != jm).any()  # the orders really differ at this size


def test_momentum_rejects_mixed_dtypes():
    p, m, g = (torch.from_numpy(a) for a in _pmg((64,), seed=5))
    with pytest.raises(TypeError, match="must agree"):
        tfu.fused_momentum_update(p.half(), m.half(), g)
    with pytest.raises(TypeError, match="must agree"):
        tfu.fused_momentum_update(p, m.bfloat16(), g)
