"""The port's flash attention against the JAX package's, on the CPU.

Every case of tests/test_flash_attention.py (causal and not, GQA 8/2, the
score-jump rescale), plus carries at non-zero offsets (a fully masked one
included), a chain of carries against one pass, bf16 inputs, the CUDA
kernel's 128-key tile at d 64 and 128, and the plain version's
ragged-tail walk against the dense oracle. The same
numpy inputs go through ``brpc_tpu.ops.flash_attention`` — its Pallas
kernel in interpret mode — and through ``brpc_tpu_torch.ops.
flash_attention`` on CPU tensors (its plain version, ``flash_carry_
reference``).

Tolerances: fp32 2e-5, as the JAX package's own tests (the same
products summed in another order). bf16 inputs: m and l to 1e-4; p is
rounded to bf16 in both packages, and where the two summation orders put
a p on either side of a rounding boundary that key's weight moves by one
bf16 step (at most 2^-8, p <= 1), so acc may differ by 2^-8 * max|v| in an
element, and in under 1% of elements by more than 1e-5; outputs one bf16
step at their magnitude.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from brpc_tpu.ops import flash_attention as jfa
from brpc_tpu_torch.ops import flash_attention as tfa

F32_TOL = 2e-5


def _qkv(b, h, hkv, s, d, seed=0, sk=None):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    return (rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32))


def _carries(b, h, s, d, seed):
    """A carry that is not fresh: as if some keys were folded already."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((b, h, s, 1)).astype(np.float32)
    l = (np.abs(rng.standard_normal((b, h, s, 1))) + 0.5).astype(np.float32)
    acc = rng.standard_normal((b, h, s, d)).astype(np.float32)
    return m, l, acc


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _jax(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# (b, h, hkv, s, d, causal, block, seed, vs_jax): the shapes of
# tests/test_flash_attention.py, held against the JAX package and the dense
# oracle; then shapes around them, against the dense oracle (each JAX shape
# costs a Pallas interpret compile).
FULL_CASES = [
    (2, 4, 4, 256, 64, False, 64, 0, True),
    (2, 4, 4, 256, 64, True, 64, 0, True),
    (2, 8, 2, 128, 32, True, 32, 3, True),     # GQA 8/2
    (2, 8, 2, 128, 32, False, 32, 3, False),
    (1, 4, 1, 64, 16, True, 16, 5, False),     # one kv head
    (1, 2, 2, 96, 8, True, 32, 6, False),      # 3 k blocks
    (3, 2, 2, 32, 16, False, 64, 7, False),    # block larger than s
    (1, 6, 3, 48, 24, True, 16, 8, False),
]


@pytest.mark.parametrize("b,h,hkv,s,d,causal,block,seed,vs_jax", FULL_CASES)
def test_flash_attention_matches_jax_and_dense(b, h, hkv, s, d, causal,
                                               block, seed, vs_jax):
    q, k, v = _qkv(b, h, hkv, s, d, seed)
    out = tfa.flash_attention(*_torch(q, k, v), causal=causal,
                              block_q=block, block_k=block)
    dense = tfa.dense_attention_mh(*_torch(q, k, v), causal=causal)
    _close(out, dense, F32_TOL)
    if vs_jax:
        jout = jfa.flash_attention(*_jax(q, k, v), causal=causal,
                                   block_q=block, block_k=block,
                                   interpret=True)
        _close(out, jout, F32_TOL)
        _close(dense, jfa.dense_attention_mh(*_jax(q, k, v), causal=causal),
               F32_TOL)


@pytest.mark.parametrize("block,vs_jax", [(64, True), (32, False)])
def test_flash_score_jump_rescale(block, vs_jax):
    # One late kv row dominates every score (the online max jumps by ~1e2
    # after most blocks were accumulated): wrong rescaling would corrupt
    # the normalizer invisibly on smooth inputs.
    q, k, v = _qkv(1, 2, 2, 256, 32, seed=7)
    k[:, :, -3] = 30.0
    out = tfa.flash_attention(*_torch(q, k, v), block_q=block,
                              block_k=block)
    _close(out, tfa.dense_attention_mh(*_torch(q, k, v)), 3e-5)
    if vs_jax:
        jout = jfa.flash_attention(*_jax(q, k, v), block_q=block,
                                   block_k=block, interpret=True)
        _close(out, jout, 3e-5)


# (sq, sk, q_off, kv_off, causal, block): non-zero offsets. (0, 64) with a
# 64-row q block lies wholly before its keys: the carry must come back as
# it went in. (64, 0) attends every key; the others cut the diagonal.
CARRY_CASES = [
    (64, 64, 0, 64, True, 16),     # fully masked: nothing folds
    (64, 64, 0, 1000, True, 32),   # fully masked, far
    (64, 64, 64, 0, True, 16),     # fully visible
    (64, 64, 32, 16, True, 16),    # the diagonal crosses mid-block
    (32, 64, 48, 0, True, 16),     # sq != sk
    (64, 32, 7, 3, True, 8),       # odd offsets
    (64, 64, 5, 9, False, 16),     # offsets do not matter unmasked
]


@pytest.mark.parametrize("sq,sk,q_off,kv_off,causal,block", CARRY_CASES)
def test_carry_at_offsets_matches_jax(sq, sk, q_off, kv_off, causal, block):
    b, h, hkv, d = 2, 4, 2, 16
    q, k, v = _qkv(b, h, hkv, sq, d, seed=sq + sk + q_off, sk=sk)
    m, l, acc = _carries(b, h, sq, d, seed=kv_off)
    off = np.array([q_off, kv_off], np.int32)
    got = tfa.flash_attention_carry(*_torch(q, k, v, m, l, acc),
                                    torch.from_numpy(off), causal=causal,
                                    block_q=block, block_k=block)
    want = jfa.flash_attention_carry(*_jax(q, k, v, m, l, acc),
                                     jnp.asarray(off), causal=causal,
                                     block_q=block, block_k=block,
                                     interpret=True)
    for g, w in zip(got, want):
        _close(g, w, F32_TOL)
    # The offsets by value give the same carries.
    by_value = tfa.flash_attention_carry(*_torch(q, k, v, m, l, acc),
                                         (q_off, kv_off), causal=causal,
                                         block_q=block, block_k=block)
    for g, w in zip(got, by_value):
        assert torch.equal(g, w)
    if causal and kv_off > q_off + sq - 1:
        for g, before in zip(got, _torch(m, l, acc)):
            assert torch.equal(g, before)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("chunks", [2, 4])
def test_chain_of_carries_equals_one_pass(causal, chunks):
    # Folding the keys in chunks with their offsets (what one rank of the
    # ring does) gives what one pass over all keys gives; the 4-chunk
    # causal chain is also held against the same chain in the JAX package.
    b, h, hkv, s, d = 1, 4, 2, 128, 16
    q, k, v = _qkv(b, h, hkv, s, d, seed=chunks)
    tq, tk, tv = _torch(q, k, v)
    m, l, acc = tfa.flash_init(b, h, s, d, device="cpu")
    step = s // chunks
    for c in range(chunks):
        sl = slice(c * step, (c + 1) * step)
        m, l, acc = tfa.flash_attention_carry(
            tq, tk[:, :, sl], tv[:, :, sl], m, l, acc, (0, c * step),
            causal=causal, block_q=32, block_k=32)
    out = tfa.flash_finalize(l, acc, torch.float32)
    _close(out, tfa.flash_attention(tq, tk, tv, causal=causal, block_q=32,
                                    block_k=32), F32_TOL)
    _close(out, tfa.dense_attention_mh(tq, tk, tv, causal=causal), F32_TOL)
    if chunks == 4 and causal:
        jm, jl, jacc = jfa.flash_init(b, h, s, d)
        for c in range(chunks):
            sl = slice(c * step, (c + 1) * step)
            jm, jl, jacc = jfa.flash_attention_carry(
                *_jax(q, k[:, :, sl], v[:, :, sl]), jm, jl, jacc,
                jnp.asarray([0, c * step], jnp.int32), causal=causal,
                block_q=32, block_k=32, interpret=True)
        _close(out, jfa.flash_finalize(jl, jacc, jnp.float32), F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hkv", [4, 2])
def test_bf16_inputs_match_jax(causal, hkv):
    b, h, s, d = 1, 4, 64, 32
    q, k, v = _qkv(b, h, hkv, s, d, seed=hkv)
    m, l, acc = _carries(b, h, s, d, seed=1)
    tq, tk, tv = _torch(q, k, v, dtype=torch.bfloat16)
    got = tfa.flash_attention_carry(tq, tk, tv, *_torch(m, l, acc), (0, 0),
                                    causal=causal, block_q=32, block_k=32)
    want = jfa.flash_attention_carry(
        *_jax(q, k, v, dtype=jnp.bfloat16), *_jax(m, l, acc),
        jnp.zeros((2,), jnp.int32), causal=causal, block_q=32, block_k=32,
        interpret=True)
    for g, w in zip(got[:2], want[:2]):
        _close(g, w, 1e-4)
    diff = np.abs(got[2].numpy() - np.asarray(want[2]))
    assert diff.max() <= 2.0 ** -8 * np.abs(v).max() * 1.01, diff.max()
    assert (diff > 1e-5).mean() < 0.01
    out = tfa.flash_attention(tq, tk, tv, causal=causal, block_q=32,
                              block_k=32)
    jout = jfa.flash_attention(*_jax(q, k, v, dtype=jnp.bfloat16),
                               causal=causal, block_q=32, block_k=32,
                               interpret=True)
    assert out.dtype == torch.bfloat16
    got32 = out.float().numpy()
    want32 = np.asarray(jout, np.float32)
    step = 2.0 ** -7 * np.maximum(np.abs(want32), 1.0)  # a bf16 step at |x|
    assert (np.abs(got32 - want32) <= step).all()


def test_init_and_finalize_match_jax():
    m, l, acc = tfa.flash_init(2, 3, 5, 4, device="cpu")
    jm, jl, jacc = jfa.flash_init(2, 3, 5, 4)
    for g, w in ((m, jm), (l, jl), (acc, jacc)):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # Never-attended rows (l == 0, acc == 0) finalize to 0, not NaN.
    l = torch.tensor([[[[0.0], [2.0]]]])
    acc = torch.tensor([[[[0.0, 0.0], [4.0, 6.0]]]])
    out = tfa.flash_finalize(l, acc, torch.float32)
    np.testing.assert_array_equal(out.numpy(), np.asarray(
        jfa.flash_finalize(jnp.asarray(l.numpy()), jnp.asarray(acc.numpy()),
                           jnp.float32)))
    assert torch.equal(out, torch.tensor([[[[0.0, 0.0], [2.0, 3.0]]]]))


@pytest.mark.parametrize("bad,err", [
    ("heads", ValueError), ("carry_shape", ValueError),
    ("offsets", ValueError), ("kv_shape", ValueError)])
def test_carry_refuses_bad_shapes(bad, err):
    q, k, v = _torch(*_qkv(1, 4, 2, 8, 4))
    m, l, acc = tfa.flash_init(1, 4, 8, 4, device="cpu")
    off = (0, 0)
    if bad == "heads":
        k = v = torch.zeros(1, 3, 8, 4)
    elif bad == "carry_shape":
        m = torch.zeros(1, 4, 8)
    elif bad == "offsets":
        off = (0, 0, 0)
    else:
        v = torch.zeros(1, 2, 9, 4)
    with pytest.raises(err):
        tfa.flash_attention_carry(q, k, v, m, l, acc, off)


def test_kernel_tile_k():
    # The tile is the CUDA kernel's own choice (brpc_flash_tile_k, checked
    # on the card in test_torch_cuda.py); CPU tensors have no kernel.
    q, k, v = _torch(*_qkv(1, 4, 2, 8, 4))
    acc = tfa.flash_init(1, 4, 8, 4, device="cpu")[2]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tfa.kernel_tile_k(q, k, v, acc)


# The CUDA kernel's tile (kernel_tile_k: 128 keys on its bf16 tensor-core
# path) at its two widths, against the JAX package: a causal GQA carry whose
# diagonal crosses a 128-row tile mid-way (q_off 24), and a ring hop's
# offset pair (each rank's own diagonal block at sq = 256).
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("q_off,kv_off", [(24, 0), (256, 256)])
def test_tile_128_carry_matches_jax(d, q_off, kv_off):
    b, h, hkv, s = 1, 4, 2, 256
    q, k, v = _qkv(b, h, hkv, s, d, seed=d + q_off)
    m, l, acc = _carries(b, h, s, d, seed=d)
    off = np.array([q_off, kv_off], np.int32)
    got = tfa.flash_attention_carry(*_torch(q, k, v, m, l, acc),
                                    torch.from_numpy(off), causal=True,
                                    block_q=128, block_k=128)
    want = jfa.flash_attention_carry(*_jax(q, k, v, m, l, acc),
                                     jnp.asarray(off), causal=True,
                                     block_q=128, block_k=128,
                                     interpret=True)
    for g, w in zip(got, want):
        _close(g, w, F32_TOL)


# The plain version's ragged-tail walk (128-key blocks and a 104-key last
# one at sk = 1000, as the CUDA kernel walks them), from a fresh carry,
# against the dense oracle.
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_ragged_tail_walk_matches_dense(d, causal):
    b, h, hkv, s = 1, 4, 2, 1000
    tq, tk, tv = _torch(*_qkv(b, h, hkv, s, d, seed=d))
    m, l, acc = tfa.flash_carry_reference(
        tq, tk, tv, *tfa.flash_init(b, h, s, d, device="cpu"), (0, 0),
        causal=causal, block_k=128, ragged_tail=True)
    out = tfa.flash_finalize(l, acc, torch.float32)
    _close(out, tfa.dense_attention_mh(tq, tk, tv, causal=causal), F32_TOL)
    # The JAX package's walk (_pick_block: 1000 -> 8-key blocks) agrees.
    _, l8, acc8 = tfa.flash_carry_reference(
        tq, tk, tv, *tfa.flash_init(b, h, s, d, device="cpu"), (0, 0),
        causal=causal, block_k=128)
    _close(out, tfa.flash_finalize(l8, acc8, torch.float32), F32_TOL)
