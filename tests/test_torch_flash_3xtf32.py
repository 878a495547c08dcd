"""The arithmetic of K3's fp32 tensor-core kernel, emulated on the CPU.

``flash_tf32x3_kernel`` (brpc_tpu_torch/ops/csrc/flash_attention.cu) takes
every fp32 product of the carry on the tensor cores in 3xTF32: each operand
x is split into big = x rounded to TF32 (10 mantissa bits, to nearest,
ties away from zero: ``cvt.rna.tf32.f32``'s rule) and small = x - big, of
which the tensor core reads the top 19 bits (truncation). For p.v each
m16n8k8 step of 8 adds small.big, then big.small, then big.big into one
fp32 accumulator; q.k^T adds the two cross terms into an accumulator of
their own and big.big into another, and sums the two at the end. Here that
arithmetic is emulated in torch (the rounding on an int32 view of the
bits) and run through the port's plain walk,
``flash_carry_reference`` at the kernel's 64-key tile with its ragged last
tile, in place of its two fp32 products. The result is held against the
JAX package's Pallas kernel in interpret mode on the same numpy inputs, at
chip_smoke.py's FLASH_TOL: m to 1e-4, l to 1e-4 relative, acc/l to 1e-4.
The same walk with plain TF32 (one product of the rounded operands)
misses m's 1e-4 at d = 128, which is why the kernel splits.

Nothing in brpc_tpu_torch uses this emulation: the kernel is held against
the plain version itself on the card (tests/test_torch_cuda.py).
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from brpc_tpu.ops import flash_attention as jfa
from brpc_tpu_torch.ops import flash_attention as tfa
from tf32x3 import mm_1xtf32, mm_3xtf32, split, trunc

FLASH_TOL = {"m": 1e-4, "l": 1e-4, "acc": 1e-4}  # chip_smoke.py's, fp32
KERNEL_TILE_K = 64  # flash_tf32x3_kernel's keys per tile at d <= 128


def _kernel_products():
    """The walk's products in its order, q.k^T then p.v for each tile, as
    the kernel takes them."""
    calls = itertools.count()
    return lambda a, b: mm_3xtf32(a, b, apart=next(calls) % 2 == 0)


def _emulated_walk(monkeypatch, mm, q, k, v, m, l, acc, offsets):
    """The plain walk at the kernel's tile with its products taken by mm."""
    with monkeypatch.context() as patch:
        patch.setattr(torch, "matmul", mm)
        return tfa.flash_carry_reference(
            *[torch.from_numpy(a) for a in (q, k, v, m, l, acc)], offsets,
            causal=True, block_k=KERNEL_TILE_K, ragged_tail=True)


def _errors(got, want):
    """max |m - m'|, max |l - l'| / |l'|, max |acc/l - acc'/l'|."""
    gm, gl, gacc = (np.asarray(x, np.float64) for x in got)
    wm, wl, wacc = (np.asarray(x, np.float64) for x in want)
    return (np.abs(gm - wm).max(),
            (np.abs(gl - wl) / np.abs(wl)).max(),
            np.abs(gacc / gl - wacc / wl).max())


def _inputs(d, seed):
    """A causal GQA carry at offsets: 4 q heads over 2 kv heads, 96 rows at
    position 130 over 200 keys at position 20 (the diagonal crosses a
    64-key tile mid-way; the last tile holds 8 keys), folded into a carry
    that already holds other keys."""
    rng = np.random.default_rng(seed)
    b, h, hkv, sq, sk = 1, 4, 2, 96, 200
    f32 = np.float32
    q = rng.standard_normal((b, h, sq, d)).astype(f32)
    k = rng.standard_normal((b, hkv, sk, d)).astype(f32)
    v = rng.standard_normal((b, hkv, sk, d)).astype(f32)
    m = rng.standard_normal((b, h, sq, 1)).astype(f32)
    l = (np.abs(rng.standard_normal((b, h, sq, 1))) + 0.5).astype(f32)
    acc = rng.standard_normal((b, h, sq, d)).astype(f32)
    return (q, k, v, m, l, acc), (130, 20)


def _jax_carry(arrays, offsets):
    return jfa.flash_attention_carry(
        *[jnp.asarray(a) for a in arrays], jnp.asarray(offsets, jnp.int32),
        causal=True, interpret=True)


@pytest.mark.parametrize("d", [8, 40, 128])
def test_3xtf32_walk_matches_jax_at_flash_tol(monkeypatch, d):
    arrays, offsets = _inputs(d, seed=d)
    got = _emulated_walk(monkeypatch, _kernel_products(), *arrays, offsets)
    err_m, err_l, err_acc = _errors(got, _jax_carry(arrays, offsets))
    assert err_m <= FLASH_TOL["m"], err_m
    assert err_l <= FLASH_TOL["l"], err_l
    assert err_acc <= FLASH_TOL["acc"], err_acc


def test_plain_tf32_misses_m_at_d128(monkeypatch):
    # The same walk and inputs with one TF32 product: a 10-bit mantissa
    # puts ~5e-3 into each score at d = 128, ~4e-4 into s * scale.
    arrays, offsets = _inputs(128, seed=128)
    want = _jax_carry(arrays, offsets)
    err_m_1x = _errors(_emulated_walk(monkeypatch, mm_1xtf32, *arrays,
                                      offsets), want)[0]
    err_m_3x = _errors(_emulated_walk(monkeypatch, _kernel_products(),
                                      *arrays, offsets), want)[0]
    assert err_m_1x > FLASH_TOL["m"], err_m_1x
    assert err_m_3x <= FLASH_TOL["m"] < err_m_1x


def test_split_rounds_as_cvt_rna():
    # Ties go away from zero; big keeps 10 mantissa bits; big + small is x
    # exactly; small's truncation drops only bits below big's 2^-21.
    one = 1.0 + 2.0 ** -11  # halfway between two TF32 values
    x = torch.tensor([one, -one, 1.0 + 2.0 ** -12, 3.0, 1e-3, -7.25e4],
                     dtype=torch.float32)
    big, small = split(x)
    assert big[0].item() == 1.0 + 2.0 ** -10
    assert big[1].item() == -(1.0 + 2.0 ** -10)
    assert big[2].item() == 1.0 and big[3].item() == 3.0
    assert torch.equal(big, trunc(big))
    assert torch.equal(big + (x - big), x)
    assert ((x - big - small).abs() <= x.abs() * 2.0 ** -21).all()
