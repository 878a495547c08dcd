"""The port's serving decoder against the JAX package's, on the CPU.

Both packages run the same inputs — made in numpy from a seed — with the
JAX package's ``init_decoder(PRNGKey(0))`` parameters carried across
(``decoder_params_from_numpy``), at the JAX tests' sizes (vocab 64, dim
32, max_len 64).

Tolerance. Both compute in fp32 with another summation order (XLA's dot
against PyTorch's matmul, the scale as a divide against a multiply), so
the returned k/v rows are held to rtol 1e-5, atol 1e-6, and the next
tokens must be equal wherever the top-2 gap of the logits, recomputed in
float64 numpy, exceeds GAP_TOL: below it the two roundings may pick
either token. Within the port, paged == monolithic and a verify window ==
sequential decode hold bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brpc_tpu.models import decoder as jdec
from brpc_tpu_torch.models import decoder as tdec
from brpc_tpu_torch.runtime.state import (decoder_params_from_numpy,
                                          decoder_params_to_numpy)

JP = jdec.init_decoder(jax.random.PRNGKey(0))
NP = {k: np.asarray(v) for k, v in JP._asdict().items()}
TP = decoder_params_from_numpy(NP, device="cpu")
MAX_LEN = 64
DIM = 32
RTOL, ATOL = 1e-5, 1e-6
GAP_TOL = 1e-3
PROMPTS = [[3, 7, 11], [5, 2], [9, 4, 1], list(range(1, 41))]


@pytest.fixture(autouse=True)
def _highest_matmul_precision_one_thread():
    """fp32 matmuls at full precision; one intra-op thread, since these
    shapes are tiny and a parallel region on a host the other test
    workers keep busy waits for every one of its threads."""
    prev = torch.get_float32_matmul_precision()
    threads = torch.get_num_threads()
    torch.set_float32_matmul_precision("highest")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision(prev)


def _np_step(kv_k, kv_v, lengths, tokens):
    """One ``_attend`` position in float64 numpy over dense lanes (written
    in place): -> logits (B, vocab)."""
    p = {k: v.astype(np.float64) for k, v in NP.items()}
    B, L, D = kv_k.shape
    pos = np.minimum(lengths, p["pos"].shape[0] - 1)
    x = p["embed"][tokens] + p["pos"][pos]
    k_new, v_new = x @ p["wk"], x @ p["wv"]
    for b in range(B):
        if lengths[b] < L:
            kv_k[b, lengths[b]] = k_new[b]
            kv_v[b, lengths[b]] = v_new[b]
    scores = np.einsum("bd,bld->bl", x @ p["wq"], kv_k) / np.sqrt(D)
    scores = np.where(np.arange(L)[None, :] <= lengths[:, None], scores,
                      -np.inf)
    w = np.exp(scores - scores.max(axis=1, keepdims=True))
    attn = w / w.sum(axis=1, keepdims=True)
    out = np.einsum("bl,bld->bd", attn, kv_v) @ p["wo"] + 0.5 * p["pos"][pos]
    return out @ p["embed"].T


def _np_window(kv_k, kv_v, lengths, window, n_known=None):
    """float64 logits (B, W, vocab) of a verify (or draft) window."""
    kv_k, kv_v = kv_k.astype(np.float64), kv_v.astype(np.float64)
    logits, prev = [], window[:, 0]
    for j in range(window.shape[1]):
        inp = window[:, j] if n_known is None else np.where(
            j < n_known, window[:, j], prev)
        lg = _np_step(kv_k, kv_v, lengths + j, inp)
        logits.append(lg)
        prev = lg.argmax(axis=1)
    return np.stack(logits, axis=1)


def _assert_tokens(got, want, logits):
    """Equal wherever the float64 top-2 gap exceeds GAP_TOL."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > GAP_TOL
    assert decided.mean() > 0.9, "inputs leave too few decided tokens"
    np.testing.assert_array_equal(np.asarray(got)[decided],
                                  np.asarray(want)[decided])


def _lanes(seed, B=4, L=MAX_LEN, lo=0, hi=MAX_LEN - 8):
    """Random finite lanes: rows below each length are 'written', rows
    past it hold whatever (finite) values a staging buffer would."""
    rng = np.random.default_rng(seed)
    kv_k = rng.standard_normal((B, L, DIM)).astype(np.float32)
    kv_v = rng.standard_normal((B, L, DIM)).astype(np.float32)
    lengths = rng.integers(lo, hi, B)
    tokens = rng.integers(0, NP["embed"].shape[0], B)
    return kv_k, kv_v, lengths, tokens


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) if a.dtype.kind == "f" else
            jnp.asarray(a, jnp.int32) for a in arrays]


def _paged(kv_k, kv_v, block_rows, seed):
    """The same lanes as a shuffled block pool + tables."""
    B, L, D = kv_k.shape
    T = L // block_rows
    perm = np.random.default_rng(seed).permutation(B * T)
    pool_k = np.zeros((B * T, block_rows, D), np.float32)
    pool_v = np.zeros_like(pool_k)
    tables = perm.reshape(B, T)
    for b in range(B):
        for t in range(T):
            pool_k[tables[b, t]] = kv_k[b, t * block_rows:(t + 1) * block_rows]
            pool_v[tables[b, t]] = kv_v[b, t * block_rows:(t + 1) * block_rows]
    return pool_k, pool_v, tables


# ---------------------------------------------------------------- params

def test_init_decoder_draws_from_its_generator():
    a = tdec.init_decoder(torch.Generator().manual_seed(5), device="cpu")
    b = tdec.init_decoder(torch.Generator().manual_seed(5), device="cpu")
    c = tdec.init_decoder(torch.Generator().manual_seed(6), device="cpu")
    assert [t.shape for t in a] == [(64, 32), (256, 32)] + [(32, 32)] * 4
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.embed, c.embed)
    # Weights are normal / sqrt(dim), as the JAX package's.
    assert abs(float(a.wq.std()) * np.sqrt(32) - 1.0) < 0.1


def test_params_carry_across_both_ways():
    back = decoder_params_to_numpy(TP)
    for k, v in NP.items():
        np.testing.assert_array_equal(back[k], v)
    assert not np.shares_memory(TP.embed.numpy(), NP["embed"])


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdec.init_decoder(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        decoder_params_from_numpy(NP)


# ---------------------------------------------------------------- steps

@pytest.mark.parametrize("seed", range(4))
def test_decode_step_matches_jax(seed):
    kv_k, kv_v, lengths, tokens = _lanes(seed)
    jn, jk, jv = jdec.decode_step(JP, *_j(kv_k, kv_v, lengths, tokens))
    tn, tk, tv = tdec.decode_step(TP, *_t(kv_k, kv_v, lengths, tokens))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), RTOL, ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), RTOL, ATOL)
    logits = _np_step(kv_k.astype(np.float64), kv_v.astype(np.float64),
                      lengths, tokens)
    _assert_tokens(tn.numpy(), np.asarray(jn), logits)


@pytest.mark.parametrize("seed", range(4))
def test_decode_step_paged_matches_jax_and_the_dense_step(seed):
    kv_k, kv_v, lengths, tokens = _lanes(seed)
    pool_k, pool_v, tables = _paged(kv_k, kv_v, 8, seed)
    jn, jk, jv = jdec.decode_step_paged(
        JP, *_j(pool_k, pool_v, tables, lengths, tokens))
    tn, tk, tv = tdec.decode_step_paged(
        TP, *_t(pool_k, pool_v, tables, lengths, tokens))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), RTOL, ATOL)
    logits = _np_step(kv_k.astype(np.float64), kv_v.astype(np.float64),
                      lengths, tokens)
    _assert_tokens(tn.numpy(), np.asarray(jn), logits)
    # Within the port: the gathered lanes give the dense step's bits.
    dn, dk, dv = tdec.decode_step(TP, *_t(kv_k, kv_v, lengths, tokens))
    assert torch.equal(tn, dn) and torch.equal(tk, dk) and torch.equal(tv, dv)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("W", [1, 3, 5])
def test_verify_step_matches_jax(seed, W):
    kv_k, kv_v, lengths, _ = _lanes(seed, hi=MAX_LEN - W)
    window = np.random.default_rng(seed + 10).integers(0, 64, (4, W))
    jy, jk, jv = jdec.verify_step(JP, *_j(kv_k, kv_v, lengths, window))
    ty, tk, tv = tdec.verify_step(TP, *_t(kv_k, kv_v, lengths, window))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), RTOL, ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), RTOL, ATOL)
    _assert_tokens(ty.numpy(), np.asarray(jy),
                   _np_window(kv_k, kv_v, lengths, window))


@pytest.mark.parametrize("seed", range(3))
def test_verify_step_paged_matches_jax_and_the_dense_window(seed):
    W = 4
    kv_k, kv_v, lengths, _ = _lanes(seed, hi=MAX_LEN - W)
    window = np.random.default_rng(seed + 20).integers(0, 64, (4, W))
    pool_k, pool_v, tables = _paged(kv_k, kv_v, 16, seed)
    jy, jk, _ = jdec.verify_step_paged(
        JP, *_j(pool_k, pool_v, tables, lengths, window))
    ty, tk, tv = tdec.verify_step_paged(
        TP, *_t(pool_k, pool_v, tables, lengths, window))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), RTOL, ATOL)
    _assert_tokens(ty.numpy(), np.asarray(jy),
                   _np_window(kv_k, kv_v, lengths, window))
    dy, dk, dv = tdec.verify_step(TP, *_t(kv_k, kv_v, lengths, window))
    assert torch.equal(ty, dy) and torch.equal(tk, dk) and torch.equal(tv, dv)


@pytest.mark.parametrize("seed", range(3))
def test_draft_propose_matches_jax(seed):
    W = 5
    rng = np.random.default_rng(seed + 30)
    kv_k, kv_v, lengths, _ = _lanes(seed, hi=MAX_LEN - W)
    window = rng.integers(0, 64, (4, W))
    n_known = rng.integers(1, W + 1, 4)
    jy, jk, _ = jdec.draft_propose(
        JP, *_j(kv_k, kv_v, lengths, window, n_known))
    ty, tk, _ = tdec.draft_propose(
        TP, *_t(kv_k, kv_v, lengths, window, n_known))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), RTOL, ATOL)
    _assert_tokens(ty.numpy(), np.asarray(jy),
                   _np_window(kv_k, kv_v, lengths, window, n_known))


def test_positions_past_the_cache_and_past_max_pos_follow_jax():
    """A window running off the cache drops those rows' writes and a
    length past max_pos reads the last position row, as XLA's scatter and
    gather do."""
    W = 4
    kv_k, kv_v, _, _ = _lanes(1)
    lengths = np.array([MAX_LEN - 2, MAX_LEN - 1, 0, 5])
    window = np.random.default_rng(2).integers(0, 64, (4, W))
    jy, jk, _ = jdec.verify_step(JP, *_j(kv_k, kv_v, lengths, window))
    ty, tk, _ = tdec.verify_step(TP, *_t(kv_k, kv_v, lengths, window))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), RTOL, ATOL)
    # A 300-row cache: lengths past the 256 position rows.
    rng = np.random.default_rng(3)
    big_k = rng.standard_normal((2, 300, DIM)).astype(np.float32)
    big_v = rng.standard_normal((2, 300, DIM)).astype(np.float32)
    lengths = np.array([270, 10])
    tokens = np.array([5, 9])
    jn, jk, _ = jdec.decode_step(JP, *_j(big_k, big_v, lengths, tokens))
    tn, tk, _ = tdec.decode_step(TP, *_t(big_k, big_v, lengths, tokens))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), RTOL, ATOL)
    assert tn.tolist() == np.asarray(jn).tolist()


def test_steps_never_write_the_callers_lanes():
    kv_k, kv_v, lengths, tokens = _lanes(7)
    tk, tv, tl, tt = _t(kv_k, kv_v, lengths, tokens)
    tdec.decode_step(TP, tk, tv, tl, tt)
    tdec.verify_step(TP, tk, tv, tl, tt[:, None].repeat(1, 3))
    pool_k, pool_v, tables = _paged(kv_k, kv_v, 8, 7)
    pk, pv, tb = _t(pool_k, pool_v, tables)
    tdec.decode_step_paged(TP, pk, pv, tb, tl, tt)
    np.testing.assert_array_equal(tk.numpy(), kv_k)
    np.testing.assert_array_equal(tv.numpy(), kv_v)
    np.testing.assert_array_equal(pk.numpy(), pool_k)


# ---------------------------------------------------------------- helpers

@pytest.mark.parametrize("token,emitted,max_tokens,eos", [
    (0, 1, 8, 0), (5, 8, 8, 0), (5, 7, 8, 0), (0, 1, 8, -1), (3, 2, 2, 3)])
def test_emit_done_equals_jax(token, emitted, max_tokens, eos):
    assert tdec.emit_done(token, emitted, max_tokens, eos) == \
        jdec.emit_done(token, emitted, max_tokens, eos)


def test_ngram_propose_equals_jax():
    rng = np.random.default_rng(11)
    cases = [[3, 7, 11, 9, 7, 11], [1, 2, 3, 1, 2, 3], [1, 2, 3, 4], [5], []]
    cases += [rng.integers(0, 4, rng.integers(2, 30)).tolist()
              for _ in range(200)]
    for seq in cases:
        for k in (0, 1, 3):
            assert tdec.ngram_propose(seq, k) == jdec.ngram_propose(seq, k)
    assert tdec.ngram_propose([3, 7, 11, 9, 7, 11], 3) == [9, 7, 11]


# ---------------------------------------------------------------- decode

@pytest.mark.parametrize("prompt", PROMPTS)
def test_decode_serial_equals_jax(prompt):
    want = jdec.decode_serial(JP, prompt, 24, MAX_LEN)
    assert tdec.decode_serial(TP, prompt, 24, MAX_LEN) == want
    # The engine's fixed-shape program, the session in lane 0 of 4.
    assert tdec.decode_serial(TP, prompt, 24, MAX_LEN, lanes=4) == want


def test_decode_serial_honours_eos():
    ref = tdec.decode_serial(TP, [3, 7, 11], 16, MAX_LEN)
    early = tdec.decode_serial(TP, [3, 7, 11], 16, MAX_LEN, eos_id=ref[2])
    assert early == ref[:3]
    assert early == jdec.decode_serial(JP, [3, 7, 11], 16, MAX_LEN,
                                       eos_id=ref[2])


def test_verify_window_is_the_sequential_path_bit_for_bit():
    """The port's twin of the JAX package's lossless-core test: every
    window position's argmax and KV row equal the sequential
    ``decode_step`` path's, bit for bit, lane 2 of 4. Both run 4 lanes: a
    matmul over one row and over four may order its sums differently
    (they do on this CPU), so the sequential path runs the window's lane
    count, as the engine and ``decode_serial(lanes=max_batch)`` do."""
    L, B, W = MAX_LEN, 4, 4
    kv_k = torch.zeros((B, L, DIM))
    kv_v = torch.zeros((B, L, DIM))
    prompt, pos, tok = [3, 7, 11], 0, None
    inputs, outs = [], []
    for _ in range(24):
        inp = prompt[pos] if pos < len(prompt) else tok
        lengths = torch.zeros((B,), dtype=torch.int64)
        tokens = torch.zeros((B,), dtype=torch.int64)
        lengths[2], tokens[2] = pos, inp
        nxt, kn, vn = tdec.decode_step(TP, kv_k, kv_v, lengths, tokens)
        kv_k[2, pos] = kn[2]
        kv_v[2, pos] = vn[2]
        inputs.append(inp)
        outs.append(int(nxt[2]))
        tok = outs[-1]
        pos += 1
    wk = torch.zeros((B, L, DIM))
    wv = torch.zeros((B, L, DIM))
    wouts, p = [], 0
    while p < len(inputs):
        w = inputs[p:p + W]
        win = torch.zeros((B, W), dtype=torch.int64)
        win[2, :len(w)] = torch.tensor(w)
        lengths = torch.zeros((B,), dtype=torch.int64)
        lengths[2] = p
        y, kr, vr = tdec.verify_step(TP, wk, wv, lengths, win)
        for j in range(len(w)):
            wouts.append(int(y[2, j]))
            assert torch.equal(kr[2, j], kv_k[2, p + j])
            assert torch.equal(vr[2, j], kv_v[2, p + j])
            wk[2, p + j] = kr[2, j]
            wv[2, p + j] = vr[2, j]
        p += len(w)
    assert wouts == outs
