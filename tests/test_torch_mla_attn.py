"""The arithmetic of the MLA attention kernels, emulated on the CPU, and
the rule that routes a call to them.

``csrc/mla_attention.cu`` computes causal attention at query-key width 192
and value width 128 in fp32 with every product on the tensor cores in
3xTF32: each operand x is split into big = x rounded to TF32 (10 mantissa
bits, to nearest, ties away from zero: ``cvt.rna.tf32.f32``'s rule) and
small = x - big, of which the tensor core reads the top 19 bits; each
m16n8k8 step of 8 adds small.big, then big.small, then big.big into an
fp32 accumulator (the forward's q.k^T keeps the two cross terms in an
accumulator of their own, as does the backward's k.q^T and v.do^T). Here
that arithmetic is emulated in torch (the rounding on an int32 view of the
bits) and run through the kernels' walk:

* forward: 64-key tiles with an online softmax in exp2 (o and the running
  max and sum in fp32), each tile's p.v summed apart and folded in as o *
  corr + p.v, then o / l and lse = m + log(l);
* backward: D = rowsum(do * o); 64-key tiles, each walking the rows from
  its diagonal down 64 at a time, p = exp2(s * scale * log2 e - lse *
  log2 e) recomputed, dv += p^T.do, ds = p * (do.v^T - D) * scale, dk +=
  ds^T.q (each step's part summed apart and added), and dq summed over
  the key tiles.

The walk is held against float64 autograd of plain attention on the same
inputs, at a ragged length (no tile size divides it), for o, lse, dq, dk
and dv: each within ``TOL`` of the largest value of its reference. The
same walk with plain TF32 products (one product of the rounded operands)
misses it, which is why the kernels split. The kernels themselves are
held against the plain version on the card
(tests/test_torch_cuda_mla_attn.py, chip_smoke.py phase 2).
"""

import math

import pytest
import torch
import torch.nn.functional as F

from brpc_tpu_torch.ops import mla_attention as mla
from tf32x3 import mm_1xtf32, mm_3xtf32

FWD_TILE_K = 64   # mla_fwd_kernel's keys a tile
BWD_TILE_K = 64   # mla_bwd_kernel's keys a block
BWD_STEP_Q = 64   # mla_bwd_kernel's rows a step
LOG2E = 1.4426950408889634
NEG = -1e30
# 3xTF32 keeps fp32's ~2^-21 a product: the walk reads 0.8e-7 to 5.5e-7
# of the largest reference value here, as plain fp32 does (1.2e-7 to
# 6.7e-7). 1e-5 leaves it 18x of room; TF32 (~2^-11 a product) misses it,
# lse by 5.6x, the others by 28x or more.
TOL = 1e-5


def fwd_walk(q, k, v, scale, mm=mm_3xtf32):
    """mla_fwd_kernel's walk -> (o, lse). Every row walks the key tiles
    from the first; a tile wholly after a row leaves its state as it is
    (p = 0, the correction 1), so all rows walk all tiles here."""
    *lead, s, _ = q.shape
    rows = torch.arange(s)[:, None]
    m = torch.full((*lead, s), NEG)
    l = torch.zeros(*lead, s)
    o = torch.zeros(*lead, s, v.shape[-1])
    for k0 in range(0, s, FWD_TILE_K):
        kt, vt = k[..., k0:k0 + FWD_TILE_K, :], v[..., k0:k0 + FWD_TILE_K, :]
        sc = mm(q, kt.transpose(-1, -2), apart=True)
        cols = k0 + torch.arange(kt.shape[-2])[None, :]
        sc = sc.masked_fill(cols > rows, float("-inf"))
        m_new = torch.maximum(m, sc.amax(-1) * scale).clamp_min(NEG)
        corr = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2(sc * (scale * LOG2E) - (m_new * LOG2E)[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + mm(p, vt)
        m = m_new
    return o / l[..., None], m + torch.log(l)


def bwd_walk(q, k, v, o, lse, do, scale, mm=mm_3xtf32):
    """mla_bwd_kernel's walk (D from mla_bwd_prep_kernel) -> (dq, dk,
    dv)."""
    s = q.shape[-2]
    delta = (do * o).sum(-1)
    dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
    for k0 in range(0, s, BWD_TILE_K):
        kt, vt = k[..., k0:k0 + BWD_TILE_K, :], v[..., k0:k0 + BWD_TILE_K, :]
        keys = k0 + torch.arange(kt.shape[-2])[:, None]
        dkt, dvt = torch.zeros_like(kt), torch.zeros_like(vt)
        for q0 in range(k0, s, BWD_STEP_Q):
            sl = slice(q0, q0 + BWD_STEP_Q)
            qs, dos = q[..., sl, :], do[..., sl, :]
            rows = q0 + torch.arange(qs.shape[-2])[None, :]
            st = mm(kt, qs.transpose(-1, -2), apart=True)
            p = torch.exp2(st * (scale * LOG2E)
                           - (lse[..., sl] * LOG2E)[..., None, :])
            p = p.masked_fill(keys > rows, 0.0)
            dvt = dvt + mm(p, dos)
            dp = mm(vt, dos.transpose(-1, -2), apart=True)
            ds = p * (dp - delta[..., None, sl]) * scale
            dkt = dkt + mm(ds, qs)
            dq[..., sl, :] += mm(ds.transpose(-1, -2), kt)
        dk[..., k0:k0 + BWD_TILE_K, :] = dkt
        dv[..., k0:k0 + BWD_TILE_K, :] = dvt
    return dq, dk, dv


def _inputs(s, seed, h=2):
    g = torch.Generator().manual_seed(seed)
    mk = lambda w: torch.randn(1, h, s, w, generator=g)  # noqa: E731
    return mk(mla.DQK), mk(mla.DQK), mk(mla.DV), mk(mla.DV)


def _float64(q, k, v, do, scale):
    """o, lse, dq, dk, dv of plain causal attention by float64 autograd."""
    q, k, v = (t.double().requires_grad_() for t in (q, k, v))
    o, lse = mla.reference(q, k, v, scale)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), do.double())
    return {"o": o.detach(), "lse": lse.detach(), "dq": dq, "dk": dk,
            "dv": dv}


def _walk(q, k, v, do, scale, mm):
    o, lse = fwd_walk(q, k, v, scale, mm)
    dq, dk, dv = bwd_walk(q, k, v, o, lse, do, scale, mm)
    return {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}


def _rel(got, want):
    return ((got.double() - want).abs().max() / want.abs().max()).item()


SCALE = mla.DQK ** -0.5
# Lengths: 200 (no tile divides it: 64 x 3 + 8 keys or rows) and 40
# (under one tile).
LENGTHS = (200, 40)


@pytest.fixture(scope="module")
def walks():
    out = {}
    for s in LENGTHS:
        q, k, v, do = _inputs(s, seed=s)
        out[s] = (_float64(q, k, v, do, SCALE),
                  _walk(q, k, v, do, SCALE, mm_3xtf32),
                  _walk(q, k, v, do, SCALE, mm_1xtf32))
    return out


@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("name", ["o", "lse", "dq", "dk", "dv"])
def test_3xtf32_walk_matches_float64(walks, s, name):
    want, got, _ = walks[s]
    assert _rel(got[name], want[name]) <= TOL


@pytest.mark.parametrize("name", ["o", "lse", "dq", "dk", "dv"])
def test_plain_tf32_walk_misses(walks, name):
    want, got, tf32 = walks[200]
    assert _rel(got[name], want[name]) <= TOL < _rel(tf32[name], want[name])


def _model_views(s=16, h=2):
    """q, k and v laid out as models/mla_moe.py makes them: q and k cat'ed
    (contiguous), v a view of the latent up-projection's output."""
    kv = torch.randn(1, s, h, 128 + mla.DV).transpose(1, 2)
    return (torch.randn(1, h, s, mla.DQK), torch.randn(1, h, s, mla.DQK),
            kv.split([128, mla.DV], dim=-1)[1])


def _shifted(t):
    """t's values in a view 4 bytes past a 16-byte boundary."""
    flat = torch.cat([t.new_zeros(1), t.reshape(-1)])
    return flat[1:].view(t.shape)


_LAYOUTS = {
    "the model's views": (lambda q, k, v: (q, k, v), True),
    "float64": (lambda q, k, v: (q.double(), k.double(), v.double()), False),
    "bfloat16": (lambda q, k, v: (q, k.bfloat16(), v), False),
    "q width 128": (lambda q, k, v: (q[..., :128], k, v), False),
    "v width 192": (lambda q, k, v: (q, k, q), False),
    "another length": (lambda q, k, v: (q, k[:, :, :8], v), False),
    "misaligned q": (lambda q, k, v: (_shifted(q), k, v), False),
    "width not unit stride": (
        lambda q, k, v: (q, k, v.transpose(-1, -2).contiguous()
                         .transpose(-1, -2)), False),
    "3-D": (lambda q, k, v: (q[0], k[0], v[0]), False),
}


@pytest.mark.parametrize("case", sorted(_LAYOUTS))
def test_layout_rule(case):
    make, want = _LAYOUTS[case]
    q, k, v = make(*_model_views())
    assert mla.layout_ok(q, k, v) is want
    # On the CPU every call keeps SDPA's math path.
    assert mla.takes(q, k, v) is False


def _reads():
    return tuple(c.value() for c in mla.counters())


def test_cpu_call_keeps_sdpa_and_counts_both_passes():
    q, k, v = (t.requires_grad_() for t in _model_views())
    before = _reads()
    o = mla.attention(q, k, v, SCALE)
    assert torch.equal(o, F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=SCALE))
    mid = _reads()
    o.sum().backward()
    after = _reads()
    assert (mid[0] - before[0], mid[1] - before[1]) == (0, 1)
    assert (after[0] - mid[0], after[1] - mid[1]) == (0, 1)


def test_kernel_path_counts_and_gradients(monkeypatch):
    # The autograd Function with the kernels' walks in the launches'
    # places: one count for its forward, one for its backward, and the
    # gradients of SDPA's math path to the walk's precision.
    monkeypatch.setattr(mla, "takes", lambda q, k, v: True)
    monkeypatch.setattr(mla, "forward_kernel", fwd_walk)
    monkeypatch.setattr(mla, "backward_kernel", bwd_walk)
    q, k, v = _model_views(s=70)
    do = torch.randn(*v.shape)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = _reads()
    o = mla.attention(*leaves, SCALE)
    mid = _reads()
    got = torch.autograd.grad(o, leaves, do)
    after = _reads()
    assert (mid[0] - before[0], mid[1] - before[1]) == (1, 0)
    assert (after[0] - mid[0], after[1] - mid[1]) == (1, 0)
    ref = [t.clone().double().requires_grad_() for t in (q, k, v)]
    o_ref = F.scaled_dot_product_attention(*ref, is_causal=True,
                                           scale=SCALE)
    want = torch.autograd.grad(o_ref, ref, do.double())
    assert _rel(o, o_ref.detach()) <= TOL
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL


def test_reference_is_causal_softmax():
    q, k, v, _ = _inputs(24, seed=7)
    o, lse = mla.reference(q.double(), k.double(), v.double(), SCALE)
    s = (q.double() @ k.double().transpose(-1, -2)) * SCALE
    keep = torch.ones(24, 24, dtype=torch.bool).tril()
    s = s.masked_fill(~keep, -math.inf)
    assert torch.allclose(lse, torch.logsumexp(s, -1))
    assert torch.allclose(o, torch.softmax(s, -1) @ v.double())
