"""The MLA attention kernels on the card, against plain attention.

Marked ``cuda``: the kernels have no CPU mode, so these skip on hosts
without a card. On one: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda_mla_attn.py``.

Tolerances, each as the largest error over the largest value of the
reference tensor (absolute where the reference is 0 throughout: at one
position dq and dk are exactly 0):

* small ragged shapes, against float64 plain attention: ``TOL_F64`` 1e-5,
  as the CPU emulation of the kernels' arithmetic is held
  (tests/test_torch_mla_attn.py: that walk reads up to 5.5e-7, plain
  TF32 from 5.6e-5);
* the stack's layer (2 x 16 x 8192), against plain fp32 attention (the
  score matrix whole, a head group at a time): ``TOL_F32`` 2e-5, the two
  fp32 errors added over 8192-key sums.

dq is summed over key tiles by fp32 atomics, so its last bits vary from
run to run; forward and dk, dv do not.
"""

import pytest
import torch
import torch.nn.functional as F

from brpc_tpu_torch.ops import mla_attention as mla

pytestmark = pytest.mark.cuda

TOL_F64 = 1e-5
TOL_F32 = 2e-5
SCALE = mla.DQK ** -0.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, h, s, dev, seed, views=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *sh: torch.randn(*sh, generator=g, device=dev)  # noqa: E731
    q, k = mk(b, h, s, mla.DQK), mk(b, h, s, mla.DQK)
    if views:  # v as models/mla_moe.py makes it: a view of kv_b's output
        v = mk(b, s, h, 128 + mla.DV).transpose(1, 2).split(
            [128, mla.DV], dim=-1)[1]
    else:
        v = mk(b, h, s, mla.DV)
    return q, k, v, mk(b, h, s, mla.DV)


def _rel(got, want):
    scale = want.double().abs().max().item()
    return ((got.double() - want.double()).abs().max().item()
            / (scale if scale > 0 else 1.0))


def _kernel(q, k, v, do):
    # detach() keeps each operand's layout (v may be a strided view).
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = mla.attention(*leaves, SCALE)
    return o.detach(), torch.autograd.grad(o, leaves, do)


def _plain(q, k, v, do, dtype, heads):
    """o, lse and the gradients of plain attention in ``dtype``, ``heads``
    heads at a time."""
    outs = {n: [] for n in ("o", "lse", "dq", "dk", "dv")}
    for h0 in range(0, q.shape[1], heads):
        sl = slice(h0, h0 + heads)
        leaves = [t[:, sl].to(dtype).requires_grad_() for t in (q, k, v)]
        o, lse = mla.reference(*leaves, SCALE)
        grads = torch.autograd.grad(o, leaves, do[:, sl].to(dtype))
        for n, t in zip(outs, (o.detach(), lse.detach(), *grads)):
            outs[n].append(t)
        del o, lse, grads, leaves
    return {n: torch.cat(ts, dim=1) for n, ts in outs.items()}


@pytest.mark.parametrize("shape", [(1, 2, 200), (2, 3, 77), (1, 1, 1),
                                   (1, 2, 300), (1, 1, 129)])
@pytest.mark.parametrize("views", [False, True])
def test_kernels_match_float64(cuda, shape, views):
    q, k, v, do = _inputs(*shape, cuda, seed=sum(shape), views=views)
    assert mla.takes(q, k, v)
    f0, b0 = mla.LAUNCHES_FWD.value, mla.LAUNCHES_BWD.value
    o, grads = _kernel(q, k, v, do)
    o2, lse = mla.forward_kernel(q, k, v, SCALE)
    torch.cuda.synchronize()
    assert mla.LAUNCHES_FWD.value == f0 + 2
    assert mla.LAUNCHES_BWD.value == b0 + 1
    assert torch.equal(o, o2)  # the forward is deterministic
    want = _plain(q, k, v, do, torch.float64, q.shape[1])
    for name, got in zip(("o", "lse", "dq", "dk", "dv"), (o, lse, *grads)):
        assert _rel(got, want[name]) <= TOL_F64, name


def test_kernels_match_plain_at_the_layer(cuda):
    q, k, v, do = _inputs(2, 16, 8192, cuda, seed=24, views=True)
    o, grads = _kernel(q, k, v, do)
    _o, lse = mla.forward_kernel(q, k, v, SCALE)
    want = _plain(q, k, v, do, torch.float32, 2)
    for name, got in zip(("o", "lse", "dq", "dk", "dv"), (o, lse, *grads)):
        assert _rel(got, want[name]) <= TOL_F32, name


def _reads():
    return tuple(c.value() for c in mla.counters())


# Calls the kernels do not take keep SDPA: on the CPU its math path, on
# CUDA its memory-efficient backend, here in bf16 (held to 2e-2: bf16
# rounds to 2^-8) and at a query-key width of 128.
@pytest.mark.parametrize("case", ["cpu", "bfloat16", "width 128", "kernel"])
def test_routing(cuda, case):
    q, k, v, do = _inputs(1, 2, 64, cuda, seed=5)
    tol = TOL_F64
    if case == "cpu":
        q, k, v, do = (t.cpu() for t in (q, k, v, do))
    elif case == "bfloat16":
        q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
        tol = 2e-2
    elif case == "width 128":
        q, k = q[..., :128].contiguous(), k[..., :128].contiguous()
    kernel = case == "kernel"
    assert mla.takes(q, k, v) is kernel
    before = _reads()
    o, grads = _kernel(q, k, v, do)
    after = _reads()
    assert (after[0] - before[0], after[1] - before[1]) == (
        (2, 0) if kernel else (0, 2))
    leaves = [t.detach().double().requires_grad_() for t in (q, k, v)]
    ref = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                         scale=SCALE)
    want = torch.autograd.grad(ref, leaves, do.double())
    assert _rel(o, ref.detach()) <= tol
    for g, w in zip(grads, want):
        assert _rel(g, w) <= tol


def test_misaligned_view_is_not_taken(cuda):
    # Routed only: SDPA's own fp32 kernel faults on a view 4 bytes off
    # ("misaligned address"), which would end every later test on the card.
    q, k, v, _ = _inputs(1, 2, 64, cuda, seed=6)
    assert mla.takes(q, k, v)
    flat = torch.cat([q.new_zeros(1), q.reshape(-1)])
    assert not mla.takes(flat[1:].view(q.shape), k, v)
