"""The port's CUDA kernels on the card: each against its plain version.

Marked ``cuda``: a CUDA kernel has no CPU mode, so these skip on hosts
without a card. On one, ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py`` runs them (``--noconftest``: the suite's
conftest imports jax, which the card's host need not have). The
full-size check is chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from brpc_tpu_torch.ops import fused_update as fu
from brpc_tpu_torch.ops import quantize as qz
from brpc_tpu_torch.runtime import codec

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(1,), (3,), (1000,), (37, 300),
                                   (768, 2304)])
def test_momentum_kernel_matches_plain(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    p, m, g = (torch.randn(shape, generator=gen, device=cuda)
               for _ in range(3))
    before = fu.LAUNCHES.value
    kp, km = fu.fused_momentum_update(p, m, g, lr=0.05, beta=0.8)
    assert fu.LAUNCHES.value == before + 1
    rp, rm = fu.momentum_update_reference(p, m, g, lr=0.05, beta=0.8)
    assert torch.equal(kp, rp) and torch.equal(km, rm)
    # Unaligned views take the scalar path and still agree.
    kp1, km1 = fu.fused_momentum_update(p.reshape(-1)[1:], m.reshape(-1)[1:],
                                        g.reshape(-1)[1:], lr=0.05, beta=0.8)
    assert torch.equal(kp1, rp.reshape(-1)[1:])
    assert torch.equal(km1, rm.reshape(-1)[1:])


def test_momentum_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.ones(8, device=cuda)
    with pytest.raises(TypeError, match="float64"):
        fu.fused_momentum_update(x.double(), x.double(), x.double())
    with pytest.raises(ValueError, match="shape"):
        fu.fused_momentum_update(x, x, torch.ones(9, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        y = torch.ones(8, 2, device=cuda)[:, 0]
        fu.fused_momentum_update(y, y, y)


@pytest.mark.parametrize("cname,dtype", [("int8", torch.int8),
                                         ("fp8e4m3", torch.float8_e4m3fn)])
@pytest.mark.parametrize("n,block", [(1, 256), (1027, 256), (4096, 128),
                                     (768 * 2304, 256)])
def test_dequant_kernel_matches_plain_and_host_decode(cuda, cname, dtype,
                                                      n, block):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    enc = codec.encode(x, cname, block=block, min_bytes=0)
    meta = {"dtype": "<f4", "shape": [n], "codec": cname, "block": block}
    q_np, s_np = codec.split_wire(meta, enc.wire)
    q = torch.from_numpy(q_np.copy()).to(cuda).view(dtype)
    s = torch.from_numpy(s_np.copy()).to(cuda)
    got = qz.dequantize_blocks(q, s, block=block, n=n, shape=(n,))
    ref = qz.dequantize_reference(q, s, block=block, n=n, shape=(n,))
    assert torch.equal(got, ref)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  codec.decode(meta, enc.wire))


def test_server_on_the_card_goes_through_the_kernels(cuda):
    # The native library builds on demand (the card's host has a C++
    # toolchain); no conftest helper, so the file also runs with
    # --noconftest where the JAX package is not installed.
    from brpc_tpu_torch.runtime.param_server import (ParameterClient,
                                                     ParameterServer)

    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((64, 64)).astype(np.float32),
              "b": rng.standard_normal(64).astype(np.float32)}
    ps = ParameterServer(params, lr=0.05, momentum=0.8, device=cuda)
    port = ps.start()
    cl = ParameterClient(f"tpu://127.0.0.1:{port}", codec="int8",
                         device=cuda)
    try:
        k1, k2 = fu.LAUNCHES.value, qz.LAUNCHES_INT8.value
        grads = {k: torch.ones(v.shape, device=cuda) for k, v in
                 params.items()}
        assert cl.push_all(grads) == {"w": 1, "b": 1}
        pulled = cl.pull_all()
        assert fu.LAUNCHES.value - k1 == 2       # one update per push
        assert qz.LAUNCHES_INT8.value - k2 == 2  # w pushed and pulled int8
        assert pulled["b"][1].device.type == "cuda"
        state = ps.state()
        assert torch.equal(pulled["b"][1], state.params["b"])
    finally:
        cl.close()
        ps.stop()
