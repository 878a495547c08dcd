"""The port's CUDA kernels on the card: each against its plain version.

Marked ``cuda``: a CUDA kernel has no CPU mode, so these skip on hosts
without a card. On one, ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py`` runs them (``--noconftest``: the suite's
conftest imports jax, which the card's host need not have). The
full-size check is chip_smoke.py.
"""

import time

import numpy as np
import pytest
import torch

from brpc_tpu_torch.ops import flash_attention as fa
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


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1,), (13,), (1000,), (37, 300),
                                   (768, 2304)])
def test_momentum_kernel_half_matches_plain(cuda, dtype, shape):
    """fp16/bf16: the kernel's fp32-per-op, rounded-per-op arithmetic
    equals the plain version's rounded half ops bit for bit, on the 16-byte
    path, the ragged tail and (offset by one element) the scalar path."""
    gen = torch.Generator(device=cuda).manual_seed(7 + sum(shape))
    p, m, g = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    counter = fu.LAUNCHES_F16 if dtype == torch.float16 else fu.LAUNCHES_BF16
    before, before32 = counter.value, fu.LAUNCHES.value
    kp, km = fu.fused_momentum_update(p, m, g, lr=0.05, beta=0.8)
    assert counter.value == before + 1 and fu.LAUNCHES.value == before32
    assert kp.dtype == km.dtype == dtype
    rp, rm = fu.momentum_update_reference(p, m, g, lr=0.05, beta=0.8)
    assert torch.equal(kp.view(torch.int16), rp.view(torch.int16))
    assert torch.equal(km.view(torch.int16), rm.view(torch.int16))
    kp1, km1 = fu.fused_momentum_update(p.reshape(-1)[1:], m.reshape(-1)[1:],
                                        g.reshape(-1)[1:], lr=0.05, beta=0.8)
    assert torch.equal(kp1.view(torch.int16),
                       rp.reshape(-1)[1:].view(torch.int16))
    assert torch.equal(km1.view(torch.int16),
                       rm.reshape(-1)[1:].view(torch.int16))


def test_momentum_kernel_refuses_mixed_dtypes(cuda):
    x = torch.ones(8, device=cuda)
    with pytest.raises(TypeError, match="must agree"):
        fu.fused_momentum_update(x.half(), x.half(), x)


def test_fp16_server_push_on_the_card_equals_plain_replay(cuda):
    """A ParameterServer holding fp16 parameters on the card takes raw fp16
    pushes (one K1 fp16 launch each) and ends where the plain half replay
    does, bit for bit."""
    from brpc_tpu_torch.runtime.param_server import (ParameterClient,
                                                     ParameterServer)

    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal((300, 37)).astype(np.float16),
              "b": rng.standard_normal(777).astype(np.float16)}
    ps = ParameterServer(params, lr=0.05, momentum=0.8, device=cuda)
    cl = ParameterClient(f"tpu://127.0.0.1:{ps.start()}", codec="int8",
                         device=cuda)
    try:
        grads = [{k: torch.from_numpy(rng.standard_normal(v.shape).astype(
            np.float16)).to(cuda) for k, v in params.items()}
            for _ in range(2)]
        k1 = fu.LAUNCHES_F16.value
        for g in grads:
            cl.push_all(g)  # fp16 is not int8-eligible: it rides raw
        assert fu.LAUNCHES_F16.value - k1 == 2 * len(params)
        state = ps.state()
        for k, v in params.items():
            rp = torch.from_numpy(v).to(cuda)
            rm = torch.zeros_like(rp)
            for g in grads:
                rp, rm = fu.momentum_update_reference(rp, rm, g[k], lr=0.05,
                                                      beta=0.8)
            assert state.params[k].dtype == torch.float16
            assert torch.equal(state.params[k].view(torch.int16),
                               rp.view(torch.int16))
            assert torch.equal(state.momenta[k].view(torch.int16),
                               rm.view(torch.int16))
        v, t = cl.pull("w")
        assert v == 2 and torch.equal(t, state.params["w"])
    finally:
        cl.close()
        ps.stop()


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


def test_wire_counters_count_each_copy_to_and_from_the_card(cuda):
    """A raw push and a raw pull of an N-byte tensor through a server in
    this process cross the host four times: the push's D2H (client) and
    H2D (server), the pull's D2H (server) and H2D (client). Each counter
    and each copy stage moves by exactly that."""
    from brpc_tpu_torch.observability import metrics
    from brpc_tpu_torch.runtime.param_server import (ParameterClient,
                                                     ParameterServer)

    shape = (300, 257)
    nbytes = 4 * shape[0] * shape[1]
    ps = ParameterServer({"w": np.zeros(shape, np.float32)}, lr=0.05,
                         momentum=0.8, device=cuda)
    port = ps.start()
    cl = ParameterClient(f"tpu://127.0.0.1:{port}", device=cuda)
    names = ("torch_wire_h2d_bytes", "torch_wire_d2h_bytes",
             "torch_stage_h2d_calls", "torch_stage_d2h_calls")
    try:
        cl.meta()
        before = {n: metrics.counter(n).value() for n in names}
        assert cl.push_grad("w", torch.ones(shape, device=cuda)) == 1
        version, pulled = cl.pull("w")
        assert version == 1 and pulled.device.type == "cuda"
        got = {n: metrics.counter(n).value() - before[n] for n in names}
        assert got == {"torch_wire_h2d_bytes": 2 * nbytes,
                       "torch_wire_d2h_bytes": 2 * nbytes,
                       "torch_stage_h2d_calls": 2,
                       "torch_stage_d2h_calls": 2}
    finally:
        cl.close()
        ps.stop()


def test_oneside_pull_lands_in_a_pinned_buffer(cuda):
    """A one-sided pull onto the card lands in the reader's page-locked
    buffer and DMAs from there: bit for bit the RPC pull, one pinned read
    a hit, the buffer reused without touching the tensors returned
    before, and the profiler sees a pinned H2D."""
    from brpc_tpu_torch.observability import metrics
    from brpc_tpu_torch.runtime.param_server import (ParameterClient,
                                                     ParameterServer)

    rng = np.random.default_rng(22)
    params = {"big": rng.standard_normal((1024, 1031)).astype(np.float32),
              "small": rng.standard_normal((300, 257)).astype(np.float32)}
    ps = ParameterServer(params, lr=0.05, momentum=0.8, device=cuda,
                         oneside=True)
    addr = f"tpu://127.0.0.1:{ps.start()}"
    one = ParameterClient(addr, device=cuda, oneside=True)
    rpc = ParameterClient(addr, device=cuda)
    names = ("torch_oneside_pull_hits", "torch_oneside_pinned_reads",
             "torch_oneside_pinned_fallbacks")
    try:
        before = {n: metrics.counter(n).value() for n in names}
        _, big = one.pull("big")
        landing = one._oneside_reader._landing
        assert landing is not None and landing.is_pinned()
        _, small = one.pull("small")
        assert one._oneside_reader._landing.data_ptr() == landing.data_ptr()
        for name, t in (("big", big), ("small", small)):
            assert t.device.type == "cuda"
            assert torch.equal(t, rpc.pull(name)[1])
            assert torch.equal(t.cpu(), torch.from_numpy(params[name]))
        # A push republishes "small"; reading it again through the same
        # buffer leaves the tensors returned before as they were.
        assert rpc.push_grad("small", torch.ones(300, 257, device=cuda)) == 1
        v, small2 = one.pull("small")
        assert v == 1 and torch.equal(small2, rpc.pull("small")[1])
        assert not torch.equal(small2, small)
        assert torch.equal(small.cpu(), torch.from_numpy(params["small"]))
        assert torch.equal(big.cpu(), torch.from_numpy(params["big"]))
        got = {n: metrics.counter(n).value() - before[n] for n in names}
        assert got == {"torch_oneside_pull_hits": 3,
                       "torch_oneside_pinned_reads": 3,
                       "torch_oneside_pinned_fallbacks": 0}
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            one.pull("big")
            torch.cuda.synchronize()
        keys = [e.key for e in prof.key_averages()]
        assert any("Memcpy HtoD (Pinned -> Device)" in k for k in keys), keys
    finally:
        one.close()
        rpc.close()
        ps.stop()


def test_fleet_reshard_and_oneside_pull_on_the_card(cuda):
    """A 2-shard fleet on the card: pushes launch K1 on the shard, a live
    1 -> 2 reshard keeps the state equal to a plain replay, and an int8
    fleet pull and an int8 one-sided pull launch K2 on the reader, equal
    to the PullQ pull."""
    import time

    from brpc_tpu_torch.fleet import (FleetClient, FleetServer, Migrator,
                                      RegistryHub, ShardMap, clear_registry)
    from brpc_tpu_torch.runtime.param_server import ParameterClient
    from brpc_tpu_torch.runtime.state import fleet_state_to_numpy

    tag = "card_fleet"
    names = [f"w{i:02d}" for i in range(8)]
    rng = np.random.default_rng(1)
    params = {n: rng.standard_normal((64, 64)).astype(np.float32)
              for n in names}
    grads = [{n: torch.from_numpy(rng.standard_normal((64, 64)).astype(
        np.float32)).to(cuda) for n in names} for _ in range(2)]
    hub = RegistryHub()
    hub.start()
    servers, clients, passes = [], [], []

    def shard():
        s = FleetServer(hub.hostport, tag=tag, ttl_s=30, device=cuda,
                        lr=0.05, momentum=0.8, oneside=True,
                        oneside_codec="int8")
        s.start()
        servers.append(s)
        return s

    def wait(cond, what):
        deadline = time.monotonic() + 60
        while not cond():
            assert time.monotonic() < deadline, what
            time.sleep(0.01)

    mig = None
    try:
        s1 = shard()
        fc = FleetClient(hub.hostport, tag=tag, device=cuda)
        clients.append(fc)
        for n, v in params.items():
            fc.install(n, v)
        mig = Migrator(hub.hostport, tag=tag,
                       on_reshard=lambda _i, k: passes.append(k)).start()
        wait(lambda: passes, "the migrator's first pass")
        k1 = fu.LAUNCHES.value
        assert fc.push_all(grads[0]) == {n: 1 for n in names}
        assert fu.LAUNCHES.value - k1 == len(names)
        s2 = shard()
        moved = [n for n in names
                 if ShardMap([s1.addr, s2.addr]).owner(n) == s2.addr]
        wait(lambda: sum(passes) == len(moved), "the 1 -> 2 move")
        assert fc.push_all(grads[1]) == {n: 2 for n in names}
        p, m, v = fleet_state_to_numpy(servers)
        assert v == {n: 2 for n in names}
        for n in names:
            rp = torch.from_numpy(params[n]).to(cuda)
            rm = torch.zeros_like(rp)
            for g in grads:
                rp, rm = fu.momentum_update_reference(rp, rm, g[n], lr=0.05,
                                                      beta=0.8)
            assert np.array_equal(p[n], rp.cpu().numpy())
            assert np.array_equal(m[n], rm.cpu().numpy())
        fq = FleetClient(hub.hostport, tag=tag, codec="int8", device=cuda)
        clients.append(fq)
        k2 = qz.LAUNCHES_INT8.value
        fleet_q = fq.pull_all(names)
        assert qz.LAUNCHES_INT8.value - k2 == len(names)
        for s in servers:
            oc = ParameterClient(f"tpu://{s.addr}", oneside=True,
                                 device=cuda)
            qc = ParameterClient(f"tpu://{s.addr}", codec="int8",
                                 device=cuda)
            clients += [oc, qc]
            k2 = qz.LAUNCHES_INT8.value
            one = oc.pull_all()
            assert qz.LAUNCHES_INT8.value - k2 == len(one) > 0
            pq = qc.pull_all()
            for n, (ver, t) in one.items():
                assert ver == pq[n][0] == 2 and t.device.type == "cuda"
                assert torch.equal(t, pq[n][1])
                assert fleet_q[n][0] == 2 and torch.equal(fleet_q[n][1], t)
    finally:
        if mig is not None:
            mig.stop()
        for c in clients:
            c.close()
        for s in servers:
            s.stop()
        clear_registry()
        hub.stop()


def test_fleet_oneside_client_launches_k2_once_per_eligible_name(cuda):
    """FleetClient(oneside=True) over two shards publishing int8 reads every
    name from the windows: one K2 launch per int8-eligible name, each
    tensor equal to the fleet's RPC int8 pull bit for bit."""
    from brpc_tpu_torch.fleet import (FleetClient, FleetServer, RegistryHub,
                                      clear_registry)
    from brpc_tpu_torch.observability import metrics

    rng = np.random.default_rng(9)
    params = {f"p{i}": rng.standard_normal(s).astype(np.float32)
              for i, s in enumerate([(64, 64), (300,), (40, 300), (2000,)])}
    elig = [n for n, v in params.items() if codec.eligible(v)]
    hub = RegistryHub()
    hub.start()
    tag = "cuda_oneside_fleet"
    servers, clients = [], []
    try:
        for i in range(2):
            s = FleetServer(hub.hostport, tag=tag, shard_name=f"os{i}",
                            device=cuda, oneside=True, oneside_codec="int8")
            s.start()
            servers.append(s)
        fq = FleetClient(hub.hostport, tag=tag, codec="int8", device=cuda)
        fo = FleetClient(hub.hostport, tag=tag, device=cuda, oneside=True)
        clients += [fq, fo]
        for n, v in params.items():
            fq.install(n, v)
        want = fq.pull_all(sorted(params))
        hits = metrics.counter("torch_oneside_pull_hits")
        h0, k2 = hits.value(), qz.LAUNCHES_INT8.value
        got = fo.pull_all(sorted(params))
        assert qz.LAUNCHES_INT8.value - k2 == len(elig) > 0
        assert hits.value() - h0 == len(params)
        for n in params:
            assert got[n][0] == want[n][0] == 0
            assert torch.equal(got[n][1], want[n][1])
    finally:
        for c in clients:
            c.close()
        for s in servers:
            s.stop()
        clear_registry()
        hub.stop()


# K3 against its plain version, run with the kernel's own k tile so p is
# rounded at the same running maxima. Tolerances: m to 1e-4 (the same fp32
# dot products summed in another order), l to 1e-4 relative, acc/l to 4e-3
# for bf16 (a p whose bf16 rounding flips with that order moves one key's
# weight by 2^-8) and 1e-4 for fp32.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "b,h,hkv,sq,sk,d,causal,offsets", [
        (1, 2, 2, 128, 128, 64, False, (0, 0)),
        (1, 4, 2, 200, 256, 128, True, (0, 0)),      # ragged sq, GQA
        (2, 4, 1, 64, 128, 128, True, (64, 0)),      # q after kv
        (1, 2, 2, 128, 128, 128, True, (0, 64)),     # a fully masked tile
        (1, 2, 2, 64, 64, 128, True, (0, 4096)),     # nothing attended
        (2, 4, 2, 32, 32, 8, True, (0, 0)),          # the dryrun shape
        (1, 2, 1, 48, 96, 256, False, (5, 7)),       # widest d
        (1, 3, 3, 33, 70, 40, True, (20, 0)),        # odd everything
        (1, 2, 2, 40, 72, 12, True, (3, 0)),         # fp32 width class 16
        (2, 2, 1, 100, 130, 32, True, (30, 0)),      # fp32 width class 32
    ])
def test_flash_carry_kernel_matches_plain(cuda, dtype, b, h, hkv, sq, sk, d,
                                          causal, offsets):
    gen = torch.Generator(device=cuda).manual_seed(sq * 1000 + d)
    q = torch.randn(b, h, sq, d, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, hkv, sk, d, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, hkv, sk, d, generator=gen, device=cuda).to(dtype)
    m, l, acc = fa.flash_init(b, h, sq, d, device=cuda)
    m, l, acc = fa.flash_carry_reference(  # a carry that is not fresh
        q, k, v, m, l, acc, (0, 0), causal=False, block_k=sk)
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    before = fa.LAUNCHES.value
    km, kl, kacc = fa.flash_attention_carry(q, k, v, m, l, acc, off,
                                            causal=causal)
    assert fa.LAUNCHES.value == before + 1
    # The same launch with the offsets by value.
    im, il, iacc = fa.flash_attention_carry(q, k, v, m, l, acc, offsets,
                                            causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(km, im) and torch.equal(kacc, iacc)
    _assert_matches_plain(q, k, v, (m, l, acc), offsets, causal,
                          (km, kl, kacc))


def _assert_matches_plain(q, k, v, carry, offsets, causal, got):
    rm, rl, racc = fa.flash_carry_reference(
        q, k, v, *carry, offsets, causal=causal,
        block_k=fa.kernel_tile_k(q, k, v, carry[2]), ragged_tail=True)
    km, kl, kacc = got
    torch.testing.assert_close(km, rm, atol=1e-4, rtol=0)
    torch.testing.assert_close(kl, rl, atol=1e-4, rtol=1e-4)
    tol = 4e-3 if q.dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(kacc / kl, racc / rl, atol=tol, rtol=tol)


# The warp-specialised bf16 kernel (128-row q tiles, 128-key tiles): a
# ragged last k tile (sk 1000), ragged q rows, and device offsets at a ring
# hop whose causal diagonal crosses tiles mid-way, at both of its widths.
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk,offsets", [
    (1000, 1000, (24, 0)),      # ragged sk and sq, diagonal mid-tile
    (333, 1000, (700, 0)),      # ragged sq after most keys
    (512, 512, (512, 512)),     # a ring hop on the diagonal
    (512, 512, (1024, 512)),    # a ring hop wholly visible
])
def test_ws_kernel_matches_plain_at_ragged_edges(cuda, d, sq, sk, offsets):
    gen = torch.Generator(device=cuda).manual_seed(sq + sk + d)
    q = torch.randn(1, 8, sq, d, generator=gen, device=cuda).bfloat16()
    k = torch.randn(1, 2, sk, d, generator=gen, device=cuda).bfloat16()
    v = torch.randn(1, 2, sk, d, generator=gen, device=cuda).bfloat16()
    assert fa.kernel_tile_k(q, k, v, q.float()) == 128
    m, l, acc = fa.flash_carry_reference(  # a carry that is not fresh
        q, k, v, *fa.flash_init(1, 8, sq, d, device=cuda), (sk, 0),
        causal=True, block_k=128, ragged_tail=True)
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    got = fa.flash_attention_carry(q, k, v, m, l, acc, off, causal=True)
    torch.cuda.synchronize()
    _assert_matches_plain(q, k, v, (m, l, acc), offsets, True, got)


@pytest.mark.parametrize("d", [64, 128])
def test_ws_block_with_no_live_tile_returns_the_carry(cuda, d):
    # q rows 0..127 end before the first key (kv_off 128): their block has
    # exactly 0 live tiles and hands its carries back bit for bit; rows
    # 128..255 fold keys.
    gen = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (torch.randn(1, 4, 256, d, generator=gen, device=cuda)
               .bfloat16() for _ in range(3))
    m, l, acc = fa.flash_carry_reference(
        q, k, v, *fa.flash_init(1, 4, 256, d, device=cuda), (512, 0),
        causal=True, block_k=128, ragged_tail=True)
    got = fa.flash_attention_carry(q, k, v, m, l, acc, (0, 128), causal=True)
    torch.cuda.synchronize()
    for g, before in zip(got, (m, l, acc)):
        assert torch.equal(g[:, :, :128], before[:, :, :128])
    assert not torch.equal(got[2][:, :, 128:], acc[:, :, 128:])
    _assert_matches_plain(q, k, v, (m, l, acc), (0, 128), True, got)


# The fp32 tensor-core kernel (3xTF32; 128-row q tiles, 64-key tiles at
# these widths) at the same edges: the ragged last k tile of sk 1000 holds
# 40 keys, and the diagonal crosses its tiles mid-way.
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk,offsets", [
    (1000, 1000, (24, 0)),      # ragged sk and sq, diagonal mid-tile
    (333, 1000, (700, 0)),      # ragged sq after most keys
    (512, 512, (512, 512)),     # a ring hop on the diagonal
    (512, 512, (1024, 512)),    # a ring hop wholly visible
])
def test_tf32x3_kernel_matches_plain_at_ragged_edges(cuda, d, sq, sk,
                                                     offsets):
    gen = torch.Generator(device=cuda).manual_seed(sq + sk + d)
    q = torch.randn(1, 8, sq, d, generator=gen, device=cuda)
    k = torch.randn(1, 2, sk, d, generator=gen, device=cuda)
    v = torch.randn(1, 2, sk, d, generator=gen, device=cuda)
    assert fa.kernel_name(q, k, v, q) == "flash_tf32x3_kernel"
    assert fa.kernel_tile_k(q, k, v, q) == 64
    m, l, acc = fa.flash_carry_reference(  # a carry that is not fresh
        q, k, v, *fa.flash_init(1, 8, sq, d, device=cuda), (sk, 0),
        causal=True, block_k=64, ragged_tail=True)
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    got = fa.flash_attention_carry(q, k, v, m, l, acc, off, causal=True)
    torch.cuda.synchronize()
    _assert_matches_plain(q, k, v, (m, l, acc), offsets, True, got)


@pytest.mark.parametrize("d", [64, 128])
def test_tf32x3_block_with_no_live_tile_returns_the_carry(cuda, d):
    # As the bf16 test: rows 0..127 (one block) end before the first key
    # and come back bit for bit; rows 128..255 fold keys.
    gen = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (torch.randn(1, 4, 256, d, generator=gen, device=cuda)
               for _ in range(3))
    m, l, acc = fa.flash_carry_reference(
        q, k, v, *fa.flash_init(1, 4, 256, d, device=cuda), (512, 0),
        causal=True, block_k=64, ragged_tail=True)
    got = fa.flash_attention_carry(q, k, v, m, l, acc, (0, 128), causal=True)
    torch.cuda.synchronize()
    for g, before in zip(got, (m, l, acc)):
        assert torch.equal(g[:, :, :128], before[:, :, :128])
    assert not torch.equal(got[2][:, :, 128:], acc[:, :, 128:])
    _assert_matches_plain(q, k, v, (m, l, acc), (0, 128), True, got)


@pytest.mark.parametrize("dtype,d,misalign,want,kernel", [
    (torch.bfloat16, 128, False, 128, "flash_ws_kernel"),
    (torch.bfloat16, 64, False, 128, "flash_ws_kernel"),
    (torch.bfloat16, 32, False, 32, "flash_simt_kernel"),
    (torch.float32, 128, False, 64, "flash_tf32x3_kernel"),
    (torch.float32, 8, False, 64, "flash_tf32x3_kernel"),
    (torch.float32, 256, False, 32, "flash_tf32x3_kernel"),
    (torch.float32, 6, False, 32, "flash_simt_kernel"),    # d % 4 != 0
    (torch.float32, 128, True, 32, "flash_simt_kernel"),   # 4-byte aligned
    (torch.bfloat16, 128, True, 32, "flash_simt_kernel")])
def test_kernel_tile_k_follows_the_kernels_dispatch(cuda, dtype, d, misalign,
                                                    want, kernel):
    base = torch.zeros(1 + 2 * 16 * d, device=cuda, dtype=dtype)
    q = base[int(misalign):int(misalign) + 2 * 16 * d].view(1, 2, 16, d)
    acc = fa.flash_init(1, 2, 16, d, device=cuda)[2]
    assert fa.kernel_tile_k(q, q, q, acc) == want
    assert fa.kernel_name(q, q, q, acc) == kernel
    before, before_tc = fa.LAUNCHES.value, fa.LAUNCHES_TF32X3.value
    fa.flash_attention_carry(q, q, q, *fa.flash_init(1, 2, 16, d,
                                                     device=cuda), (0, 0))
    assert fa.LAUNCHES.value == before + 1
    assert (fa.LAUNCHES_TF32X3.value
            == before_tc + int(kernel == "flash_tf32x3_kernel"))


def test_dryrun_rings_go_through_the_fp32_tensor_core_kernel(cuda):
    # dryrun_multichip(1) on a one-rank NCCL group folds its two fp32 rings
    # (d = 8) through flash_tf32x3_kernel, once each.
    from brpc_tpu_torch.models import tensor_service as ts

    before, before_tc = fa.LAUNCHES.value, fa.LAUNCHES_TF32X3.value
    ts.dryrun_multichip(1)
    torch.cuda.synchronize()
    assert fa.LAUNCHES.value - before == 2
    assert fa.LAUNCHES_TF32X3.value - before_tc == 2


def test_flash_attention_kernel_matches_dense(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(2, 8, 256, 128, generator=gen, device=cuda)
    k = torch.randn(2, 2, 256, 128, generator=gen, device=cuda)
    v = torch.randn(2, 2, 256, 128, generator=gen, device=cuda)
    out = fa.flash_attention(q, k, v, causal=True)
    ref = fa.dense_attention_mh(q, k, v, causal=True)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


def test_flash_carry_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(1, 2, 8, 16, device=cuda)
    m, l, acc = fa.flash_init(1, 2, 8, 16, device=cuda)
    with pytest.raises(TypeError, match="float16"):
        fa.flash_attention_carry(x.half(), x.half(), x.half(), m, l, acc,
                                 (0, 0))
    with pytest.raises(TypeError, match="acc"):
        fa.flash_attention_carry(x, x, x, m, l, acc.double(), (0, 0))
    with pytest.raises(ValueError, match="contiguous"):
        y = torch.zeros(1, 2, 16, 8, device=cuda).transpose(-1, -2)
        fa.flash_attention_carry(y, y, y, m, l, acc, (0, 0))
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_carry(x, x[:, :1].expand(1, 3, 8, 16).contiguous(),
                                 x[:, :1].expand(1, 3, 8, 16).contiguous(),
                                 m, l, acc, (0, 0))
    # d > 256 is taken (on flash_simt_kernel), not refused.
    wide = torch.zeros(1, 1, 8, 264, device=cuda)
    wm, wl, wacc = fa.flash_init(1, 1, 8, 264, device=cuda)
    assert fa.kernel_name(wide, wide, wide, wacc) == "flash_simt_kernel"
    fa.flash_attention_carry(wide, wide, wide, wm, wl, wacc, (0, 0))
    torch.cuda.synchronize()


# Shapes the reference folds that the kernel once refused: b*h past
# 65535 (one q tile a head: the grid is 1-D on every route) and d past
# 256 (flash_simt_kernel; at 640 its tiles outgrow a block's shared
# memory, so a fold is two launches over column chunks of acc).
@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.bfloat16, 64, "flash_ws_kernel"),
    (torch.float32, 64, "flash_tf32x3_kernel"),
    (torch.bfloat16, 48, "flash_simt_kernel")])
def test_flash_carry_kernel_at_b_times_h_65536_matches_plain(cuda, dtype, d,
                                                            kernel):
    b, h, hkv, sq, sk = 2048, 32, 8, 64, 128
    gen = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn(b, h, sq, d, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(b, hkv, sk, d, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    carry = fa.flash_init(b, h, sq, d, device=cuda)
    assert fa.kernel_name(q, k, v, carry[2]) == kernel
    got = fa.flash_attention_carry(q, k, v, *carry, (64, 0), causal=True)
    torch.cuda.synchronize()
    _assert_matches_plain(q, k, v, carry, (64, 0), True, got)


# d 1280 and 1300: the scores no longer fit beside an acc chunk, so they
# are summed over d in 128-column chunks with Q reloaded each chunk (at
# 1300 the last chunk is 20 columns wide).
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,launches", [(320, 1), (640, 2), (1280, 2),
                                        (1300, 2)])
def test_flash_carry_kernel_past_d_256_matches_plain(cuda, dtype, d,
                                                     launches):
    gen = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn(1, 4, 96, d, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(1, 2, 160, d, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    m, l, acc = fa.flash_carry_reference(  # a carry that is not fresh
        q, k, v, *fa.flash_init(1, 4, 96, d, device=cuda), (400, 0),
        causal=True, block_k=32, ragged_tail=True)
    assert fa.kernel_name(q, k, v, acc) == "flash_simt_kernel"
    assert fa.simt_launches(d) == launches
    off = torch.tensor((40, 0), dtype=torch.int32, device=cuda)
    got = fa.flash_attention_carry(q, k, v, m, l, acc, off, causal=True)
    torch.cuda.synchronize()
    _assert_matches_plain(q, k, v, (m, l, acc), (40, 0), True, got)


# The ring over NCCL, one rank per card: each rank folds its resident
# queries over the kv blocks sent around the ring; the result equals
# one-card flash attention on the whole sequence (kv blocks fold in
# another order, so p is rounded at other running maxima: acc/l to 4e-3,
# plus one bf16 step of the output), and each rank's output equals the
# same folds replayed on that rank with no transfer, bit for bit.
RING_CARDS = 4
RING_SHAPE = dict(b=1, h=32, hkv=8, s=8192, d=128)  # Llama 3 8B layer
# Four gloo ranks sharing one card (CUDA tensors staged through the host).
SHARED_RING_SHAPE = dict(b=1, h=4, hkv=2, s=1024, d=64)


def _ring_inputs(shape=RING_SHAPE):
    gen = torch.Generator(device="cuda").manual_seed(11)
    c = shape
    mk = lambda h: torch.randn(c["b"], h, c["s"], c["d"], generator=gen,  # noqa: E731
                               device="cuda").to(torch.bfloat16)
    return mk(c["h"]), mk(c["hkv"]), mk(c["hkv"])


def _ring_card_rank(shape, dryrun):
    """One rank's ring on its card: (its output, K3 launches, shifts,
    whether the output equals its replay bit for bit)."""
    import torch.distributed as dist

    from brpc_tpu_torch.models.tensor_service import dryrun_multichip
    from brpc_tpu_torch.ops import ring_attention as ra
    from brpc_tpu_torch.parallel import collectives as col
    from brpc_tpu_torch.parallel.mesh import make_mesh

    rank, n = dist.get_rank(), dist.get_world_size()
    mesh = make_mesh(client=1, shard=n)
    full = _ring_inputs(shape)
    q, k, v = (t.chunk(n, dim=2)[rank].contiguous() for t in full)
    before, shifts = fa.LAUNCHES.value, col.SHIFTS.value
    out = ra.ring_attention(mesh, causal=True)(q, k, v)
    torch.cuda.synchronize()
    launches = fa.LAUNCHES.value - before
    shifts = col.SHIFTS.value - shifts
    blocks = [tuple(t.chunk(n, dim=2)[(rank - hop) % n].contiguous()
                    for t in full[1:]) for hop in range(n)]
    replayed = torch.equal(out, ra.ring_replay(q, blocks, rank, n,
                                               causal=True))
    if dryrun:
        dryrun_multichip(n)
    return out.float().cpu().numpy(), launches, shifts, replayed


def _check_ring_ranks(results, shape):
    n = len(results)
    assert [r[1:] for r in results] == [(n, n - 1, True)] * n
    got = torch.from_numpy(np.concatenate([r[0] for r in results], axis=2))
    ref = fa.flash_attention(*_ring_inputs(shape), causal=True).float().cpu()
    assert ((got - ref).abs() <= 4e-3 + 2.0 ** -8 * ref.abs()).all()


def test_ring_attention_over_nccl_matches_one_card(cuda):
    if torch.cuda.device_count() < RING_CARDS:
        pytest.skip(f"needs {RING_CARDS} CUDA cards")
    from brpc_tpu_torch.ops import _build
    from brpc_tpu_torch.parallel.launch import run_ranks

    _build.load()  # build once here, before the ranks start
    results = run_ranks(RING_CARDS, _ring_card_rank, (RING_SHAPE, True),
                        device_type="cuda", timeout_s=300)
    _check_ring_ranks(results, RING_SHAPE)


def test_ring_attention_shares_one_card_over_gloo(cuda):
    from brpc_tpu_torch.ops import _build
    from brpc_tpu_torch.parallel.launch import run_ranks

    _build.load()
    results = run_ranks(4, _ring_card_rank, (SHARED_RING_SHAPE, False),
                        device_type="cuda", share_card=True, timeout_s=300)
    _check_ring_ranks(results, SHARED_RING_SHAPE)


# One ring closure called again and again with new inputs: on NCCL the
# first call runs eagerly, the second captures the ring as a CUDA graph and
# replays it, the rest replay; each call equals the eager schedule and the
# replay of its folds bit for bit, and counts n K3 launches and n-1 shifts.
# A call at another shape then drops the captured ring and runs eagerly.
# The Llama layer in bf16, and a small GQA shape in fp32 (3xTF32).
GRAPH_RING_CASES = [(RING_SHAPE, torch.bfloat16),
                    (dict(b=2, h=8, hkv=2, s=1024, d=64), torch.float32)]
GRAPH_RING_CALLS = 5


def _graph_ring_rank(cases, calls):
    """Per case and call: (== eager, == replay, K3 launches, shifts,
    K3 launches on the fp32 tensor-core kernel); whether the closure
    holds a captured ring after the calls; and, after one more call at
    half the rows, whether that call == eager and the ring was dropped."""
    import torch.distributed as dist

    from brpc_tpu_torch.ops import ring_attention as ra
    from brpc_tpu_torch.parallel import collectives as col
    from brpc_tpu_torch.parallel.mesh import make_mesh

    rank, n = dist.get_rank(), dist.get_world_size()
    mesh = make_mesh(client=1, shard=n)
    group = mesh.get_group("shard")
    out = []
    for shape, dtype in cases:
        ring = ra.ring_attention(mesh, causal=True)
        rows = []
        for call in range(calls):
            gen = torch.Generator(device="cuda").manual_seed(100 + call)
            full = [torch.randn(shape["b"], heads, shape["s"], shape["d"],
                                generator=gen, device="cuda").to(dtype)
                    for heads in (shape["h"], shape["hkv"], shape["hkv"])]
            q, k, v = (t.chunk(n, dim=2)[rank].contiguous() for t in full)
            before = (fa.LAUNCHES.value, col.SHIFTS.value,
                      fa.LAUNCHES_TF32X3.value)
            got = ring(q, k, v)
            torch.cuda.synchronize()
            counts = (fa.LAUNCHES.value - before[0],
                      col.SHIFTS.value - before[1],
                      fa.LAUNCHES_TF32X3.value - before[2])
            eager = ra._ring_eager(q, k, v, group, rank, n, causal=True)
            blocks = [tuple(t.chunk(n, dim=2)[(rank - hop) % n].contiguous()
                            for t in full[1:]) for hop in range(n)]
            replay = ra.ring_replay(q, blocks, rank, n, causal=True)
            rows.append((torch.equal(got, eager), torch.equal(got, replay))
                        + counts)
        captured = ring.cache.graph is not None
        q2, k2, v2 = (t[:, :, :t.shape[2] // 2].contiguous()
                      for t in (q, k, v))
        other = torch.equal(ring(q2, k2, v2), ra._ring_eager(
            q2, k2, v2, group, rank, n, causal=True))
        out.append((rows, captured, other, ring.cache.graph is None))
        del ring
        torch.cuda.synchronize()
    return out


def _check_graph_ring(results, cases, captured):
    n = len(results)
    for rank, res in enumerate(results):
        for (shape, dtype), (rows, *rest) in zip(cases, res):
            tc = n if dtype == torch.float32 else 0
            assert rows == [(True, True, n, n - 1, tc)] * len(rows), (
                rank, dtype, rows)
            assert rest == [captured, True, True], (rank, dtype, rest)


def test_ring_graph_over_nccl_equals_eager_and_replay(cuda):
    if torch.cuda.device_count() < RING_CARDS:
        pytest.skip(f"needs {RING_CARDS} CUDA cards")
    from brpc_tpu_torch.ops import _build
    from brpc_tpu_torch.parallel.launch import run_ranks

    _build.load()
    results = run_ranks(RING_CARDS, _graph_ring_rank,
                        (GRAPH_RING_CASES, GRAPH_RING_CALLS),
                        device_type="cuda", timeout_s=300)
    _check_graph_ring(results, GRAPH_RING_CASES, captured=True)


def test_ring_shares_one_card_over_gloo_call_after_call(cuda):
    # gloo (ranks sharing the card) runs the eager packed schedule every
    # call: nothing is captured.
    from brpc_tpu_torch.ops import _build
    from brpc_tpu_torch.parallel.launch import run_ranks

    _build.load()
    cases = [(SHARED_RING_SHAPE, torch.bfloat16)]
    results = run_ranks(4, _graph_ring_rank, (cases, 3), device_type="cuda",
                        share_card=True, timeout_s=300)
    _check_graph_ring(results, cases, captured=False)


# ---------------------------------------------------------------------------
# The training plane on the card.
# ---------------------------------------------------------------------------

_DP_SIZES = [64, 256, 256, 64]


def _threads(n, fn):
    import threading

    out, errs = {}, []

    def worker(r):
        try:
            out[r] = fn(r)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(r,)) for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs, errs
    return [out[r] for r in range(n)]


def _dp_run(cuda, track, steps=2):
    from brpc_tpu_torch.models.tensor_service import LayeredMLP
    from brpc_tpu_torch.models.tp_layers import LocalRing
    from brpc_tpu_torch.runtime.step_driver import CollectiveStepDriver

    ring = LocalRing(2)
    ds = [CollectiveStepDriver(ring.member(r),
                               LayeredMLP(_DP_SIZES, device=cuda),
                               track=track) for r in range(2)]
    for d in ds:
        d.prime()
    data = [ds[0].harness.data(16, seed=40 + r) for r in range(2)]
    k1 = fu.LAUNCHES.value
    _threads(2, lambda r: [ds[r].step(*data[r]) for _ in range(steps)])
    torch.cuda.synchronize()
    return ds, fu.LAUNCHES.value - k1


def test_collective_driver_launches_k1_per_layer_per_step(cuda):
    ds, launches = _dp_run(cuda, track=False)
    layers = len(_DP_SIZES) - 1
    assert launches == 2 * 2 * layers  # 2 members x 2 steps x layers
    for n, p in ds[0].params().items():
        assert p.device.type == "cuda"
        assert torch.equal(p, ds[1].params()[n])


def test_tracked_collective_step_equals_untracked_on_the_card(cuda):
    plain, _ = _dp_run(cuda, track=False)
    from brpc_tpu_torch.collectives.ring import chunk_spans

    tracked, launches = _dp_run(cuda, track=True)
    # The spans a LocalRing member finalizes per allreduce: every
    # non-empty chunk of the ring schedule.
    plan = {n: [(i, sp) for i, sp in enumerate(chunk_spans(p.numel(), 2))
                if sp[1]]
            for n, p in plain[0].params().items()}
    for d in tracked:
        assert {n: sorted(v) for n, v in d.last_chunk_log.items()} == plan
    # One K1 per landed chunk: 2 members x 2 steps x the plan.
    assert launches == 2 * 2 * sum(len(v) for v in plan.values())
    for n, p in plain[0].params().items():
        assert torch.equal(tracked[0].params()[n], p), n
        assert torch.equal(tracked[0].momenta()[n], plain[0].momenta()[n])


def test_overlapped_driver_hides_wire_time_on_the_card(cuda):
    """3 layers over a server on the card: the wire lane copies each
    finished gradient on its own stream, so wire time runs in the
    compute lane's shadow; overlapped == serial bit for bit."""
    from brpc_tpu_torch.models.tensor_service import LayeredMLP
    from brpc_tpu_torch.runtime.param_server import (ParameterClient,
                                                     ParameterServer)
    from brpc_tpu_torch.runtime.step_driver import OverlappedStepDriver
    from brpc_tpu_torch.runtime.step_sched import current_lane

    sizes = [512, 2048, 2048, 512]
    h = LayeredMLP(sizes, device=cuda)
    x, y = h.data(4096)
    init = {k: v.cpu().numpy() for k, v in h.init_params().items()}
    results = []
    for overlap in (True, False):
        ps = ParameterServer(init, device=cuda)
        cl = ParameterClient(f"tpu://127.0.0.1:{ps.start()}", device=cuda)
        try:
            d = OverlappedStepDriver(cl, h, overlap=overlap)
            d.prime()
            k1 = fu.LAUNCHES.value
            losses = [d.step(x, y) for _ in range(3)]
            torch.cuda.synchronize()
            assert fu.LAUNCHES.value - k1 == 3 * 3
            results.append((losses, ps.state(), d.totals))
        finally:
            cl.close()
            ps.stop()
    (lo, so, to), (ls, ss, ts_) = results
    assert lo == ls
    for k in so.params:
        assert torch.equal(so.params[k], ss.params[k])
    assert to["overlapped_comm_ms"] > 0.0
    assert ts_["overlapped_comm_ms"] == 0.0


def test_overlapped_driver_keeps_its_lane_stream_across_steps(cuda):
    """Each wire lane runs on one stream for the driver's lifetime, so
    the caching allocator hands each step's pulled weights the blocks the
    last step freed: after three warm steps, three more reserve no
    device memory. The server runs in a process of its own, with one-sided
    pulls, as chip_smoke.py phase 6 runs it; its state equals an
    overlap=False run against a server in this process, bit for bit."""
    from brpc_tpu_torch.models.tensor_service import LayeredMLP
    from brpc_tpu_torch.parallel.ps_process import ServerProcess
    from brpc_tpu_torch.runtime import handoff
    from brpc_tpu_torch.runtime.param_server import (ParameterClient,
                                                     ParameterServer)
    from brpc_tpu_torch.runtime.step_driver import OverlappedStepDriver
    from brpc_tpu_torch.runtime.step_sched import current_lane

    sizes = [512, 2048, 2048, 512]
    h = LayeredMLP(sizes, device=cuda)
    x, y = h.data(4096)
    init = {k: v.cpu().numpy() for k, v in h.init_params().items()}
    entered = []  # (lane, stream), one per wire lane per step
    orig = handoff.LaneStreams.ctx

    def ctx(self):
        cm = orig(self)
        entered.append((current_lane(), cm.stream))
        return cm

    with ServerProcess(init, device=cuda, oneside=True, timeout_s=300) as srv:
        cl = ParameterClient(srv.addr, device=cuda, oneside=True)
        try:
            d = OverlappedStepDriver(cl, h, overlap=True)
            d.prime()
            handoff.LaneStreams.ctx = ctx
            try:
                losses = [d.step(x, y) for _ in range(3)]
                torch.cuda.synchronize()
                reserved = torch.cuda.memory_reserved(cuda)
                losses += [d.step(x, y) for _ in range(3)]
                torch.cuda.synchronize()
                assert torch.cuda.memory_reserved(cuda) == reserved
            finally:
                handoff.LaneStreams.ctx = orig
        finally:
            cl.close()
        own = srv.state()
    # Two wire lanes (pushes; confirms and pulls), each entered at the
    # start of each of the 6 steps: each lane on one stream of its own,
    # the same every step.
    assert len(entered) == 12
    by_lane = {}
    for lane, stream in entered:
        by_lane.setdefault(lane, set()).add(stream)
    assert set(by_lane) == {"wire", "wire:pull"}
    assert all(len(v) == 1 for v in by_lane.values())
    assert by_lane["wire"] != by_lane["wire:pull"]
    ps = ParameterServer(init, device=cuda)
    cl = ParameterClient(f"tpu://127.0.0.1:{ps.start()}", device=cuda)
    try:
        d = OverlappedStepDriver(cl, h, overlap=False)
        d.prime()
        assert [d.step(x, y) for _ in range(6)] == losses
        ref = ps.state()
    finally:
        cl.close()
        ps.stop()
    assert own.versions == ref.versions
    for k in ref.params:
        assert torch.equal(own.params[k], ref.params[k].cpu())
        assert torch.equal(own.momenta[k], ref.momenta[k].cpu())


# LayeredMLP over a client x shard mesh on the card: the wire rank (rank 0)
# alone drives a server in this process; every other rank runs the driver
# with client=None. Held against the single-device harness on the same
# driver within rtol 2e-5 / atol 1e-6 (the mesh sums its partials in
# another order); K1 runs once per name per step, on the server only.
_MESH_SIZES = [256, 1024, 256, 1024, 128]
_MESH_BATCH, _MESH_STEPS = 512, 2


def _mesh_card_rank(addr, client, shard):
    from brpc_tpu_torch.models.tensor_service import LayeredMLP
    from brpc_tpu_torch.parallel.mesh import make_mesh
    from brpc_tpu_torch.runtime.param_server import ParameterClient
    from brpc_tpu_torch.runtime.step_driver import OverlappedStepDriver

    dev = torch.device("cuda", torch.cuda.current_device())
    h = LayeredMLP(_MESH_SIZES, mesh=make_mesh(client, shard), seed=7,
                   device=dev)
    cl = ParameterClient(addr, device=dev) if h.is_wire else None
    k1 = fu.LAUNCHES.value
    try:
        d = OverlappedStepDriver(cl, h)
        d.prime()
        losses = [d.step(*h.data(_MESH_BATCH, seed=70 + i))
                  for i in range(_MESH_STEPS)]
    finally:
        if cl is not None:
            cl.close()
    torch.cuda.synchronize()
    return losses, dict(d.versions), fu.LAUNCHES.value - k1


def _mesh_card_run(cuda, run):
    """``run(addr)`` against a server on the card seeded with the stack's
    weights -> (run's result, final params, K1 launches meanwhile)."""
    from brpc_tpu_torch.models.tensor_service import LayeredMLP
    from brpc_tpu_torch.runtime.param_server import ParameterServer

    init = {k: v.cpu().numpy() for k, v in LayeredMLP(
        _MESH_SIZES, seed=7, device="cpu").init_params().items()}
    ps = ParameterServer(init, device=cuda)
    try:
        k1 = fu.LAUNCHES.value
        out = run(f"tpu://127.0.0.1:{ps.start()}")
        torch.cuda.synchronize()
        return out, ps.state().params, fu.LAUNCHES.value - k1
    finally:
        ps.stop()


def _mesh_card_check(cuda, results, params, launches):
    from brpc_tpu_torch.models.tensor_service import LayeredMLP
    from brpc_tpu_torch.runtime.param_server import ParameterClient
    from brpc_tpu_torch.runtime.step_driver import OverlappedStepDriver

    def single(addr):
        h = LayeredMLP(_MESH_SIZES, seed=7, device=cuda)
        cl = ParameterClient(addr, device=cuda)
        try:
            d = OverlappedStepDriver(cl, h)
            d.prime()
            return [d.step(*h.data(_MESH_BATCH, seed=70 + i))
                    for i in range(_MESH_STEPS)]
        finally:
            cl.close()

    ref_losses, ref_params, ref_launches = _mesh_card_run(cuda, single)
    names = sorted(ref_params)
    assert launches == ref_launches == len(names) * _MESH_STEPS
    losses, versions, _k1 = results[0]
    assert versions == {n: _MESH_STEPS for n in names}
    for other, v, k1 in results[1:]:
        assert other == losses and v == {} and k1 == 0
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-5, atol=1e-6)
    for n in names:
        torch.testing.assert_close(params[n], ref_params[n], rtol=2e-5,
                                   atol=1e-6)


def test_mesh_harness_shares_one_card_over_gloo(cuda):
    from brpc_tpu_torch.parallel.launch import run_ranks

    results, params, launches = _mesh_card_run(cuda, lambda addr: run_ranks(
        4, _mesh_card_rank, (addr, 2, 2), device_type="cuda",
        share_card=True, timeout_s=300))
    assert results[0][2] == 0  # the wire rank launched no K1 itself
    _mesh_card_check(cuda, results, params, launches)


def test_mesh_harness_on_a_one_rank_nccl_group(cuda):
    import torch.distributed as dist

    from brpc_tpu_torch.parallel.launch import one_rank_group

    def run(addr):
        with one_rank_group("cuda"):
            assert dist.get_backend() == "nccl"
            return [_mesh_card_rank(addr, 1, 1)]

    results, params, launches = _mesh_card_run(cuda, run)
    _mesh_card_check(cuda, results, params, launches)


def test_mesh_harness_over_nccl_on_four_cards(cuda):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards")
    from brpc_tpu_torch.parallel.launch import run_ranks

    results, params, launches = _mesh_card_run(cuda, lambda addr: run_ranks(
        4, _mesh_card_rank, (addr, 2, 2), device_type="cuda",
        timeout_s=300))
    _mesh_card_check(cuda, results, params, launches)


def test_parameter_server_runs_on_a_stream_of_its_own(cuda, monkeypatch):
    """Every handler's device work — here a push's H2D and K1 — runs on
    the server's stream, not the default stream a trainer in the same
    process computes on; the pulled and snapshot state is the update's."""
    from brpc_tpu_torch.runtime import param_server as psmod

    streams = []
    kernel = psmod.fused_momentum_update

    def spy(*a, **kw):
        streams.append(torch.cuda.current_stream(cuda).cuda_stream)
        return kernel(*a, **kw)

    monkeypatch.setattr(psmod, "fused_momentum_update", spy)
    w = np.arange(4096, dtype=np.float32).reshape(64, 64)
    ps = psmod.ParameterServer({"w": w}, device=cuda)
    cl = psmod.ParameterClient(f"tpu://127.0.0.1:{ps.start()}", device=cuda)
    try:
        own = ps._stream.cuda_stream
        assert own not in (torch.cuda.default_stream(cuda).cuda_stream,
                           torch.cuda.current_stream(cuda).cuda_stream)
        g = torch.ones((64, 64), device=cuda)
        assert cl.push_grad("w", g) == 1
        assert streams == [own]
        ref_p, _ = fu.momentum_update_reference(
            torch.from_numpy(w).to(cuda), torch.zeros_like(g), g)
        _v, pulled = cl.pull("w")
        assert torch.equal(pulled, ref_p)
        assert torch.equal(ps.state().params["w"], ref_p)
    finally:
        cl.close()
        ps.stop()


def _serving_params(cuda):
    from brpc_tpu_torch.models.decoder import init_decoder

    return init_decoder(torch.Generator().manual_seed(3), vocab=2048,
                        dim=128, max_pos=256, device=cuda)


_SERVE_PROMPTS = [list(range(1, 40)), [5, 2, 9], list(range(100, 164)),
                  [7] * 20, list(range(1, 40)) + [11, 12], [300, 301, 302]]


def _serve_on_card(cuda, params, **kw):
    """Six staggered sessions through an engine on the card -> tokens."""
    from brpc_tpu_torch.serving import (DONE, CallableSink, DecodeEngine,
                                        SessionManager)

    mgr = SessionManager(max_len=256, dim=128, kv_arena_bytes=16 << 20,
                         paged=kw.pop("paged", False), block_rows=16)
    eng = DecodeEngine(mgr, params, max_batch=4, device=cuda, **kw)
    assert eng._stream is not None
    assert eng._stream.cuda_stream != \
        torch.cuda.default_stream(cuda).cuda_stream
    outs, sessions = [], []
    for p in _SERVE_PROMPTS:
        toks = []
        outs.append(toks)
        sessions.append(mgr.open(p, 48, CallableSink(
            lambda f, toks=toks: toks.append(int(f[1:]))
            if f.startswith(b"T") else None)))
        eng.step()
    for _ in range(2000):
        if not eng.step() and all(s.state == DONE for s in sessions):
            break
    assert all(s.state == DONE for s in sessions)
    mgr.shutdown()
    return outs


def test_serving_batched_paged_and_spec_equal_serial_on_the_card(cuda):
    """The continuous batch on the card: every session's tokens equal
    decode_serial's at the engine's lane count, and the paged pool and
    both speculative drafts equal the monolithic plain engine."""
    from brpc_tpu_torch.models.decoder import decode_serial, init_decoder

    params = _serving_params(cuda)
    mono = _serve_on_card(cuda, params)
    assert mono == [decode_serial(params, p, 48, 256, lanes=4)
                    for p in _SERVE_PROMPTS]
    assert _serve_on_card(cuda, params, paged=True) == mono
    assert _serve_on_card(cuda, params, spec_k=4) == mono
    draft = init_decoder(torch.Generator().manual_seed(4), vocab=2048,
                         dim=32, max_pos=256, device=cuda)
    assert _serve_on_card(cuda, params, spec_k=4, draft="model",
                          draft_params=draft) == mono
    assert _serve_on_card(cuda, params, spec_k=4, draft="model",
                          draft_params=params) == mono


def test_fleet_drain_lands_mid_step_on_the_card(cuda, monkeypatch):
    """A drain whose freezes land while the source engine's step is still
    running on the card: each session is exported only after that step's
    device-to-host copy has landed (freeze -> park at the next boundary
    -> export), ships to the other member, and its stream equals
    decode_serial at the engine's lane count."""
    import threading

    from brpc_tpu_torch.fleet import RegistryHub, clear_registry
    from brpc_tpu_torch.models.decoder import decode_serial
    from brpc_tpu_torch.serving import (FleetServingServer,
                                        ServingFleetClient)
    from brpc_tpu_torch.serving import engine as eng_mod

    params = _serving_params(cuda)
    hub = RegistryHub()
    hub.start()
    kw = dict(max_batch=4, max_len=256, dim=128, kv_arena_bytes=16 << 20,
              reg_ttl_s=3, device=cuda)
    a = FleetServingServer(hub.hostport, params, tag="cudadrain", **kw)
    b = FleetServingServer(hub.hostport, params, tag="cudadrain", **kw)
    a.start()
    b.start()
    in_step, events = threading.Event(), []
    armed = {"on": False, "inflight": False}
    real_step = eng_mod.decode_step

    def slow_step(*args, **kwargs):
        out = real_step(*args, **kwargs)  # queued on the engine's stream
        if armed["on"] and threading.current_thread() is a.engine._thread:
            armed["inflight"] = True
            in_step.set()
            time.sleep(0.05)  # the step's device work is still in flight
            armed["inflight"] = False
        return out

    monkeypatch.setattr(eng_mod, "decode_step", slow_step)
    for name in ("freeze", "export_session"):
        inner = getattr(a.manager, name)

        def traced(sess, _inner=inner, _name=name):
            events.append((_name, armed["inflight"]))
            return _inner(sess)

        monkeypatch.setattr(a.manager, name, traced)
    c = ServingFleetClient(hub.hostport, tag="cudadrain")
    try:
        c.router.refresh(force=True)
        keys, i = [], 0
        while len(keys) < 3:
            if c.router.route(f"cd-{i}") == a.addr:
                keys.append(f"cd-{i}")
            i += 1
        prompts = [_SERVE_PROMPTS[j] for j in (0, 3, 4)]
        streams = [c.open(p, 96, session_key=k)
                   for k, p in zip(keys, prompts)]
        for ts in streams:
            while len(ts.tokens) < 3:
                ts.read_token(timeout_ms=30000)
        readers = [threading.Thread(target=lambda ts=ts: list(ts))
                   for ts in streams]
        for t in readers:
            t.start()
        armed["on"] = True
        assert in_step.wait(30)
        moved = a.drain()
        for t in readers:
            t.join(timeout=120)
            assert not t.is_alive()
        assert moved == 3
        assert ("freeze", True) in events, events
        assert all(not inflight for name, inflight in events
                   if name == "export_session"), events
        for ts, p in zip(streams, prompts):
            assert ts.tokens == decode_serial(params, p, 96, 256, lanes=4)
            assert ts.resumes == 1 and ts.addr == b.addr
    finally:
        c.close()
        for srv in (a, b):
            srv.stop()
        clear_registry()
        hub.stop()
