"""The port's mesh, collectives, ring attention and sharded step on 4 gloo
ranks, against the JAX package on 4 virtual CPU devices.

One spawn of 4 ranks (``parallel.launch.run_ranks``; the ranks import
neither jax nor the suite's conftest: this module imports jax only inside
the fixture that runs the JAX side) computes, from the same numpy inputs:

- every collective of ``parallel/collectives.py`` — gloo takes all five
  (all_gather_into_tensor, all_reduce, reduce_scatter_tensor,
  batch_isend_irecv, all_to_all_single), so none is left out here;
- ``ring_attention`` causal and not, GQA, the 3-D form and extreme scores
  (the cases of tests/test_flash_attention.py:58-95 and
  tests/test_data_plane.py:150-186);
- the ring's schedule: the order in which each rank starts its shifts,
  folds and waits (``ring_shift_start`` and ``flash_attention_carry``
  wrapped in the ranks), and each rank's output against a serialized
  replay of the same folds (``hop_offsets``, in order), bit for bit;
- the packed hop: each shift is one send and one receive of the packed
  K|V buffer (``dist.batch_isend_irecv`` wrapped in the ranks), received
  into two buffers made once a call and used in turn, at shapes whose
  block is no multiple of the packing's 256-byte boundary; repeated calls
  of one ring each make n-1 shifts and n folds and equal their replays;
- a ``ring_shift_start`` handle holds the tensor it sends until
  ``wait()``;
- ``make_sharded_train_step`` on a 2x2 mesh, with the reference's
  n_shard-times gradient of w1, b1 and w2 pinned;
- ``dryrun_multichip(4, device="cpu")`` inside the group.

Tolerances: collectives move or sum the same fp32 values — exact, except
sums of two fp32 values (exact too). Ring attention 3e-5 (fp32, the JAX
tests' own). The sharded step 2e-6 absolute on the state: both packages
round the same bf16 operands and gradients; the fp32 sums run in another
order.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from brpc_tpu_torch.ops.ring_attention import hop_offsets
from brpc_tpu_torch.parallel.launch import run_ranks

N = 4
RING_CASES = {
    # name: (q shape, kv heads or None for 3-D, causal, block, seed, shards)
    "mh": ((2, 4, 128, 32), 4, False, 32, 11, 4),
    "mh_causal": ((2, 4, 128, 32), 4, True, 32, 11, 4),
    "gqa_causal": ((1, 8, 64, 32), 2, True, 16, 13, 4),
    "single_head_3d": ((2, 64, 16), None, False, 1024, 5, 2),
    "data_plane_3d": ((2, 32, 16), None, False, 1024, 7, 4),
    # s/n * d = 5 * 7 elements a head: V's half of the packed buffer
    # starts past padding.
    "gqa_odd": ((1, 4, 20, 7), 2, False, 1024, 17, 4),
    "gqa_odd_causal": ((1, 4, 20, 7), 2, True, 1024, 17, 4),
}
REPEAT_CASE = "gqa_odd_causal"
REPEAT_SCALES = (1.0, 0.5, 2.0)
STEP_DIMS = dict(din=16, dh=32, dout=8, batch=16)
FIELDS = ("w1", "b1", "w2", "b2", "m_w1", "m_w2", "stats")


def _inputs():
    rng = np.random.default_rng(2024)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    inp = {"gather": f32(4, 3), "reduce": f32(8, 4), "rs": f32(8, 4),
           "stream": f32(4, 2), "a2a": np.arange(32, dtype=np.float32
                                                 ).reshape(4, 8)}
    for name, (shape, hkv, _c, _b, seed, _n) in RING_CASES.items():
        r = np.random.default_rng(seed)
        kv_shape = shape if hkv is None else (shape[0], hkv, *shape[2:])
        inp[name] = (r.standard_normal(shape).astype(np.float32),
                     r.standard_normal(kv_shape).astype(np.float32),
                     r.standard_normal(kv_shape).astype(np.float32))
    # Extreme scores (tests/test_data_plane.py): one shard's keys dominate,
    # so the running max jumps mid-ring.
    q = np.full((1, 32, 8), 3.0, np.float32)
    k = np.concatenate([np.full((1, 8, 8), x, np.float32)
                        for x in (-5.0, 0.1, 9.0, 0.1)], axis=1)
    v = np.tile(np.arange(32, dtype=np.float32)[None, :, None], (1, 1, 8))
    inp["extreme"] = (q, k, v)
    d = STEP_DIMS
    inp["state"] = {
        "w1": f32(d["din"], d["dh"]) / np.float32(4.0),
        "b1": f32(d["dh"]) * np.float32(0.1),
        "w2": f32(d["dh"], d["dout"]) / np.float32(6.0),
        "b2": f32(d["dout"]) * np.float32(0.1),
        "m_w1": f32(d["din"], d["dh"]) * np.float32(0.01),
        "m_w2": f32(d["dh"], d["dout"]) * np.float32(0.01),
        "stats": f32(d["dout"])}
    inp["x"] = f32(d["batch"], d["din"])
    inp["t"] = f32(d["batch"], d["dout"])
    return inp


def _rank_body(inp):
    """Runs on each of the 4 ranks; returns this rank's numpy results."""
    import torch.distributed as dist

    from brpc_tpu_torch.models import tensor_service as ts
    from brpc_tpu_torch.ops.ring_attention import ring_attention
    from brpc_tpu_torch.parallel import collectives as col
    from brpc_tpu_torch.parallel.mesh import make_mesh, ring_mesh
    from brpc_tpu_torch.runtime.state import psstate_from_numpy

    rank = dist.get_rank()
    ci, si = rank // 2, rank % 2  # 2x2 mesh: arange(4).reshape(2, 2)
    mesh22 = make_mesh()
    mesh14 = make_mesh(client=1, shard=4)
    ring = ring_mesh()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    chunk = lambda a, n, i, dim=0: np.array_split(a, n, axis=dim)[i]  # noqa: E731
    out = {"mesh22": (mesh22["client"].size(), mesh22["shard"].size())}
    out["gather"] = col.fanout_gather(mesh22, "shard")(
        t(chunk(inp["gather"], 2, si))).numpy()
    out["reduce"] = col.fanout_reduce(mesh22, "client")(
        t(chunk(inp["reduce"], 2, ci))).numpy()
    out["rs"] = col.reduce_scatter(mesh22, "client")(
        t(chunk(inp["rs"], 2, ci))).numpy()
    for hops in (1, 3, 4):
        out[f"stream{hops}"] = col.ring_stream(ring, hops=hops)(
            t(chunk(inp["stream"], N, rank))).numpy()
    out["a2a"] = col.all_to_all_reshard(ring)(
        t(chunk(inp["a2a"], N, rank))).numpy()

    runs = _ring_runs(rank, mesh22, mesh14)
    for name, (mesh, idx, n, causal, block) in runs.items():
        dim = 1 if inp[name][0].ndim == 3 else 2
        q, k, v = (t(chunk(a, n, idx, dim)) for a in inp[name])
        shifts = col.SHIFTS.value
        with _recorded() as log, _p2p_recorded() as p2p:
            out[name] = ring_attention(mesh, causal=causal, block_q=block,
                                       block_k=block)(q, k, v).numpy()
        out["order_" + name] = log
        out["p2p_" + name] = p2p
        out["shifts_" + name] = col.SHIFTS.value - shifts
        out["replay_" + name] = _serial_replay(
            *(t(a) for a in inp[name]), idx, n, causal, block).numpy()

    from brpc_tpu_torch.ops import flash_attention as fa

    mesh, idx, n, causal, block = runs[REPEAT_CASE]
    attend = ring_attention(mesh, causal=causal, block_q=block,
                            block_k=block)
    out["repeat"] = []
    for scale in REPEAT_SCALES:  # one closure, new inputs each call
        full = [t(a * np.float32(scale)) for a in inp[REPEAT_CASE]]
        shifts, k3 = col.SHIFTS.value, fa.LAUNCHES.value
        with _recorded() as log:
            got = attend(*(x.chunk(n, dim=2)[idx].contiguous()
                           for x in full))
        out["repeat"].append({
            "shifts": col.SHIFTS.value - shifts,
            "k3": fa.LAUNCHES.value - k3,
            "folds": sum(isinstance(e, tuple) for e in log),
            "replayed": torch.equal(got, _serial_replay(
                *full, idx, n, causal, block))})

    import gc
    import weakref

    x = torch.arange(8, dtype=torch.float32) + rank
    sent = weakref.ref(x)
    shift = col.ring_shift_start([x], ring.get_group("shard"))
    del x
    gc.collect()
    out["held_until_wait"] = sent() is not None
    (y,) = shift.wait()
    gc.collect()
    out["released_after_wait"] = sent() is None
    out["shift_got"] = y.numpy()

    state = ts.shard_state(psstate_from_numpy(inp["state"], device="cpu"),
                           mesh22)
    x = ts.shard_batch(t(inp["x"]), mesh22)
    tgt = ts.shard_batch(t(inp["t"]), mesh22)
    new, loss = ts.make_sharded_train_step(mesh22)(state, x, tgt)
    out["step"] = {f: getattr(new, f).numpy() for f in FIELDS}
    out["loss"] = float(loss)

    ts.dryrun_multichip(N, device="cpu")
    out["dryrun"] = True
    return out


def _ring_runs(rank, mesh22, mesh14) -> dict:
    """name -> (mesh, this rank's index on its shard axis, shards, causal,
    block) of every ring run; "extreme" takes ring_attention's defaults."""
    runs = {name: ((mesh14, rank) if n == 4 else (mesh22, rank % 2))
            + (n, causal, block)
            for name, (_s, _h, causal, block, _seed, n) in RING_CASES.items()}
    runs["extreme"] = (mesh14, rank, N, False, 1024)
    return runs


class _recorded:
    """Wraps ``ring_shift_start`` (and the handles it returns) and
    ``flash_attention_carry`` in ring_attention's module for the scope;
    the log lists "shift", ("fold", q_off, kv_off) and "wait" in the order
    the ring called them."""

    def __enter__(self):
        from brpc_tpu_torch.ops import ring_attention as ra

        self.ra, log = ra, []
        self.saved = (ra.ring_shift_start, ra.flash_attention_carry)
        start, carry = self.saved

        def shift(tensors, group, **kw):
            log.append("shift")
            handle = start(tensors, group, **kw)
            wait = handle.wait
            handle.wait = lambda: log.append("wait") or wait()
            return handle

        def fold(q, k, v, m, l, acc, offsets, **kw):
            log.append(("fold", *map(int, offsets)))
            return carry(q, k, v, m, l, acc, offsets, **kw)

        ra.ring_shift_start, ra.flash_attention_carry = shift, fold
        return log

    def __exit__(self, *exc):
        self.ra.ring_shift_start, self.ra.flash_attention_carry = self.saved


class _p2p_recorded:
    """Wraps ``torch.distributed.batch_isend_irecv`` for the scope; the log
    holds, for each batch, (op, peer, data_ptr, numel) of each of its
    point-to-point ops."""

    def __enter__(self):
        import torch.distributed as dist

        self.dist, log = dist, []
        self.saved = dist.batch_isend_irecv
        batch = self.saved

        def record(ops):
            log.append([(op.op.__name__, op.peer, op.tensor.data_ptr(),
                         op.tensor.numel()) for op in ops])
            return batch(ops)

        dist.batch_isend_irecv = record
        return log

    def __exit__(self, *exc):
        self.dist.batch_isend_irecv = self.saved


def _serial_replay(q, k, v, idx, n, causal, block):
    """Rank ``idx``'s ring output folded in one process with no transfer
    (``ring_replay``): its queries over every hop's kv block, in hop
    order, with the ring's tiles. q, k, v: the whole sequence, [b, s, d]
    or [b, h, s, d]."""
    from brpc_tpu_torch.ops.ring_attention import ring_replay

    three_d = q.dim() == 3
    if three_d:
        q, k, v = q[:, None], k[:, None], v[:, None]
    sq = q.shape[2] // n
    rows = lambda t, off: t[:, :, off:off + sq].contiguous()  # noqa: E731
    blocks = [(rows(k, kv_off), rows(v, kv_off)) for _q_off, kv_off in
              (hop_offsets(idx, hop, n, sq) for hop in range(n))]
    out = ring_replay(rows(q, idx * sq), blocks, idx, n, causal=causal,
                      block_q=block, block_k=block)
    return out[:, 0] if three_d else out


def _jax_side(inp):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from brpc_tpu.models import tensor_service as jts
    from brpc_tpu.ops.ring_attention import ring_attention
    from brpc_tpu.parallel import collectives as col
    from brpc_tpu.parallel.mesh import (CLIENT_AXIS, SHARD_AXIS, make_mesh,
                                        ring_mesh)

    devs = jax.devices()[:N]
    mesh22 = make_mesh(devs, client=2, shard=2)
    mesh14 = make_mesh(devs, client=1, shard=4)
    ring = ring_mesh(devs)
    a = lambda x: np.asarray(x)  # noqa: E731
    out = {"gather": a(col.fanout_gather(mesh22, SHARD_AXIS)(inp["gather"])),
           "reduce": a(col.fanout_reduce(mesh22, CLIENT_AXIS)(inp["reduce"])),
           "rs": a(col.reduce_scatter(mesh22, CLIENT_AXIS)(inp["rs"])),
           "a2a": a(col.all_to_all_reshard(ring, SHARD_AXIS)(inp["a2a"]))}
    for hops in (1, 3, 4):
        out[f"stream{hops}"] = a(col.ring_stream(ring, hops=hops)(
            inp["stream"]))
    for name, (_s, _hkv, causal, block, _seed, n) in RING_CASES.items():
        mesh = mesh14 if n == 4 else make_mesh(devs[:2], client=1, shard=2)
        out[name] = a(ring_attention(mesh, causal=causal, block_q=block,
                                     block_k=block)(*inp[name]))
    out["extreme"] = a(ring_attention(mesh14)(*inp["extreme"]))

    specs = jts.PSState(
        w1=P(None, SHARD_AXIS), b1=P(SHARD_AXIS), w2=P(SHARD_AXIS, None),
        b2=P(), m_w1=P(None, SHARD_AXIS), m_w2=P(SHARD_AXIS, None),
        stats=P())
    state = jts.PSState(**{f: jnp.asarray(inp["state"][f]) for f in FIELDS})
    state = jax.tree.map(lambda x, s: jax.device_put(
        x, NamedSharding(mesh22, s)), state, specs)
    batch = NamedSharding(mesh22, P(CLIENT_AXIS, None))
    new, loss = jts.make_sharded_train_step(mesh22)(
        state, jax.device_put(inp["x"], batch),
        jax.device_put(inp["t"], batch))
    out["step"] = {f: a(getattr(new, f)) for f in FIELDS}
    out["loss"] = float(loss)

    # The single-device gradient of the same loss, per client half of the
    # batch (each rounded to bf16 where JAX rounds it), averaged as the
    # client fan-in averages them.
    def loss_fn(w1, b1, w2, b2, x, t):
        h = jax.nn.relu(jnp.dot(x.astype(jnp.bfloat16),
                                w1.astype(jnp.bfloat16),
                                preferred_element_type=jnp.float32) + b1)
        y = jnp.dot(h.astype(jnp.bfloat16), w2.astype(jnp.bfloat16),
                    preferred_element_type=jnp.float32) + b2
        return jnp.mean(jnp.square(y - t))

    st = inp["state"]
    halves = [jax.grad(loss_fn, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(st[f]) for f in ("w1", "b1", "w2", "b2")),
        jnp.asarray(xh), jnp.asarray(th))
        for xh, th in zip(np.split(inp["x"], 2), np.split(inp["t"], 2))]
    out["grad_single"] = {
        f: (a(g0) + a(g1)) / np.float32(2.0)
        for f, g0, g1 in zip(("w1", "b1", "w2", "b2"), *halves)}
    return out


@pytest.fixture(scope="module")
def runs():
    inp = _inputs()
    # The ranks run in their own processes while this one runs the JAX side.
    with ThreadPoolExecutor(max_workers=1) as pool:
        port = pool.submit(run_ranks, N, _rank_body, (inp,),
                           device_type="cpu", timeout_s=240)
        jax_out = _jax_side(inp)
        return inp, port.result(), jax_out


def _assemble(port, key, n, dim, index):
    """Concatenate rank results along ``dim`` in the order of their index
    on the sharded axis (``index(rank)``), from the ranks with client 0."""
    parts = {}
    for rank, res in enumerate(port):
        parts.setdefault(index(rank), res[key])
    return np.concatenate([parts[i] for i in range(n)], axis=dim)


def test_make_mesh_factors_four_ranks_two_by_two(runs):
    _inp, port, _jax = runs
    assert all(res["mesh22"] == (2, 2) for res in port)


@pytest.mark.parametrize("key", ["gather", "reduce"])
def test_replicating_collectives_match_jax(runs, key):
    _inp, port, jax_out = runs
    for res in port:
        np.testing.assert_array_equal(res[key], jax_out[key])


def test_reduce_scatter_matches_jax(runs):
    _inp, port, jax_out = runs
    for rank, res in enumerate(port):
        ci = rank // 2
        np.testing.assert_array_equal(res["rs"], jax_out["rs"][2 * ci:
                                                               2 * ci + 2])


@pytest.mark.parametrize("hops", [1, 3, 4])
def test_ring_stream_matches_jax(runs, hops):
    inp, port, jax_out = runs
    got = np.concatenate([res[f"stream{hops}"] for res in port])
    np.testing.assert_array_equal(got, jax_out[f"stream{hops}"])
    np.testing.assert_array_equal(got, np.roll(inp["stream"], hops, axis=0))


def test_all_to_all_reshard_matches_jax(runs):
    _inp, port, jax_out = runs
    got = np.concatenate([res["a2a"] for res in port])
    assert got.shape == (16, 2)
    np.testing.assert_array_equal(got, jax_out["a2a"])


@pytest.mark.parametrize("name", sorted(RING_CASES) + ["extreme"])
def test_ring_attention_matches_jax_and_dense(runs, name):
    inp, port, jax_out = runs
    from brpc_tpu_torch.ops.flash_attention import dense_attention_mh
    from brpc_tpu_torch.ops.ring_attention import dense_attention_reference

    if name == "extreme":
        n, dim, causal, three_d = 4, 1, False, True
    else:
        shape, hkv, causal, _b, _s, n = RING_CASES[name]
        three_d = hkv is None
        dim = 1 if three_d else 2
    idx = (lambda r: r) if n == 4 else (lambda r: r % 2)
    got = _assemble(port, name, n, dim, idx)
    for res in port:  # client replicas agree
        assert res[name].shape == np.array_split(got, n, axis=dim)[0].shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, jax_out[name], atol=3e-5, rtol=3e-5)
    q, k, v = (torch.from_numpy(a) for a in inp[name])
    dense = (dense_attention_reference(q, k, v) if three_d
             else dense_attention_mh(q, k, v, causal=causal))
    np.testing.assert_allclose(got, dense.numpy(), atol=3e-5, rtol=3e-5)


def _expected_order(idx, n, sq):
    """The reference's schedule on rank ``idx``: hop t+1's shift starts
    before fold t and is waited on after it; n-1 shifts, none after the
    last fold."""
    want = []
    for hop in range(n):
        last = hop + 1 == n
        want += ([] if last else ["shift"]) + [
            ("fold", *hop_offsets(idx, hop, n, sq))] + ([] if last
                                                        else ["wait"])
    return want


@pytest.mark.parametrize("name", sorted(RING_CASES) + ["extreme"])
def test_ring_attention_sends_the_next_hop_before_each_fold(runs, name):
    inp, port, _jax = runs
    n = RING_CASES[name][-1] if name in RING_CASES else N
    dim = 1 if inp[name][0].ndim == 3 else 2
    sq = inp[name][0].shape[dim] // n
    for rank, res in enumerate(port):
        log = res["order_" + name]
        assert log == _expected_order(rank % n, n, sq), (rank, log)
        assert log.count("shift") == res["shifts_" + name] == n - 1


@pytest.mark.parametrize("name", sorted(RING_CASES) + ["extreme"])
def test_ring_attention_equals_its_serialized_replay_bit_for_bit(runs, name):
    _inp, port, _jax = runs
    for res in port:
        np.testing.assert_array_equal(res[name], res["replay_" + name])


def _packed_numel(kv_shard_shape) -> int:
    """Elements of a packed fp32 K|V buffer of one kv block: K's and V's
    each rounded up to 64 (256 bytes)."""
    numel = int(np.prod(kv_shard_shape))
    return 2 * -(-numel // 64) * 64


def _kv_shard_shape(name, n):
    shape, hkv, _c, _b, _s, _n = (RING_CASES[name] if name in RING_CASES
                                  else ((1, 32, 8), None, 0, 0, 0, N))
    if hkv is None:  # 3-D: [b, s, d] -> one head
        return (shape[0], 1, shape[1] // n, shape[2])
    return (shape[0], hkv, shape[2] // n, shape[3])


@pytest.mark.parametrize("name", sorted(RING_CASES) + ["extreme"])
def test_ring_hop_is_one_send_and_one_receive_of_packed_kv(runs, name):
    _inp, port, _jax = runs
    n = RING_CASES[name][-1] if name in RING_CASES else N
    numel = _packed_numel(_kv_shard_shape(name, n))
    for rank, res in enumerate(port):
        batches = res["p2p_" + name]
        assert len(batches) == n - 1, (rank, batches)
        idx = rank % n
        # The ranks of a ring: all four on mesh14; on mesh22 the pair with
        # this rank's client index.
        ring = list(range(N)) if n == N else [rank - idx, rank - idx + 1]
        for ops in batches:
            assert [(op, peer, size) for op, peer, _p, size in ops] == [
                ("isend", ring[(idx + 1) % n], numel),
                ("irecv", ring[(idx - 1) % n], numel)], (rank, ops)


@pytest.mark.parametrize("name", sorted(RING_CASES) + ["extreme"])
def test_ring_receives_into_two_buffers_made_once_a_call(runs, name):
    _inp, port, _jax = runs
    for rank, res in enumerate(port):
        batches = res["p2p_" + name]
        sends = [ops[0][2] for ops in batches]
        recvs = [ops[1][2] for ops in batches]
        assert recvs == [recvs[t % 2] for t in range(len(recvs))], rank
        assert len(set(recvs)) == min(len(recvs), 2), rank
        # Each hop after the first sends the block the last one received.
        assert sends[1:] == recvs[:-1], rank
        assert sends[0] not in recvs, rank


def test_repeated_ring_calls_shift_n_minus_1_and_fold_n_times(runs):
    _inp, port, _jax = runs
    n = RING_CASES[REPEAT_CASE][-1]
    for rank, res in enumerate(port):
        assert len(res["repeat"]) == len(REPEAT_SCALES)
        for call in res["repeat"]:
            # The folds run the plain version on the CPU: K3 launches 0.
            assert call == {"shifts": n - 1, "k3": 0, "folds": n,
                            "replayed": True}, (rank, call)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 2, 5, 7), (2, 1, 3, 3), (1, 8, 64, 32),
                                   (1, 1, 1, 1)])
def test_pack_kv_aligns_v_and_unpacks_exactly(dtype, shape):
    from brpc_tpu_torch.ops.ring_attention import KV_ALIGN, pack_kv, unpack_kv

    gen = torch.Generator().manual_seed(sum(shape))
    k, v = (torch.randn(shape, generator=gen).to(dtype) for _ in range(2))
    kv = pack_kv(k, v)
    pk, pv = unpack_kv(kv, k.shape)
    assert pk.is_contiguous() and pv.is_contiguous()
    assert torch.equal(pk, k) and torch.equal(pv, v)
    gap = pv.data_ptr() - pk.data_ptr()
    assert gap % KV_ALIGN == 0 and 0 <= gap - k.numel() * k.element_size() \
        < KV_ALIGN
    assert pk.data_ptr() == kv.data_ptr()


def test_ring_shift_start_holds_what_it_sends_until_wait(runs):
    _inp, port, _jax = runs
    for rank, res in enumerate(port):
        assert res["held_until_wait"] and res["released_after_wait"]
        np.testing.assert_array_equal(
            res["shift_got"], np.arange(8, dtype=np.float32) + (rank - 1) % N)


@pytest.mark.parametrize("backend,device,staged", [
    ("gloo", "cuda:0", True), ("nccl", "cuda:0", False),
    ("gloo", "cpu", False)])
def test_ring_shift_stages_cuda_tensors_on_gloo_only(backend, device,
                                                     staged):
    from brpc_tpu_torch.parallel.collectives import stages_through_host

    assert stages_through_host(backend, torch.device(device)) is staged


_SHARD_DIM = {"w1": 1, "b1": 0, "m_w1": 1, "w2": 0, "m_w2": 0}


@pytest.mark.parametrize("field", FIELDS)
def test_sharded_step_state_matches_jax(runs, field):
    _inp, port, jax_out = runs
    if field in _SHARD_DIM:
        got = _assemble([r["step"] for r in port], field, 2,
                        _SHARD_DIM[field], lambda r: r % 2)
        for rank, res in enumerate(port):  # client replicas agree
            other = port[rank ^ 2]["step"][field]
            np.testing.assert_array_equal(res["step"][field], other)
    else:
        got = port[0]["step"][field]
        for res in port:
            np.testing.assert_array_equal(res["step"][field], got)
    np.testing.assert_allclose(got, jax_out["step"][field], atol=2e-6,
                               rtol=1e-5)


def test_sharded_step_loss_matches_jax(runs):
    _inp, port, jax_out = runs
    assert len({res["loss"] for res in port}) == 1
    np.testing.assert_allclose(port[0]["loss"], jax_out["loss"], rtol=1e-6)


@pytest.mark.parametrize("param,factor", [("w1", 2.0), ("b1", 2.0),
                                          ("w2", 2.0), ("b2", 1.0)])
def test_sharded_step_gradient_is_n_shard_times_for_all_but_b2(runs, param,
                                                               factor):
    # The reference differentiates through psum over `shard`, which JAX
    # transposes into another psum: w1, b1 and w2 move by n_shard (= 2)
    # times the single-device gradient, b2 by 1x. The port does the same.
    inp, port, jax_out = runs
    st = inp["state"]
    if param in ("w1", "w2"):
        m_new = _assemble([r["step"] for r in port], "m_" + param, 2,
                          _SHARD_DIM[param], lambda r: r % 2)
        applied = m_new - np.float32(0.9) * st["m_" + param]
    else:
        new = (_assemble([r["step"] for r in port], param, 2, 0,
                         lambda r: r % 2) if param == "b1"
               else port[0]["step"][param])
        applied = (st[param] - new) / np.float32(0.01)
    single = jax_out["grad_single"][param]
    np.testing.assert_allclose(applied, factor * single, atol=1e-6,
                               rtol=1e-4)


def test_dryrun_multichip_ran_inside_the_group(runs):
    _inp, port, _jax = runs
    assert all(res["dryrun"] for res in port)


@pytest.mark.parametrize("rank,hop,n,want", [
    (0, 0, 4, (0, 0)), (0, 1, 4, (0, 48)), (3, 1, 4, (48, 32)),
    (1, 3, 4, (16, 32)), (1, 1, 2, (16, 0))])
def test_hop_offsets(rank, hop, n, want):
    # After `hop` rotations rank r holds rank (r - hop) mod n's kv block
    # (16 rows per shard here).
    assert hop_offsets(rank, hop, n, 16) == want
