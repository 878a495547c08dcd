"""The port's collectives against the JAX package's.

Pure half, tolerance 0 throughout:

  * ring and tree schedules equal the JAX package's for every
    ``(rank, n)`` up to 8;
  * ``ChunkCodec`` codes, scales and error-feedback residuals equal the
    JAX ``ChunkCodec``'s byte for byte, on the whole-chunk (fused) path
    and the per-fragment path, over repeated calls;
  * allreduce (ring and tree), allgather, reduce-scatter and broadcast
    over in-memory links give the JAX package's results bit for bit, raw
    and int8 — raw equal to the ring-order fp32 sum, int8 within
    ``codec.error_bound`` of every hop;
  * a hop failure mid-collective raises ``CollectiveAborted`` carrying
    exactly the finished chunks.

Live half (native library, armed stall watchdog), each test with its
own registry tag, waiting on conditions:

  * a mixed ring (2 JAX members + 1 port member, then 1 + 2) gives every
    member the bytes an all-JAX ring gives, raw and int8 (two ops, so
    the int8 run carries error feedback across them);
  * a member that dies mid-collective leaves the others a typed
    ``MemberLeft`` with salvage; they re-sync and reduce on the smaller
    ring.
"""

import threading
import time

import numpy as np
import pytest
import torch

from brpc_tpu.collectives import core as jcore
from brpc_tpu.collectives import quant as jquant
from brpc_tpu.collectives import ring as jring
from brpc_tpu_torch.collectives import core as tcore
from brpc_tpu_torch.collectives import quant as tquant
from brpc_tpu_torch.collectives import ring as tring
from brpc_tpu_torch.runtime import codec as tcodec

SEED = 20251017


def _data(n, size, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(size) * scale).astype(np.float32)
            for _ in range(n)]


# ---------------------------------------------------------------------------
# Schedules.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_schedules_match_jax(n):
    for rank in range(n):
        assert tring.reduce_scatter_steps(rank, n) == \
            jring.reduce_scatter_steps(rank, n)
        assert tring.allgather_steps(rank, n) == \
            jring.allgather_steps(rank, n)
        assert tring.owned_chunk(rank, n) == jring.owned_chunk(rank, n)
        assert tring.reduce_order(rank, n) == jring.reduce_order(rank, n)
    assert tring.tree_root(n) == jring.tree_root(n)
    assert tring.tree_gather_srcs(n) == jring.tree_gather_srcs(n)
    for size in (0, 1, n, 7 * n + 3, 10007):
        assert tring.chunk_spans(size, n) == jring.chunk_spans(size, n)
        assert tring.fragment_spans(size, n) == jring.fragment_spans(size, n)
    addrs = [f"127.0.0.1:{9000 - 7 * i}" for i in range(n)]
    assert tring.ring_order(addrs + addrs[:1]) == jring.ring_order(addrs)


# ---------------------------------------------------------------------------
# ChunkCodec: the same bytes as the JAX package's.
# ---------------------------------------------------------------------------

def _frags_equal(a, b):
    assert len(a) == len(b)
    for (ma, wa), (mb, wb) in zip(a, b):
        assert ma == mb
        assert np.asarray(wa).tobytes() == np.asarray(wb).tobytes()


@pytest.mark.parametrize("ef", [True, False])
@pytest.mark.parametrize("frag", [1 << 14, 1000], ids=["fused", "per_frag"])
@pytest.mark.parametrize("size", [1500, 40000, 70001])
def test_chunk_codec_bytes_match_jax(size, frag, ef):
    xs = _data(4, size, SEED + size, scale=3.0)
    xs[1][:700] = 0.0  # an all-zero block keeps scale 0
    tc, jc = tquant.ChunkCodec(ef=ef), jquant.ChunkCodec(ef=ef)
    for x in xs:
        _frags_equal(tc.encode_chunk("k", x, "int8", frag),
                     jc.encode_chunk("k", x, "int8", frag))
        _frags_equal([tc.encode("one", x, "int8")],
                     [jc.encode("one", x, "int8")])
        keys = ["k", "one"] + [f"k#f{i}" for i in range(-(-size // frag))]
        for k in keys:
            rt, rj = tc.residual(k), jc.residual(k)
            assert (rt is None) == (rj is None), k
            if rt is not None:
                assert rt.tobytes() == rj.tobytes(), k
    # Raw hops and fp8 ride the same bytes too.
    _frags_equal(tc.encode_chunk("r", xs[0], None, frag),
                 jc.encode_chunk("r", xs[0], None, frag))
    _frags_equal([tc.encode("f", xs[2], "fp8e4m3")],
                 [jc.encode("f", xs[2], "fp8e4m3")])


def test_fused_codes_equal_codec_encode():
    """On normal inputs the fused encoder's codes are ``codec.encode``'s;
    its scales are within one ulp of ``absmax / 127``, so its residuals
    are within 127 such ulps, plus the rounding of codec.encode's
    dequantized product, of ``x - dequantized``."""
    (x,) = _data(1, 12345, SEED, scale=7.0)
    q, scales, res = tquant.fused_int8(x, tcodec.DEFAULT_BLOCK)
    enc = tcodec.encode(x, "int8")
    ref_scales = enc.wire[:scales.nbytes].view(np.float32)
    assert np.array_equal(enc.wire[scales.nbytes:].view(np.int8), q)
    assert np.all(np.abs(scales - ref_scales)
                  <= np.spacing(ref_scales))
    np.testing.assert_allclose(res, x - enc.dequantized(), rtol=0,
                               atol=128 * float(np.spacing(ref_scales).max())
                               + float(np.spacing(np.abs(x).max())))


# ---------------------------------------------------------------------------
# The algorithms over in-memory links.
# ---------------------------------------------------------------------------

class _QueueLink:
    """The pure transport: one Mailbox per member, direct deposit."""

    def __init__(self, boxes, rank, timeout_s=10.0, fail_at=None):
        self.boxes = boxes
        self.rank = rank
        self.deadline = time.monotonic() + timeout_s
        self.fail_at = fail_at  # (phase, step): die before sending

    def send(self, dst, ph, step, idx, meta, blob, frag=0, nfrags=1):
        if self.fail_at is not None and (ph, step) == self.fail_at:
            raise tcore.MemberLeft("member-left", ph, step)
        detached = np.array(np.asarray(blob).reshape(-1).view(np.uint8))
        self.boxes[dst].deposit(("op", 0, ph, int(step), int(frag)),
                                (idx, meta, detached))

    def recv(self, ph, step, frag=0):
        return self.boxes[self.rank].take(
            ("op", 0, ph, int(step), int(frag)), self.deadline)


def _run_members(n, fn):
    out, errs = [None] * n, {}

    def worker(r):
        try:
            out[r] = fn(r)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs[r] = e

    ts = [threading.Thread(target=worker, args=(r,)) for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        raise next(iter(errs.values()))
    return out


def _pure(pkg, verb, xs, codec_name, ef=True, **kw):
    """Every member of an n-ring runs ``verb`` of package ``pkg`` on
    ``xs[rank]``; returns the per-rank results as numpy."""
    core = tcore if pkg == "torch" else jcore
    quant = tquant if pkg == "torch" else jquant
    n = len(xs)
    boxes = [core.Mailbox() for _ in range(n)]
    codecs = [quant.ChunkCodec(ef=ef) for _ in range(n)]

    def member(r):
        link = _QueueLink(boxes, r)
        fn = getattr(core, verb)
        if verb == "tree_broadcast":
            return fn(r, n, xs[r] if r == 0 else None, codecs[r], link,
                      "b", codec_name, **kw)
        return fn(r, n, xs[r], codecs[r], link, "g", codec_name, **kw)

    return _run_members(n, member)


def _ring_reference(xs, spans):
    """The ring's addition order: chunk j sums ``reduce_order(j, n)``
    left to right."""
    n = len(xs)
    ref = np.empty_like(xs[0])
    for j, (off, ln) in enumerate(spans):
        order = tring.reduce_order(j, n)
        a = xs[order[0]][off:off + ln].copy()
        for r in order[1:]:
            a = a + xs[r][off:off + ln]
        ref[off:off + ln] = a
    return ref


def _assert_same(a, b):
    if isinstance(a, tuple):
        assert a[0] == b[0]
        a, b = a[1], b[1]
    if isinstance(a, list):
        for x, y in zip(a, b):
            _assert_same(x, y)
        return
    assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


CASES = [("ring_allreduce", {"frag_elems": 3000}),
         ("tree_allreduce", {}),
         ("ring_allgather", {"frag_elems": 3000}),
         ("ring_reduce_scatter", {"frag_elems": 3000}),
         ("tree_broadcast", {"frag_elems": 3000})]


@pytest.mark.parametrize("codec_name", [None, "int8"])
@pytest.mark.parametrize("verb,kw", CASES, ids=[c[0] for c in CASES])
def test_pure_verbs_match_jax(verb, kw, codec_name):
    n, size = 3, 10007
    xs = _data(n, size, SEED + 3, scale=2.0)
    got = _pure("torch", verb, xs, codec_name, **kw)
    want = _pure("jax", verb, xs, codec_name, **kw)
    for r in range(n):
        _assert_same(got[r], want[r])
    fp32 = np.sum(np.stack(xs), axis=0, dtype=np.float32)
    if verb == "ring_allreduce" and codec_name is None:
        ref = _ring_reference(xs, tring.chunk_spans(size, n))
        for r in range(n):
            assert np.array_equal(got[r], ref)
    if verb.endswith("allreduce") and codec_name == "int8":
        # One quantization per hop, each within codec.error_bound (half
        # a scale step at its block's scale): three hops, each scale at
        # most the sum's largest magnitude / 127 (the JAX tests' bound).
        step = np.abs(fp32).max() / 127.0
        for r in range(n):
            assert np.array_equal(got[r], got[0])
            assert np.abs(got[r] - fp32).max() < step * 3


def test_host_array_and_like_input_round_trip():
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    h = tcore.host_array(t)
    assert h.dtype == np.float32 and h.shape == (3, 4)
    back = tcore.like_input(h * 2, t)
    assert isinstance(back, torch.Tensor) and back.device == t.device
    assert torch.equal(back, t * 2)
    assert isinstance(tcore.like_input(h, h), torch.Tensor)


def test_salvage_on_abort_carries_finished_chunks():
    """Member 0's link dies at allgather step 1: it holds its owned chunk
    (final after reduce-scatter) and the chunk of allgather step 0, and
    the error carries exactly those, bit-equal to the reduction."""
    n, size = 3, 9001
    xs = _data(n, size, SEED + 9)
    boxes = [tcore.Mailbox() for _ in range(n)]
    spans = tring.chunk_spans(size, n)
    ref = _ring_reference(xs, spans)
    errs = {}

    def member(r):
        link = _QueueLink(boxes, r, timeout_s=2.0,
                          fail_at=("ag", 1) if r == 0 else None)
        try:
            return tcore.ring_allreduce(r, n, xs[r], tquant.ChunkCodec(),
                                        link, "s")
        except tcore.CollectiveAborted as e:
            errs[r] = e
            return None

    _run_members(n, member)
    e = errs[0]
    assert isinstance(e, tcore.MemberLeft)
    assert set(e.done) == {tring.owned_chunk(0, n),
                           tring.allgather_steps(0, n)[0][1]}
    for idx, ((off, ln), vals) in e.done.items():
        assert (off, ln) == spans[idx]
        assert np.array_equal(vals, ref[off:off + ln])


def test_mailbox_abort_timeout_and_gc():
    box = tcore.Mailbox()
    with pytest.raises(tcore.CollectiveTimeout):
        box.take(("o", 0, "rs", 0, 0), time.monotonic() + 0.05)
    ev = threading.Event()
    ev.set()
    with pytest.raises(tcore.MemberLeft):
        box.take(("o", 0, "rs", 0, 0), time.monotonic() + 5, ev)
    box.deposit(("o", 1, "rs", 0, 0), (0, {}, b""))
    assert box.drop_op(("o", 1)) == 1
    box.deposit(("o", 1, "rs", 1, 0), (0, {}, b""))  # late: discarded
    with pytest.raises(tcore.CollectiveTimeout):
        box.take(("o", 1, "rs", 1, 0), time.monotonic() + 0.05)


def test_concurrent_members_and_shared_codec_under_a_short_switch():
    """More members than cores, a short switch interval: a 10-ring's raw
    allreduce still equals the ring-order sum on every member, and one
    ChunkCodec encoding 10 keys from 10 threads at once leaves each key
    the residual a lone encoder would."""
    import sys

    n, size = 10, 4099
    xs = _data(n, size, SEED + 41)
    ref = _ring_reference(xs, tring.chunk_spans(size, n))
    shared = tquant.ChunkCodec()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = _pure("torch", "ring_allreduce", xs, None, frag_elems=500)
        frags = _run_members(n, lambda r: [
            shared.encode_chunk(f"k{r}", xs[r] * np.float32(i + 1),
                                "int8", 1024) for i in range(3)])
    finally:
        sys.setswitchinterval(switch)
    for r in range(n):
        assert np.array_equal(got[r], ref)
        alone = tquant.ChunkCodec()
        want = [alone.encode_chunk(f"k{r}", xs[r] * np.float32(i + 1),
                                   "int8", 1024) for i in range(3)]
        for a, b in zip(frags[r], want):
            _frags_equal(a, b)
        assert shared.residual(f"k{r}").tobytes() == \
            alone.residual(f"k{r}").tobytes()


# ---------------------------------------------------------------------------
# Live: mixed rings over the real wire.
# ---------------------------------------------------------------------------

def _wait(cond, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout_s} s: {what}")
        time.sleep(0.02)


@pytest.fixture(scope="module")
def coll_env(tmp_path_factory):
    from conftest import require_native_lib
    require_native_lib()
    from brpc_tpu_torch.fleet import RegistryHub, clear_registry
    from brpc_tpu_torch.observability import health
    health.start_watchdog(str(tmp_path_factory.mktemp("torch_coll_dumps")))
    hub = RegistryHub()
    hub.start()
    try:
        yield {"hub": hub}
    finally:
        clear_registry()
        hub.stop()
    _wait(lambda: health.state() != "stalled", 10,
          f"scheduler stalled after collective tests; dump: "
          f"{health.last_dump_path()}")


def _groups(env, tag, impls, **kw):
    """One synced group per entry of ``impls`` ("jax"/"torch"), sorted
    by rank."""
    from brpc_tpu.collectives.group import CollectiveGroup as JGroup
    from brpc_tpu_torch.collectives.group import CollectiveGroup as TGroup

    kw = dict({"arena_bytes": 16 << 20, "client_arena_bytes": 8 << 20},
              **kw)
    groups = [(JGroup if i == "jax" else TGroup)(
        env["hub"].hostport, tag=tag, **kw) for i in impls]
    try:
        _run_members(len(groups), lambda r: groups[r].sync(
            expect=len(groups), timeout_s=20))
    except Exception:
        _close(groups)
        raise
    return sorted(groups, key=lambda g: g.rank)


def _on_groups(groups, fn):
    return _run_members(len(groups), lambda r: fn(groups[r]))


def _close(groups):
    """Close concurrently: each close waits out its registry watcher's
    long poll."""
    _on_groups(groups, lambda g: g.close())


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _ring_ops(env, tag, impls, codec, xs):
    """Two ring allreduces and an allgather on every member -> per-rank
    results as numpy."""
    groups = _groups(env, tag, impls, codec=codec)
    try:
        def member(g):
            a = g.allreduce("g", xs[g.rank], algo="ring")
            b = g.allreduce("g", xs[g.rank] * np.float32(0.5), algo="ring")
            c = g.allgather("ag", xs[g.rank][:20000])
            return [_np(a), _np(b)] + [_np(p) for p in c]
        return _on_groups(groups, member), [type(g).__module__
                                            for g in groups]
    finally:
        _close(groups)


@pytest.mark.parametrize("codec", [None, "int8"], ids=["raw", "int8"])
def test_mixed_ring_gives_all_jax_bytes(coll_env, codec):
    n, size = 3, 150000
    xs = _data(n, size, SEED + 21, scale=1.5)
    tag = f"tmix_{codec}"
    want, _ = _ring_ops(coll_env, tag + "_j", ["jax"] * 3, codec, xs)
    for impls in (["jax", "jax", "torch"], ["jax", "torch", "torch"]):
        got, mods = _ring_ops(coll_env, f"{tag}_{impls.count('torch')}",
                              impls, codec, xs)
        assert sum("brpc_tpu_torch" in m for m in mods) == \
            impls.count("torch")
        for r in range(n):
            for a, b in zip(got[r], want[r]):
                assert a.tobytes() == b.tobytes(), (impls, r)
    if codec is None:
        ref = _ring_reference(xs, tring.chunk_spans(size, n))
        assert np.array_equal(want[0][0], ref)


def test_member_death_gives_member_left_with_salvage(coll_env):
    size = 120000
    xs = _data(3, size, SEED + 31)
    groups = _groups(coll_env, "tdeath", ["torch"] * 3, op_timeout_s=8.0)
    survivors = groups[:2]
    try:
        left = threading.Event()

        def member(g):
            if g.rank == 2:
                g.close()
                left.set()
                return None
            left.wait(10)
            try:
                g.allreduce("d", xs[g.rank], timeout_s=8.0)
            except tcore.CollectiveAborted as e:
                return e
            return None

        out = _on_groups(groups, member)
        for e in out[:2]:
            assert isinstance(e, tcore.MemberLeft), type(e)
            assert isinstance(e.done, dict)
        _on_groups(survivors, lambda g: g.sync(expect=2, timeout_s=20))
        got = _on_groups(survivors,
                         lambda g: _np(g.allreduce("after", xs[g.rank])))
        ref = _ring_reference(xs[:2], tring.chunk_spans(size, 2))
        for r in range(2):
            assert np.array_equal(got[r], ref)
    finally:
        _close(survivors)
