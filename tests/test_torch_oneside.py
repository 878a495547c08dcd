"""The port's one-sided tensor reads against the JAX package's.

Pure half: the publication framing, ``pad_header64`` and the miss/gone
contract equal the JAX package's.

Live half (native library, under an armed stall watchdog):
  * a JAX ``OnesideWindow`` read by the port's ``OnesideReader``, and the
    reverse, byte for byte (both map the same shm segment);
  * in every client/server pairing with a port side, a one-sided pull
    equals the RPC pull: raw bit for bit, and an int8 publication equal
    to PullQ's decode of the same committed version;
  * the JAX package's one-sided tests, on the port: the torn-read hammer,
    epoch reclamation, fallback parity (unmapped, unpublished), a disabled
    server negotiating off, flight events and the stats document;
  * the doorbell-free input polling flag over the port's echo service, and
    serving KV published in place: a session's planes (and a paged
    manager's per-block slots) read one-sidedly mid-decode equal the live
    rows at version == rows filled, and release unpublishes them.

Hammer tests run until they have counted enough reads and publishes,
under an explicit deadline, not for a fixed time.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from brpc_tpu.runtime import codec as jcodec
from brpc_tpu.runtime import param_server as jps
from brpc_tpu.runtime import tensor as jtensor
from brpc_tpu_torch.runtime import codec as tcodec
from brpc_tpu_torch.runtime import param_server as tps
from brpc_tpu_torch.runtime import tensor as ttensor
from brpc_tpu_torch.runtime.state import state_from_numpy


def _wait(cond, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout_s} s: {what}")
        time.sleep(0.01)


def _decoded(mod, payload) -> np.ndarray:
    """A payload decoded to a host array by either package."""
    if mod is ttensor:
        return mod.consume_oneside_payload(payload, "cpu").numpy()
    return mod.consume_oneside_payload(payload, to_host=True)


# ---------------------------------------------------------------------------
# Pure.
# ---------------------------------------------------------------------------

def test_payload_framing_matches_jax_and_rpc_wire():
    arr = np.arange(48, dtype=np.float32).reshape(6, 8)
    payload = tcodec.pack_header(
        {"dtype": arr.dtype.str, "shape": list(arr.shape)}) + arr.tobytes()
    assert payload == jcodec.pack_header(
        {"dtype": arr.dtype.str, "shape": list(arr.shape)}) + arr.tobytes()
    t = ttensor.consume_oneside_payload(payload, "cpu")
    assert t.dtype == torch.float32 and torch.equal(t, torch.from_numpy(arr))
    host = t.numpy()
    assert host.flags.writeable  # a buffer of its own, not the bytes
    np.testing.assert_array_equal(
        host, jtensor.consume_oneside_payload(payload, to_host=True))
    # The int8 wire form decodes through the plain dequantize version on
    # a CPU tensor, and equals the JAX package's host decode.
    x = np.linspace(-3, 3, 4096, dtype=np.float32)
    enc = tcodec.encode(x, "int8")
    q = enc.header + enc.wire.tobytes()
    np.testing.assert_array_equal(
        ttensor.consume_oneside_payload(q, "cpu").numpy(),
        jtensor.consume_oneside_payload(q, to_host=True))


def test_pad_header64_matches_jax():
    for meta in ({"dtype": "<f4", "shape": [3]},
                 {"dtype": "<f4", "shape": list(range(1, 24))},
                 {"dtype": "<f4", "shape": [64, 64], "codec": "int8",
                  "block": 256}):
        h = tcodec.pack_header(meta)
        padded = ttensor.pad_header64(h)
        assert padded == jtensor.pad_header64(h)
        assert len(padded) % 64 == 0
        m2, rest = ttensor._decode_meta_ex(padded + b"\x01\x02")
        assert m2 == meta and rest == b"\x01\x02"


def test_oneside_miss_contract():
    m = ttensor.OnesideMiss("w", 2)
    g = ttensor.OnesideGone("w", 3)
    assert isinstance(g, ttensor.OnesideMiss)
    assert (m.status, g.status) == (2, 3)


# ---------------------------------------------------------------------------
# Live.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def oneside_env(tmp_path_factory):
    from conftest import require_native_lib
    require_native_lib()
    from brpc_tpu_torch.observability import health, metrics
    health.start_watchdog(str(tmp_path_factory.mktemp("torch_oneside")))
    yield {"health": health, "metrics": metrics}
    _wait(lambda: health.state() != "stalled", 10,
          f"scheduler stalled after oneside tests; dump: "
          f"{health.last_dump_path()}")


def _stage_payload(mod, arena, arr: np.ndarray):
    """Write [header|bytes] into a fresh arena range -> (off, total)."""
    header = mod.pad_header64(tcodec.pack_header(
        {"dtype": arr.dtype.str, "shape": list(arr.shape)}))
    raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    total = len(header) + raw.nbytes
    off = arena.alloc(total)
    view = arena.view(off, total)
    view[:len(header)] = np.frombuffer(header, np.uint8)
    view[len(header):] = raw
    return off, total


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_window_read_across_packages(oneside_env, writer, reader):
    """One package publishes, the other maps and reads: the same bytes,
    versions, misses and GONE after the window closes."""
    w = jtensor if writer == "jax" else ttensor
    r = jtensor if reader == "jax" else ttensor
    arena = w.TensorArena(8 << 20)
    win = w.OnesideWindow(arena, n_slots=8, n_readers=4)
    arr = np.arange(3000, dtype=np.float32)
    off, total = _stage_payload(w, arena, arr)
    win.publish("t0", off, total, version=7)
    expect = bytes(arena.view(off, total))
    rd = r.OnesideReader.map(win.describe())
    assert rd is not None
    v, owned = rd.read_np("t0")
    assert v == 7 and owned.tobytes() == expect
    assert owned.ctypes.data % 64 == 0
    np.testing.assert_array_equal(_decoded(r, owned), arr)
    assert rd.read("t0") == (7, expect)
    with pytest.raises(r.OnesideMiss):
        rd.read("nope")
    bad = dict(win.describe())
    bad["token"] ^= 1
    assert r.OnesideReader.map(bad) is None  # token mismatch fails closed
    assert win.unpublish("t0")
    with pytest.raises(r.OnesideMiss):
        rd.read_np("t0")
    win.close()
    with pytest.raises(r.OnesideGone):
        rd.read_np("t0")
    rd.close()
    arena.close()


PARAMS = {
    "w": np.arange(4096, dtype=np.float32).reshape(64, 64) / 100.0,
    "b": np.ones((129,), dtype=np.float32),
    "tiny": np.arange(4, dtype=np.float32),
    "q": np.linspace(-3, 3, 64 * 64, dtype=np.float32).reshape(64, 64),
}
PAIRINGS = [("torch", "torch"), ("torch", "jax"), ("jax", "torch")]


def _server(impl, **kw):
    if impl == "jax":
        srv = jps.ParameterServer({k: jnp.asarray(v)
                                   for k, v in PARAMS.items()}, **kw)
    else:
        srv = tps.ParameterServer(state_from_numpy(PARAMS, device="cpu"),
                                  **kw)
    return srv, f"tpu://127.0.0.1:{srv.start()}"


def _client(impl, addr, **kw):
    if impl == "jax":
        return jps.ParameterClient(addr, **kw)
    return tps.ParameterClient(addr, device="cpu", **kw)


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _grad(impl, a):
    return jnp.asarray(a) if impl == "jax" else torch.from_numpy(a.copy())


def _counters(metrics):
    return (metrics.counter("torch_oneside_pull_hits"),
            metrics.counter("torch_oneside_pull_fallbacks"))


@pytest.mark.parametrize("server_impl,client_impl", PAIRINGS)
def test_raw_oneside_pull_equals_rpc_pull(oneside_env, server_impl,
                                          client_impl):
    srv, addr = _server(server_impl, oneside=True)
    one = _client(client_impl, addr, oneside=True)
    rpc = _client(client_impl, addr)
    try:
        for name in PARAMS:
            v1, a1 = one.pull(name)
            v2, a2 = rpc.pull(name)
            assert v1 == v2 == 0
            np.testing.assert_array_equal(_host(a1), _host(a2))
            np.testing.assert_array_equal(_host(a1), PARAMS[name])
        # A push republishes: the window serves the new committed bytes.
        g = np.full((64, 64), 0.25, np.float32)
        newv = rpc.push_grad("w", _grad(client_impl, g))
        v1, a1 = one.pull("w")
        v2, a2 = rpc.pull("w")
        assert v1 == v2 == newv == 1
        np.testing.assert_array_equal(_host(a1), _host(a2))
        got, want = one.pull_all(), rpc.pull_all()
        assert sorted(got) == sorted(want) == sorted(PARAMS)
        for name in got:
            assert got[name][0] == want[name][0]
            np.testing.assert_array_equal(_host(got[name][1]),
                                          _host(want[name][1]))
        assert one._oneside_reader not in (None, False)  # really mapped
    finally:
        one.close()
        rpc.close()
        srv.stop()


@pytest.mark.parametrize("server_impl,client_impl", PAIRINGS)
def test_int8_publication_equals_pullq(oneside_env, server_impl,
                                       client_impl):
    """An int8 publication decodes to exactly what PullQ's int8 pull of
    the same version decodes to (the fallback-parity contract); small
    tensors stay raw in both."""
    srv, addr = _server(server_impl, oneside=True, oneside_codec="int8")
    one = _client(client_impl, addr, oneside=True, codec="int8")
    rpcq = _client(client_impl, addr, codec="int8")
    hits, _ = _counters(oneside_env["metrics"])
    h0 = hits.value()
    try:
        got, want = one.pull_all(), rpcq.pull_all()
        assert sorted(got) == sorted(want) == sorted(PARAMS)
        for name in PARAMS:
            assert got[name][0] == want[name][0] == 0
            np.testing.assert_array_equal(_host(got[name][1]),
                                          _host(want[name][1]))
        q = _host(got["q"][1])
        assert not np.array_equal(q, PARAMS["q"])  # the codec engaged
        assert np.max(np.abs(q - PARAMS["q"])) <= 3.0 / 127
        np.testing.assert_array_equal(_host(got["tiny"][1]), PARAMS["tiny"])
        if client_impl == "torch":
            assert hits.value() == h0 + len(PARAMS)
    finally:
        one.close()
        rpcq.close()
        srv.stop()


@pytest.mark.parametrize("server_impl", ["torch", "jax"])
def test_oneside_per_call_overrides_the_client_flag(oneside_env,
                                                    server_impl):
    """``pull(oneside=)`` and ``pull_all(oneside=)`` choose per call, as the
    JAX client's do: a client made without the flag reads the window when
    asked, and one made with it rides the RPC path when told not to."""
    srv, addr = _server(server_impl, oneside=True)
    plain = _client("torch", addr)
    flagged = _client("torch", addr, oneside=True)
    hits, _ = _counters(oneside_env["metrics"])
    try:
        h0 = hits.value()
        v, a = plain.pull("w")
        assert hits.value() == h0 and plain._oneside_reader is None
        v1, a1 = plain.pull("w", oneside=True)
        assert hits.value() == h0 + 1
        assert v == v1 == 0
        np.testing.assert_array_equal(a1.numpy(), a.numpy())
        got = plain.pull_all(oneside=True)
        assert hits.value() == h0 + 1 + len(PARAMS)
        for name, (ver, t) in got.items():
            assert ver == 0
            np.testing.assert_array_equal(t.numpy(), PARAMS[name])
        h1 = hits.value()
        flagged.pull("b", oneside=False)
        flagged.pull_all(oneside=False)
        assert hits.value() == h1
        flagged.pull("b")
        assert hits.value() == h1 + 1
    finally:
        plain.close()
        flagged.close()
        srv.stop()


def test_fleet_client_oneside_reads_every_shards_window(oneside_env):
    """FleetClient(oneside=True) over two port shards, one publishing raw
    and one int8: every name is read from its shard's window (one hit
    each) and equals the RPC fleet pull of the same form, bit for bit."""
    from brpc_tpu_torch.fleet import (FleetClient, FleetServer, RegistryHub,
                                      clear_registry)

    hub = RegistryHub()
    hub.start()
    tag = "torch_oneside_fleet"
    shards, clients = [], []
    try:
        for i, pub in enumerate((None, "int8")):
            s = FleetServer(hub.hostport, tag=tag, shard_name=f"tof{i}",
                            device="cpu", oneside=True, oneside_codec=pub)
            s.start()
            shards.append(s)
        # Pinned placement: an eligible tensor on each shard.
        pins = {"w": shards[0].addr, "tiny": shards[0].addr,
                "q": shards[1].addr, "b": shards[1].addr}
        fq = FleetClient(hub.hostport, tag=tag, codec="int8", device="cpu",
                         overrides=pins)
        fr = FleetClient(hub.hostport, tag=tag, device="cpu",
                         overrides=pins)
        fo = FleetClient(hub.hostport, tag=tag, device="cpu", oneside=True,
                         tenant="reader", overrides=pins)
        clients += [fq, fr, fo]
        names = sorted(PARAMS)
        for n in names:
            fq.install(n, PARAMS[n])
        int8_shard = set(shards[1].ps.state().params)
        assert int8_shard == {"q", "b"}
        raw, q = fr.pull_all(names), fq.pull_all(names)
        hits, _ = _counters(oneside_env["metrics"])
        h0 = hits.value()
        got = fo.pull_all(names)
        assert hits.value() - h0 == len(names)
        for n in names:
            want = q[n] if n in int8_shard else raw[n]
            assert got[n][0] == want[0] == 0
            np.testing.assert_array_equal(got[n][1].numpy(),
                                          want[1].numpy())
            np.testing.assert_array_equal(raw[n][1].numpy(), PARAMS[n])
        assert not np.array_equal(got["q"][1].numpy(), PARAMS["q"])  # int8
    finally:
        for c in clients:
            c.close()
        for s in shards:
            s.stop()
        clear_registry()
        hub.stop()


def test_torn_read_retry_under_republish_hammer(oneside_env):
    """Concurrent republishing: every successful read is uniformly
    stamped with its own version and versions never go backwards."""
    arena = ttensor.TensorArena(32 << 20)
    win = ttensor.OnesideWindow(arena, n_slots=4, n_readers=4)
    n = 64 << 10

    def publish(version):
        arr = np.full(n, np.uint8(version % 251), np.uint8)
        off, total = _stage_payload(ttensor, arena, arr)
        win.publish("h", off, total, version)

    publish(0)
    stop = threading.Event()
    published = [0]

    def hammer():
        v = 0
        while not stop.is_set():
            v += 1
            publish(v)
            published[0] = v

    t = threading.Thread(target=hammer, daemon=True)
    t.start()
    rd = ttensor.OnesideReader.map(win.describe())
    ok = [0]
    last_v = -1
    try:
        deadline = time.monotonic() + 60
        while not (ok[0] >= 50 and published[0] >= 50):
            assert time.monotonic() < deadline, (ok, published)
            try:
                v, payload = rd.read_np("h")
            except ttensor.OnesideMiss:
                continue
            arr = ttensor.consume_oneside_payload(payload, "cpu").numpy()
            u = np.unique(arr)
            assert arr.shape == (n,) and u.size == 1, f"torn at v={v}"
            assert int(u[0]) == v % 251, f"version/body mismatch v={v}"
            assert v >= last_v, f"version went backwards {last_v} -> {v}"
            last_v = v
            ok[0] += 1
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    assert ttensor.oneside_stats()["reclaims"] > 0
    rd.close()
    win.close()
    arena.close()


def test_epoch_reclamation_never_frees_midread_and_drains(oneside_env):
    """4 MB payloads under republish: a range a reader is copying is never
    reclaimed (the bytes stay uniform), and once the reader quiesces the
    retired backlog drains."""
    arena = ttensor.TensorArena(128 << 20)
    win = ttensor.OnesideWindow(arena, n_slots=2, n_readers=2)
    n = 4 << 20

    def publish(version):
        arr = np.full(n, np.uint8(version % 251), np.uint8)
        off, total = _stage_payload(ttensor, arena, arr)
        win.publish("big", off, total, version)

    publish(0)
    stop = threading.Event()
    published = [0]

    def hammer():
        v = 0
        while not stop.is_set():
            v += 1
            publish(v)
            published[0] = v

    t = threading.Thread(target=hammer, daemon=True)
    t.start()
    rd = ttensor.OnesideReader.map(win.describe())
    ok = 0
    try:
        deadline = time.monotonic() + 60
        while not (ok >= 4 and published[0] >= 4):
            assert time.monotonic() < deadline, (ok, published)
            try:
                v, payload = rd.read_np("big")
            except ttensor.OnesideMiss:
                continue
            u = np.unique(payload[payload.size - n:])
            assert u.size == 1, f"mid-read reclaim: mixed bytes at v={v}"
            assert int(u[0]) == v % 251
            ok += 1
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    rd.close()
    publish(10_000_000)  # one more publish runs a reclaim pass
    wins = {w["dir_off"]: w for w in ttensor.oneside_stats()["windows"]}
    assert wins[win.describe()["dir_off"]]["retired_ranges"] <= 2
    win.close()
    arena.close()


def test_fallback_parity_unmapped_and_unpublished(oneside_env, monkeypatch):
    """Every fallback lands on the RPC path with the same result: a
    window that does not map (the off-host shape) and an unpublished name
    on a mapped window; each counts as a fallback."""
    srv, addr = _server("torch", oneside=True)
    rpc = _client("torch", addr)
    _, fallbacks = _counters(oneside_env["metrics"])
    try:
        ref = {n: rpc.pull(n) for n in ("w", "b")}
        monkeypatch.setattr(ttensor.OnesideReader, "map",
                            classmethod(lambda cls, desc: None))
        f0 = fallbacks.value()
        off = _client("torch", addr, oneside=True)
        try:
            for n, (rv, ra) in ref.items():
                v, a = off.pull(n)
                assert v == rv and torch.equal(a, ra)
            out = off.pull_all(["w", "b"])
            for n in ref:
                assert torch.equal(out[n][1], ref[n][1])
            assert off._oneside_reader is False
            assert fallbacks.value() == f0 + 4
        finally:
            off.close()
        monkeypatch.undo()
        assert srv._oneside_window.unpublish("b")
        one = _client("torch", addr, oneside=True)
        try:
            f1 = fallbacks.value()
            assert torch.equal(one.pull("b")[1], ref["b"][1])
            assert fallbacks.value() == f1 + 1
            assert torch.equal(one.pull("w")[1], ref["w"][1])
            assert fallbacks.value() == f1 + 1
        finally:
            one.close()
    finally:
        rpc.close()
        srv.stop()


@pytest.mark.parametrize("server_impl", ["jax", "torch"])
def test_oneside_disabled_server_negotiates_off(oneside_env, server_impl):
    """Against a server that does not advertise one-sided reads the port's
    client asks nothing extra and serves every pull by RPC."""
    srv, addr = _server(server_impl)
    c = _client("torch", addr, oneside=True)
    try:
        v, a = c.pull("b")
        assert v == 0 and torch.equal(a, torch.ones(129))
        assert c._oneside_reader is False
    finally:
        c.close()
        srv.stop()


def test_flight_events_cover_publication_lifecycle(oneside_env):
    health = oneside_env["health"]
    arena = ttensor.TensorArena(8 << 20)
    win = ttensor.OnesideWindow(arena, n_slots=4, n_readers=2)
    arr = np.ones(4096, np.uint8)
    for v in range(3):
        off, total = _stage_payload(ttensor, arena, arr)
        win.publish("fl", off, total, v)
    rd = ttensor.OnesideReader.map(win.describe())
    rd.read("fl")
    text = health.flight_snapshot(4096)
    assert "ONESIDE_PUBLISH" in text
    assert "ONESIDE_READ_BEGIN" in text
    assert "ONESIDE_RECLAIM" in text
    types = {e["type"] for e in health.flight_events(4096)}
    assert "ONESIDE_PUBLISH" in types
    rd.close()
    win.close()
    arena.close()


def test_oneside_stats_json_document(oneside_env):
    st = ttensor.oneside_stats()
    for key in ("publishes", "reads", "read_retries", "reads_torn",
                "reclaims", "reader_evictions", "windows"):
        assert key in st
    assert isinstance(st["windows"], list)
    assert st == json.loads(json.dumps(st))


def test_input_poll_flag_roundtrip_and_echo(oneside_env):
    """The polling flag reloads at runtime and echoes over tpu:// stay
    correct while it is armed."""
    from brpc_tpu_torch.runtime import native

    L = native.lib()
    assert L.tbrpc_flag_set(b"rpc_input_poll_us", b"200") == 0
    try:
        srv = native.Server()
        srv.add_echo_service()
        port = srv.start("127.0.0.1:0")
        ch = native.Channel(f"tpu://127.0.0.1:{port}", timeout_ms=5000)
        for i in range(50):
            payload = f"poll-{i}".encode()
            assert ch.call("EchoService/Echo", payload)[0] == payload
        ch.close()
        srv.close()
    finally:
        assert L.tbrpc_flag_set(b"rpc_input_poll_us", b"0") == 0
    assert L.tbrpc_flag_set(b"rpc_input_poll_us", b"-5") != 0


def test_serving_kv_pages_publishable(oneside_env):
    """KV planes published in place (not owned) at version == rows
    filled; a one-sided read mid-decode equals the live plane; the lane
    sweep's release unpublishes before the range can be reused."""
    from brpc_tpu_torch.serving.engine import DecodeEngine
    from brpc_tpu_torch.serving.session import CallableSink, SessionManager

    mgr = SessionManager(max_len=16, dim=8, publish_kv=True)
    assert mgr.oneside is not None
    eng = DecodeEngine(mgr, max_batch=2, device="cpu")
    sess = mgr.open([1, 2, 3], 8, CallableSink(lambda f: None))
    for _ in range(4):
        eng.step()
    rd = ttensor.OnesideReader.map(mgr.oneside.describe())
    assert rd is not None
    v, payload = rd.read(f"kv:{sess.id}:k")
    assert v == sess.pos == 4
    arr = np.frombuffer(payload, np.float32).reshape(16, 8)
    np.testing.assert_array_equal(arr, np.asarray(sess.kv_k))
    assert arr[:sess.pos].any() and not arr[sess.pos:].any()
    for _ in range(40):
        eng.step()
    with pytest.raises(ttensor.OnesideMiss):
        rd.read(f"kv:{sess.id}:k")
    rd.close()
    mgr.shutdown()


def test_serving_kv_blocks_publishable_per_block(oneside_env):
    """The paged form: every table slot ``kv:<sid>:k:<j>`` reads the
    block's rows at version == rows filled in that block."""
    from brpc_tpu_torch.serving.engine import DecodeEngine
    from brpc_tpu_torch.serving.session import CallableSink, SessionManager

    r, dim = 4, 8
    mgr = SessionManager(max_len=16, dim=dim, publish_kv=True, paged=True,
                         block_rows=r)
    eng = DecodeEngine(mgr, max_batch=2, device="cpu")
    sess = mgr.open([1, 2, 3, 4, 5, 6], 8, CallableSink(lambda f: None))
    for _ in range(7):
        eng.step()
    rd = ttensor.OnesideReader.map(mgr.oneside.describe())
    with mgr._mu:
        k_rows, _v = mgr._gather_rows_locked(sess)
    for j, _bid in enumerate(sess.block_table):
        v, payload = rd.read(f"kv:{sess.id}:k:{j}")
        assert v == min(r, max(0, sess.pos - j * r))
        blk = np.frombuffer(payload, np.float32).reshape(r, dim)
        np.testing.assert_array_equal(blk[:v], k_rows[j * r:j * r + v])
    rd.close()
    mgr.shutdown()


# ---------------------------------------------------------------------------
# The page-locked landing buffer (OnesideReader.read_to_device), with the
# pinned allocation swapped for plain memory: the CPU has no pinned
# allocator, and what is tested here is the reuse, not the pinning.
# ---------------------------------------------------------------------------

# Payload sizes growing past the first 2-MiB buffer (raw and int8 both),
# then shrinking again.
LANDING_SHAPES = [(16,), (64, 64), (300, 257), (1200, 2600), (300, 257),
                  (64, 64), (16,)]


def _landing_server(codec=None):
    rng = np.random.default_rng(22)
    params = {f"s{i}": rng.standard_normal(shape).astype(np.float32)
              for i, shape in enumerate(LANDING_SHAPES[:4])}
    srv = tps.ParameterServer(state_from_numpy(params, device="cpu"),
                              oneside=True, oneside_codec=codec)
    return srv, f"tpu://127.0.0.1:{srv.start()}", params


def _plain_pins(monkeypatch):
    """Swap the pinned allocation for plain memory -> the sizes asked."""
    asked = []

    def plain(nbytes):
        asked.append(nbytes)
        return torch.empty(nbytes, dtype=torch.uint8)

    monkeypatch.setattr(ttensor, "_pinned_empty", plain)
    return asked


def _landing_order():
    """The names of LANDING_SHAPES in read order (growing, shrinking)."""
    index = {s: i for i, s in enumerate(LANDING_SHAPES[:4])}
    return [f"s{index[s]}" for s in LANDING_SHAPES]


@pytest.mark.parametrize("codec", [None, "int8"])
def test_landing_buffer_reads_equal_read_np(oneside_env, monkeypatch,
                                            codec):
    """One reader, payloads growing then shrinking: every read through the
    landing buffer equals read_np's decode of the same version, bit for
    bit, raw and int8; the buffer grows only past its size (to the payload
    plus 64 bytes, in 2-MiB steps), is reused from then on, and a later
    read leaves the tensors returned before it intact."""
    asked = _plain_pins(monkeypatch)
    srv, _addr, _params = _landing_server(codec)
    rd = ttensor.OnesideReader.map(srv._oneside_window.describe())
    pinned = oneside_env["metrics"].counter("torch_oneside_pinned_reads")
    try:
        p0 = pinned.value()
        got, ptrs = [], []
        for name in _landing_order():
            v, t = rd.read_to_device(name, "cpu")
            assert v == 0
            got.append((name, t))
            ptrs.append(rd._landing.data_ptr())
        assert pinned.value() == p0 + len(LANDING_SHAPES)
        need = {n: rd.read_np(n)[1].nbytes for n, _ in got}
        largest = max(need.values())
        step = 2 << 20
        assert asked == [step, -(-(largest + 64) // step) * step]
        assert need[got[0][0]] + 64 <= step < largest + 64
        assert len(set(ptrs[3:])) == 1  # grown once, at the largest
        assert rd._landing.numel() == asked[-1]
        for name, t in got:
            _, owned = rd.read_np(name)
            want = ttensor.consume_oneside_payload(owned, "cpu")
            assert t.dtype == want.dtype and t.shape == want.shape
            assert torch.equal(t, want)
        if codec == "int8":
            assert not torch.equal(got[3][1], torch.from_numpy(
                _params[got[3][0]]))  # the codec engaged
    finally:
        rd.close()
        srv.stop()
    assert rd._landing is None  # released with the reader


def test_landing_pin_failure_takes_read_np(oneside_env, monkeypatch):
    """A pinned allocation that raises is tried once: that read and every
    later one take read_np, count in torch_oneside_pinned_fallbacks (not
    in _pinned_reads) and equal the RPC pull."""
    calls = []

    def refuse(nbytes):
        calls.append(nbytes)
        raise RuntimeError("no pinned memory here")

    monkeypatch.setattr(ttensor, "_pinned_empty", refuse)
    srv, addr, _params = _landing_server()
    rpc = _client("torch", addr)
    rd = ttensor.OnesideReader.map(srv._oneside_window.describe())
    m = oneside_env["metrics"]
    pinned = m.counter("torch_oneside_pinned_reads")
    fallbacks = m.counter("torch_oneside_pinned_fallbacks")
    try:
        p0, f0 = pinned.value(), fallbacks.value()
        for name in _landing_order():
            v, t = rd.read_to_device(name, "cpu")
            rv, rt = rpc.pull(name)
            assert v == rv and torch.equal(t, rt)
        assert len(calls) == 1 and rd._landing is None
        assert fallbacks.value() == f0 + len(LANDING_SHAPES)
        assert pinned.value() == p0
        with pytest.raises(ttensor.OnesideMiss):
            rd.read_to_device("nope", "cpu")
    finally:
        rd.close()
        rpc.close()
        srv.stop()


def test_cpu_target_never_lands_in_the_pinned_buffer(oneside_env,
                                                     monkeypatch):
    """A client on the CPU reads one-sidedly through read_np: its tensors
    keep their owned buffers, and no landing buffer is ever asked for."""
    asked = _plain_pins(monkeypatch)
    srv, addr, params = _landing_server()
    one = _client("torch", addr, oneside=True)
    hits, _ = _counters(oneside_env["metrics"])
    pinned = oneside_env["metrics"].counter("torch_oneside_pinned_reads")
    try:
        h0, p0 = hits.value(), pinned.value()
        got = one.pull_all()
        v, t = one.pull("s1")
        assert hits.value() == h0 + len(params) + 1
        assert pinned.value() == p0 and asked == []
        assert one._oneside_reader._landing is None
        for name, (ver, x) in got.items():
            assert ver == 0
            np.testing.assert_array_equal(x.numpy(), params[name])
        np.testing.assert_array_equal(t.numpy(), params["s1"])
    finally:
        one.close()
        srv.stop()


def test_landing_buffer_is_held_by_one_read_at_a_time(oneside_env,
                                                      monkeypatch):
    """Twelve threads read through one reader's landing buffer at once,
    with the interpreter switching threads as often as it can: every value
    equals its publication, so no read overwrote another's bytes before
    they were copied out."""
    import sys

    _plain_pins(monkeypatch)
    srv, _addr, params = _landing_server()
    rd = ttensor.OnesideReader.map(srv._oneside_window.describe())
    names = sorted(params)
    bad, done = [], []

    def reader(k):
        for i in range(12):
            name = names[(k + i) % len(names)]
            _v, t = rd.read_to_device(name, "cpu")
            if not np.array_equal(t.numpy(), params[name]):
                bad.append(name)
        done.append(k)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=reader, args=(k,))
                   for k in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
        rd.close()
        srv.stop()
    assert sorted(done) == list(range(12)) and bad == []
