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
