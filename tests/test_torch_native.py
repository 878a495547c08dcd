"""The port's native build rule, checked without running a build, and
the native surface the serving plane calls.

The port shares ``native/build/`` with the JAX package: it must never
reconfigure that tree with another compiler (cmake would delete the cache
and regenerate the tree under the JAX package's processes) and never
overwrite its library. Its own g++ copy goes to ``native/build_torch/``,
stamped with the hash of the native sources.
Every build scenario below swaps the build steps for recorders.

The live tests drive the port's bindings on the library it loads: a
``Stream`` opened by ``open_stream`` and taken by ``accept_stream``
inside a handler (order, credit backpressure, coded close), the
progressive HTTP writer, the /sessionz provider slot, the echo service
and a server's admission settings, ``deadline_remaining_ms``, the arena's
``busy_bytes``/``wait_reusable`` and ``TensorView.zero_copy``, and the
latency recorder's read side.
"""

import fcntl
import json
import os
import socket
import threading
import time
import types
import urllib.request

import numpy as np
import pytest

from brpc_tpu.runtime import native as jnative
from brpc_tpu_torch.runtime import native as tnative
from brpc_tpu_torch.utils.build import source_digest


def test_configure_of_an_existing_tree_is_the_jax_packages(tmp_path,
                                                           monkeypatch):
    build = tmp_path / "build"
    build.mkdir()
    (build / "CMakeCache.txt").write_text("CMAKE_CXX_COMPILER:FILEPATH=c++\n")
    seen = []
    monkeypatch.setattr(jnative, "subprocess", types.SimpleNamespace(
        run=lambda cmd, **kw: seen.append(list(cmd))))
    jnative._build_native()
    jax_configure = [str(build) if a == os.path.join(
        jnative._REPO, "native", "build") else a for a in seen[0]]
    assert tnative.configure_command(str(build)) == jax_configure
    assert not any(a.startswith("-DCMAKE_CXX_COMPILER")
                   for a in tnative.configure_command(str(build)))


@pytest.mark.parametrize("fresh", [True, False])
def test_configure_never_names_a_compiler(tmp_path, fresh):
    build = tmp_path / "build"
    if not fresh:
        build.mkdir()
        (build / "CMakeCache.txt").write_text("cache\n")
    cmd = tnative.configure_command(str(build))
    assert cmd[:5] == ["cmake", "-S", "native", "-B", str(build)]
    assert not any(a.startswith("-DCMAKE_CXX_COMPILER") for a in cmd)


class _Fake:
    """Recorders in place of cmake, g++ and readelf over a scratch tree."""

    def __init__(self, tmp_path, monkeypatch, *, jax_lib=None, cache=False,
                 torch_lib=None, cmake=True, cmake_links_dynamic=True):
        self.calls = []
        build = tmp_path / "native" / "build"
        torch_build = tmp_path / "native" / "build_torch"
        build.mkdir(parents=True)
        src = tmp_path / "native" / "tbutil" / "a.cpp"
        src.parent.mkdir()
        src.write_text("int a() { return 1; }\n")
        self.jax_lib = build / "libbrpc_tpu.so"
        self.torch_lib = torch_build / "libbrpc_tpu.so"
        self.dynamic = {}
        if jax_lib is not None:
            self.jax_lib.write_bytes(b"jax")
            self.dynamic[str(self.jax_lib)] = jax_lib == "dynamic"
        if cache:
            (build / "CMakeCache.txt").write_text("cache\n")
        for name, value in (("_REPO", tmp_path),
                            ("_BUILD_DIR", build),
                            ("_LIB_PATH", self.jax_lib),
                            ("_TORCH_BUILD_DIR", torch_build),
                            ("_TORCH_LIB_PATH", self.torch_lib),
                            ("_LOCK_PATH", tmp_path / "native" /
                             "build.lock")):
            monkeypatch.setattr(tnative, name, str(value))
        monkeypatch.setattr(tnative, "_native_sources", lambda: [str(src)])
        if torch_lib is not None:  # a g++ copy from an earlier process
            torch_build.mkdir()
            self.torch_lib.write_bytes(b"torch")
            digest = source_digest(str(tmp_path), [str(src)],
                                   tnative._CXXFLAGS)
            (torch_build / "sources.sha256").write_text(
                digest if torch_lib == "current" else "0" * 64)
        monkeypatch.setattr(tnative, "_have_cmake", lambda: cmake)
        monkeypatch.setattr(tnative, "links_shared_libstdcxx",
                            lambda p: self.dynamic[str(p)])

        def run(cmd, **kw):
            self.calls.append(("cmake", list(cmd)))
            if "--build" in cmd:
                self.jax_lib.write_bytes(b"cmake")
                self.dynamic[str(self.jax_lib)] = cmake_links_dynamic

        def gxx():
            self.calls.append(("g++", str(self.torch_lib)))
            self.torch_lib.parent.mkdir(parents=True, exist_ok=True)
            self.torch_lib.write_bytes(b"g++")

        monkeypatch.setattr(tnative, "subprocess",
                            types.SimpleNamespace(run=run))
        monkeypatch.setattr(tnative, "_build_native_gxx", gxx)


@pytest.mark.parametrize("scenario,want,builds", [
    # The JAX package's library links libstdc++ dynamically: shared.
    (dict(jax_lib="dynamic", cache=True), "jax", []),
    # It does not: the port's g++ copy, built once, the JAX one untouched.
    (dict(jax_lib="static", cache=True), "torch", ["g++"]),
    (dict(jax_lib="static", cache=True, torch_lib="current"), "torch", []),
    # No library yet: the JAX package's configure and the library target.
    (dict(), "jax", ["configure", "build"]),
    (dict(cache=True), "jax", ["configure", "build"]),
    (dict(cache=True, cmake_links_dynamic=False), "torch",
     ["configure", "build", "g++"]),
    # No cmake+ninja: the g++ copy.
    (dict(cmake=False), "torch", ["g++"]),
    # A g++ copy whose stamp no longer matches the sources is rebuilt.
    (dict(jax_lib="static", cache=True, torch_lib="stale"), "torch",
     ["g++"]),
    (dict(cmake=False, torch_lib="current"), "torch", []),
    (dict(cmake=False, torch_lib="stale"), "torch", ["g++"]),
])
def test_library_choice_and_builds(tmp_path, monkeypatch, scenario, want,
                                   builds):
    fake = _Fake(tmp_path, monkeypatch, **scenario)
    before = (fake.jax_lib.read_bytes() if fake.jax_lib.exists() else None)
    path = tnative.library_path()
    assert path == str(fake.jax_lib if want == "jax" else fake.torch_lib)
    got = []
    for kind, what in fake.calls:
        if kind == "g++":
            got.append("g++")
        elif "--build" in what:
            assert what[-2:] == ["--target", "brpc_tpu"]
            got.append("build")
        else:
            assert what == tnative.configure_command(tnative._BUILD_DIR)
            got.append("configure")
    assert got == builds
    if before is not None:  # an existing JAX library is never rewritten
        assert fake.jax_lib.read_bytes() == before
    if "g++" in builds:  # the fresh copy is stamped: the next call reuses it
        fake.calls.clear()
        assert tnative.library_path() == str(fake.torch_lib)
        assert fake.calls == []


def test_build_runs_under_an_exclusive_file_lock(tmp_path, monkeypatch):
    lock = tmp_path / "build.lock"
    monkeypatch.setattr(tnative, "_LOCK_PATH", str(lock))

    def resolve():  # another open file, as another process would hold
        with open(lock) as other:
            with pytest.raises(BlockingIOError):
                fcntl.flock(other, fcntl.LOCK_EX | fcntl.LOCK_NB)
        return "resolved"

    monkeypatch.setattr(tnative, "_resolve_library", resolve)
    assert tnative.library_path() == "resolved"
    with open(lock) as other:
        fcntl.flock(other, fcntl.LOCK_EX | fcntl.LOCK_NB)
        fcntl.flock(other, fcntl.LOCK_UN)


def test_lock_file_and_torch_tree_are_ignored_by_git():
    with open(os.path.join(tnative._REPO, ".gitignore")) as f:
        ignored = f.read().split()
    assert "native/build.lock" in ignored
    assert "native/build*/" in ignored  # covers native/build_torch/


def test_port_refuses_to_load_beside_another_copy(tmp_path):
    # Two copies of the runtime in one process name their shm segments
    # alike, so the port will not load a second one.
    mine = tmp_path / "a" / "libbrpc_tpu.so"
    other = tmp_path / "b" / "libbrpc_tpu.so"
    for p in (mine, other):
        p.parent.mkdir()
        p.write_bytes(b"")
    maps = tmp_path / "maps"
    maps.write_text(f"7f00-7f01 r-xp 0 08:01 1 {other}\n"
                    "7f02-7f03 r--p 0 08:01 2 /usr/lib/libc.so.6\n")
    with pytest.raises(RuntimeError, match="already loaded"):
        tnative.refuse_second_copy(str(mine), str(maps))
    maps.write_text(f"7f00-7f01 r-xp 0 08:01 1 {mine}\n")
    tnative.refuse_second_copy(str(mine), str(maps))
    tnative.refuse_second_copy(str(mine), str(tmp_path / "no_such_maps"))
    # This process maps the library the port loaded, and no other.
    tnative.lib()
    tnative.refuse_second_copy(tnative.library_path())


# ---------------------------------------------------------------------------
# Live: the serving plane's native surface.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def live_native():
    from conftest import require_native_lib
    require_native_lib()
    tnative.lib()


def _stream_server(on_stream, window=0):
    """A server whose Stream/Open accepts the caller's stream and hands
    it to ``on_stream`` on a thread of its own."""
    srv = tnative.Server()
    seen = {}

    def handler(method, request, attachment):
        if method == "Deadline":
            seen["deadline_ms"] = tnative.deadline_remaining_ms()
            return b"", b""
        stream = tnative.accept_stream(window)
        if stream is None:
            raise tnative.RpcError(tnative.TRPC_EREQUEST, "no stream")
        threading.Thread(target=on_stream, args=(stream, request),
                         daemon=True).start()
        return b"accepted:" + request, b""

    srv.add_service("Stream", handler)
    return srv, srv.start("127.0.0.1:0"), seen


@pytest.mark.parametrize("scheme", ["", "tpu://"])
def test_stream_round_trip_in_order(live_native, scheme):
    def serve(stream, request):
        for i in range(int(request)):
            assert stream.write(f"m{i}".encode())
        stream.close()

    srv, port, _ = _stream_server(serve)
    ch = tnative.Channel(f"{scheme}127.0.0.1:{port}", timeout_ms=5000,
                         max_retry=0)
    try:
        stream, body = tnative.open_stream(ch, "Stream/Open", b"50")
        assert body == b"accepted:50"
        got = []
        with pytest.raises(tnative.StreamClosed) as ei:
            while True:
                msg = stream.read(5000)
                assert msg is not None, "a message never came"
                got.append(msg)
        assert ei.value.error == 0, "a clean close carries no code"
        assert got == [f"m{i}".encode() for i in range(50)]
        stream.close()
        stream.close()  # idempotent
    finally:
        ch.close()
        srv.close()


def test_stream_credit_backpressure_and_coded_close(live_native):
    """A reader that does not read: probes report a full window (False),
    and a coded close reaches the reader past the full window."""
    state = {}
    done = threading.Event()

    def serve(stream, _request):
        writes = 0
        while stream.write(b"x" * 32, timeout_ms=0):
            writes += 1
            if writes > 10000:
                break
        state["writes"] = writes
        state["timed_out"] = not stream.write(b"y", timeout_ms=50)
        stream.close(tnative.TRPC_ELIMIT)
        done.set()

    srv, port, _ = _stream_server(serve)
    ch = tnative.Channel(f"127.0.0.1:{port}", timeout_ms=5000, max_retry=0)
    try:
        stream, _ = tnative.open_stream(ch, "Stream/Open", b"",
                                        max_buf_size=256)
        assert done.wait(10)
        assert 0 < state["writes"] < 10000 and state["timed_out"]
        with pytest.raises(tnative.StreamClosed) as ei:
            for _ in range(state["writes"] + 2):
                assert stream.read(5000) is not None
        assert ei.value.error == tnative.TRPC_ELIMIT
        stream.close()
    finally:
        ch.close()
        srv.close()


def test_open_stream_errors_and_accept_outside_a_handler(live_native):
    srv = tnative.Server()
    srv.add_service("Plain", lambda m, r, a: (b"ok", b""))
    port = srv.start("127.0.0.1:0")
    ch = tnative.Channel(f"127.0.0.1:{port}", timeout_ms=5000, max_retry=0)
    try:
        assert ch.call("Plain/x") == (b"ok", b"")
        with pytest.raises(tnative.RpcError) as ei:
            tnative.open_stream(ch, "NoSuch/Open", b"")
        assert ei.value.code in (tnative.TRPC_ENOSERVICE,
                                 tnative.TRPC_ENOMETHOD)
        assert tnative.accept_stream() is None
    finally:
        ch.close()
        srv.close()
    closed = tnative.Channel("127.0.0.1:1", timeout_ms=100, max_retry=0)
    closed.close()
    with pytest.raises(RuntimeError, match="closed"):
        tnative.open_stream(closed, "Stream/Open")


def test_deadline_remaining_inside_and_outside_a_handler(live_native):
    assert tnative.deadline_remaining_ms() is None
    srv, port, seen = _stream_server(lambda s, r: s.close())
    ch = tnative.Channel(f"127.0.0.1:{port}", timeout_ms=3000, max_retry=0)
    try:
        ch.call("Stream/Deadline")
        assert seen["deadline_ms"] is not None
        assert 0 < seen["deadline_ms"] <= 3000
    finally:
        ch.close()
        srv.close()


def test_echo_service_and_admission_settings(live_native):
    srv = tnative.Server()
    srv.add_echo_service()
    srv.add_service("Py", lambda m, r, a: (r, a))
    srv.set_max_concurrency(8)
    srv.set_tenant_quota(4)
    with pytest.raises(RuntimeError, match="refused"):
        srv.set_inline("Py")  # Python handlers never run inline
    port = srv.start("127.0.0.1:0")
    with pytest.raises(RuntimeError, match="before start"):
        srv.set_max_concurrency(16)
    srv.set_tenant_quota(0)  # runtime-safe
    ch = tnative.Channel(f"tpu://127.0.0.1:{port}", timeout_ms=5000)
    try:
        for i in range(20):
            payload = f"echo-{i}".encode()
            assert ch.call("EchoService/Echo", payload)[0] == payload
        assert ch.call("Py/x", b"req", b"att") == (b"req", b"att")
    finally:
        ch.close()
        srv.close()


def test_progressive_http_writer(live_native):
    """A chunked response fed line by line after the handler returned;
    writes after the close report a gone peer."""
    pids = []
    ready = threading.Event()

    def handler(path, query, pid):
        pids.append(pid)
        ready.set()
        return 200, f"head {path} {query}\n".encode(), True

    tnative.register_http_stream_handler("/torch_progressive_test", handler)
    with pytest.raises(RuntimeError, match="already registered"):
        tnative.register_http_stream_handler("/torch_progressive_test",
                                             handler)
    srv = tnative.Server()
    port = srv.start("127.0.0.1:0")
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        s.sendall(b"GET /torch_progressive_test?a=1 HTTP/1.1\r\n"
                  b"Host: x\r\n\r\n")
        assert ready.wait(10)
        for i in range(3):
            assert tnative.progressive_write(pids[0], f"line{i}\n".encode())
        tnative.progressive_close(pids[0])
        buf = b""
        while b"0\r\n\r\n" not in buf:
            chunk = s.recv(4096)
            if not chunk:
                break
            buf += chunk
        header, _, body = buf.partition(b"\r\n\r\n")
        assert b"Transfer-Encoding: chunked" in header
        text = b"".join(body.split(b"\r\n")[1::2])
        assert b"head /torch_progressive_test a=1" in text
        assert b"line0" in text and b"line2" in text
        assert not tnative.progressive_write(pids[0], b"late\n")
    finally:
        s.close()
        srv.close()


def test_sessionz_provider_slot(live_native):
    srv = tnative.Server()
    port = srv.start("127.0.0.1:0")
    url = f"http://127.0.0.1:{port}/sessionz?format=json"
    try:
        def doc_a():
            return json.dumps({"active": 1, "sessions": [], "who": "a"})

        def doc_b():
            return json.dumps({"active": 2, "sessions": [], "who": "b"})

        tnative.set_sessionz_provider(doc_a)
        assert json.loads(urllib.request.urlopen(url, timeout=5).read())[
            "who"] == "a"
        tnative.set_sessionz_provider(doc_b)  # the newest serves
        tnative.clear_sessionz_provider(doc_a)  # not the holder: no-op
        assert json.loads(urllib.request.urlopen(url, timeout=5).read())[
            "who"] == "b"
        tnative.clear_sessionz_provider(doc_b)
        assert tnative._sessionz_holder["fn"] is None
    finally:
        tnative.set_sessionz_provider(None)
        srv.close()


def test_parse_moved_equals_jax():
    for text in ("session s1 moved:10.0.0.2:8000", "moved:h:1; retry",
                 "moved:a,b", "", "no address here", None):
        assert tnative.parse_moved(text) == jnative.parse_moved(text)
    assert tnative.E_SESSION_MOVED == jnative.E_SESSION_MOVED


def test_arena_busy_bytes_wait_reusable_and_zero_copy(live_native):
    """The port's twin of the JAX package's zero-copy and recycle tests
    (tests/test_tensor_bridge.py): a handler's in-place write lands in the
    sender's pages, the freed range becomes reusable, and every range of a
    loop of sends drains to 0 busy bytes on both sides."""
    from brpc_tpu_torch.runtime.tensor import (TensorArena, TensorChannel,
                                               add_tensor_service)

    def handler(method, request, att):
        if method == "Mark":
            att[0] = 0xEE  # visible to the sender iff the pages are shared
        return b"", np.asarray(att) * 2

    server = tnative.Server()
    srv_arena = add_tensor_service(server, "Echo", handler)
    port = server.start("127.0.0.1:0")
    ch = TensorChannel(f"tpu://127.0.0.1:{port}", TensorArena(64 << 20))
    try:
        n = 1 << 20
        off = ch.arena.alloc(n)
        view = ch.arena.view(off, n)
        view[:] = 7
        _payload, resp_view = ch.call_raw("Echo/Mark", b"", off, n)
        with resp_view:
            assert resp_view.zero_copy
        assert view[0] == 0xEE and view[1] == 7
        ch.arena.free(off)
        assert ch.arena.wait_reusable(off, 5000)
        for i in range(10):
            x = np.full((256, 1024), i, dtype=np.uint8)
            off = ch.arena.alloc(x.nbytes)
            ch.arena.view(off, x.nbytes)[:] = x.reshape(-1)
            _p, v = ch.call_raw("Echo/Mul2", b"", off, x.nbytes)
            v.release()
            ch.arena.free(off)
        deadline = time.monotonic() + 5
        while ((ch.arena.busy_bytes() or srv_arena.busy_bytes())
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert ch.arena.busy_bytes() == 0 and srv_arena.busy_bytes() == 0
    finally:
        ch.close()
        server.close()
    closed = TensorArena(1 << 20)
    closed.close()
    assert closed.busy_bytes() == 0


def test_latency_recorder_read_side_and_null_series(live_native):
    from brpc_tpu_torch.observability import metrics as obs

    from brpc_tpu.observability import metrics as jobs

    # The windowed reads (max, mean, percentiles) follow the native
    # sampler, once a second: the same samples in a JAX recorder read the
    # same once both windows hold them.
    rec = obs.latency("torch_test_native_latency_read")
    twin = jobs.latency("test_torch_native_latency_read_twin")
    for us in (100, 200, 300, 4000):
        rec.record_us(us)
        twin.record_us(us)
    assert rec.count() == twin.count() == 4
    # The max and the percentile windows are sampled apart: wait for both
    # in both recorders.
    deadline = time.monotonic() + 5
    while 0 in (rec.max_us(), twin.max_us(), rec.p99(), twin.p99()):
        assert time.monotonic() < deadline, "the windows never sampled"
        time.sleep(0.1)
    assert rec.max_us() == 4000
    assert rec.snapshot() == twin.snapshot()
    for name in ("count", "avg_us", "max_us", "p50", "p90", "p99", "p999"):
        assert getattr(rec, name)() == getattr(twin, name)(), name
    assert rec.qps() >= 0
    null = obs.NullSeries()
    null.add(5)
    null.record_us(7)
    null.record_s(0.1)
    assert (null.count(), null.qps(), null.p99(), null.value()) == \
        (0, 0, 0, 0)
