"""The port's live serving scenarios, run in a process of their own.

    python tests/torch_serving_live.py PARAMS.npz RESULTS.json NAME...

A ``ServingServer`` registers the process-wide ``/gen`` HTTP route and the
one ``/sessionz`` slot, and a process in which the JAX package's server
registered them first cannot host the port's (the registration raises).
``tests/test_torch_serving.py`` therefore runs these scenarios here, in a
fresh interpreter that imports only the port, and asserts on the results
this writes: ``{name: null | traceback}``. Each scenario is the port's
twin of one of the JAX package's native serving tests
(tests/test_serving.py, test_spec_decode.py, test_paged_kv.py). The
decoder's parameters come in as numpy (the JAX package's, carried
across); everything runs on the CPU under an armed stall watchdog.
"""

import json
import os
import socket
import sys
import tempfile
import threading
import time
import traceback
import urllib.request

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from brpc_tpu_torch.models.decoder import decode_serial  # noqa: E402
from brpc_tpu_torch.runtime import native  # noqa: E402
from brpc_tpu_torch.runtime.state import (  # noqa: E402
    decoder_params_from_numpy)

MAX_LEN = 64
SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def _serial(P, prompt, n, lanes):
    return decode_serial(P, prompt, n, MAX_LEN, lanes=lanes)


def _server(P, **kw):
    from brpc_tpu_torch.serving import ServingServer
    srv = ServingServer(P, max_len=MAX_LEN, device="cpu", **kw)
    return srv, srv.start()


def _client(addr, **kw):
    from brpc_tpu_torch.serving import ServingClient
    return ServingClient(addr, **kw)


def _drain(ts, out, timings):
    for tok in ts:
        out.append(tok)
        timings.append(time.monotonic())


def _join(threads, timeout_s=60):
    for t in threads:
        t.join(timeout=timeout_s)
        assert not t.is_alive(), "a stream reader hung"


@scenario
def two_streamed_sessions_incremental_and_parity(P):
    """Two concurrent streamed sessions, token for token the serial
    trajectory, delivered one frame per token in order (held by order and
    count, not by wall-clock gaps: the suite runs on loaded workers)."""
    srv, port = _server(P, max_batch=4)
    try:
        n_tok = 24
        c1 = _client(f"127.0.0.1:{port}", tenant="u1")
        c2 = _client(f"127.0.0.1:{port}", tenant="u2")
        ts1 = c1.open([3, 7, 11], n_tok)
        ts2 = c2.open([5, 2], n_tok)
        out1, out2, times1, times2 = [], [], [], []
        th = [threading.Thread(target=_drain, args=(ts1, out1, times1)),
              threading.Thread(target=_drain, args=(ts2, out2, times2))]
        for t in th:
            t.start()
        _join(th)
        assert out1 == _serial(P, [3, 7, 11], n_tok, 4)
        assert out2 == _serial(P, [5, 2], n_tok, 4)
        for ts, times in ((ts1, times1), (ts2, times2)):
            assert len(times) == n_tok == len(ts.tokens)
            assert times == sorted(times)
            assert ts.ttft_s is not None
            assert ts.ttft_s <= times[-1] - ts.opened_at
        c1.close()
        c2.close()
    finally:
        srv.stop()


@scenario
def stream_over_tpu_transport(P):
    srv, port = _server(P, max_batch=2)
    try:
        c = _client(f"tpu://127.0.0.1:{port}", tenant="tpu-user")
        assert c.generate([9, 4, 1], 12) == _serial(P, [9, 4, 1], 12, 2)
        c.close()
    finally:
        srv.stop()


@scenario
def slow_reader_never_delays_the_other_session(P):
    """A stalled reader (64-byte receive window, never read): the other
    session streams every token while it stalls, and it is shed alone,
    visibly to its client."""
    from brpc_tpu_torch.serving import SHED, SessionShed
    srv, port = _server(P, max_batch=4, stall_timeout_s=0.4)
    try:
        stuck = _client(f"127.0.0.1:{port}", tenant="stuck")
        fast = _client(f"127.0.0.1:{port}", tenant="fast")
        ts_stuck = stuck.open([3, 7], 40, recv_window=64)
        n_tok = 30
        ts_fast = fast.open([5, 2], n_tok)
        out, times = [], []
        _drain(ts_fast, out, times)
        assert out == _serial(P, [5, 2], n_tok, 4)
        deadline = time.monotonic() + 20
        shed_reason = None
        while shed_reason is None and time.monotonic() < deadline:
            sess = srv.manager.get(ts_stuck.session_id)
            if sess is not None and sess.state == SHED:
                shed_reason = sess.shed_reason
            time.sleep(0.05)
        assert shed_reason == "slow reader", shed_reason
        try:
            while True:
                ts_stuck.read_token(timeout_ms=4000)
        except SessionShed:
            pass
        else:
            raise AssertionError("the stalled client never saw its shed")
        stuck.close()
        fast.close()
    finally:
        srv.stop()


@scenario
def tenant_quota_sheds_third_session_mid_batch(P):
    srv, port = _server(P, max_batch=4, tenant_max_sessions=2)
    try:
        c = _client(f"127.0.0.1:{port}", tenant="greedy")
        other = _client(f"127.0.0.1:{port}", tenant="polite")
        ts1 = c.open([3, 7], 40)
        ts2 = c.open([5, 2], 40)
        try:
            c.open([9], 8)
        except native.RpcError as e:
            assert e.overloaded and e.retry_after_ms is not None
        else:
            raise AssertionError("a third session over quota was admitted")
        assert other.generate([9, 4, 1], 8) == _serial(P, [9, 4, 1], 8, 4)
        ts1.close()
        ts2.close()
        c.close()
        other.close()
    finally:
        srv.stop()


@scenario
def ttl_eviction_closes_stream_with_e_frame(P):
    from brpc_tpu_torch.serving import SessionShed
    srv, port = _server(P, max_batch=2, ttl_s=0.2)
    try:
        srv.engine.stop()  # nobody decodes: the session stays idle
        c = _client(f"127.0.0.1:{port}", tenant="idle")
        ts = c.open([3, 7], 8)
        time.sleep(0.3)
        assert len(srv.manager.evict_expired()) == 1
        try:
            ts.read_token(timeout_ms=2000)
        except SessionShed as e:
            assert "ttl" in e.reason, e.reason
        else:
            raise AssertionError("no shed after the TTL eviction")
        c.close()
    finally:
        srv.stop()


@scenario
def open_without_stream_is_a_clean_error(P):
    srv, port = _server(P, max_batch=2)
    try:
        ch = native.Channel(f"127.0.0.1:{port}", timeout_ms=2000,
                            max_retry=0)
        try:
            ch.call("Gen/Open", json.dumps(
                {"prompt": [1], "max_tokens": 2}).encode())
        except native.RpcError as e:
            assert "requires a stream" in e.text, e.text
        else:
            raise AssertionError("Gen/Open without a stream succeeded")
        ch.close()
    finally:
        srv.stop()


@scenario
def sessionz_and_vars(P):
    """/sessionz (json and text) renders the port's manager, and the
    torch_serving_* recorders are plain native vars."""
    from brpc_tpu_torch.observability import metrics as obs
    from brpc_tpu_torch.serving import serving_metrics
    srv, port = _server(P, max_batch=2)
    try:
        c = _client(f"127.0.0.1:{port}", tenant="scrape-me")
        assert len(c.generate([3, 7, 11], 8)) == 8
        vars_text = obs.dump_vars("torch_serving_")
        assert "torch_serving_tokens" in vars_text
        assert "torch_serving_ttft_latency" in vars_text
        doc = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/sessionz?format=json",
            timeout=5).read().decode())
        assert doc["tokens_total"] >= 8
        assert any(s["tenant"] == "scrape-me" for s in doc["sessions"])
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/sessionz", timeout=5).read().decode()
        assert "per-tenant sessions" in text and "scrape-me" in text
        m = serving_metrics()
        assert m["ttft"].count() >= 1 and m["token"].count() >= 8
        # The windowed reads follow the native sampler, once a second.
        deadline = time.monotonic() + 10
        while m["ttft"].max_us() == 0:
            assert time.monotonic() < deadline, "the TTFT window never sampled"
            time.sleep(0.1)
        snap = m["ttft"].snapshot()
        assert set(snap) == {"count", "avg_us", "p50_us", "p99_us",
                             "max_us"}
        assert snap["max_us"] > 0 and snap["count"] >= 1
        c.close()
    finally:
        srv.stop()


@scenario
def http_fallback_streams_progressively(P):
    srv, port = _server(P, max_batch=2)
    try:
        ref = _serial(P, [3, 7, 11], 16, 2)
        s = socket.create_connection(("127.0.0.1", port), timeout=20)
        s.sendall(b"GET /gen?prompt=3,7,11&max_tokens=16 HTTP/1.1\r\n"
                  b"Host: x\r\n\r\n")
        buf = b""
        t0 = time.monotonic()
        done = False
        while time.monotonic() - t0 < 20:
            chunk = s.recv(4096)
            if not chunk:
                break
            buf += chunk
            if b"0\r\n\r\n" in buf:  # terminal chunk
                done = True
                break
        s.close()
        assert done, buf[-200:]
        header, _, body = buf.partition(b"\r\n\r\n")
        assert b"Transfer-Encoding: chunked" in header, header
        toks = [int(line[1:]) for line in body.splitlines()
                if line.startswith(b"T")]
        assert toks == ref, (toks, ref)
    finally:
        srv.stop()


@scenario
def spec_streamed_parity_and_ab_toggle(P):
    srv, port = _server(P, max_batch=4, spec_k=3)
    try:
        c = _client(f"127.0.0.1:{port}", tenant="spec")
        for prompt in ([3, 7, 11], list(range(1, 41))):
            assert c.generate(prompt, 24) == _serial(P, prompt, 24, 4)
        assert srv.manager.sessionz_doc()["spec_proposed"] > 0
        resp, _ = c.channel.call("Gen/Spec", json.dumps(
            {"spec_k": 0}).encode())
        assert json.loads(resp.decode()) == {"spec_k": 0, "was": 3}
        assert c.generate([5, 2], 12) == _serial(P, [5, 2], 12, 4)
        resp, _ = c.channel.call("Gen/Spec", json.dumps(
            {"spec_k": 3}).encode())
        assert json.loads(resp.decode())["was"] == 0
        c.close()
    finally:
        srv.stop()


@scenario
def paged_serving_parity_and_surfaces(P):
    from brpc_tpu_torch.observability import metrics as obs
    srv, port = _server(P, max_batch=4, paged=True, block_rows=8)
    try:
        prompt = list(range(2, 22))
        ref = _serial(P, prompt, 8, 4)
        c = _client(f"127.0.0.1:{port}", tenant="pg")
        assert c.generate(prompt, 8) == ref
        assert c.generate(prompt, 8) == ref, "cache-hit replay parity"
        doc = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/sessionz?format=json",
            timeout=5).read().decode())
        assert doc["paged_mode"] and doc["block_rows"] == 8
        assert doc["prefix_hits"] >= 2 and doc["prefix_hit_pct"] > 0
        assert doc["kv_blocks_free"] > 0
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/sessionz", timeout=5).read().decode()
        assert "prefix hit:" in text and "blocks free/shared/cached:" in text
        vars_text = obs.dump_vars("torch_serving_")
        assert "torch_serving_prefix_hits" in vars_text
        assert "torch_serving_kv_blocks_free" in vars_text
        c.close()
    finally:
        srv.stop()


@scenario
def resume_on_a_single_server_is_no_method(P):
    """Gen/Resume belongs to a serving fleet's server; a single server
    answers ENOMETHOD, and the client raises it."""
    srv, port = _server(P, max_batch=2)
    try:
        c = _client(f"127.0.0.1:{port}")
        try:
            c.resume("s-nowhere", have=0)
        except native.RpcError as e:
            assert e.code == native.TRPC_ENOMETHOD, e
        else:
            raise AssertionError("Gen/Resume answered on a single server")
        c.close()
    finally:
        srv.stop()


def main(argv) -> int:
    params_path, out_path, names = argv[1], argv[2], argv[3:]
    import torch

    from brpc_tpu_torch.observability import health

    # Tiny steps on a host the test workers keep busy: one intra-op
    # thread, so no step waits for a parallel region's threads.
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")

    values = dict(np.load(params_path))
    P = decoder_params_from_numpy(values, device="cpu")
    dump_dir = tempfile.mkdtemp(prefix="torch_serving_dumps")
    health.start_watchdog(dump_dir)
    results = {}
    for name in names:
        try:
            SCENARIOS[name](P)
            results[name] = None
        except Exception:  # noqa: BLE001 — reported to the parent test
            results[name] = traceback.format_exc()
    deadline = time.monotonic() + 10
    while health.state() == "stalled" and time.monotonic() < deadline:
        time.sleep(0.1)
    results["_watchdog"] = (None if health.state() != "stalled" else
                            f"scheduler stalled; dump: "
                            f"{health.last_dump_path()}")
    with open(out_path, "w") as f:
        json.dump(results, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
