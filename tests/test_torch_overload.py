"""Multi-tenant overload protection through the port: twins of
tests/test_overload.py.

  * the port's ``RpcError`` classifies ELIMIT/EOVERCROWDED as overloaded
    and parses the retry hint; its ``OverloadPacer`` paces on the hint,
    escalates without one and heals on success;
  * the QoS wire: a port ``Channel``'s unmarked request is byte for byte
    the layout that predates the QoS fields, a stamped one carries the
    priority and the tenant;
  * per-tenant quotas: a greedy tenant sheds (ELIMIT with a retry hint)
    before it can crowd out another one, ``Server.tenantz()`` accounts for
    every call — on the native echo service, and through two port
    ``ParameterClient``s with tenants of their own, where the greedy one
    still completes its ``pull_all``, paced, and the steady one is never
    shed;
  * QoS negotiation rides Meta, a port client against a JAX server and the
    reverse; a stamped call killed at parse time heals when the re-read
    Meta no longer advertises QoS;
  * a shed storm against a fleet shard is paced with
    ``FleetClient(tenant=)``.

Scenarios wait on conditions or on calls that complete, never on a bare
sleep; ``inject_latency`` is cleared after each test whatever happened.
"""

import collections
import ctypes
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from brpc_tpu.runtime import param_server as jps
from brpc_tpu_torch.runtime import codec as tcodec
from brpc_tpu_torch.runtime import native
from brpc_tpu_torch.runtime import param_server as tps
from brpc_tpu_torch.runtime.state import state_from_numpy

BULK_PAYLOAD = b"x" * 8192  # over the small-message threshold: no batching


@pytest.fixture(autouse=True)
def _clear_injections():
    yield
    native.inject_latency("", 0)


@pytest.fixture(scope="module")
def _native_lib():
    from conftest import require_native_lib
    require_native_lib()


# ---- pure Python ---------------------------------------------------------

def test_rpc_error_overload_classification():
    e = native.RpcError(1011, "bulk lane shed (retry_after_ms=37)")
    assert e.overloaded
    assert e.retry_after_ms == 37
    assert "overloaded" in str(e)
    e2 = native.RpcError(2006, "write queue full")
    assert e2.overloaded and e2.retry_after_ms is None
    e3 = native.RpcError(2041, "moved:127.0.0.1:1")
    assert not e3.overloaded and "overloaded" not in str(e3)


def test_overload_pacer_hint_backoff_and_heal():
    p = tps.OverloadPacer()
    t0 = time.monotonic()
    owed = p.note(native.RpcError(1011, "shed (retry_after_ms=50)"))
    assert 0.03 <= owed <= 0.06, owed
    p.pace()
    assert time.monotonic() - t0 >= 0.045
    d1 = p.note(native.RpcError(2006, "write queue full"))
    d2 = p.note(native.RpcError(2006, "write queue full"))
    assert d2 >= d1 > 0
    assert p.note(native.RpcError(2041, "moved:x")) == 0.0
    assert p.sheds == 3
    p.clear()
    t1 = time.monotonic()
    p.pace()
    assert time.monotonic() - t1 < 0.01


# ---- the QoS wire --------------------------------------------------------

def _capture_request_frame(priority=None, tenant=""):
    """Point a port Channel at a raw socket; return the request bytes."""
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    port = lsock.getsockname()[1]
    captured = {}

    def accept():
        conn, _ = lsock.accept()
        conn.settimeout(2)
        buf = b""
        try:
            while len(buf) < 12:
                buf += conn.recv(4096)
            meta_size, body_size = struct.unpack_from("<II", buf, 4)
            while len(buf) < 12 + meta_size + body_size:
                buf += conn.recv(4096)
        except socket.timeout:
            pass
        captured["frame"] = buf
        conn.close()

    t = threading.Thread(target=accept)
    t.start()
    ch = native.Channel(f"127.0.0.1:{port}", timeout_ms=300, max_retry=0)
    try:
        if priority is None:
            ch.call("Svc/Method", b"payload")
        else:
            with native.qos(priority, tenant):
                ch.call("Svc/Method", b"payload")
    except native.RpcError:
        pass  # nobody answers; the request bytes are what we want
    t.join()
    ch.close()
    lsock.close()
    return captured["frame"]


def _parse_meta_layout(frame):
    assert frame[:4] == b"TRPC"
    meta_size, body_size = struct.unpack_from("<II", frame, 4)
    meta = frame[12:12 + meta_size]
    msg_type, _compress = struct.unpack_from("<BB", meta, 0)
    (flags,) = struct.unpack_from("<H", meta, 2)
    off = 4 + 8 + 4 + 4 + 8 + 8 + 8  # cid, att_size, timeout, trace ids
    out = {"flags": flags, "meta_size": meta_size, "body_size": body_size,
           "msg_type": msg_type}
    if flags & 1:  # stream
        off += 16
    if flags & 2:  # checksum
        off += 4
    if flags & 4:  # qos
        (out["priority"],) = struct.unpack_from("<B", meta, off)
        off += 1
        (tlen,) = struct.unpack_from("<H", meta, off)
        off += 2
        out["tenant"] = meta[off:off + tlen].decode()
        off += tlen
    (slen,) = struct.unpack_from("<H", meta, off)
    off += 2
    out["service"] = meta[off:off + slen].decode()
    off += slen
    (mlen,) = struct.unpack_from("<H", meta, off)
    off += 2
    out["method"] = meta[off:off + mlen].decode()
    out["consumed"] = off + mlen
    return out


def test_qos_unset_wire_is_byte_identical_to_pre_qos_layout(_native_lib):
    m = _parse_meta_layout(_capture_request_frame())
    assert m["msg_type"] == 0
    assert m["flags"] == 0, m
    assert m["service"] == "Svc" and m["method"] == "Method"
    assert m["consumed"] == m["meta_size"] == (
        44 + 2 + len("Svc") + 2 + len("Method"))
    assert m["body_size"] == len(b"payload")


def test_qos_stamped_wire_carries_priority_and_tenant(_native_lib):
    m = _parse_meta_layout(_capture_request_frame(
        priority=native.PRIORITY_BULK, tenant="trainer-7"))
    assert m["flags"] & 4, m
    assert m["priority"] == native.PRIORITY_BULK
    assert m["tenant"] == "trainer-7"
    assert m["service"] == "Svc" and m["method"] == "Method"
    assert m["consumed"] == m["meta_size"]


# ---- per-tenant quotas ---------------------------------------------------

def test_tenant_quota_sheds_greedy_before_others(_native_lib):
    """Quota 2: a 6-deep burst from one tenant admits 2 and sheds 4 with
    ELIMIT + retry_after_ms at once; another tenant is admitted; tenantz
    accounts for every call."""
    srv = native.Server()
    srv.add_echo_service()
    srv.set_max_concurrency(16)
    srv.set_tenant_quota(2)
    addr = f"127.0.0.1:{srv.start()}"
    native.inject_latency("EchoService", 300)
    results = []
    barrier = threading.Barrier(6)
    shed_seen = threading.Semaphore(0)

    def greedy():
        ch = native.Channel(addr, timeout_ms=8000, max_retry=0)
        barrier.wait()
        t0 = time.monotonic()
        try:
            with native.qos(native.PRIORITY_BULK, "greedy"):
                ch.call("EchoService/Echo", BULK_PAYLOAD)
            results.append(("ok", time.monotonic() - t0, None))
        except native.RpcError as e:
            results.append(("shed", time.monotonic() - t0, e))
            shed_seen.release()
        ch.close()

    threads = [threading.Thread(target=greedy) for _ in range(6)]
    for t in threads:
        t.start()
    try:
        for _ in range(4):  # the burst's sheds are in: 2 calls hold slots
            assert shed_seen.acquire(timeout=10)
        oc = native.Channel(addr, timeout_ms=8000, max_retry=0)
        with native.qos(native.PRIORITY_HIGH, "polite"):
            oc.call("EchoService/Echo", b"hi")
        oc.close()
    finally:
        for t in threads:
            t.join()
        native.inject_latency("", 0)
    sheds = [r for r in results if r[0] == "shed"]
    assert len(sheds) == 4 and len(results) == 6, results
    for _, dt, e in sheds:
        assert dt < 0.15, dt  # shed before queueing: at once
        assert e.code == native.TRPC_ELIMIT and e.overloaded
        assert e.retry_after_ms is not None, e.text
        assert "over quota" in e.text
    tz = srv.tenantz()
    by_name = {t["name"]: t for t in tz["tenants"]}
    assert (by_name["greedy"]["admitted"], by_name["greedy"]["shed"]) == (2, 4)
    assert (by_name["polite"]["admitted"], by_name["polite"]["shed"]) == (1, 0)
    assert tz["quota"] == 2
    srv.close()


class _TenantCount:
    """Counts the calls a ParameterClient issues, by the tenant stamped on
    the issuing thread (``""`` = unstamped: the server keys it by ip)."""

    def __init__(self, *clients):
        self.calls = collections.Counter()
        self._mu = threading.Lock()
        L = native.lib()
        for cl in clients:
            for attr in ("call_raw", "call_async"):
                real = getattr(cl.channel, attr)

                def counted(*a, _real=real, **k):
                    prio = ctypes.c_int()
                    buf = ctypes.create_string_buffer(512)
                    L.tbrpc_qos_get(ctypes.byref(prio), buf, len(buf))
                    with self._mu:
                        self.calls[buf.value.decode()] += 1
                    return _real(*a, **k)

                setattr(cl.channel, attr, counted)


def test_parameter_clients_greedy_tenant_shed_first_steady_never(
        _native_lib):
    """Two trainers of two tenants on one port server with quota 2 and
    20 ms of injected service time: the greedy one pulls every name with
    a window of 8 (int8 PullQ groups, retrying what was shed, paced by its
    OverloadPacer) while the steady one pulls one name in a loop. The
    greedy one is shed and still gets every tensor; the steady one is
    never shed; tenantz admitted + shed equals the calls each issued."""
    rng = np.random.default_rng(4)
    params = {f"w{i:02d}": rng.standard_normal(
        (64, 64) if i % 3 else (40,)).astype(np.float32) for i in range(24)}
    ps = tps.ParameterServer(state_from_numpy(params, device="cpu"))
    port = ps.start()
    ps.server.set_tenant_quota(2)
    addr = f"tpu://127.0.0.1:{port}"
    greedy = tps.ParameterClient(addr, codec="int8", tenant="greedy",
                                 device="cpu")
    steady = tps.ParameterClient(addr, tenant="steady", device="cpu")
    count = _TenantCount(greedy, steady)
    greedy.meta()
    steady.meta()
    native.inject_latency("ParamService", 20)
    done = threading.Event()
    steady_pulls, steady_errors = [], []

    def steady_loop():
        while not done.is_set() or len(steady_pulls) < 3:
            try:
                v, t = steady.pull("w01")
            except native.RpcError as e:
                steady_errors.append(e)
                return
            steady_pulls.append(v)

    th = threading.Thread(target=steady_loop)
    th.start()
    got, missing, rounds = {}, sorted(params), 0
    try:
        while missing:
            rounds += 1
            assert rounds < 200
            try:
                got.update(greedy.pull_all(missing, window=8))
                missing = []
            except tps.PartialPullError as e:
                assert e.overloaded, e
                got.update(e.partial)
                missing = e.missing
            except native.RpcError as e:
                assert e.overloaded, e
    finally:
        done.set()
        th.join()
        native.inject_latency("", 0)
    assert not steady_errors, steady_errors
    assert rounds > 1 and greedy.pacer.sheds >= 1 and steady.pacer.sheds == 0
    # Every tensor, bit for bit: raw for the ineligible ones, and the
    # decode of the server's int8 encoding for the rest.
    for k, a in params.items():
        v, t = got[k]
        assert v == 0
        enc = tcodec.encode(a, "int8")
        want = a if enc is None else tcodec.decode(
            {"dtype": "<f4", "shape": list(a.shape), "codec": "int8",
             "block": enc.block}, enc.wire)
        np.testing.assert_array_equal(t.numpy(), want)
    tz = {t["name"]: t for t in ps.server.tenantz()["tenants"]}
    assert tz["greedy"]["shed"] >= 1 and tz["steady"]["shed"] == 0
    for name in ("greedy", "steady"):
        assert tz[name]["inflight"] == 0
        assert tz[name]["admitted"] + tz[name]["shed"] == count.calls[name]
    assert tz["steady"]["admitted"] == len(steady_pulls)  # one call a pull
    greedy.close()
    steady.close()
    ps.stop()


# ---- negotiation ---------------------------------------------------------

@pytest.mark.parametrize("server_impl,client_impl",
                         [("jax", "torch"), ("torch", "jax")])
def test_qos_negotiation_rides_meta_advertisement(_native_lib, server_impl,
                                                  client_impl):
    """Stamping is negotiated: a client stamps priority and tenant only
    after the server's Meta carried "qos": 1 (fetched on the first stamped
    call); against no advertisement every lane is a no-op scope."""
    import contextlib

    w = np.ones((64,), np.float32)
    srv = (jps.ParameterServer({"w0": jnp.asarray(w)}) if server_impl == "jax"
           else tps.ParameterServer({"w0": w}, device="cpu"))
    port = srv.start()
    addr = f"tpu://127.0.0.1:{port}"
    pc = (tps.ParameterClient(addr, tenant="t9", device="cpu")
          if client_impl == "torch"
          else jps.ParameterClient(addr, tenant="t9"))
    try:
        srv.server.set_tenant_quota(4)
        assert pc._srv_qos is None
        v, _arr = pc.pull("w0")
        assert v == 0 and pc._srv_qos is True
        names = {t["name"] for t in srv.server.tenantz()["tenants"]}
        assert "t9" in names  # the pull rode stamped with the tenant
        pc._srv_qos = False
        assert isinstance(pc._qos_bulk(), contextlib.nullcontext)
        assert isinstance(pc._qos_high(), contextlib.nullcontext)
    finally:
        pc.close()
        srv.stop()


def test_qos_rollback_self_heals(_native_lib):
    """A stamped call against a build that predates the QoS fields dies at
    parse time (the connection is killed). The client re-reads Meta once
    (unstamped) and, QoS no longer advertised, retries unstamped; while
    the server still advertises QoS the error stands."""
    import json

    w = np.arange(64, dtype=np.float32)
    srv = tps.ParameterServer({"w0": w}, device="cpu")
    port = srv.start()
    pc = tps.ParameterClient(f"tpu://127.0.0.1:{port}", tenant="t1",
                             device="cpu")
    try:
        assert pc.pull("w0")[0] == 0 and pc._srv_qos
        real = pc.channel.call_raw
        old_build = {"on": True}

        def parse_kill(method, *a, **k):
            stamped = pc._srv_qos and method != "ParamService/Meta"
            if old_build["on"] and stamped:
                raise native.RpcError(native.TRPC_EEOF, "peer closed")
            return real(method, *a, **k)

        pc.channel.call_raw = parse_kill
        with pytest.raises(native.RpcError) as ei:
            pc.pull("w0")  # still advertised: a genuine transport fault
        assert ei.value.code == native.TRPC_EEOF and pc._srv_qos
        real_call = pc.channel.call

        def no_qos_meta(method, *a, **k):
            payload, arr = real_call(method, *a, **k)
            if method == "ParamService/Meta":
                doc = json.loads(payload.decode())
                doc.pop("qos")
                payload = json.dumps(doc).encode()
            return payload, arr

        pc.channel.call = no_qos_meta
        v, t = pc.pull("w0")
        assert v == 0 and pc._srv_qos is False
        np.testing.assert_array_equal(t.numpy(), w)
        assert pc.push_grad("w0", torch.zeros(64)) == 1
    finally:
        pc.close()
        srv.stop()


# ---- the fleet -----------------------------------------------------------

def test_fleet_shed_storm_is_paced(_native_lib):
    """A FleetClient hammering an overloaded shard does not hot-retry:
    ELIMIT answers retry paced by the retry_after_ms hint, never count as
    reshard evidence, and the per-tenant counters bound the attempts."""
    from brpc_tpu_torch.fleet import (FleetClient, FleetServer, RegistryHub,
                                      clear_registry)

    hub = RegistryHub()
    hub.start()
    try:
        shard = FleetServer(hub.hostport, tag="torch_storm",
                            shard_name="torch_storm_s0", ttl_s=3,
                            device="cpu")
        shard.ps.server.set_max_concurrency(2)
        shard.ps.server.set_tenant_quota(1)
        shard.start()
        fc = FleetClient(hub.hostport, tag="torch_storm", op_deadline_s=3.0,
                         tenant="stormy", device="cpu")
        fc.install("w0", np.ones((256,), np.float32))
        native.inject_latency("ParamService", 250)
        started = threading.Event()

        def blocker():
            started.set()
            fc.pull("w0")

        t0 = time.monotonic()
        th = threading.Thread(target=blocker)
        th.start()
        started.wait()
        v, arr = fc.pull("w0")  # retries through the sheds, paced
        elapsed = time.monotonic() - t0
        th.join()
        native.inject_latency("", 0)
        assert v == 0 and float(arr[0]) == 1.0
        stormy = {t["name"]: t for t in
                  shard.ps.server.tenantz()["tenants"]}["stormy"]
        assert stormy["shed"] >= 1, stormy
        assert stormy["admitted"] >= 2  # both pulls got through
        attempts = stormy["admitted"] + stormy["shed"]
        assert attempts <= 30, (attempts, elapsed, stormy)
        fc.close()
        shard.stop()
    finally:
        native.inject_latency("", 0)
        clear_registry()
        hub.stop()
