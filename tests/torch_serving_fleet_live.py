"""The port's live serving-fleet and fleet-observability scenarios, run in
a process of their own.

    python tests/torch_serving_fleet_live.py PARAMS.npz RESULTS.json NAME...

A ``FleetServingServer`` registers the process-wide ``/gen`` route and
the one ``/sessionz`` slot, and a process's tbvar namespace is one, so
the scenarios run here, in a fresh interpreter that imports only the
port, and ``tests/test_torch_serving_fleet.py`` /
``tests/test_torch_fleet_view.py`` assert on the results this writes:
``{name: null | traceback}``. Each scenario is the port's twin of one of
the JAX package's live fleet tests (tests/test_serving_fleet.py,
test_spec_decode.py, test_paged_kv.py, test_serving.py,
test_fleet_view.py), plus the port's own (a drain whose k-th Install is
refused, and a fleet that mixes a JAX member with a port member). The
decoder's parameters come in as numpy; ``PARAMS.npz`` may carry a
``refs.json`` beside it with the JAX package's tokens for the mixed
fleet. Everything runs on the CPU under an armed stall watchdog. rpcz
is switched on only after this process's first server has started.
"""

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from brpc_tpu_torch.models.decoder import decode_serial  # noqa: E402
from brpc_tpu_torch.runtime import native  # noqa: E402
from brpc_tpu_torch.runtime.state import (  # noqa: E402
    decoder_params_from_numpy)

MAX_LEN = 64
LONG_PROMPT = list(range(1, 41))
SCENARIOS = {}
REFS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def _serial(P, prompt, n, lanes):
    return decode_serial(P, prompt, n, MAX_LEN, lanes=lanes)


def _hub():
    from brpc_tpu_torch.fleet import RegistryHub
    hub = RegistryHub()
    hub.start()
    return hub


def _member(P, hub, tag, role="both", **kw):
    from brpc_tpu_torch.serving import FleetServingServer
    kw.setdefault("max_batch", 4)
    srv = FleetServingServer(hub.hostport, P, tag=tag, role=role,
                             max_len=MAX_LEN, reg_ttl_s=3, device="cpu",
                             **kw)
    srv.start()
    return srv


def _cleanup(hub, *servers):
    from brpc_tpu_torch.fleet import clear_registry
    for srv in servers:
        try:
            srv.stop()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass
    clear_registry()
    hub.stop()


def _keys_owned_by(client, addr, n, prefix):
    """Session keys whose sticky owner is ``addr`` under the live map."""
    client.router.refresh(force=True)
    keys, i = [], 0
    while len(keys) < n:
        k = f"{prefix}-{i}"
        if client.router.route(k) == addr:
            keys.append(k)
        i += 1
        assert i < 10000
    return keys


def _http(hostport, path, timeout=10):
    with urllib.request.urlopen(f"http://{hostport}{path}",
                                timeout=timeout) as resp:
        return resp.read().decode()


def _slowed(srv, delay_s=0.01):
    """Hold each of ``srv``'s engine steps back by ``delay_s``, so a
    drain lands while its sessions are still mid-stream."""
    inner = srv.engine.step

    def step():
        time.sleep(delay_s)
        return inner()

    srv.engine.step = step


def _read_until(ts, n):
    while len(ts.tokens) < n:
        ts.read_token(timeout_ms=5000)


def _drain_with_readers(src, streams):
    """Drain ``src`` while a thread per stream reads it to the end;
    returns the drain's count of moved sessions."""
    threads = [threading.Thread(target=lambda ts=ts: list(ts))
               for ts in streams.values()]
    for t in threads:
        t.start()
    moved = src.drain()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "stream reader hung after drain"
    return moved


def _assert_single_home(sid, *servers):
    """No session is live (QUEUED, ACTIVE or FROZEN) on two members."""
    live = [s.addr for s in servers
            if s.manager.get(sid) is not None
            and s.manager.get(sid).state in ("queued", "active", "frozen")]
    assert len(live) <= 1, f"session {sid} live on {live}"


# ---------------------------------------------------------------------------
# tests/test_serving_fleet.py's live half.
# ---------------------------------------------------------------------------

@scenario
def routing_determinism_and_sticky_opens(P):
    from brpc_tpu_torch.serving import ServingFleetClient
    hub = _hub()
    a = _member(P, hub, "rt")
    b = _member(P, hub, "rt")
    try:
        c1 = ServingFleetClient(hub.hostport, tag="rt")
        c2 = ServingFleetClient(hub.hostport, tag="rt")
        c1.router.refresh(force=True)
        c2.router.refresh(force=True)
        assert sorted(c1.router.members()) == sorted([a.addr, b.addr])
        for i in range(50):
            sid = f"det-{i}"
            assert c1.router.route(sid) == c2.router.route(sid)
        for srv in (a, b):
            key = _keys_owned_by(c1, srv.addr, 1, f"on-{srv.addr}")[0]
            toks = c1.generate([3, 7], 6, session_key=key)
            assert toks == _serial(P, [3, 7], 6, 4)
            assert srv.manager.get(key) is not None, \
                f"session {key} did not land on its owner {srv.addr}"
        c1.close()
        c2.close()
    finally:
        _cleanup(hub, a, b)


def _drain_parity(P, tag, **member_kw):
    """Two sessions owned by A stream a few tokens, A drains, both resume
    on B with the serial trajectory; A then sheds opens with E_DRAINING."""
    from brpc_tpu_torch.serving import ServingClient, ServingFleetClient
    hub = _hub()
    a = _member(P, hub, tag, **member_kw)
    b = _member(P, hub, tag, **member_kw)
    _slowed(a)
    try:
        c = ServingFleetClient(hub.hostport, tag=tag)
        n_tok = 30
        keys = _keys_owned_by(c, a.addr, 2, f"{tag}-drain")
        key_prompt = dict(zip(keys, ([3, 7, 11], [5, 2])))
        refs = {k: _serial(P, p, n_tok, 4) for k, p in key_prompt.items()}
        streams = {k: c.open(p, n_tok, session_key=k)
                   for k, p in key_prompt.items()}
        for ts in streams.values():
            _read_until(ts, 3)
        for k in keys:
            assert a.manager.get(k) is not None
        moved = _drain_with_readers(a, streams)
        assert moved == 2, f"expected both sessions to migrate, got {moved}"
        for k, ts in streams.items():
            assert ts.tokens == refs[k], (
                f"stream {k} tore across the migration:\n got "
                f"{ts.tokens}\n ref {refs[k]}")
            assert ts.resumes >= 1, "the stream must have followed a move"
            assert ts.last_gap_s is not None and ts.last_gap_s < 15
            assert b.manager.get(k) is not None, "session lives on B"
            sa = a.manager.get(k)
            assert sa is not None and sa.state == "shed"
            assert sa.shed_reason == f"moved:{b.addr}"
            _assert_single_home(k, a, b)
        direct = ServingClient(a.addr)
        try:
            direct.open([1], 2)
        except native.RpcError as e:
            assert e.draining and e.code == native.E_DRAINING, e
        else:
            raise AssertionError("a drained member admitted an open")
        direct.close()
        for ts in streams.values():
            ts.close()
        c.close()
    finally:
        _cleanup(hub, a, b)


@scenario
def drain_migration_token_parity(P):
    _drain_parity(P, "dr")


@scenario
def draining_server_sheds_opens_with_code(P):
    from brpc_tpu_torch.serving import ServingClient, ServingFleetClient
    hub = _hub()
    a = _member(P, hub, "dg", max_batch=2)
    b = _member(P, hub, "dg", max_batch=2)
    try:
        c = ServingFleetClient(hub.hostport, tag="dg")
        c.router.refresh(force=True)
        a._draining = True  # gate only: keep membership for the probe
        direct = ServingClient(a.addr)
        try:
            direct.open([1], 2)
        except native.RpcError as e:
            assert e.draining and e.retry_after_ms is not None, e
        else:
            raise AssertionError("a draining member admitted an open")
        direct.close()
        key = _keys_owned_by(c, a.addr, 1, "spill")[0]
        toks = c.generate([3, 7], 6, session_key=key)
        assert toks == _serial(P, [3, 7], 6, 2)
        assert b.manager.get(key) is not None
        c.close()
    finally:
        _cleanup(hub, a, b)


def _split(P, tag, prompt, n_tok, **member_kw):
    from brpc_tpu_torch.serving import ServingFleetClient
    hub = _hub()
    pre = _member(P, hub, tag, role="prefill", **member_kw)
    dec = _member(P, hub, tag, role="decode", **member_kw)
    try:
        c = ServingFleetClient(hub.hostport, tag=tag)
        ref = _serial(P, prompt, n_tok, 4)
        sid = f"{tag}-split-1"
        ts = c.open(prompt, n_tok, session_key=sid)
        toks = list(ts)
        assert toks == ref, (toks, ref)
        assert ts.resumes == 1, "the stream followed the prefill handoff"
        assert ts.addr == dec.addr
        sp = pre.manager.get(sid)
        assert sp is not None and sp.state == "shed"
        assert sp.shed_reason == f"moved:{dec.addr}"
        sd = dec.manager.get(sid)
        assert sd is not None and sd.state == "done"
        assert sd.emitted == n_tok
        ts.close()
        c.close()
    finally:
        _cleanup(hub, pre, dec)


@scenario
def prefill_decode_split(P):
    _split(P, "pd", [9, 4, 1], 12)


def _oneside_spy(srv, log):
    orig = type(srv)._read_kv_oneside

    def spy(self, manifest, _orig=orig, _log=log):
        kv = _orig(self, manifest)
        _log.append(manifest.get("blocks", manifest["session"]))
        return kv

    srv._read_kv_oneside = spy.__get__(srv)


def _open_and_migrate(client, a, b, key, prompt, n_tok):
    ts = client.open(prompt, n_tok, session_key=key)
    _read_until(ts, 3)
    sess = a.manager.get(key)
    assert sess is not None
    assert a.migrate_session(sess, b.addr)
    return ts


@scenario
def oneside_kv_consumer_and_bytes_fallback(P):
    """publish_kv=True: the destination reads the source's published
    planes one-sided; publishing off, and a forced one-sided miss, take
    the bytes path. Every stream keeps the serial trajectory."""
    from brpc_tpu_torch.serving import ServingFleetClient
    for mode in ("oneside", "bytes", "miss"):
        hub = _hub()
        a = _member(P, hub, "os", publish_kv=(mode != "bytes"))
        b = _member(P, hub, "os")
        _slowed(a)
        try:
            installs = []
            _oneside_spy(b, installs)
            if mode == "miss":
                # The slot vanishes between export and Install: the
                # destination's read misses, answers E_NO_SUCH, and the
                # source ships the bytes instead.
                inner = a._install_oneside

                def unpublish_first(manifest, dest, _inner=inner):
                    sid = manifest["session"]
                    a.manager.oneside.unpublish(f"kv:{sid}:k")
                    return _inner(manifest, dest)

                a._install_oneside = unpublish_first
            c = ServingFleetClient(hub.hostport, tag="os")
            n_tok = 16
            key = _keys_owned_by(c, a.addr, 1, f"os-{mode}")[0]
            prompt = [3, 7, 11]
            ts = _open_and_migrate(c, a, b, key, prompt, n_tok)
            rest = list(ts)
            assert ts.tokens == _serial(P, prompt, n_tok, 4)
            assert rest, "tokens kept flowing after the move"
            if mode == "oneside":
                assert installs == [key], installs
            else:
                assert installs == [], installs
            ts.close()
            c.close()
        finally:
            _cleanup(hub, a, b)


def _fleetz_row(addr, tag, key=None):
    doc = json.loads(_http(addr, f"/fleetz?format=json&tag={tag}"))
    return doc, next(r for r in doc["shards"] if r["addr"] == addr)


@scenario
def fleetz_serving_columns_native_and_twin(P):
    """The native /fleetz page lists a port member (its serving columns
    read the plain serving_* names, which a port member does not
    export); the FleetObserver folds the same member's torch_serving_*
    series into nonzero serving columns."""
    from brpc_tpu_torch.observability.fleet_view import FleetObserver
    from brpc_tpu_torch.serving import ServingFleetClient
    hub = _hub()
    a = _member(P, hub, "fz", max_batch=2)
    try:
        c = ServingFleetClient(hub.hostport, tag="fz")
        assert len(c.generate([3, 7, 11], 8)) == 8
        doc, row = _fleetz_row(a.addr, "fz")
        assert row["reachable"] and row["health"] == "ok"
        assert "serving_tokens_s" in row and "serving_sessions" in row
        assert doc["rollup"]["members"] == 1
        text = _http(a.addr, "/fleetz?tag=fz")
        assert "serving: tokens_s=" in text and a.addr in text
        obs_view = FleetObserver(hub.hostport, tag="fz")
        deadline = time.monotonic() + 8
        while True:  # latency windows roll once a second
            fz = obs_view.fleetz()
            trow = next(r for r in fz["shards"] if r["addr"] == a.addr)
            if trow["serving_ttft_p99_us"] > 0 \
                    or time.monotonic() >= deadline:
                break
            time.sleep(0.3)
        assert trow["serving_ttft_p99_us"] > 0
        assert fz["rollup"]["serving_ttft_p99_max_us"] == \
            trow["serving_ttft_p99_us"]
        assert fz["rollup"]["serving_sessions_total"] == \
            trow["serving_sessions"]
        prom = obs_view.fleet_prometheus()
        assert "fleet_serving_tokens_s_total" in prom
        assert "fleet_serving_ttft_p99_max_us" in prom
        c.close()
    finally:
        _cleanup(hub, a)


# ---------------------------------------------------------------------------
# tests/test_spec_decode.py's fleet half.
# ---------------------------------------------------------------------------

@scenario
def spec_drain_migration_parity(P):
    _drain_parity(P, "sdr", spec_k=3)


@scenario
def spec_prefill_decode_split_parity(P):
    _split(P, "spd", LONG_PROMPT, 12, spec_k=3)


@scenario
def fleetz_spec_accept_columns_twin(P):
    from brpc_tpu_torch.observability.fleet_view import FleetObserver
    from brpc_tpu_torch.serving import ServingFleetClient
    hub = _hub()
    a = _member(P, hub, "sfz", max_batch=2, spec_k=3)
    try:
        c = ServingFleetClient(hub.hostport, tag="sfz")
        assert len(c.generate([3, 7, 11], 12)) == 12
        _doc, row = _fleetz_row(a.addr, "sfz")
        assert 0.0 <= row["serving_spec_accept_pct"] <= 100.0
        text = _http(a.addr, "/fleetz?tag=sfz")
        assert "spec_accept=" in text and "spec%" in text
        obs_view = FleetObserver(hub.hostport, tag="sfz")
        fz = obs_view.fleetz()
        trow = next(r for r in fz["shards"] if r["addr"] == a.addr)
        assert trow["serving_spec_proposed"] > 0
        assert 0.0 <= trow["serving_spec_accept_pct"] <= 100.0
        assert fz["rollup"]["serving_spec_accept_pct"] == \
            trow["serving_spec_accept_pct"]
        assert "fleet_serving_spec_accept_pct" in obs_view.fleet_prometheus()
        assert "spec accept:" in _http(a.addr, "/sessionz")
        c.close()
    finally:
        _cleanup(hub, a)


# ---------------------------------------------------------------------------
# tests/test_paged_kv.py's fleet half.
# ---------------------------------------------------------------------------

@scenario
def paged_oneside_per_block_read_parity(P):
    from brpc_tpu_torch.serving import ServingFleetClient
    hub = _hub()
    a = _member(P, hub, "pgo", publish_kv=True, paged=True, block_rows=8)
    b = _member(P, hub, "pgo", publish_kv=True, paged=True, block_rows=8)
    _slowed(a)
    try:
        installs = []
        _oneside_spy(b, installs)
        c = ServingFleetClient(hub.hostport, tag="pgo")
        prompt, n_tok = list(range(2, 22)), 16
        key = _keys_owned_by(c, a.addr, 1, "pgo")[0]
        ts = _open_and_migrate(c, a, b, key, prompt, n_tok)
        rest = list(ts)
        assert ts.tokens == _serial(P, prompt, n_tok, 4)
        assert rest, "tokens kept flowing after the move"
        assert len(installs) == 1, \
            "published per-block KV must serve the migration read"
        assert installs[0], "the manifest carried the block slots"
        c.close()
        ts.close()
    finally:
        _cleanup(hub, a, b)


@scenario
def paged_migration_ships_only_missed_blocks(P):
    """After a first migration seeds the destination's prefix cache, a
    second same-prefix migration ships fewer KV bytes
    (torch_serving_migrated_kv_bytes counts what rode the wire)."""
    from brpc_tpu_torch.serving import ServingFleetClient, serving_metrics
    hub = _hub()
    a = _member(P, hub, "pgb", paged=True, block_rows=8)
    b = _member(P, hub, "pgb", paged=True, block_rows=8)
    _slowed(a)
    try:
        c = ServingFleetClient(hub.hostport, tag="pgb")
        prompt, n_tok = list(range(3, 43)), 16  # 40 tokens: 5 full blocks
        ref = _serial(P, prompt, n_tok, 4)
        counter = serving_metrics()["migrated_kv_bytes"]
        k1, k2 = _keys_owned_by(c, a.addr, 2, "pgb")
        before = counter.value()
        ts1 = _open_and_migrate(c, a, b, k1, prompt, n_tok)
        full_bytes = counter.value() - before
        assert full_bytes >= 2 * (len(prompt) + 2) * 32 * 4, full_bytes
        assert list(ts1) and ts1.tokens == ref
        before = counter.value()
        ts2 = _open_and_migrate(c, a, b, k2, prompt, n_tok)
        slim_bytes = counter.value() - before
        assert list(ts2) and ts2.tokens == ref
        assert slim_bytes < full_bytes, (slim_bytes, full_bytes)
        assert slim_bytes <= full_bytes - 2 * len(prompt) * 32 * 4 \
            + 2 * n_tok * 32 * 4, (slim_bytes, full_bytes)
        ts1.close()
        ts2.close()
        c.close()
    finally:
        _cleanup(hub, a, b)


@scenario
def paged_fleetz_prefix_hit_columns(P):
    from brpc_tpu_torch.observability.fleet_view import FleetObserver
    from brpc_tpu_torch.serving import ServingFleetClient
    hub = _hub()
    a = _member(P, hub, "pgz", max_batch=2, paged=True, block_rows=8)
    try:
        c = ServingFleetClient(hub.hostport, tag="pgz")
        prompt = list(range(2, 22))
        assert len(c.generate(prompt, 6)) == 6
        assert len(c.generate(prompt, 6)) == 6  # the hit
        text = _http(a.addr, "/fleetz?tag=pgz")
        assert "prefix_hit=" in text and "pfx%" in text
        obs_view = FleetObserver(hub.hostport, tag="pgz")
        fz = obs_view.fleetz()
        trow = next(r for r in fz["shards"] if r["addr"] == a.addr)
        assert trow["serving_prefix_hits"] >= 2
        assert trow["serving_prefix_hit_pct"] > 0
        assert fz["rollup"]["serving_prefix_hit_pct"] > 0
        assert "fleet_serving_prefix_hit_pct" in obs_view.fleet_prometheus()
        c.close()
    finally:
        _cleanup(hub, a)


# ---------------------------------------------------------------------------
# tests/test_serving.py::test_sessionz_and_generic_fleet_scrape, its fleet
# half.
# ---------------------------------------------------------------------------

@scenario
def serving_series_ride_the_generic_fleet_scrape(P):
    from brpc_tpu_torch.fleet import Registration
    from brpc_tpu_torch.observability.fleet_view import FleetObserver
    from brpc_tpu_torch.serving import ServingClient, ServingServer
    hub = _hub()
    srv = ServingServer(P, max_len=MAX_LEN, max_batch=2, device="cpu")
    port = srv.start()
    try:
        c = ServingClient(f"127.0.0.1:{port}", tenant="scrape-me")
        assert len(c.generate([3, 7, 11], 8)) == 8
        reg = Registration(hub.hostport, f"127.0.0.1:{port}",
                           tag="serve").start()
        obs_view = FleetObserver(hub.hostport, tag="serve")
        try:
            prom = obs_view.fleet_prometheus()
            assert (f'torch_serving_tokens{{shard="127.0.0.1:{port}"}}'
                    in prom), prom[:2000]
            assert "torch_serving_ttft_latency" in prom
            fz = obs_view.fleetz()
            assert any(r["addr"] == f"127.0.0.1:{port}" and r["reachable"]
                       for r in fz["shards"]), fz
        finally:
            reg.stop()
        c.close()
    finally:
        srv.stop()
        _cleanup(hub)


# ---------------------------------------------------------------------------
# The port's own.
# ---------------------------------------------------------------------------

@scenario
def drain_refused_install_resumes_only_that_session(P):
    """The destination's KV pool cannot hold the drain's first session
    (ELIMIT, even after paging its cold sessions out) while the two
    Installs behind it are in flight: that session alone resumes on the
    source, the other two move, no session is ever live on both
    members, and every stream keeps the serial trajectory."""
    from brpc_tpu_torch.serving import ServingFleetClient
    hub = _hub()
    a = _member(P, hub, "rf")
    # 5 blocks of 8 rows: the two short sessions fit (2 blocks each at
    # their end), the long one (6 or more blocks at the drain) cannot.
    b = _member(P, hub, "rf", paged=True, block_rows=8,
                kv_arena_bytes=5 * 2 * 8 * 32 * 4)
    _slowed(a, 0.02)
    try:
        refusals = []
        inner = b.manager.import_session

        def import_session(manifest, kv, _inner=inner):
            try:
                return _inner(manifest, kv)
            except native.RpcError as e:
                refusals.append((manifest["session"], e.code))
                raise

        b.manager.import_session = import_session
        c = ServingFleetClient(hub.hostport, tag="rf")
        keys = _keys_owned_by(c, a.addr, 3, "rf")
        specs = {keys[0]: (LONG_PROMPT, 20), keys[1]: ([3, 7], 14),
                 keys[2]: ([5, 2], 14)}
        refs = {k: _serial(P, p, n, 4) for k, (p, n) in specs.items()}
        # The long session first (it leads the drain's window), the
        # short ones once it streams, so all three are live at the drain.
        streams = {keys[0]: c.open(*specs[keys[0]], session_key=keys[0])}
        _read_until(streams[keys[0]], 3)
        for k in keys[1:]:
            streams[k] = c.open(*specs[k], session_key=k)
        for ts in streams.values():
            _read_until(ts, 3)
        moved = _drain_with_readers(a, streams)
        assert refusals == [(keys[0], native.TRPC_ELIMIT)], refusals
        assert moved == 2, moved
        for k, ts in streams.items():
            assert ts.tokens == refs[k], (k, ts.tokens, refs[k])
            _assert_single_home(k, a, b)
        assert a.manager.get(keys[0]).state == "done"
        assert b.manager.get(keys[0]) is None
        assert streams[keys[0]].resumes == 0
        for k in keys[1:]:
            assert a.manager.get(k).shed_reason == f"moved:{b.addr}"
            assert b.manager.get(k).state == "done"
            assert streams[k].resumes == 1
        for ts in streams.values():
            ts.close()
        c.close()
    finally:
        _cleanup(hub, a, b)


_JAX_MEMBER = r"""
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
from brpc_tpu.models.decoder import DecoderParams
import jax.numpy as jnp
values = dict(np.load(sys.argv[3]))
P = DecoderParams(**{k: jnp.asarray(v) for k, v in values.items()})
from brpc_tpu.serving import FleetServingServer
srv = FleetServingServer(sys.argv[2], P, tag=sys.argv[4], max_len=64,
                         max_batch=4, reg_ttl_s=3)
inner = srv.engine.step
def step():  # slowed, so a drain lands mid-stream
    time.sleep(0.05)
    return inner()
srv.engine.step = step
srv.start()
print(json.dumps({"addr": srv.addr}), flush=True)
for line in sys.stdin:
    cmd = line.strip()
    if cmd == "drain":
        print(json.dumps({"moved": srv.drain()}), flush=True)
    elif cmd.startswith("state "):
        s = srv.manager.get(cmd[6:])
        print(json.dumps({"state": s.state if s else None,
                          "reason": s.shed_reason if s else None}),
              flush=True)
    else:
        break
srv.stop()
"""


class _JaxMember:
    """A JAX package FleetServingServer in a process of its own (a
    second native library copy in this process is refused)."""

    def __init__(self, hub, params_path, tag):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        self.proc = subprocess.Popen(  # tpulint: allow(py-blocking)
            [sys.executable, "-c", _JAX_MEMBER, ROOT, hub.hostport,
             params_path, tag], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True, env=env)
        line = self.proc.stdout.readline()
        assert line, "the JAX member did not start"
        self.addr = json.loads(line)["addr"]

    def ask(self, cmd):
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()
        return json.loads(self.proc.stdout.readline())

    def close(self):
        try:
            self.proc.stdin.close()
            self.proc.wait(timeout=30)
        except Exception:  # noqa: BLE001 — teardown must reach the kill
            self.proc.kill()


@scenario
def mixed_fleet_drains_jax_to_port_and_back(P):
    """One hub, two JAX members in processes of their own and a port
    member here: a session opened on a JAX member drains to the port
    member, then from the port member to the other JAX member; the
    stream is prefix-exact against the JAX package's tokens (an input
    where every step is decided)."""
    from brpc_tpu_torch.serving import ServingFleetClient
    ref = REFS["mixed"]
    prompt, n_tok = ref["prompt"], len(ref["tokens"])
    hub = _hub()
    jax_members = []
    port = None
    try:
        jax_members = [_JaxMember(hub, ref["params"], "mx")
                       for _ in range(2)]
        port = _member(P, hub, "mx")
        _slowed(port, 0.05)
        c = ServingFleetClient(hub.hostport, tag="mx")
        c.router.refresh(force=True)
        assert len(c.router.members()) == 3
        # A key whose ring walk is JAX member, port member, JAX member:
        # each drain ships to the next member of the walk.
        key = next(k for k in (f"mx-{i}" for i in range(10000))
                   if c.router.candidates(k)[:2] == [jax_members[0].addr,
                                                     port.addr])
        j1, j2 = jax_members[0], jax_members[1]
        ts = c.open(prompt, n_tok, session_key=key)
        _read_until(ts, 2)
        assert j1.ask("drain")["moved"] == 1
        assert j1.ask(f"state {key}") == {"state": "shed",
                                          "reason": f"moved:{port.addr}"}
        _read_until(ts, 5)
        assert ts.addr == port.addr and port.manager.get(key) is not None
        assert port.drain() == 1
        rest = list(ts)
        assert rest, "tokens kept flowing after the second move"
        assert ts.tokens == ref["tokens"], (ts.tokens, ref["tokens"])
        assert ts.resumes == 2 and ts.addr == j2.addr
        assert port.manager.get(key).shed_reason == f"moved:{j2.addr}"
        assert j2.ask(f"state {key}")["state"] == "done"
        ts.close()
        c.close()
    finally:
        for m in jax_members:
            m.close()
        if port is not None:
            _cleanup(hub, port)
        else:
            _cleanup(hub)


# ---------------------------------------------------------------------------
# tests/test_fleet_view.py's live half, on a port fleet.
# ---------------------------------------------------------------------------

TAG = "obsfleet"

_SHARD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from brpc_tpu_torch.fleet import FleetServer
from brpc_tpu_torch.observability import tracing
s = FleetServer(sys.argv[2], tag=sys.argv[3], ttl_s=3, device="cpu")
addr = s.start()
tracing.rpcz_enable(True)  # after this process's first server started
print(json.dumps({"addr": addr}), flush=True)
sys.stdin.readline()
s.stop()
"""

_obs = {}


def _obs_fleet():
    """One 2-process port parameter fleet (shard subprocesses), a hub in
    this process, rpcz on here after the hub started, 12 tensors
    installed across both shards; built once, shared by the scenarios."""
    if _obs:
        return _obs
    from brpc_tpu_torch.fleet import FleetClient
    from brpc_tpu_torch.observability import tracing
    hub = _hub()
    tracing.rpcz_enable(True)
    tracing.rpcz_set_sample_1_in_n(1)
    procs = [subprocess.Popen(  # tpulint: allow(py-blocking)
        [sys.executable, "-c", _SHARD, ROOT, hub.hostport, TAG],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        for _ in range(2)]
    addrs = sorted(json.loads(p.stdout.readline())["addr"] for p in procs)
    fc = FleetClient(hub.hostport, tag=TAG, op_deadline_s=15.0,
                     device="cpu")
    names = [f"w{i:02d}" for i in range(12)]
    fc.refresh()
    for name in names:
        fc.install(name, np.full((256,), 1.0, np.float32))
    placement = {m["shard"] for m in fc.meta().values()}
    assert placement == set(addrs), placement
    _obs.update(hub=hub, procs=procs, addrs=addrs, fc=fc, names=names)
    return _obs


def _obs_teardown():
    if not _obs:
        return
    from brpc_tpu_torch.fleet import clear_registry
    _obs["fc"].close()
    for p in _obs["procs"]:
        try:
            p.stdin.close()
            p.wait(timeout=10)
        except Exception:  # noqa: BLE001 — teardown must reach the kill
            p.kill()
    clear_registry()
    _obs["hub"].stop()
    _obs.clear()


@scenario
def fleet_trace_assembly_two_processes(P):
    from brpc_tpu_torch.fleet import FleetObserver
    from brpc_tpu_torch.observability import tracing
    env = _obs_fleet()
    fc, names = env["fc"], env["names"]
    with tracing.trace_span("test/train_step") as root:
        got = fc.pull_all(names)
    assert sorted(got) == names
    assert root.trace_id != 0
    tr = FleetObserver(env["hub"].hostport, tag=TAG).assemble(root.trace_id)
    assert tr.rpcz_off == [] and tr.unreachable == []
    assert set(tr.sources) == {"local"} | set(env["addrs"]), tr.sources
    assert tr.root is not None
    assert tr.root["service_method"] == "test/train_step"
    assert tr.root["source"] == "local"
    by_id = {s["span_id"]: s for s in tr.spans}
    pulls = [s for s in tr.spans
             if s["service_method"] == "FleetClient/pull_all"]
    assert len(pulls) == 1
    assert pulls[0]["parent_span_id"] == tr.root["span_id"]
    for addr in env["addrs"]:
        server_spans = [s for s in tr.spans
                        if s["source"] == addr and s["server_side"]]
        assert server_spans, f"no server spans scraped from {addr}"
        for s in server_spans:
            parent = by_id.get(s["parent_span_id"])
            assert parent is not None, s
            assert parent["source"] == "local" and not parent["server_side"]
    for parent_id, children in tr.children.items():
        p = by_id[parent_id]
        for ch in children:
            assert ch["start_us"] >= p["start_us"], (p, ch)
            assert ch["end_us"] <= p["end_us"], (p, ch)
    starts = [s["start_us"] for s in tr.spans]
    assert starts == sorted(starts)
    text = tr.render()
    assert "test/train_step" in text and "FleetClient/pull_all" in text


@scenario
def fleetz_page_and_observer_parity(P):
    """The native /fleetz and FleetObserver.fleetz() agree on the
    columns the native page can read of a port fleet (membership,
    reachability, health, rpcz state, qps present), the merged
    exposition labels every series, and the rollup gauges repoint into
    this process's registry under torch_fleet_*."""
    from brpc_tpu_torch.fleet import FleetObserver
    from brpc_tpu_torch.observability import metrics as obsm
    env = _obs_fleet()
    fc, names = env["fc"], env["names"]
    for _ in range(3):
        fc.pull_all(names)
    hub_addr = env["hub"].hostport
    doc = json.loads(_http(hub_addr, f"/fleetz?tag={TAG}&format=json"))
    obs = FleetObserver(hub_addr, tag=TAG)
    pdoc = obs.fleetz()
    assert [s["addr"] for s in doc["shards"]] == env["addrs"]
    assert [s["addr"] for s in pdoc["shards"]] == env["addrs"]
    for native_row, twin_row in zip(doc["shards"], pdoc["shards"]):
        for col in ("addr", "reachable", "health", "rpcz_enabled"):
            assert native_row[col] == twin_row[col], (col, native_row,
                                                      twin_row)
        assert native_row["rpcz_enabled"] == 1
    for col in ("members", "reachable", "health_worst", "rpcz_off"):
        assert doc["rollup"][col] == pdoc["rollup"][col], col
    assert doc["rollup"]["qps_total"] > 0 and pdoc["rollup"]["qps_total"] > 0
    merged = obs.fleet_prometheus()
    for addr in env["addrs"]:
        assert f'fleet_shard_up{{shard="{addr}"}} 1' in merged
    series = [ln for ln in merged.splitlines()
              if ln and not ln.startswith("fleet_")]
    assert series and all('shard="' in ln for ln in series)
    assert "fleet_qps_total " in merged and "fleet_health_worst 0" in merged
    obs.publish_rollup_gauges()
    obs.fleetz()
    dumped = obsm.dump_vars("torch_fleet_")
    assert "torch_fleet_members_reachable : 2" in dumped, dumped
    assert "torch_fleet_health_worst : 0" in dumped


@scenario
def fleetz_names_rpcz_off_shards(P):
    from brpc_tpu_torch.fleet import FleetObserver
    from brpc_tpu_torch.observability import tracing
    env = _obs_fleet()
    victim = env["addrs"][0]
    assert "= 0" in _http(victim, "/flags/rpcz_enabled?setvalue=0")
    try:
        doc = json.loads(_http(env["hub"].hostport,
                               f"/fleetz?tag={TAG}&format=json"))
        assert doc["rollup"]["rpcz_off"] == [victim]
        obs = FleetObserver(env["hub"].hostport, tag=TAG)
        assert obs.fleetz()["rollup"]["rpcz_off"] == [victim]
        with tracing.trace_span("test/blind_pull") as root:
            pass
        assert obs.assemble(root.trace_id).rpcz_off == [victim]
    finally:
        assert "= 1" in _http(victim, "/flags/rpcz_enabled?setvalue=1")


@scenario
def sampling_flag_ab(P):
    from brpc_tpu_torch.observability import tracing
    _obs_fleet()
    assert tracing.rpcz_sample_1_in_n() == 1
    try:
        tracing.rpcz_set_sample_1_in_n(1 << 30)
        assert tracing.rpcz_sample_1_in_n() == 1 << 30
        for _ in range(8):
            with tracing.trace_span("test/unsampled") as h:
                pass
            assert (h.trace_id, h.span_id) == (0, 0)
        tracing.set_trace(0xabc, 0xdef)
        try:
            with tracing.trace_span("test/nested_sampled") as nested:
                pass
            assert nested.trace_id == 0xabc and nested.span_id != 0
        finally:
            tracing.clear_trace()
        spans = tracing.dump_rpcz(0xabc)
        assert [s["service_method"] for s in spans] == [
            "test/nested_sampled"]
        assert tracing.find_trace("test/nested_sampled") == f"{0xabc:016x}"
        try:
            tracing.rpcz_set_sample_1_in_n(0)
        except ValueError:
            pass
        else:
            raise AssertionError("rpcz_sample_1_in_n accepted 0")
        assert native.lib().tbrpc_flag_set(b"rpcz_sample_1_in_n",
                                           b"-5") != 0
    finally:
        tracing.rpcz_set_sample_1_in_n(1)
    with tracing.trace_span("test/sampled_again") as h:
        pass
    assert h.span_id != 0


@scenario
def dump_rpcz_disabled_is_typed(P):
    from brpc_tpu_torch.observability import tracing
    env = _obs_fleet()
    doc = json.loads(_http(env["addrs"][0], "/rpcz?format=json"))
    assert doc["enabled"] is True and isinstance(doc["spans"], list)
    assert doc["sample_1_in_n"] == 1
    tracing.rpcz_enable(False)
    try:
        try:
            tracing.dump_rpcz()
        except tracing.RpczDisabled as e:
            assert e.source == "local"
        else:
            raise AssertionError("dump_rpcz with rpcz off returned")
        local = json.loads(_http(env["hub"].hostport, "/rpcz?format=json"))
        assert local["enabled"] is False
    finally:
        tracing.rpcz_enable(True)


def main(argv) -> int:
    params_path, out_path, names = argv[1], argv[2], argv[3:]
    import torch

    from brpc_tpu_torch.observability import health

    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    values = dict(np.load(params_path))
    P = decoder_params_from_numpy(values, device="cpu")
    refs_path = os.path.join(os.path.dirname(params_path), "refs.json")
    if os.path.exists(refs_path):
        with open(refs_path) as f:
            REFS.update(json.load(f))
    dump_dir = tempfile.mkdtemp(prefix="torch_fleet_dumps")
    health.start_watchdog(dump_dir)
    results = {}
    try:
        for name in names:
            try:
                SCENARIOS[name](P)
                results[name] = None
            except Exception:  # noqa: BLE001 — reported to the parent test
                results[name] = traceback.format_exc()
    finally:
        _obs_teardown()
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
