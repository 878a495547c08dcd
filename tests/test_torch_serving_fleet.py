"""The port's serving fleet against the JAX package's, on the CPU: the
twins of tests/test_serving_fleet.py, the fleet halves of
tests/test_spec_decode.py, tests/test_paged_kv.py and
tests/test_serving.py, and sessions migrated across the two packages.

Pure half (this process): the port's ``ServingRouter`` and the JAX one
give the same owner and the same spill chain for the same members, and
bias it alike (penalty box, load); the error classification keys on the
codes; freeze -> export -> import round trips between port managers and
JAX -> port -> JAX between managers of both packages, with manifests and
KV bytes equal at every hop; the prefill handoff, its EOS case and its
local fallback; KV page-out and the bytes path of a paged-out session;
the /fleetz fold and rollup against the JAX package's on the same text,
the port's ``torch_`` series read where the JAX package reads the plain
ones.

Parity of tokens. Within the port, tokens are held to ``decode_serial(...,
lanes=max_batch)`` bit for bit (tests/test_torch_serving.py says why the
lane count). Where the packages meet, tokens must be equal on inputs
where every greedy step is decided: the float64 top-2 logit gap of each
step exceeds GAP_TOL (tests/test_torch_decoder.py's rule), checked here
by a float64 numpy decode.

Live half: every scenario that starts a server runs in ONE subprocess
that imports only the port (tests/torch_serving_fleet_live.py; /gen,
/sessionz and the tbvar namespace are one per process), and each test
here asserts on its scenario's result. The mixed fleet's JAX member runs
in a process of its own beside it, on the same registry hub.
"""

import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from brpc_tpu.models import decoder as jdec
from brpc_tpu.observability import fleet_view as jfv
from brpc_tpu.serving import engine as jengine
from brpc_tpu.serving import router as jrouter
from brpc_tpu.serving import session as jsession
from brpc_tpu_torch.fleet.shard_map import ShardMap
from brpc_tpu_torch.models.decoder import decode_serial
from brpc_tpu_torch.observability import fleet_view as tfv
from brpc_tpu_torch.runtime import native
from brpc_tpu_torch.runtime.state import decoder_params_from_numpy
from brpc_tpu_torch.serving import (DONE, FROZEN, QUEUED, CallableSink,
                                    DecodeEngine, ServingRouter,
                                    SessionManager, SessionShed)
from brpc_tpu_torch.serving.session import FRAME_TOKEN

JP = jdec.init_decoder(jax.random.PRNGKey(0))
NP = {k: np.asarray(v) for k, v in JP._asdict().items()}
PARAMS = decoder_params_from_numpy(NP, device="cpu")
MAX_LEN = 64
GAP_TOL = 1e-3
MIXED = {"prompt": [3, 7, 11], "n_tok": 30}
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module", autouse=True)
def native_env(tmp_path_factory):
    from conftest import require_native_lib
    require_native_lib()
    from brpc_tpu_torch.observability import health
    health.start_watchdog(str(tmp_path_factory.mktemp("torch_fleet")))
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny steps: see tests/test_torch_serving.py
    yield
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision(prev)
    deadline = time.monotonic() + 10
    while health.state() == "stalled" and time.monotonic() < deadline:
        time.sleep(0.1)
    assert health.state() != "stalled", health.last_dump_path()


def serial(prompt, n, lanes, eos_id=0):
    return decode_serial(PARAMS, prompt, n, MAX_LEN, eos_id, lanes=lanes)


def manager(**kw):
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("kv_arena_bytes", 1 << 20)
    return SessionManager(**kw)


def engine(mgr, **kw):
    kw.setdefault("device", "cpu")
    return DecodeEngine(mgr, PARAMS, **kw)


def collector(out):
    return CallableSink(lambda f: out.append(int(f[1:]))
                        if f.startswith(b"T") else None)


def run_to_done(eng, *sessions, steps=200):
    for _ in range(steps):
        eng.step()
        if all(s.state in (DONE, "shed") for s in sessions):
            return
    raise AssertionError([s.state for s in sessions])


def np_decode(prompt, n):
    """Greedy decode in float64 numpy (the decoder's math): -> (tokens,
    the smallest top-2 logit gap over the generated steps)."""
    p = {k: v.astype(np.float64) for k, v in NP.items()}
    dim = p["wq"].shape[0]
    kv_k = np.zeros((MAX_LEN, dim))
    kv_v = np.zeros((MAX_LEN, dim))
    out, gaps = [], []
    for pos in range(len(prompt) + n - 1):
        tok = prompt[pos] if pos < len(prompt) else out[-1]
        row = min(pos, p["pos"].shape[0] - 1)
        x = p["embed"][tok] + p["pos"][row]
        kv_k[pos], kv_v[pos] = x @ p["wk"], x @ p["wv"]
        s = kv_k[:pos + 1] @ (x @ p["wq"]) / np.sqrt(dim)
        w = np.exp(s - s.max())
        logits = ((w / w.sum()) @ kv_v[:pos + 1] @ p["wo"]
                  + 0.5 * p["pos"][row]) @ p["embed"].T
        if pos >= len(prompt) - 1:
            top2 = np.sort(logits)[-2:]
            gaps.append(top2[1] - top2[0])
            out.append(int(logits.argmax()))
            if len(out) == n:
                break
    return out, min(gaps)


def decided_ref(prompt, n):
    """The JAX package's tokens for an input where every step is decided
    (float64 agrees and every top-2 gap exceeds GAP_TOL)."""
    ref = jdec.decode_serial(JP, prompt, n, MAX_LEN)
    f64, gap = np_decode(prompt, n)
    assert f64 == ref and gap > GAP_TOL, (prompt, gap)
    return ref


# ---------------------------------------------------------------------------
# The router and the error classification.
# ---------------------------------------------------------------------------

MEMBERS = [f"10.0.0.{i}:7{i:03d}" for i in range(1, 6)]


def test_router_matches_the_jax_router_for_200_keys():
    """The same static members give the same owner and the same spill
    chain in both packages, on instances that share nothing else."""
    ports = [ServingRouter(members=list(MEMBERS)),
             ServingRouter(members=list(reversed(MEMBERS)))]
    jr = jrouter.ServingRouter(members=list(MEMBERS))
    owners = set()
    for i in range(200):
        sid = f"sess-{i}"
        for r in ports:
            assert r.route(sid) == jr.route(sid)
            assert r.candidates(sid) == jr.candidates(sid)
        owners.add(ports[0].route(sid))
    assert owners == set(MEMBERS)


def test_router_penalty_box_matches_the_jax_router():
    members = ["a:1", "b:2", "c:3"]
    r, jr = ServingRouter(members=members), jrouter.ServingRouter(
        members=members)
    sid = "sticky-session"
    walk = r.candidates(sid)
    assert walk == jr.candidates(sid) and walk[0] == r.route(sid)
    assert sorted(walk) == sorted(members)
    for x in (r, jr):
        x.penalize(walk[0], for_s=30)
    walk2 = r.candidates(sid)
    assert walk2 == jr.candidates(sid)
    assert walk2[-1] == walk[0] and sorted(walk2) == sorted(members)
    assert r.route(sid) == walk[0], "route() stays pure placement"
    r.penalize(walk[1], for_s=0.01)
    time.sleep(0.03)
    assert r.candidates(sid) == walk2


def test_router_load_bias_matches_the_jax_router():
    """Load reorders the spill half lightest-first, the owner stays
    first, the penalty box overrides; the port reads torch_serving_*
    where the JAX router reads serving_*."""
    members = ["a:1", "b:2", "c:3", "d:4"]
    r, jr = ServingRouter(members=members), jrouter.ServingRouter(
        members=members)
    sid = "load-sess"
    base = r.candidates(sid)
    assert base == jr.candidates(sid)
    owner, spill = base[0], base[1:]

    def text(sessions, tokens_s, prefix=""):
        return (f"{prefix}serving_sessions : {sessions}\n"
                f"{prefix}serving_token_emit_qps : {tokens_s}\n")

    loads = {spill[0]: (9, 900)}
    loads.update({a: (1, 10) for a in spill[1:-1]})
    loads[spill[-1]] = (0, 0)
    for addr, load in loads.items():
        r.ingest_load(addr, text(*load, prefix="torch_"))
        jr.ingest_load(addr, text(*load))
    walk = r.candidates(sid)
    assert walk == jr.candidates(sid)
    assert walk[0] == owner and walk[-1] == spill[0] and walk[1] == spill[-1]
    for x in (r, jr):
        x.penalize(spill[-1], for_s=30)
    assert r.candidates(sid) == jr.candidates(sid)
    assert r.candidates(sid)[-1] == spill[-1]
    r.close()
    jr.close()


def test_router_load_scrape_pass_uses_fetch_seam():
    r = ServingRouter(members=["a:1", "b:2"], load_ttl_s=0.05)
    fetched = []

    def fake_fetch(addr):
        fetched.append(addr)
        return ("torch_serving_sessions : 5\n" if addr == "a:1"
                else "torch_serving_sessions : 0\n")

    r._fetch_vars = fake_fetch
    r.scrape_loads()
    assert sorted(fetched) == ["a:1", "b:2"]
    now = time.monotonic()
    assert r._load_key("a:1", 0, now)[0] == 5
    assert r._load_key("b:2", 0, now)[0] == 0
    time.sleep(0.2)
    assert r._load_key("a:1", 0, time.monotonic())[0] == 0
    r.close()


def test_preference_limit_counts_override_head():
    m = ShardMap(["a:1", "b:2", "c:3"], overrides={"pinned-key": "c:3"})
    assert m.preference("pinned-key")[0] == "c:3"
    assert m.preference("pinned-key", limit=1) == ["c:3"]
    assert len(m.preference("pinned-key", limit=2)) == 2


def test_error_classification_draining_and_moved():
    from brpc_tpu.runtime import native as jnative
    assert native.E_DRAINING == jnative.E_DRAINING == 2047
    e = native.RpcError(native.E_DRAINING,
                        "server 1.2.3.4:5 draining (retry_after_ms=100)")
    assert e.draining and not e.overloaded
    assert e.retry_after_ms == 100 and e.moved_to is None
    m = native.RpcError(native.E_SESSION_MOVED,
                        "session s7 moved:10.0.0.2:7002")
    assert m.moved_to == "10.0.0.2:7002" and not m.draining
    # Keyed on the code: the same text under another code is no move.
    assert native.RpcError(2041, "parameter x moved:10.0.0.2:7002"
                           ).moved_to is None
    assert SessionShed("moved:10.0.0.9:7009",
                       code=native.E_SESSION_MOVED).moved == "10.0.0.9:7009"
    assert SessionShed("slow reader").moved is None


# ---------------------------------------------------------------------------
# Freeze, export, import (the engine-level core of a live migration).
# ---------------------------------------------------------------------------

def _mid_stream_export(mgr, eng, prompt, n_tok, sid, got, steps):
    sess = mgr.open(prompt, n_tok, collector(got), sid=sid)
    for _ in range(steps):
        eng.step()
    assert 0 < len(got) < n_tok, "export MID-stream"
    assert mgr.freeze(sess)
    eng.step()  # the sweep parks the lane, keeps the KV
    assert mgr.exportable(sess)
    return sess, mgr.export_session(sess)


def test_migration_round_trip_token_parity():
    n_tok = 12
    src = manager()
    esrc = engine(src, max_batch=2)
    got = []
    sess, (manifest, kv) = _mid_stream_export(src, esrc, [3, 7, 11], n_tok,
                                              "mig-1", got, 6)
    assert manifest["pos"] == sess.pos and kv.shape == (2, sess.pos, 32)
    src.finish(sess, shed_reason="moved:dst",
               shed_code=native.E_SESSION_MOVED)
    assert sess.sink.closed_code == native.E_SESSION_MOVED
    dst = manager()
    edst = engine(dst, max_batch=2)
    sess2 = dst.import_session(manifest, kv)
    assert sess2.id == "mig-1" and sess2.state == QUEUED
    edst.step()
    assert sess2.lane == -1, "PARKED: never admitted before a sink attaches"
    assert dst.attach_sink(sess2, collector(got), len(got)) == 0
    run_to_done(edst, sess2)
    assert got == serial([3, 7, 11], n_tok, 2)


def test_migration_replays_tokens_the_client_missed():
    n_tok = 10
    src = manager()
    esrc = engine(src, max_batch=2)
    got = []
    _sess, (manifest, kv) = _mid_stream_export(src, esrc, [5, 2], n_tok,
                                               "mig-2", got, 5)
    have = max(0, len(got) - 2)  # the client lost two tokens in flight
    client_view = got[:have]
    dst = manager()
    edst = engine(dst, max_batch=2)
    sess2 = dst.import_session(manifest, kv)
    assert dst.attach_sink(sess2, collector(client_view), have) == \
        len(got) - have
    run_to_done(edst, sess2)
    assert client_view == serial([5, 2], n_tok, 2)


def _jax_manager():
    return jsession.SessionManager(max_len=MAX_LEN, kv_arena_bytes=1 << 20)


def test_jax_to_port_to_jax_keeps_manifests_bytes_and_tokens():
    """A session exported by the JAX package, imported and stepped by the
    port, exported again and finished by the JAX package: each import
    re-exports the manifest and KV bytes it received, and the stream
    equals the JAX package's on a decided input."""
    prompt, n_tok = [3, 7, 11], 24
    ref = decided_ref(prompt, n_tok)
    got = []
    j1 = _jax_manager()
    try:
        sess, (m1, kv1) = _mid_stream_export(
            j1, jengine.DecodeEngine(j1, JP, max_batch=2), prompt, n_tok,
            "x-rt", got, 6)
        j1.finish(sess, shed_reason="moved:port",
                  shed_code=native.E_SESSION_MOVED)
    finally:
        j1.shutdown()
    port = manager()
    peng = engine(port, max_batch=2)
    psess = port.import_session(m1, kv1)
    port.freeze(psess)
    m1b, kv1b = port.export_session(psess)
    assert m1b == m1 and kv1b.tobytes() == np.asarray(kv1).tobytes()
    port.unfreeze(psess)
    port.attach_sink(psess, collector(got), len(got))
    for _ in range(6):
        peng.step()
    assert len(got) < n_tok
    port.freeze(psess)
    peng.step()
    m2, kv2 = port.export_session(psess)
    port.finish(psess, shed_reason="moved:jax",
                shed_code=native.E_SESSION_MOVED)
    j2 = _jax_manager()
    try:
        jsess = j2.import_session(m2, kv2)
        j2.freeze(jsess)
        m2b, kv2b = j2.export_session(jsess)
        assert m2b == m2 and np.asarray(kv2b).tobytes() == kv2.tobytes()
        j2.unfreeze(jsess)
        j2.attach_sink(jsess, jsession.CallableSink(
            lambda f: got.append(int(f[1:])) if f.startswith(b"T")
            else None), len(got))
        jeng = jengine.DecodeEngine(j2, JP, max_batch=2)
        for _ in range(200):
            jeng.step()
            if jsess.state == DONE:
                break
    finally:
        j2.shutdown()
    assert got == ref, (got, ref)


def test_prefill_handoff_freezes_at_first_token():
    n_tok = 8
    pre = manager()
    epre = engine(pre, max_batch=2)
    frozen = []
    epre.on_session_frozen = frozen.append
    seen = []
    sess = pre.open([9, 4, 1], n_tok, collector(seen), prefill_handoff=True)
    for _ in range(10):
        epre.step()
        if frozen:
            break
    ref = serial([9, 4, 1], n_tok, 2)
    assert frozen == [sess] and sess.state == FROZEN
    assert seen == [], "prefill must not stream"
    assert sess.emitted == 1 and sess.out_tokens == [ref[0]]
    assert sess.pos == len(sess.prompt) and pre.exportable(sess)
    manifest, kv = pre.export_session(sess)
    pre.finish(sess, shed_reason="moved:decode",
               shed_code=native.E_SESSION_MOVED)
    dec = manager()
    edec = engine(dec, max_batch=2)
    sess2 = dec.import_session(manifest, kv)
    out = []
    assert dec.attach_sink(sess2, collector(out), have=0) == 1
    run_to_done(edec, sess2)
    assert out == ref


def test_prefill_handoff_respects_eos_on_first_token():
    eos = serial([3, 7, 11], 8, 2)[0]
    colocated = serial([3, 7, 11], 8, 2, eos_id=eos)
    pre = manager()
    epre = engine(pre, max_batch=2, eos_id=eos)
    frozen = []
    epre.on_session_frozen = frozen.append
    sess = pre.open([3, 7, 11], 8, collector([]), prefill_handoff=True)
    for _ in range(10):
        epre.step()
        if frozen:
            break
    assert sess.out_tokens == [eos] and sess.max_tokens == 1
    manifest, kv = pre.export_session(sess)
    dec = manager()
    edec = engine(dec, max_batch=2, eos_id=eos)
    sess2 = dec.import_session(manifest, kv)
    out = []
    dec.attach_sink(sess2, collector(out), have=0)
    run_to_done(edec, sess2)
    assert out == [eos] == colocated[:1] and sess2.state == DONE


def test_prefill_local_fallback_loses_nothing():
    """No decode member: the frozen prefill session resumes locally, its
    recorded-but-unstreamed first token queued first (the fleet server's
    _resume_local, inlined)."""
    n_tok = 6
    mgr = manager()
    eng = engine(mgr, max_batch=2)
    frozen = []
    eng.on_session_frozen = frozen.append
    out = []
    sess = mgr.open([3, 7], n_tok, collector(out), prefill_handoff=True)
    for _ in range(10):
        eng.step()
        if frozen:
            break
    assert sess.state == FROZEN and out == []
    frame = FRAME_TOKEN + str(sess.out_tokens[-1]).encode()
    sess.pending.append(frame)
    sess.pending_bytes += len(frame)
    sess.prefill_handoff = False
    mgr.unfreeze(sess)
    run_to_done(eng, sess)
    assert sess.state == DONE and out == serial([3, 7], n_tok, 2)


def test_paged_out_session_migrates_via_bytes():
    """A session paged out to the host spill store exports from there
    and continues on the destination (the bytes path)."""
    n_tok = 8
    src = manager()
    esrc = engine(src, max_batch=1)
    got = []
    sess = src.open([5, 2], n_tok, collector(got))
    for _ in range(4):
        esrc.step()
    src.freeze(sess)
    esrc.step()
    with src._mu:
        src._page_out_locked(sess)
    manifest, kv = src.export_session(sess)
    assert kv.shape[1] == sess.pos
    dst = manager()
    edst = engine(dst, max_batch=1)
    sess2 = dst.import_session(manifest, kv)
    dst.attach_sink(sess2, collector(got), have=len(got))
    run_to_done(edst, sess2)
    assert got == serial([5, 2], n_tok, 1)


# ---------------------------------------------------------------------------
# The /fleetz fold and rollup against the JAX package's.
# ---------------------------------------------------------------------------

SERVING_VARS = ("serving_token_emit_qps : 1234\n"
                "serving_sessions : 7\n"
                "serving_ttft_latency_99 : 4500\n"
                "serving_spec_proposed : 200\n"
                "serving_spec_accepted : 150\n"
                "serving_prefix_hits : 6\n"
                "serving_prefix_misses : 2\n"
                "tensor_codec_bytes_logical : 4000\n"
                "tensor_codec_bytes_wire : 1000\n"
                "param_server_version_lag_s0 : 3\n"
                "rpc_server_echo_qps : 10\n"
                "rpc_server_echo_latency_99 : 900\n")


def _ported(text):
    """The same series under the port's names (rpc_server_* are the
    native runtime's, shared by both packages)."""
    return "\n".join(ln if ln.startswith("rpc_server_") else "torch_" + ln
                     for ln in text.splitlines()) + "\n"


def test_fleetz_fold_matches_jax_with_torch_names_mapped():
    want = jfv.fold_vars(SERVING_VARS)
    assert tfv.fold_vars(SERVING_VARS) == want
    assert tfv.fold_vars(_ported(SERVING_VARS)) == want
    assert want["serving_spec_accept_pct"] == 75.0
    assert want["serving_prefix_hit_pct"] == 75.0
    expo = SERVING_VARS.replace(" : ", " ")
    assert tfv.fold_exposition(_ported(expo)) == jfv.fold_exposition(expo)
    # Both names present (a process holding both packages): the port
    # reads the torch_ series, column by column.
    both = tfv.fold_vars("torch_serving_sessions : 3\n"
                         "serving_sessions : 9\n"
                         "serving_token_emit_qps : 5\n")
    assert both["serving_sessions"] == 3 and both["serving_tokens_s"] == 5.0


def test_fleetz_rollup_matches_jax():
    fold = tfv.fold_vars(_ported(SERVING_VARS))
    rows = [dict(fold, addr="a:1", reachable=True, health="ok",
                 rpcz_enabled=1),
            {"addr": "b:2", "reachable": True, "health": "degraded",
             "serving_tokens_s": 766.0, "serving_sessions": 3,
             "serving_ttft_p99_us": 9000, "serving_spec_proposed": 100,
             "serving_spec_accepted": 0, "rpcz_enabled": 0},
            {"addr": "c:3", "reachable": False, "health": "unreachable"}]
    roll = tfv.rollup(rows)
    assert roll == jfv.rollup(rows)
    assert roll["serving_tokens_s_total"] == 2000.0
    assert roll["serving_sessions_total"] == 10
    assert roll["serving_spec_accept_pct"] == 50.0
    assert roll["health_worst"] == "unreachable"
    assert roll["rpcz_off"] == ["b:2"]
    assert tfv.FleetObserver._rollup_exposition(roll) == \
        jfv.FleetObserver._rollup_exposition(roll)


# ---------------------------------------------------------------------------
# Live: every scenario with a server, in a process of its own.
# ---------------------------------------------------------------------------

LIVE = ["routing_determinism_and_sticky_opens",
        "drain_migration_token_parity",
        "draining_server_sheds_opens_with_code",
        "prefill_decode_split",
        "oneside_kv_consumer_and_bytes_fallback",
        "fleetz_serving_columns_native_and_twin",
        "spec_drain_migration_parity",
        "spec_prefill_decode_split_parity",
        "fleetz_spec_accept_columns_twin",
        "paged_oneside_per_block_read_parity",
        "paged_migration_ships_only_missed_blocks",
        "paged_fleetz_prefix_hit_columns",
        "serving_series_ride_the_generic_fleet_scrape",
        "drain_refused_install_resumes_only_that_session",
        "mixed_fleet_drains_jax_to_port_and_back"]


def run_live(tmp_path_factory, names, refs=None):
    """Run ``names`` in one fresh interpreter that imports only the port;
    -> {name: None | traceback}."""
    d = tmp_path_factory.mktemp("torch_fleet_live")
    np.savez(d / "params.npz", **NP)
    if refs is not None:
        refs = {k: dict(v, params=str(d / "params.npz"))
                for k, v in refs.items()}
        (d / "refs.json").write_text(json.dumps(refs))
    out = d / "results.json"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run(
        [sys.executable, os.path.join(HERE, "torch_serving_fleet_live.py"),
         str(d / "params.npz"), str(out), *names],
        capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0 and out.exists(), (
        f"rc {r.returncode}\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    results = json.loads(out.read_text())
    assert results["_watchdog"] is None, results["_watchdog"]
    return results


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    refs = {"mixed": {"prompt": MIXED["prompt"],
                      "tokens": decided_ref(MIXED["prompt"],
                                            MIXED["n_tok"])}}
    return run_live(tmp_path_factory, LIVE, refs)


@pytest.mark.parametrize("name", LIVE)
def test_live_serving_fleet(live, name):
    assert live[name] is None, live[name]
