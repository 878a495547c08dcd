"""The port's single-node serving plane against the JAX package's, on the
CPU: the twins of tests/test_serving.py, the single-node parts of
tests/test_spec_decode.py and tests/test_paged_kv.py, and sessions
exported by one package and continued by the other.

The decoder's parameters are the JAX package's ``init_decoder(PRNGKey(0))``
carried across, the sizes the JAX tests' (vocab 64, dim 32, max_len 64).
Every engine runs on the CPU (``device="cpu"``).

Parity. The engine's tokens are held to ``decode_serial(...,
lanes=max_batch)``, the session alone in lane 0 of the engine's own lane
count: a matmul over one row and over several may order its sums
differently, so the port holds batched == serial on one shape by
construction (the JAX package compares against one lane; on XLA:CPU the
two shapes round alike). Within the port, paged == monolithic, spec-on ==
spec-off and export -> import == unmigrated hold exactly. Across the
packages, the tokens equal the JAX package's ``decode_serial`` on these
prompts (tests/test_torch_decoder.py holds the step math to a tolerance).

Live half: every scenario that starts a ``ServingServer`` runs in a
process of its own (tests/torch_serving_live.py) — ``/gen`` and the
``/sessionz`` slot are one per process, and a worker that ran the JAX
package's serving tests holds them — and each test here asserts on that
scenario's result. The fleet-dependent cases of the JAX files
(``FleetServingServer``, ``FleetObserver``, /fleetz) wait for the serving
fleet's slice.
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
from brpc_tpu.serving import engine as jengine
from brpc_tpu.serving import session as jsession
from brpc_tpu_torch.models.decoder import decode_serial
from brpc_tpu_torch.runtime import native
from brpc_tpu_torch.runtime import tensor as ttensor
from brpc_tpu_torch.runtime.param_server import E_NO_SUCH
from brpc_tpu_torch.runtime.state import decoder_params_from_numpy
from brpc_tpu_torch.serving import (ACTIVE, DONE, FROZEN, QUEUED, SHED,
                                    CallableSink, DecodeEngine,
                                    SessionManager)

JP = jdec.init_decoder(jax.random.PRNGKey(0))
NP = {k: np.asarray(v) for k, v in JP._asdict().items()}
PARAMS = decoder_params_from_numpy(NP, device="cpu")
MAX_LEN = 64
R = 8                       # block_rows of the paged tests
BLOCK_NBYTES = 2 * R * 32 * 4
SHORT_PROMPTS = [[3, 7, 11], [5, 2], [9, 4, 1]]
LONG_PROMPT = list(range(1, 41))
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module", autouse=True)
def native_env(tmp_path_factory):
    from conftest import require_native_lib
    require_native_lib()
    from brpc_tpu_torch.observability import health
    health.start_watchdog(str(tmp_path_factory.mktemp("torch_serving")))
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    # One intra-op thread: these steps are tiny, and on a host whose
    # cores the other test workers keep busy a parallel region waits for
    # every one of its threads to be scheduled (100x slower each step).
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
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


def paged_manager(**kw):
    kw.setdefault("paged", True)
    kw.setdefault("block_rows", R)
    return manager(**kw)


def engine(mgr, **kw):
    kw.setdefault("device", "cpu")
    return DecodeEngine(mgr, PARAMS, **kw)


class TokenCollector:
    """CallableSink helper: decodes T-frames, remembers the close."""

    def __init__(self):
        self.tokens = []
        self.sink = CallableSink(self._on)

    def _on(self, frame: bytes):
        if frame.startswith(b"T"):
            self.tokens.append(int(frame[1:]))


def run_engine(eng, sessions, steps=300):
    for _ in range(steps):
        progressed = eng.step()
        if not progressed and all(s.state in (DONE, SHED)
                                  for s in sessions):
            return
    raise AssertionError(
        f"engine did not finish: {[s.state for s in sessions]}")


# ---------------------------------------------------------------------------
# The engine and the session manager (tests/test_serving.py's pure half).
# ---------------------------------------------------------------------------

def test_decode_serial_deterministic_and_prompt_sensitive():
    a = serial([3, 7, 11], 8, 1)
    assert a == serial([3, 7, 11], 8, 1)
    assert a != serial([5, 2], 8, 1)
    assert len(a) <= 8 and len(set(a)) > 2


def test_batched_engine_matches_serial_token_for_token():
    """Two sessions admitted at different step boundaries decode to
    exactly the serial tokens — and to the JAX package's."""
    mgr = manager()
    eng = engine(mgr, max_batch=4)
    c1, c2 = TokenCollector(), TokenCollector()
    s1 = mgr.open([3, 7, 11], 8, c1.sink)
    eng.step()  # s1 alone for a step
    s2 = mgr.open([5, 2], 8, c2.sink)  # admitted mid-generation of s1
    for _ in range(40):
        if not eng.step():
            break
    assert s1.state == DONE and s2.state == DONE
    assert c1.tokens == serial([3, 7, 11], 8, 4)
    assert c2.tokens == serial([5, 2], 8, 4)
    assert c1.tokens == jdec.decode_serial(JP, [3, 7, 11], 8, MAX_LEN)
    assert c2.tokens == jdec.decode_serial(JP, [5, 2], 8, MAX_LEN)


def test_admission_prefers_high_priority_when_lanes_scarce():
    mgr = manager()
    eng = engine(mgr, max_batch=1)
    bulk = mgr.open([3], 4, TokenCollector().sink,
                    priority=native.PRIORITY_BULK)
    high = mgr.open([5], 4, TokenCollector().sink,
                    priority=native.PRIORITY_HIGH)
    eng.step()
    assert high.state == ACTIVE, "HIGH jumps the single lane"
    assert bulk.state == QUEUED


def test_slow_reader_pending_buffer_sheds_only_that_session():
    mgr = manager(stall_timeout_s=0.05)
    eng = engine(mgr, max_batch=4)

    class FullSink:
        def __init__(self):
            self.closed_with = None

        def emit(self, frame):
            return "full"

        def close(self, error=""):
            self.closed_with = error

    stuck_sink = FullSink()
    stuck = mgr.open([3, 7, 11], 8, stuck_sink)
    ok = TokenCollector()
    healthy = mgr.open([5, 2], 8, ok.sink)
    deadline = time.monotonic() + 20
    while (healthy.state != DONE or stuck.state not in (DONE, SHED)) \
            and time.monotonic() < deadline:
        eng.step()
        time.sleep(0.005)
    assert healthy.state == DONE
    assert ok.tokens == serial([5, 2], 8, 4)
    assert stuck.state == SHED and stuck.shed_reason == "slow reader"
    assert stuck_sink.closed_with == "slow reader"


def test_deadline_sheds_between_steps():
    mgr = manager()
    eng = engine(mgr, max_batch=2)
    col = TokenCollector()
    sess = mgr.open([3, 7], 40, col.sink, deadline_s=0.05)
    eng.step()
    emitted_before = len(col.tokens)
    time.sleep(0.08)
    eng.step()  # the boundary check fires BEFORE the model runs
    assert sess.state == SHED and sess.shed_reason == "deadline expired"
    assert col.sink.closed_with == "deadline expired"
    assert len(col.tokens) == emitted_before


def test_ttl_evicts_idle_sessions():
    mgr = manager(ttl_s=0.05)
    sess = mgr.open([3], 4, CallableSink(lambda f: None))
    assert mgr.evict_expired() == []
    time.sleep(0.08)
    assert mgr.evict_expired() == [sess] and sess.state == SHED
    assert sess.shed_reason == "idle past ttl"


def test_tenant_session_quota_sheds_with_retry_hint():
    mgr = manager(tenant_max_sessions=2)
    mgr.open([1], 4, CallableSink(lambda f: None), tenant="a")
    mgr.open([2], 4, CallableSink(lambda f: None), tenant="a")
    with pytest.raises(native.RpcError) as ei:
        mgr.open([3], 4, CallableSink(lambda f: None), tenant="a")
    assert ei.value.overloaded and ei.value.retry_after_ms is not None
    other = mgr.open([4], 4, CallableSink(lambda f: None), tenant="b")
    assert other.state == QUEUED
    doc = mgr.sessionz_doc()
    assert doc["shed_total"] == 1 and doc["active"] == 3


def test_kv_arena_accounting_and_reuse():
    mgr = manager()
    per_session = 2 * MAX_LEN * mgr.dim * 4
    s1 = mgr.open([1, 2], 4, CallableSink(lambda f: None))
    assert mgr.sessionz_doc()["kv_bytes"] == per_session
    off1 = s1.kv_off
    mgr.finish(s1)
    assert mgr.sessionz_doc()["kv_bytes"] == 0
    s2 = mgr.open([3], 4, CallableSink(lambda f: None))
    assert s2.kv_off == off1, "a freed KV range is reused"
    assert float(np.sum(s2.kv_k)) == 0.0, "a reused cache arrives zeroed"


def test_prompt_budget_validated_against_kv_window():
    mgr = manager()
    with pytest.raises(native.RpcError):
        mgr.open(list(range(60)), 10, CallableSink(lambda f: None))
    with pytest.raises(native.RpcError):
        mgr.open([], 4, CallableSink(lambda f: None))


def test_manager_raises_when_the_native_library_fails(monkeypatch):
    """No host-arena stand-in: the KV pages are the native arena's."""
    def broken():
        raise OSError("libbrpc_tpu.so: cannot open shared object file")

    monkeypatch.setattr(ttensor, "lib", broken)
    with pytest.raises(OSError, match="libbrpc_tpu"):
        SessionManager(max_len=MAX_LEN)


def test_engine_and_server_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is usable")
    from brpc_tpu_torch.serving import ServingServer
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(manager(), PARAMS)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingServer(PARAMS, max_len=MAX_LEN)


# ---------------------------------------------------------------------------
# Speculative decoding (tests/test_spec_decode.py's single-node half).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft", ["ngram", "model"])
@pytest.mark.parametrize("spec_k", [1, 3, 4])
def test_spec_engine_parity_batched(draft, spec_k):
    n_tok = 14
    prompts = SHORT_PROMPTS + [LONG_PROMPT]
    refs = [serial(p, n_tok, 4) for p in prompts]
    mgr = manager()
    eng = engine(mgr, max_batch=4, spec_k=spec_k, draft=draft)
    outs, sessions = [], []
    for p in prompts:
        col = TokenCollector()
        outs.append(col.tokens)
        sessions.append(mgr.open(p, n_tok, col.sink))
        eng.step()  # stagger: later sessions join a running batch
    run_engine(eng, sessions)
    assert outs == refs


def test_spec_engine_parity_single_with_eos():
    ref = serial([3, 7, 11], 16, 2)
    eos_ref = serial([3, 7, 11], 16, 2, eos_id=ref[2])
    mgr = manager()
    eng = engine(mgr, max_batch=2, eos_id=ref[2], spec_k=4, draft="model",
                 draft_params=PARAMS)
    col = TokenCollector()
    sess = mgr.open([3, 7, 11], 16, col.sink)
    run_engine(eng, [sess])
    assert col.tokens == eos_ref and len(col.tokens) < len(ref)
    assert sess.state == DONE


def test_spec_adversarial_clamps_k_to_one_and_keeps_parity():
    n_tok = 24
    refs = [serial(p, n_tok, 4) for p in SHORT_PROMPTS]
    mgr = manager()
    eng = engine(mgr, max_batch=4, spec_k=4, draft="model")
    outs, sessions = [], []
    for p in SHORT_PROMPTS:
        col = TokenCollector()
        outs.append(col.tokens)
        sessions.append(mgr.open(p, n_tok, col.sink))
    run_engine(eng, sessions)
    assert outs == refs
    assert all(s.spec_k == 1 for s in sessions), [s.spec_k for s in sessions]
    doc = mgr.sessionz_doc()
    assert doc["spec_proposed"] > 0 and doc["spec_accept_pct"] < 30.0


def test_spec_acceptance_drives_k_up_and_multi_token_steps():
    n_tok = 20
    refs = [serial(p, n_tok, 2, eos_id=-1) for p in SHORT_PROMPTS[:2]]
    mgr = manager()
    eng = engine(mgr, max_batch=2, eos_id=-1, spec_k=4, draft="model",
                 draft_params=PARAMS)
    outs, sessions = [], []
    for p in SHORT_PROMPTS[:2]:
        col = TokenCollector()
        outs.append(col.tokens)
        sessions.append(mgr.open(p, n_tok, col.sink))
    run_engine(eng, sessions)
    assert outs == refs
    assert eng.steps < n_tok, f"no multi-token steps happened: {eng.steps}"
    assert mgr.sessionz_doc()["spec_accept_pct"] > 60.0
    assert all(s.spec_k >= 3 for s in sessions), [s.spec_k for s in sessions]


def test_spec_kill_switch_toggles_live_without_perturbing_output():
    n_tok = 18
    mgr = manager()
    eng = engine(mgr, max_batch=2, spec_k=3)
    col = TokenCollector()
    sess = mgr.open([5, 2], n_tok, col.sink)
    for flip in range(40):
        eng.step()
        eng.spec_k = 0 if flip % 2 else 3  # toggle every boundary
        if sess.state == DONE:
            break
    run_engine(eng, [sess])
    assert col.tokens == serial([5, 2], n_tok, 2)


def test_spec_never_exposes_draft_rows():
    """Only ACCEPTED rows reach the session's planes, and a spy oneside
    window sees publishes at accepted positions only."""
    published = []

    class SpyWindow:
        def publish(self, name, off, nbytes, version, own=True):
            published.append((name, version))

        def begin_rewrite(self, name):
            pass

        def unpublish(self, name):
            pass

    n_tok = 16
    mgr = manager()
    mgr.oneside = SpyWindow()
    eng = engine(mgr, max_batch=2, spec_k=4, draft="model")
    col = TokenCollector()
    sess = mgr.open([3, 7, 11], n_tok, col.sink)
    pos_log = []
    for _ in range(200):
        eng.step()
        pos_log.append(sess.pos)
        if sess.kv_k is not None:
            assert not np.asarray(sess.kv_k[sess.pos:]).any()
            assert not np.asarray(sess.kv_v[sess.pos:]).any()
        if sess.state in (DONE, SHED):
            break
    assert sess.state == DONE
    assert col.tokens == serial([3, 7, 11], n_tok, 2)
    versions = [v for _name, v in published]
    assert versions and all(v in pos_log or v == 0 for v in versions)


def test_spec_migration_round_trip_parity_and_ephemeral_state():
    n_tok = 16
    ref = serial([3, 7, 11], n_tok, 2)
    src = manager()
    esrc = engine(src, max_batch=2, spec_k=3, draft="model",
                  draft_params=PARAMS)
    got = []
    sink = CallableSink(lambda f: got.append(int(f[1:]))
                        if f.startswith(b"T") else None)
    sess = src.open([3, 7, 11], n_tok, sink, sid="smig-1")
    for _ in range(3):
        esrc.step()
    assert 0 < len(got) < n_tok, "migrate MID-stream"
    assert src.freeze(sess)
    esrc.step()  # the lane sweep frees the lane, keeps the KV
    manifest, kv = src.export_session(sess)
    assert kv.shape == (2, sess.pos, 32)
    src.finish(sess, shed_reason="moved:dst",
               shed_code=native.E_SESSION_MOVED)
    dst = manager()
    edst = engine(dst, max_batch=2, spec_k=3, draft="model",
                  draft_params=PARAMS)
    sess2 = dst.import_session(manifest, kv)
    assert sess2.spec_k == 0 and sess2.spec_ema == 1.0
    dst.attach_sink(sess2, CallableSink(
        lambda f: got.append(int(f[1:])) if f.startswith(b"T") else None),
        have=len(got))
    run_engine(edst, [sess2])
    assert got == ref


def test_spec_prefill_handoff_parity_and_eos_clamp():
    n_tok = 10
    for eos in (0, serial([9, 4, 1], n_tok, 2)[0]):
        ref = serial([9, 4, 1], n_tok, 2, eos_id=eos)
        pre = manager()
        epre = engine(pre, max_batch=2, eos_id=eos, spec_k=3)
        frozen = []
        epre.on_session_frozen = frozen.append
        col = TokenCollector()
        sess = pre.open([9, 4, 1], n_tok, col.sink, prefill_handoff=True)
        for _ in range(10):
            epre.step()
            if frozen:
                break
        assert frozen == [sess] and sess.state == FROZEN
        assert col.tokens == [], "prefill must not stream"
        assert sess.emitted == 1 and sess.out_tokens == [ref[0]]
        assert sess.pos == len(sess.prompt)
        if ref[0] == eos:
            assert sess.max_tokens == 1, "EOS clamps at the handoff"
        manifest, kv = pre.export_session(sess)
        dec = manager()
        edec = engine(dec, max_batch=2, eos_id=eos, spec_k=3)
        sess2 = dec.import_session(manifest, kv)
        out = []
        replayed = dec.attach_sink(sess2, CallableSink(
            lambda f: out.append(int(f[1:]))
            if f.startswith(b"T") else None), have=0)
        assert replayed == 1
        run_engine(edec, [sess2])
        assert out == ref, (eos, out, ref)


def test_sessionz_spec_columns_pure():
    mgr = manager()
    eng = engine(mgr, max_batch=2, spec_k=2, draft="model")
    col = TokenCollector()
    sess = mgr.open([3, 7], 8, col.sink)
    run_engine(eng, [sess])
    doc = json.loads(mgr.sessionz_json())
    assert doc["spec_proposed"] > 0
    assert 0.0 <= doc["spec_accept_pct"] <= 100.0
    assert all("spec_k" in row for row in doc["sessions"])


# ---------------------------------------------------------------------------
# Paged KV (tests/test_paged_kv.py's single-node half).
# ---------------------------------------------------------------------------

def test_pool_alloc_account_and_release():
    mgr = paged_manager()
    cap = mgr._pool_cap
    assert cap >= 64 and mgr.block_rows == R
    sess = mgr.open(list(range(1, 11)), 4, TokenCollector().sink)
    assert len(sess.block_table) == 2          # ceil(11/8)
    assert sess.kv_nbytes == 2 * BLOCK_NBYTES
    doc = mgr.sessionz_doc()
    assert doc["paged_mode"] and doc["block_rows"] == R
    assert doc["kv_bytes"] == 2 * BLOCK_NBYTES
    assert mgr._blocks_free() == cap - 2
    mgr.finish(sess)
    assert mgr.sessionz_doc()["kv_bytes"] == 0
    assert mgr._blocks_free() == cap


def test_block_rows_shrinks_to_max_len_divisor():
    mgr = SessionManager(max_len=48, kv_arena_bytes=1 << 20, paged=True,
                         block_rows=10)
    assert mgr.block_rows == 8


def test_shared_prefix_hits_sharing_and_parity():
    mgr = paged_manager()
    eng = engine(mgr, max_batch=4)
    prompt = list(range(2, 22))               # 20 tokens: 2 full blocks
    n_tok = 6
    ref = serial(prompt, n_tok, 4)
    c1 = TokenCollector()
    s1 = mgr.open(prompt, n_tok, c1.sink)
    run_engine(eng, [s1])
    assert c1.tokens == ref
    doc = mgr.sessionz_doc()
    assert doc["prefix_misses"] == 2 and doc["prefix_hits"] == 0
    assert doc["kv_blocks_cached"] == 2
    c2, c3 = TokenCollector(), TokenCollector()
    s2 = mgr.open(prompt, n_tok, c2.sink)
    assert s2.pos == 2 * R, "prefill skipped the cached full blocks"
    s3 = mgr.open(prompt, n_tok, c3.sink)
    assert s2.block_table[:2] == s3.block_table[:2]
    doc = mgr.sessionz_doc()
    assert doc["prefix_hits"] == 4 and doc["prefix_hit_pct"] == 66.7
    assert doc["kv_blocks_shared"] == 2
    run_engine(eng, [s2, s3])
    assert c2.tokens == ref and c3.tokens == ref


@pytest.mark.parametrize("spec_k", [0, 3])
def test_paged_parity_with_serial_spec_on_and_off(spec_k):
    mgr = paged_manager()
    eng = engine(mgr, max_batch=4, spec_k=spec_k)
    prompts = [[3, 7, 11], [5, 2], list(range(1, 17)), list(range(2, 22))]
    n_tok = 10
    refs = [serial(p, n_tok, 4) for p in prompts]
    for _round in range(2):  # the second round hits every prompt block
        cols = [TokenCollector() for _ in prompts]
        sessions = [mgr.open(p, n_tok, c.sink)
                    for p, c in zip(prompts, cols)]
        run_engine(eng, sessions)
        for p, c, r in zip(prompts, cols, refs):
            assert c.tokens == r, f"prompt {p}: {c.tokens} != {r}"
    assert mgr.sessionz_doc()["prefix_hits"] >= 3


@pytest.mark.parametrize("spec_k", [0, 3])
def test_paged_equals_monolithic_bit_for_bit(spec_k):
    """The same sessions on a paged and a monolithic manager: equal
    tokens and bit-equal committed KV rows (the gather hands the
    attention the monolithic lanes' values, and masked rows weigh an
    exact 0)."""
    prompts = [[3, 7, 11], list(range(1, 17)), list(range(2, 22)), [5, 2]]
    runs = []
    for paged in (False, True):
        mgr = manager(paged=paged, block_rows=R)
        eng = engine(mgr, max_batch=4, spec_k=spec_k)
        cols = [TokenCollector() for _ in prompts]
        sessions = [mgr.open(p, 12, c.sink, sid=f"eq{i}")
                    for i, (p, c) in enumerate(zip(prompts, cols))]
        for _ in range(6):
            eng.step()
        kvs = []
        for s in sessions:
            if s.state != ACTIVE:
                continue
            assert mgr.freeze(s)
        eng.step()
        for s in sessions:
            if s.state == FROZEN:
                kvs.append(mgr.export_session(s)[1])
        runs.append(([c.tokens for c in cols], kvs))
    (mono_tok, mono_kv), (paged_tok, paged_kv) = runs
    assert mono_tok == paged_tok
    assert len(mono_kv) == len(paged_kv) > 0
    for a, b in zip(mono_kv, paged_kv):
        np.testing.assert_array_equal(a, b)


def test_cow_fires_on_block_aligned_cache_hit_and_preserves_cache():
    mgr = paged_manager()
    eng = engine(mgr, max_batch=2)
    prompt = list(range(1, 17))               # exactly 2 blocks
    ref = serial(prompt, 6, 2)
    c1 = TokenCollector()
    s1 = mgr.open(prompt, 6, c1.sink)
    run_engine(eng, [s1])
    with mgr._mu:
        cached_bid = mgr._prefix_cache[s1.prompt_digests[1]]
        before = np.array(mgr._pool_k[cached_bid])
    c2 = TokenCollector()
    s2 = mgr.open(prompt, 6, c2.sink)
    assert s2.pos == len(prompt) - 1, "never skip the final prompt row"
    assert s2.block_table[1] == cached_bid
    eng.step()  # re-ingests row 15 into the shared block: CoW fires
    assert s2.block_table[1] != cached_bid
    run_engine(eng, [s2])
    assert c2.tokens == ref and c1.tokens == ref
    assert mgr.sessionz_doc()["cow_faults"] >= 1
    with mgr._mu:
        assert mgr._prefix_cache[s1.prompt_digests[1]] == cached_bid
        assert np.array_equal(np.array(mgr._pool_k[cached_bid]), before)


def test_block_spill_and_fault_in_bit_exact():
    mgr = paged_manager()
    eng = engine(mgr, max_batch=1)
    sess = mgr.open([3, 7, 11], 8, TokenCollector().sink)
    for _ in range(4):
        eng.step()
    mgr.freeze(sess)
    eng.step()                                # lane sweep
    mgr.unfreeze(sess)
    with mgr._mu:
        k_before, v_before = mgr._gather_rows_locked(sess)
    assert mgr.page_out(sess)
    assert sess.paged and sess.block_table == []
    doc = mgr.sessionz_doc()
    assert doc["kv_bytes"] == 0
    assert doc["kv_spilled_bytes"] == 2 * sess.pos * mgr.dim * 4
    assert mgr.fault_in(sess)
    assert not sess.paged and sess.block_table
    with mgr._mu:
        k_after, v_after = mgr._gather_rows_locked(sess)
    assert np.array_equal(k_after, k_before)
    assert np.array_equal(v_after, v_before)
    assert mgr.sessionz_doc()["kv_spilled_bytes"] == 0


def test_monolithic_spill_and_fault_in_continue_exactly():
    """A cold monolithic session pages out and back, and its tokens
    still equal the unpaged trajectory."""
    mgr = manager()
    eng = engine(mgr, max_batch=1)
    col = TokenCollector()
    sess = mgr.open([3, 7, 11], 10, col.sink)
    for _ in range(5):
        eng.step()
    mgr.freeze(sess)
    eng.step()
    mgr.unfreeze(sess)
    assert mgr.page_out(sess) and sess.kv_k is None
    assert mgr.sessionz_doc()["kv_spilled_bytes"] == 2 * sess.pos * 32 * 4
    run_engine(eng, [sess])  # admission faults it back in
    assert col.tokens == serial([3, 7, 11], 10, 1)


def test_pool_pressure_pages_cold_session_then_elimit():
    mgr = paged_manager(kv_arena_bytes=2 * BLOCK_NBYTES)
    assert mgr._pool_cap == 2
    s1 = mgr.open(list(range(1, 11)), 4, TokenCollector().sink)
    assert len(s1.block_table) == 2
    with pytest.raises(native.RpcError) as ei:
        mgr.open(list(range(1, 21)), 4, TokenCollector().sink)
    assert ei.value.code == native.TRPC_ELIMIT
    assert "retry_after_ms" in str(ei.value)
    assert s1.paged, "pressure paged the cold session before giving up"
    s2 = mgr.open([5, 2], 4, TokenCollector().sink)
    assert len(s2.block_table) == 1


def test_ttl_evicts_warm_cached_blocks():
    mgr = paged_manager(ttl_s=0.05)
    eng = engine(mgr, max_batch=1)
    s1 = mgr.open(list(range(2, 22)), 4, TokenCollector().sink)
    run_engine(eng, [s1])
    doc = mgr.sessionz_doc()
    assert doc["kv_blocks_cached"] == 2 and doc["kv_bytes"] > 0
    time.sleep(0.12)
    mgr.evict_expired()
    doc = mgr.sessionz_doc()
    assert doc["kv_blocks_cached"] == 0 and doc["kv_bytes"] == 0


def _mid_stream_export(mgr, eng, prompt, n_tok, sid, got):
    sess = mgr.open(prompt, n_tok, CallableSink(
        lambda f: got.append(int(f[1:])) if f.startswith(b"T") else None),
        sid=sid)
    for _ in range(40):
        eng.step()
        if len(got) >= 3:
            break
    assert 0 < len(got) < n_tok, "export MID-stream"
    assert mgr.freeze(sess)
    eng.step()
    assert mgr.exportable(sess)
    return sess, mgr.export_session(sess)


def _resume(mgr, eng, manifest, kv, got):
    sess = mgr.import_session(manifest, kv)
    assert sess.state == QUEUED
    mgr.attach_sink(sess, CallableSink(
        lambda f: got.append(int(f[1:])) if f.startswith(b"T") else None),
        have=len(got))
    run_engine(eng, [sess])
    return sess


def test_migration_round_trip_paged_token_parity():
    n_tok = 12
    prompt = list(range(2, 22))
    src = paged_manager()
    esrc = engine(src, max_batch=2)
    got = []
    sess, (manifest, kv) = _mid_stream_export(src, esrc, prompt, n_tok,
                                              "pg-mig-1", got)
    assert manifest["block_rows"] == R
    nfull = len(prompt) // R
    assert len(manifest["blocks"]) == -(-sess.pos // R)
    assert all(d is not None for d in manifest["blocks"][:nfull])
    assert all(d is None for d in manifest["blocks"][nfull:])
    src.finish(sess, shed_reason="moved:dst",
               shed_code=native.E_SESSION_MOVED)
    dst = paged_manager()
    _resume(dst, engine(dst, max_batch=2), manifest, kv, got)
    assert got == serial(prompt, n_tok, 2)
    s3 = dst.open(prompt, 4, TokenCollector().sink)
    assert s3.pos == nfull * R, "the install seeded the prefix cache"


def test_partial_kv_blocks_payload_installs_bit_exact():
    prompt = list(range(2, 22))
    n_tok = 12
    src = paged_manager()
    esrc = engine(src, max_batch=1)
    got = []
    sess, (manifest, kv) = _mid_stream_export(src, esrc, prompt, n_tok,
                                              "pg-slim-1", got)
    dst = paged_manager()
    edst = engine(dst, max_batch=1)
    warm = dst.open(prompt, 4, TokenCollector().sink)
    run_engine(edst, [warm])
    need = dst.probe_prefix(manifest["blocks"], manifest["block_rows"])
    nfull = len(prompt) // R
    assert need == list(range(nfull, len(manifest["blocks"])))
    assert dst.probe_prefix(manifest["blocks"], R // 2) == \
        list(range(len(manifest["blocks"])))
    pos = manifest["pos"]
    slim = np.ascontiguousarray(np.concatenate(
        [kv[:, j * R:min(pos, j * R + R), :] for j in need], axis=1))
    assert slim.nbytes < kv.nbytes
    src.finish(sess, shed_reason="moved:dst",
               shed_code=native.E_SESSION_MOVED)
    sess2 = dst.import_session(dict(manifest, kv_blocks=need), slim)
    with dst._mu:
        k2, v2 = dst._gather_rows_locked(sess2)
    assert np.array_equal(k2, kv[0]) and np.array_equal(v2, kv[1])
    dst.attach_sink(sess2, CallableSink(
        lambda f: got.append(int(f[1:])) if f.startswith(b"T") else None),
        have=len(got))
    run_engine(edst, [sess2])
    assert got == serial(prompt, n_tok, 1)


def test_partial_payload_to_monolithic_server_rejected():
    mono = manager()
    manifest = {"session": "x-1", "prompt": [1, 2, 3], "max_tokens": 4,
                "pos": 3, "dim": 32, "kv_blocks": [0], "block_rows": R}
    with pytest.raises(native.RpcError) as ei:
        mono.import_session(manifest, np.zeros((2, 3, 32), np.float32))
    assert ei.value.code == native.TRPC_EINTERNAL
    assert "partial block payload" in str(ei.value)


def test_missing_block_neither_shipped_nor_cached_is_no_such():
    dst = paged_manager()
    free_before = dst._blocks_free()
    manifest = {"session": "x-2", "prompt": list(range(1, 17)),
                "max_tokens": 4, "pos": 17, "dim": 32, "block_rows": R,
                "kv_blocks": [2],
                "blocks": ["deadbeefdeadbeef", "feedfacefeedface", None]}
    with pytest.raises(native.RpcError) as ei:
        dst.import_session(manifest, np.zeros((2, 1, 32), np.float32))
    assert ei.value.code == E_NO_SUCH
    assert dst._blocks_free() == free_before, "rollback leaked blocks"


# ---------------------------------------------------------------------------
# Across the packages: a session exported by one continues on the other.
# ---------------------------------------------------------------------------

def _jax_manager(paged):
    return jsession.SessionManager(max_len=MAX_LEN, kv_arena_bytes=1 << 20,
                                   paged=paged, block_rows=R)


@pytest.mark.parametrize("paged", [False, True])
def test_jax_export_continues_on_the_port(paged):
    prompt, n_tok = list(range(2, 22)), 14
    ref = jdec.decode_serial(JP, prompt, n_tok, MAX_LEN)
    src = _jax_manager(paged)
    esrc = jengine.DecodeEngine(src, JP, max_batch=2)
    got = []
    try:
        sess, (manifest, kv) = _mid_stream_export(src, esrc, prompt, n_tok,
                                                  "x-jax", got)
        src.finish(sess, shed_reason="moved:port",
                   shed_code=native.E_SESSION_MOVED)
    finally:
        src.shutdown()
    dst = manager(paged=paged, block_rows=R)
    sess2 = _resume(dst, engine(dst, max_batch=2), manifest, kv, got)
    assert got == ref and sess2.state == DONE


@pytest.mark.parametrize("paged", [False, True])
def test_port_export_continues_on_jax(paged):
    prompt, n_tok = list(range(2, 22)), 14
    ref = jdec.decode_serial(JP, prompt, n_tok, MAX_LEN)
    src = manager(paged=paged, block_rows=R)
    got = []
    sess, (manifest, kv) = _mid_stream_export(
        src, engine(src, max_batch=2), prompt, n_tok, "x-port", got)
    dst = _jax_manager(paged)
    try:
        _resume(dst, jengine.DecodeEngine(dst, JP, max_batch=2), manifest,
                kv, got)
    finally:
        dst.shutdown()
    assert got == ref


def test_export_manifests_agree_across_packages():
    """The same session stepped equally far in both packages exports the
    same manifest (block digests included) and KV rows within the
    decoder's tolerance."""
    prompt = list(range(2, 22))
    docs = []
    for mgr, eng in ((_jax_manager(True), None), (paged_manager(), None)):
        eng = (jengine.DecodeEngine(mgr, JP, max_batch=2)
               if isinstance(mgr, jsession.SessionManager)
               else engine(mgr, max_batch=2))
        sess = mgr.open(prompt, 8, CallableSink(lambda f: None), sid="m-1")
        for _ in range(23):
            eng.step()
        mgr.freeze(sess)
        eng.step()
        docs.append(mgr.export_session(sess))
        if isinstance(mgr, jsession.SessionManager):
            mgr.shutdown()
    (jm, jkv), (tm, tkv) = docs
    assert jm == tm
    np.testing.assert_allclose(tkv, jkv, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Live: every scenario with a ServingServer, in a process of its own.
# ---------------------------------------------------------------------------

LIVE = ["two_streamed_sessions_incremental_and_parity",
        "stream_over_tpu_transport",
        "slow_reader_never_delays_the_other_session",
        "tenant_quota_sheds_third_session_mid_batch",
        "ttl_eviction_closes_stream_with_e_frame",
        "open_without_stream_is_a_clean_error",
        "sessionz_and_vars",
        "http_fallback_streams_progressively",
        "spec_streamed_parity_and_ab_toggle",
        "paged_serving_parity_and_surfaces",
        "resume_on_a_single_server_is_no_method"]


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_serving_live")
    np.savez(d / "params.npz", **NP)
    out = d / "results.json"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run(
        [sys.executable, os.path.join(HERE, "torch_serving_live.py"),
         str(d / "params.npz"), str(out), *LIVE],
        capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0 and out.exists(), (
        f"rc {r.returncode}\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    results = json.loads(out.read_text())
    assert results["_watchdog"] is None, results["_watchdog"]
    return results


@pytest.mark.parametrize("name", LIVE)
def test_live_serving(live, name):
    assert live[name] is None, live[name]
