"""The port's fleet observability plane against the JAX package's.

Pure half (this process): the JAX package's pure tests of
tests/test_fleet_view.py (skew estimation, cross-process trace assembly,
Prometheus relabeling, the /vars, exposition and /flags folds, the
rollup), each run on both packages' ``fleet_view`` with the same inputs:
the port's result must equal the JAX package's, and both must pass the
reference's assertions.

Live half: a port parameter fleet of two shard processes, its registry
hub and the observer in a third process that imports only the port
(tests/torch_serving_fleet_live.py): one client root span through
``FleetClient.pull_all`` assembled across the three processes, the
native /fleetz page against ``FleetObserver`` over the columns the page
can read, an rpcz-off shard named, the sampling flag, and the typed
``RpczDisabled``. Every process switches rpcz on after its first server
has started.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from brpc_tpu.observability import fleet_view as jfv
from brpc_tpu_torch.observability import fleet_view as tfv
from brpc_tpu_torch.observability import tracing

ZERO_ID = tfv.ZERO_ID
T = "00000000000000aa"
HERE = os.path.dirname(os.path.abspath(__file__))


def _span(trace, span, parent, source, start, end, server=False,
          method="m", annotations=()):
    return {"trace_id": trace, "span_id": span, "parent_span_id": parent,
            "server_side": server, "start_us": start, "end_us": end,
            "error_code": 0, "service_method": method, "peer": "",
            "annotations": list(annotations), "source": source}


def _two_shard_spans():
    """Client 'local', shard A 5 s ahead, shard B 3 s behind, with
    asymmetric network delays."""
    base = 1_000_000_000
    skew_a, skew_b = 5_000_000, -3_000_000
    spans = [
        _span(T, "r" + "0" * 15, ZERO_ID, "local", base, base + 10_000,
              method="root"),
        _span(T, "c1" + "0" * 14, "r" + "0" * 15, "local", base + 1_000,
              base + 5_000, method="A/pull"),
        _span(T, "c2" + "0" * 14, "r" + "0" * 15, "local", base + 1_200,
              base + 6_000, method="B/pull"),
        _span(T, "s1" + "0" * 14, "c1" + "0" * 14, "A",
              base + 2_000 + skew_a, base + 4_500 + skew_a, server=True,
              method="A/pull"),
        _span(T, "s2" + "0" * 14, "c2" + "0" * 14, "B",
              base + 2_200 + skew_b, base + 5_600 + skew_b, server=True,
              method="B/pull"),
    ]
    return spans, skew_a, skew_b


def _by_source(spans, *sources):
    return {src: [s for s in spans if s["source"] == src]
            for src in sources}


def _assemble_both(*args, **kw):
    """Assemble with both packages (each on its own copy of the spans:
    assembly corrects timestamps in copies, never the input) and require
    equal results; -> the port's trace."""
    got = tfv.assemble_trace(*json.loads(json.dumps(args)), **kw)
    want = jfv.assemble_trace(*json.loads(json.dumps(args)), **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.render() == want.render()
    assert list(got.walk()) == list(want.walk())
    return got


def _assert_nested(tr):
    by_id = {s["span_id"]: s for s in tr.spans}
    for parent_id, children in tr.children.items():
        p = by_id[parent_id]
        for c in children:
            assert c["start_us"] >= p["start_us"], (p, c)
            assert c["end_us"] <= p["end_us"], (p, c)


def test_skew_estimation_recovers_offsets():
    spans, skew_a, skew_b = _two_shard_spans()
    off = tfv.estimate_skew_us(spans)
    assert off == jfv.estimate_skew_us(spans)
    assert off["local"] == 0
    assert abs(off["A"] + skew_a) <= 300
    assert abs(off["B"] + skew_b) <= 300


def test_skew_intersection_beats_averaging():
    spans = [
        _span(T, "r" + "0" * 15, ZERO_ID, "local", 500, 4000,
              method="root"),
        _span(T, "c1" + "0" * 14, "r" + "0" * 15, "local", 1000, 2000),
        _span(T, "s1" + "0" * 14, "c1" + "0" * 14, "A", 1900, 1950,
              server=True),
        _span(T, "c2" + "0" * 14, "r" + "0" * 15, "local", 3000, 3100),
        _span(T, "s2" + "0" * 14, "c2" + "0" * 14, "A", 3010, 3090,
              server=True),
    ]
    off = tfv.estimate_skew_us(spans)
    assert off == jfv.estimate_skew_us(spans)
    assert -10 <= off["A"] <= 10
    _assert_nested(_assemble_both(T, _by_source(spans, "local", "A")))


def test_assemble_trace_monotone_and_parentage():
    spans, _a, _b = _two_shard_spans()
    tr = _assemble_both(T, _by_source(spans, "local", "A", "B"))
    assert tr.root is not None and tr.root["service_method"] == "root"
    assert tr.sources == ["A", "B", "local"]
    kids = {k: [c["span_id"] for c in v] for k, v in tr.children.items()}
    assert kids["r" + "0" * 15] == ["c1" + "0" * 14, "c2" + "0" * 14]
    assert kids["c1" + "0" * 14] == ["s1" + "0" * 14]
    _assert_nested(tr)
    order = [(d, s["span_id"]) for d, s in tr.walk()]
    assert order[0] == (0, "r" + "0" * 15)
    assert (1, "c1" + "0" * 14) in order and (2, "s1" + "0" * 14) in order
    assert tr.render().startswith(f"trace {T}")


def test_assemble_trace_dedup_orphans_and_honesty():
    spans, _a, _b = _two_shard_spans()
    local = [s for s in spans if s["source"] == "local"]
    orphan = _span(T, "ff" + "0" * 14, "ee" + "0" * 14, "A",
                   2_000_000_000, 2_000_001_000, server=True)
    other_trace = _span("00000000000000bb", "dd" + "0" * 14, ZERO_ID, "A",
                        5, 10)
    a_spans = [s for s in spans if s["source"] == "A"] + [orphan,
                                                          other_trace]
    tr = _assemble_both(T, {"local": local, "A": a_spans, "A2": a_spans},
                        rpcz_off=["B"], unreachable=["10.0.0.9:1"])
    assert all(s["trace_id"] == T for s in tr.spans)
    assert len([s for s in tr.spans if s["span_id"] == "s1" + "0" * 14]) == 1
    assert "ff" + "0" * 14 in [r["span_id"] for r in tr.roots]
    assert tr.rpcz_off == ["B"] and tr.unreachable == ["10.0.0.9:1"]
    assert "rpcz disabled" in tr.render() and "unreachable" in tr.render()


def test_skew_reference_prefers_client_side_orphan():
    base = 1_000_000_000
    skew_a = -3_000_000
    spans = [
        _span(T, "c1" + "0" * 14, "r" + "0" * 15, "local",
              base + 1_000, base + 5_000),
        _span(T, "s1" + "0" * 14, "c1" + "0" * 14, "A",
              base + 2_000 + skew_a, base + 4_000 + skew_a, server=True),
        _span(T, "s2" + "0" * 14, "ee" + "0" * 14, "A",
              base + 100 + skew_a, base + 200 + skew_a, server=True),
    ]
    ordered = sorted(spans, key=lambda s: s["start_us"])
    off = tfv.estimate_skew_us(ordered)
    assert off == jfv.estimate_skew_us(ordered)
    assert off["local"] == 0
    assert abs(off["A"] + skew_a) <= 1_000


def test_assemble_empty_trace():
    tr = _assemble_both(T, {"local": []}, rpcz_off=["local"])
    assert isinstance(tr, tfv.AssembledTrace)
    assert tr.root is None and tr.spans == [] and tr.rpcz_off == ["local"]


def test_relabel_exposition_injects_shard_label():
    text = ("# HELP x helptext\n"
            "# TYPE x counter\n"
            "rpc_server_qps 42\n"
            'thing{method="Pull"} 7\n')
    out = tfv.relabel_exposition(text, 'h"o:1')
    assert out == jfv.relabel_exposition(text, 'h"o:1')
    lines = out.splitlines()
    assert lines[0] == 'rpc_server_qps{shard="h\\"o:1"} 42'
    assert lines[1] == 'thing{method="Pull",shard="h\\"o:1"} 7'


VARS = ("rpc_server_param_service_pull_qps : 120\n"
        "rpc_server_param_service_pull_latency_99 : 900\n"
        "rpc_server_epoch_qps : 30\n"
        "rpc_server_epoch_latency_99 : 150\n"
        "tensor_codec_bytes_logical : 4000\n"
        "tensor_codec_bytes_wire : 1000\n"
        "param_server_version_lag_s0 : 3\n"
        "rpc_client_qps : 999\n")


def _torch_names(text):
    return "\n".join(("torch_" + ln) if ln.startswith(("tensor_", "param_"))
                     else ln for ln in text.splitlines()) + "\n"


@pytest.mark.parametrize("names", ["plain", "torch"])
def test_fold_vars_and_flags_and_rollup(names):
    """The folds agree with the JAX package's on the reference's text;
    with the port's torch_ series names the port folds the same
    columns."""
    want = jfv.fold_vars(VARS)
    text = VARS if names == "plain" else _torch_names(VARS)
    folded = tfv.fold_vars(text)
    assert folded == want
    assert folded["qps"] == 150.0 and folded["p99_us"] == 900
    assert folded["version_lag_max"] == 3
    expo = text.replace(" : ", " ")
    assert tfv.fold_exposition(
        "# TYPE rpc_server_epoch_qps gauge\n" + expo) == folded
    assert jfv.fold_exposition(VARS.replace(" : ", " ")) == want
    flags_text = ("rpcz_enabled = 1  # collect spans\n"
                  "rpcz_sample_1_in_n = 64 (default 1)  # sampling\n")
    assert tfv.fold_flags(flags_text) == jfv.fold_flags(flags_text) == {
        "rpcz_enabled": 1, "rpcz_sample_1_in_n": 64}
    rows = [dict(addr="a:1", reachable=True, health="ok", **folded,
                 rpcz_enabled=1),
            dict(addr="b:2", reachable=True, health="degraded", qps=50.0,
                 p99_us=2000, codec_bytes_logical=0, codec_bytes_wire=0,
                 version_lag_max=7, rpcz_enabled=0),
            {"addr": "c:3", "reachable": False, "health": "unreachable"}]
    roll = tfv.rollup(rows)
    assert roll == jfv.rollup(rows)
    assert roll["members"] == 3 and roll["reachable"] == 2
    assert roll["qps_total"] == 200.0 and roll["p99_max_us"] == 2000
    assert roll["health_worst"] == "unreachable"
    assert roll["version_lag_max"] == 7 and roll["codec_ratio"] == 4.0
    assert roll["rpcz_off"] == ["b:2"]
    assert tfv.rollup([]) == jfv.rollup([])
    assert tfv.rollup([])["health_worst"] == "empty"


def test_rpcz_disabled_is_a_typed_runtime_error():
    e = tracing.RpczDisabled("10.0.0.1:7")
    assert isinstance(e, RuntimeError) and e.source == "10.0.0.1:7"
    assert "rpcz is disabled on 10.0.0.1:7" in str(e)
    assert tracing.RpczDisabled().source == "local"


# ---------------------------------------------------------------------------
# Live: a port parameter fleet of two shard processes, observed from a
# third that imports only the port.
# ---------------------------------------------------------------------------

LIVE = ["fleet_trace_assembly_two_processes",
        "fleetz_page_and_observer_parity",
        "fleetz_names_rpcz_off_shards",
        "sampling_flag_ab",
        "dump_rpcz_disabled_is_typed"]


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    from conftest import require_native_lib
    require_native_lib()
    from brpc_tpu.models import decoder as jdec
    import jax
    d = tmp_path_factory.mktemp("torch_fleet_view_live")
    np.savez(d / "params.npz", **{
        k: np.asarray(v) for k, v in
        jdec.init_decoder(jax.random.PRNGKey(0))._asdict().items()})
    out = d / "results.json"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    t0 = time.monotonic()
    r = subprocess.run(
        [sys.executable, os.path.join(HERE, "torch_serving_fleet_live.py"),
         str(d / "params.npz"), str(out), *LIVE],
        capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0 and out.exists(), (
        f"rc {r.returncode} after {time.monotonic() - t0:.1f} s\n"
        f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    results = json.loads(out.read_text())
    assert results["_watchdog"] is None, results["_watchdog"]
    return results


@pytest.mark.parametrize("name", LIVE)
def test_live_fleet_view(live, name):
    assert live[name] is None, live[name]
