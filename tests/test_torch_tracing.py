"""The port's span mechanism (``observability.tracing``): stage Adders on
/vars, rpcz annotations only while rpcz is on, profiler ranges only while
a profiler runs (from every thread of an all-threads profiler), the
server's ``serve`` / ``queue_wait`` stages, and the wire's byte counters,
which CPU copies leave alone."""

import json
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from brpc_tpu_torch.observability import metrics, tracing
from brpc_tpu_torch.parallel import ps_process
from brpc_tpu_torch.runtime import native
from brpc_tpu_torch.runtime import param_server as tps
from brpc_tpu_torch.runtime import step_driver
from brpc_tpu_torch.runtime import tensor as ttensor

SHAPES = {"w_a": (64, 64), "w_b": (37, 300), "bias": (100,)}


@pytest.fixture(scope="module")
def live():
    """A CPU ParameterServer in this process and a client of it. Started
    before any test switches rpcz on."""
    from conftest import require_native_lib
    require_native_lib()
    rng = np.random.default_rng(0)
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for k, s in SHAPES.items()}
    ps = tps.ParameterServer(params, lr=0.05, momentum=0.8, device="cpu")
    port = ps.start()
    cl = tps.ParameterClient(f"tpu://127.0.0.1:{port}", device="cpu")
    cl.meta()
    yield ps, cl
    cl.close()
    ps.stop()


@pytest.fixture
def rpcz(live):
    """Switch rpcz on (sampling every trace) for one test, then back."""
    was_on, old_n = tracing.rpcz_enabled(), tracing.rpcz_sample_1_in_n()

    def switch(on: bool) -> None:
        tracing.rpcz_enable(on)
        tracing.rpcz_set_sample_1_in_n(1)

    yield switch
    tracing.rpcz_set_sample_1_in_n(old_n)
    tracing.rpcz_enable(was_on)


def profiling() -> bool:
    """The one flag ``stage`` and ``trace_span`` read."""
    return torch.autograd.profiler._is_profiler_enabled


def _value(name: str) -> int:
    return metrics.counter(name).value()


def _within(seconds, fn):
    """``fn()`` on a thread that must finish within ``seconds``."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"still running after its {seconds} s limit"
    if "err" in box:
        raise box["err"]
    return box["out"]


@pytest.mark.parametrize("on", [False, True], ids=["rpcz_off", "rpcz_on"])
def test_stage_adders_count_calls_and_us(rpcz, on):
    rpcz(on)
    name = f"t_adders_{int(on)}"
    us0 = _value(f"torch_stage_{name}_us")  # tpulint: allow(metric-name)
    n0 = _value(f"torch_stage_{name}_calls")  # tpulint: allow(metric-name)
    for _ in range(3):
        with tracing.stage(name):
            time.sleep(0.002)
    with tracing.stage(name, calls=0):
        time.sleep(0.002)
    assert _value(f"torch_stage_{name}_calls") - n0 == 3  # tpulint: allow(metric-name)
    assert _value(f"torch_stage_{name}_us") - us0 >= 4 * 2000  # tpulint: allow(metric-name)
    # On /vars, beside the port's other series.
    assert f"torch_stage_{name}_calls : 3" in metrics.dump_vars(
        f"torch_stage_{name}")


def test_no_native_annotate_while_rpcz_off(rpcz, monkeypatch):
    calls = []
    L = native.lib()
    monkeypatch.setattr(L, "tbrpc_span_annotate", calls.append)
    rpcz(False)
    with tracing.stage("t_annotate"):
        pass
    tracing.annotate("x=1")

    class Trace:
        exposed_wait_s = compute_busy_s = 0.001

        def overlapped_comm_s(self):
            return 0.002

    step_driver._annotate(Trace())
    assert calls == []
    rpcz(True)
    with tracing.stage("t_annotate"):
        pass
    step_driver._annotate(Trace())
    heads = [c.split(b"=")[0] for c in calls]
    for head in (b"t_annotate", b"exposed_comm", b"overlapped_comm",
                 b"compute"):
        assert heads.count(head) == 1, heads


def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("record_function built with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(tracing, "_Range", refuse)
    assert not profiling()
    with tracing.stage("t_off"):
        pass
    with tracing.trace_span("t_off_span"):
        pass


def test_ranges_reach_an_all_threads_trace_from_another_thread(tmp_path):
    go, done = threading.Event(), threading.Event()
    tids = []

    def worker():
        go.wait(30)
        tids.append(threading.get_native_id())
        with tracing.trace_span("t_span/worker"):
            with tracing.stage("t_traced"):
                torch.ones(8).add_(1)
        done.set()

    t = threading.Thread(target=worker, daemon=True)
    t.start()  # before the profiler: the all-threads config still sees it
    prof = ps_process._profiler(cuda=False)
    prof.start()
    try:
        assert profiling()
        go.set()
        assert done.wait(30)
    finally:
        prof.stop()
    t.join(30)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    by_name = {e["name"]: e for e in events if e.get("ph") == "X"}
    for name in ("stage/t_traced", "t_span/worker"):
        assert name in by_name, name
        assert by_name[name]["tid"] == tids[0] != threading.get_native_id()
    assert not profiling()


def test_each_push_counts_one_serve_and_one_queue_wait(live):
    _ps, cl = live
    before = {k: _value(f"torch_stage_{k}_calls")  # tpulint: allow(metric-name)
              for k in ("serve", "queue_wait")}
    wait_us = _value("torch_stage_queue_wait_us")
    # The handler recorder reads the serve stage's clock: one sample a
    # push.
    handler = ttensor._metrics()["serve"]
    handled = handler.count()
    for k in range(3):
        cl.push_grad("w_a", torch.full(SHAPES["w_a"], 0.01 * k))
    after = {k: _value(f"torch_stage_{k}_calls")  # tpulint: allow(metric-name)
             for k in ("serve", "queue_wait")}
    assert after["serve"] - before["serve"] == 3
    assert handler.count() - handled == 3
    assert after["queue_wait"] - before["queue_wait"] == 3
    assert _value("torch_stage_queue_wait_us") >= wait_us


def test_cpu_copies_leave_the_wire_bytes(live):
    _ps, cl = live
    names = ("torch_wire_h2d_bytes", "torch_wire_d2h_bytes",
             "torch_stage_h2d_calls", "torch_stage_d2h_calls")
    before = {n: _value(n) for n in names}
    arr = np.arange(12, dtype=np.float32)
    assert torch.equal(ttensor._device_put_from_view(arr, torch.device("cpu")),
                       torch.from_numpy(arr))
    assert ttensor._as_host_array(torch.ones(3)).tolist() == [1.0] * 3
    arena = ttensor.TensorArena(1 << 20)
    try:
        off, nbytes, host = arena.place(torch.ones(5))
        assert nbytes == 20 and host.tolist() == [1.0] * 5
        arena.free(off)
    finally:
        arena.close()
    cl.push_all({k: torch.zeros(s) for k, s in SHAPES.items()})
    cl.pull_all()
    assert {n: _value(n) for n in names} == before


def test_server_process_trace_holds_serve_ranges_of_its_handlers(tmp_path):
    """Every RPC of a traced stretch is one ``stage/serve`` range in the
    server process's trace, on a handler thread, not its main one."""
    from conftest import require_native_lib
    require_native_lib()
    params = {k: np.ones(s, np.float32) for k, s in SHAPES.items()}
    path = tmp_path / "server.json"

    def run():
        with ps_process.ServerProcess(params, device="cpu",
                                      timeout_s=120) as srv:
            cl = tps.ParameterClient(srv.addr, device="cpu")
            try:
                cl.meta()
                srv.profile_start()
                cl.push_all({k: torch.full(s, 0.5)
                             for k, s in SHAPES.items()}, window=2)
                cl.pull_all(list(SHAPES), window=2)
                srv.profile_stop(str(path))
            finally:
                cl.close()
            return srv.pid

    pid = _within(90, run)
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    serve = [e for e in events if e["name"] == "stage/serve"]
    assert len(serve) == 2 * len(SHAPES)
    assert all(e["tid"] != pid for e in serve)
    assert sum(e["name"] == "stage/queue_wait" for e in events) >= len(SHAPES)


def test_rpcz_on_before_the_first_server_in_a_port_only_process(tmp_path):
    """A port-only process may switch rpcz on before its first native
    server starts: the push's server span carries its stages."""
    from conftest import ROOT, require_native_lib
    require_native_lib()
    script = tmp_path / "first.py"
    script.write_text(
        "import json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import torch\n"
        "from brpc_tpu_torch.observability import tracing\n"
        "tracing.rpcz_enable(True)\n"
        "tracing.rpcz_set_sample_1_in_n(1)\n"
        "from brpc_tpu_torch.runtime import param_server as tps\n"
        "ps = tps.ParameterServer({'w': torch.ones(64, 64)}, lr=0.1,\n"
        "                         momentum=0.9, device='cpu')\n"
        "cl = tps.ParameterClient(f'tpu://127.0.0.1:{ps.start()}',\n"
        "                         device='cpu')\n"
        "assert cl.push_grad('w', torch.ones(64, 64)) == 1\n"
        "spans = tracing.dump_rpcz()\n"
        "held = sorted(m for m in sys.modules\n"
        "              if m.split('.')[0] in ('jax', 'brpc_tpu'))\n"
        "print(json.dumps({'spans': spans, 'held': held}))\n"
        "cl.close()\n"
        "ps.stop()\n")
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=90)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["held"] == []
    notes = [" ".join(s.get("annotations", [])) for s in got["spans"]
             if s["service_method"] == "ParamService/Push"]
    assert any("fused_update=" in n and "serve=" in n for n in notes), notes
