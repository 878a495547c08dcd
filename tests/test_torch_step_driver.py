"""The port's step scheduler and step drivers against the JAX package's.

Pure half: the port's ``run_graph`` runs the same graphs to the same
results serial and overlapped, cancels exactly a failed node's
dependents, surfaces a dead wire lane, and really runs a compute node
and a wire node at once (a handshake that can only finish concurrently —
the span overlap read off ``RunTrace``, no timing threshold); each wire
thread knows its lane, and two wire lanes busy at once count once in
the step's wire time.

Drivers, on CPU tensors (the plain K1/K2 versions):

  * ``OverlappedStepDriver`` of each package over its own parameter
    server, from the same numpy parameters and batches, 3 steps: losses
    and server state within rtol 1e-5, atol 1e-6 — the tolerance at which
    the port's ``LayeredMLP`` meets the JAX one (XLA:CPU and torch order
    a matmul's sums differently);
  * inside the port, overlapped == serial bit for bit, raw and int8;
  * a parameter retired under a running driver: ``PartialPushError``
    with the other layers' versions applied;
  * the top layer's pull does not wait behind pushes (confirms and
    pulls ride a wire lane of their own), and the two lanes share the
    push window under a 10 us switch interval;
  * one overlapped step's rpcz dump (the JAX package's
    ``test_rpcz_shows_push_inside_compute_shadow``): a push span inside a
    lower layer's backward span, the step span's exposed/overlapped
    communication and the push spans' ``arena_stage``;
  * the server in a process of its own (``parallel.ps_process``) ==
    the server in this process, bit for bit (losses, params, momenta,
    versions), serial and overlapped; the server process is gone after a
    trainer that raised, after its caller died, and at its time limit;
  * ``CollectiveStepDriver`` on a ``LocalRing``: the port against the
    JAX driver at the same tolerance, started mid-trajectory from a state
    carried across with ``runtime.state``; ``track=True`` == untracked
    bit for bit within the port; over a live ``CollectiveGroup`` == over
    the ``LocalRing`` bit for bit; int8 with error feedback closer to
    the raw trajectory than the naive requantizer.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from brpc_tpu_torch.runtime import step_sched as ts
from brpc_tpu_torch.runtime.state import (driver_state_to_numpy,
                                          tensors_to_numpy)

SIZES = [24, 32, 32, 16]
DP_SIZES = [64, 256, 256, 64]  # >= 4 KB layer grads: the quantized path
LR, MU = 0.05, 0.9


# ---------------------------------------------------------------------------
# Pure: the scheduler.
# ---------------------------------------------------------------------------

def _diamond():
    g = ts.StepGraph()

    def node(val, deps=()):
        g.add(f"n{val}", lambda done: val + sum(done[d] for d in deps),
              deps=deps, lane=lanes[val])

    lanes = {1: ts.COMPUTE, 2: ts.WIRE, 3: ts.COMPUTE, 4: "wire:x"}
    node(1)
    node(2, ("n1",))
    node(3, ("n1",))
    node(4, ("n2", "n3"))
    return g


def test_graph_topology_contracts():
    g = ts.StepGraph()
    g.add("a", lambda d: 1)
    with pytest.raises(ValueError):
        g.add("a", lambda d: 1)
    with pytest.raises(ValueError):
        g.add("b", lambda d: 1, deps=("zz",))
    with pytest.raises(ValueError):
        g.add("c", lambda d: 1, lane="wire:")
    assert _diamond().serial_order() == ["n1", "n2", "n3", "n4"]


def test_serial_and_overlapped_give_the_same_results():
    r_ser, t_ser = ts.run_graph(_diamond(), overlap=False)
    r_ovl, t_ovl = ts.run_graph(_diamond(), overlap=True)
    assert r_ser == r_ovl == {"n1": 1, "n2": 3, "n3": 4, "n4": 11}
    assert [e[0] for e in t_ser.events] == ["n1", "n2", "n3", "n4"]
    assert set(t_ovl.lane_busy_s) == {ts.WIRE, "wire:x"}
    assert t_ser.exposed_join_s == 0.0
    assert t_ser.exposed_wait_s == t_ser.wire_busy_s
    assert t_ovl.exposed_wait_s == pytest.approx(
        t_ovl.exposed_stall_s + t_ovl.exposed_join_s, abs=1e-9)


def test_compute_and_wire_nodes_really_overlap():
    """The wire node signals and then waits for the compute node; the
    compute node waits for that signal and then answers. Neither can end
    until the other has started, so their spans must intersect."""
    to_wire, to_compute = threading.Event(), threading.Event()

    def wire(done):
        to_compute.set()
        assert to_wire.wait(10), "compute node never ran alongside"

    def compute(done):
        assert to_compute.wait(10), "wire node never started"
        to_wire.set()

    g = ts.StepGraph()
    g.add("w", wire, lane=ts.WIRE)
    g.add("c", compute, lane=ts.COMPUTE)
    _r, trace = ts.run_graph(g, overlap=True)
    assert trace.overlapped("w", "c")
    assert trace.overlapped_comm_s() >= 0.0


def test_failure_cancels_dependents_not_siblings():
    g = ts.StepGraph()
    g.add("a", lambda d: 1)
    g.add("bad", lambda d: 1 / 0, deps=("a",), lane=ts.WIRE)
    g.add("child", lambda d: 2, deps=("bad",), lane=ts.COMPUTE)
    g.add("sib", lambda d: 3, deps=("a",), lane="wire:s")
    for overlap in (True, False):
        with pytest.raises(ts.StepFailure) as ei:
            ts.run_graph(g, overlap=overlap)
        sf = ei.value
        assert set(sf.failed) == {"bad"}
        assert sf.cancelled == ["child"]
        assert sf.done == {"a": 1, "sib": 3}
        assert isinstance(sf.cause, ZeroDivisionError)


def test_wire_lane_death_surfaces_as_failure():
    class Boom:
        def __enter__(self):
            raise RuntimeError("lane context failed")

        def __exit__(self, *a):
            return False

    g = ts.StepGraph()
    g.add("a", lambda d: 1)
    g.add("w", lambda d: 2, deps=("a",), lane=ts.WIRE)
    g.add("after", lambda d: 3, deps=("w",), lane=ts.COMPUTE)
    with pytest.raises(ts.StepFailure) as ei:
        ts.run_graph(g, overlap=True, wire_ctx=Boom)
    assert "<wire-lane>" in ei.value.failed
    assert set(ei.value.cancelled) == {"w", "after"}


def test_each_wire_thread_knows_its_lane():
    """``current_lane()`` names the lane on a wire thread, inside its
    ``wire_ctx`` and its nodes (what keys ``handoff.LaneStreams``), and
    is None on the caller's thread."""
    seen = []

    class Ctx:
        def __enter__(self):
            seen.append(("ctx", ts.current_lane()))

        def __exit__(self, *a):
            return False

    g = ts.StepGraph()
    g.add("c", lambda d: ts.current_lane())
    for lane in (ts.WIRE, "wire:pull", "wire:x"):
        g.add(f"n:{lane}", lambda d: ts.current_lane(), deps=("c",),
              lane=lane)
    done, _trace = ts.run_graph(g, overlap=True, wire_ctx=Ctx)
    assert done == {"c": None, "n:wire": "wire", "n:wire:pull": "wire:pull",
                    "n:wire:x": "wire:x"}
    assert sorted(seen) == [("ctx", "wire"), ("ctx", "wire:pull"),
                            ("ctx", "wire:x")]
    assert ts.current_lane() is None


def test_two_busy_wire_lanes_count_once():
    """Two wire lanes busy at the same time count once in ``wire_busy_s``
    (the union of their node intervals), each lane in full in
    ``lane_busy_s``; so overlapped communication never exceeds the
    step."""
    both = threading.Barrier(2)

    def wire(d):
        both.wait(10)  # both lanes' nodes run at once from here
        time.sleep(0.05)

    g = ts.StepGraph()
    g.add("w1", wire, lane=ts.WIRE)
    g.add("w2", wire, lane="wire:pull")
    g.add("c", lambda d: time.sleep(0.08))
    _done, trace = ts.run_graph(g, overlap=True)
    assert trace.overlapped("w1", "w2")
    lanes = trace.lane_busy_s
    assert set(lanes) == {ts.WIRE, "wire:pull"}
    assert max(lanes.values()) <= trace.wire_busy_s < sum(lanes.values())
    spans = [trace.span("w1"), trace.span("w2")]
    assert trace.wire_busy_s == pytest.approx(
        max(e for _s, e in spans) - min(s for s, _e in spans), abs=1e-9)
    assert trace.overlapped_comm_s() <= trace.wall_s


# ---------------------------------------------------------------------------
# Drivers over a live parameter server.
# ---------------------------------------------------------------------------

def _wait(cond, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout_s} s: {what}")
        time.sleep(0.02)


@pytest.fixture(scope="module")
def drv_env(tmp_path_factory):
    from conftest import require_native_lib
    require_native_lib()
    from brpc_tpu_torch.observability import health
    health.start_watchdog(str(tmp_path_factory.mktemp("torch_step_dumps")))
    yield {}
    _wait(lambda: health.state() != "stalled", 10,
          f"scheduler stalled after step-driver tests; dump: "
          f"{health.last_dump_path()}")


def _jax_init(sizes):
    """The JAX package's seeded parameters and its data, as numpy."""
    from brpc_tpu.models.tensor_service import LayeredMLP

    h = LayeredMLP(list(sizes), seed=0)
    params = tensors_to_numpy(h.init_params())
    batches = [tuple(np.asarray(a) for a in h.data(8, seed=100 + i))
               for i in range(4)]
    return params, batches


def _torch_pair(params, codec=None):
    from brpc_tpu_torch.models.tensor_service import LayeredMLP
    from brpc_tpu_torch.runtime.param_server import (ParameterClient,
                                                     ParameterServer)

    sizes = [params["layer00"].shape[0]] + [
        params[k].shape[1] for k in sorted(params)]
    ps = ParameterServer(params, lr=LR, momentum=MU, device="cpu")
    port = ps.start()
    cl = ParameterClient(f"tpu://127.0.0.1:{port}", codec=codec,
                         device="cpu")
    return ps, cl, LayeredMLP(sizes, device="cpu")


def _close(*objs):
    for o in objs:
        (o.close if hasattr(o, "close") else o.stop)()


def _torch_run(params, batches, overlap, steps=3, codec=None, window=4):
    from brpc_tpu_torch.runtime.step_driver import OverlappedStepDriver

    ps, cl, h = _torch_pair(params, codec)
    try:
        d = OverlappedStepDriver(cl, h, overlap=overlap, window=window)
        d.prime()
        losses = [d.step(torch.tensor(x), torch.tensor(y))
                  for x, y in batches[:steps]]
        state = ps.state()
        assert d.versions == {n: steps for n in h.names}
        return losses, tensors_to_numpy(state.params), d
    finally:
        _close(cl, ps)


def test_overlapped_driver_matches_jax(drv_env):
    from brpc_tpu.models.tensor_service import LayeredMLP
    from brpc_tpu.runtime.param_server import (ParameterClient,
                                               ParameterServer)
    from brpc_tpu.runtime.step_driver import OverlappedStepDriver

    params, batches = _jax_init(SIZES)
    losses, state, d = _torch_run(params, batches, overlap=True)
    jh = LayeredMLP(list(SIZES), seed=0)
    jps = ParameterServer({k: jnp.asarray(v) for k, v in params.items()},
                          lr=LR, momentum=MU)
    jcl = ParameterClient(f"tpu://127.0.0.1:{jps.start()}")
    try:
        jd = OverlappedStepDriver(jcl, jh, overlap=True)
        jd.prime()
        jlosses = [jd.step(jnp.asarray(x), jnp.asarray(y))
                   for x, y in batches[:3]]
        jstate = {n: np.asarray(jcl.pull(n)[1]) for n in jh.names}
    finally:
        jcl.close()
        jps.stop()
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=1e-6)
    for n in jstate:
        np.testing.assert_allclose(state[n], jstate[n], rtol=1e-5,
                                   atol=1e-6)
    assert d.totals["steps"] == 3
    lanes = {lane for _n, lane, _s, _e in d.last_trace.events}
    assert lanes == {ts.COMPUTE, ts.WIRE, "wire:pull"}


@pytest.mark.parametrize("codec", [None, "int8"], ids=["raw", "int8"])
def test_overlapped_equals_serial_bit_for_bit(drv_env, codec):
    sizes = SIZES if codec is None else (48, 64, 64, 32)
    params, batches = _jax_init(sizes)
    lo, so, do = _torch_run(params, batches, overlap=True, codec=codec)
    ls, ss, ds = _torch_run(params, batches, overlap=False, codec=codec)
    assert lo == ls
    for n in so:
        assert so[n].tobytes() == ss[n].tobytes(), n
    assert ds.totals["overlapped_comm_ms"] == 0.0


def test_midstep_push_failure_salvages_partially(drv_env):
    """Retire one parameter under a running driver: that layer's push
    dies mid-step, its confirm and pull are cancelled, every OTHER layer
    lands — PartialPushError carries the split."""
    from brpc_tpu_torch.runtime.param_server import (ParameterClient,
                                                     PartialPushError)
    from brpc_tpu_torch.runtime.step_driver import OverlappedStepDriver

    params, batches = _jax_init((24, 32, 32, 32, 32, 32, 16))
    ps, cl, h = _torch_pair(params)
    victim = h.names[1]
    try:
        d = OverlappedStepDriver(cl, h, overlap=True, window=2)
        d.prime()
        x, y = (torch.tensor(a) for a in batches[0])
        d.step(x, y)
        ctl = ParameterClient(f"tpu://127.0.0.1:{ps.port}", device="cpu")
        ctl.retire(victim)
        ctl.close()
        with pytest.raises(PartialPushError) as ei:
            d.step(x, y)
        err = ei.value
        assert victim in err.unpushed
        assert set(err.applied) == set(h.names) - set(err.unpushed)
        assert all(v == 2 for v in err.applied.values())
        sf = err.step_failure
        assert any(n.startswith(("push:", "opt:")) for n in sf.failed)
        assert f"pull:{victim}" in sf.cancelled
    finally:
        _close(cl, ps)


def test_top_layer_pull_does_not_wait_behind_pushes(drv_env):
    """Confirms and pulls ride a wire lane of their own: the top layer's
    next version comes back while a push still waits. Here the middle
    layer's push waits until the lowest backward is done, so the lowest
    layer's push is ready behind it, and that push waits for the top
    layer's pull; on one wire lane the pull would queue behind it and
    the wait would run out."""
    from brpc_tpu_torch.runtime.step_driver import OverlappedStepDriver

    params, batches = _jax_init(SIZES)
    ps, cl, h = _torch_pair(params)
    top, mid, bottom = h.names[-1], h.names[1], h.names[0]
    pulled_top, bottom_done, seen = threading.Event(), threading.Event(), []
    real_pull, real_bwd, real_enc = cl.pull, h.backward, cl._grad_encoder

    def pull(name, *a, **kw):
        out = real_pull(name, *a, **kw)
        if name == top:
            pulled_top.set()
        return out

    def backward(ctx, name):
        out = real_bwd(ctx, name)
        if name == bottom:
            bottom_done.set()
        return out

    def grad_encoder(name):  # runs on the push's lane, before its submit
        if name == mid:
            assert bottom_done.wait(10)
        if name == bottom:
            seen.append(pulled_top.wait(10))
        return real_enc(name)

    cl.pull, h.backward, cl._grad_encoder = pull, backward, grad_encoder
    try:
        d = OverlappedStepDriver(cl, h, overlap=True, window=4)
        d.prime()
        x, y = (torch.tensor(a) for a in batches[0])
        d.step(x, y)
    finally:
        _close(cl, ps)
    assert seen == [True]
    assert d.versions == {n: 1 for n in h.names}


def test_two_lanes_share_the_window_under_a_short_switch_interval(
        drv_env):
    """Both wire lanes take calls off one PipelineWindow: with a window
    of 1 every push drains the one before it on the push lane while the
    confirms drain on the other, and a 10 us switch interval interleaves
    them; 10 steps land every version once and equal the serial run."""
    import sys

    params, batches = _jax_init((24, 32, 32, 32, 32, 16))
    batches = batches * 3
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        lo, so, do = _within(120, lambda: _torch_run(
            params, batches, overlap=True, steps=10, window=1))
    finally:
        sys.setswitchinterval(old)
    ls, ss, _ds = _torch_run(params, batches, overlap=False, steps=10,
                             window=1)
    assert lo == ls
    for n in so:
        assert so[n].tobytes() == ss[n].tobytes(), n
    assert do.totals["steps"] == 10


def test_rpcz_shows_push_inside_compute_shadow(drv_env):
    """One overlapped step's rpcz dump has a push span whose interval sits
    inside a LOWER layer's backward span (backward runs top-down, so
    lower layers compute later), the step span carries the exposed /
    overlapped communication, and the push spans their ``arena_stage``.
    rpcz goes on after this process's first server has started (a
    process that enables it before dies at that start)."""
    from brpc_tpu_torch.observability import tracing
    from brpc_tpu_torch.runtime.step_driver import OverlappedStepDriver

    params, _ = _jax_init((64, 128, 128, 128, 32))
    ps, client, h = _torch_pair(params)
    was_on = tracing.rpcz_enabled()
    tracing.rpcz_enable(True)
    old_n = tracing.rpcz_sample_1_in_n()
    tracing.rpcz_set_sample_1_in_n(1)
    try:
        driver = OverlappedStepDriver(client, h, overlap=True, window=4)
        driver.prime()
        x, y = h.data(64, seed=400)
        driver.step(x, y)
        by_name = {}
        for s in tracing.dump_rpcz():
            by_name.setdefault(s["service_method"], s)
    finally:
        tracing.rpcz_set_sample_1_in_n(old_n)
        tracing.rpcz_enable(was_on)
        _close(client, ps)
    step_span = by_name.get("train_step")
    assert step_span is not None, f"no step span in {sorted(by_name)}"
    notes = " ".join(step_span.get("annotations", []))
    assert "exposed_comm=" in notes and "overlapped_comm=" in notes
    overlapped_pairs = []
    for k, pushed in enumerate(h.names):
        push = by_name.get(f"step/push:{pushed}")
        if push is None:
            continue
        for lower in h.names[:k]:
            bwd = by_name.get(f"step/bwd:{lower}")
            if bwd is not None and (push["start_us"] < bwd["end_us"]
                                    and bwd["start_us"] < push["end_us"]):
                overlapped_pairs.append((pushed, lower))
    assert overlapped_pairs, (
        "no push span overlapped a later layer's compute span: "
        + str({n: (s["start_us"], s["end_us"])
               for n, s in by_name.items() if n.startswith("step/")}))
    push_notes = " ".join(" ".join(s.get("annotations", []))
                          for n, s in by_name.items()
                          if n.startswith("step/push:"))
    assert "arena_stage=" in push_notes


# ---------------------------------------------------------------------------
# The server in a process of its own.
# ---------------------------------------------------------------------------

def _within(seconds, fn):
    """``fn()`` under a time limit of its own: run on a thread, which
    must finish within ``seconds``; returns its result."""
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


def _gone(pid: int) -> bool:
    """The process has exited (a zombie waiting for its reaper counts)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def _drive(addr, h, batches, overlap, steps=3):
    from brpc_tpu_torch.runtime.param_server import ParameterClient
    from brpc_tpu_torch.runtime.step_driver import OverlappedStepDriver

    cl = ParameterClient(addr, device="cpu")
    try:
        d = OverlappedStepDriver(cl, h, overlap=overlap, window=4)
        d.prime()
        return [d.step(torch.tensor(x), torch.tensor(y))
                for x, y in batches[:steps]]
    finally:
        cl.close()


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["serial", "overlapped"])
def test_own_process_server_equals_in_process(drv_env, overlap):
    from brpc_tpu_torch.models.tensor_service import LayeredMLP
    from brpc_tpu_torch.parallel.ps_process import ServerProcess

    params, batches = _jax_init(SIZES)
    h = LayeredMLP(SIZES, device="cpu")

    def own():
        with ServerProcess(params, lr=LR, momentum=MU, device="cpu",
                           timeout_s=60) as srv:
            losses = _drive(srv.addr, h, batches, overlap)
            return losses, srv.state()

    losses, state = _within(60, own)
    ps, cl, _h = _torch_pair(params)
    cl.close()
    try:
        ref = _drive(f"tpu://127.0.0.1:{ps.port}", h, batches, overlap)
        ref_state = ps.state()
    finally:
        ps.stop()
    assert losses == ref
    assert state.versions == ref_state.versions == {n: 3 for n in h.names}
    for n in h.names:
        assert torch.equal(state.params[n], ref_state.params[n]), n
        assert torch.equal(state.momenta[n], ref_state.momenta[n]), n


def test_server_process_is_gone_after_the_trainer_raises(drv_env):
    from brpc_tpu_torch.models.tensor_service import LayeredMLP
    from brpc_tpu_torch.parallel.ps_process import ServerProcess

    params, batches = _jax_init(SIZES)
    h = LayeredMLP(SIZES, device="cpu")
    pids = []

    def trainer_fails():
        with pytest.raises(RuntimeError, match="trainer failed"):
            with ServerProcess(params, lr=LR, momentum=MU, device="cpu",
                               timeout_s=60) as srv:
                pids.append(srv.pid)
                _drive(srv.addr, h, batches, True, steps=1)
                raise RuntimeError("trainer failed")

    _within(60, trainer_fails)
    assert pids and _gone(pids[0])


def test_server_process_dies_with_its_caller(drv_env, tmp_path):
    """A caller that exits without closing (os._exit, as after a crash):
    the server process sees its command pipe end and stops."""
    import subprocess
    import sys

    from conftest import ROOT

    script = tmp_path / "caller.py"
    script.write_text(
        "import os, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import numpy as np\n"
        "from brpc_tpu_torch.parallel.ps_process import ServerProcess\n"
        "srv = ServerProcess({'w': np.ones((4, 4), np.float32)},\n"
        "                    device='cpu', timeout_s=120)\n"
        "print(srv.pid, flush=True)\n"
        "os._exit(3)\n")

    def run():
        out = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, timeout=60)
        assert out.returncode == 3, out.stderr[-2000:]
        pid = int(out.stdout.split()[-1])
        _wait(lambda: _gone(pid), 30, f"server process {pid} to end")

    _within(90, run)


def test_server_process_stops_at_its_time_limit(drv_env):
    import numpy as np

    from brpc_tpu_torch.parallel.ps_process import ServerProcess

    def run():
        srv = ServerProcess({"w": np.ones((4, 4), np.float32)},
                            device="cpu", timeout_s=3)
        proc = srv.proc
        try:
            _wait(lambda: proc.poll() is not None, 30,
                  "the server process to reach its time limit")
            assert proc.returncode == 124
        finally:
            srv.close()

    _within(60, run)


# ---------------------------------------------------------------------------
# CollectiveStepDriver.
# ---------------------------------------------------------------------------

def _on_threads(n, fn):
    out, errs = {}, []

    def worker(r):
        try:
            out[r] = fn(r)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append((r, e))

    ts_ = [threading.Thread(target=worker, args=(r,)) for r in range(n)]
    for t in ts_:
        t.start()
    for t in ts_:
        t.join()
    assert not errs, errs
    return [out[r] for r in range(n)]


def _dp_batches(steps, seed=500):
    rng = np.random.default_rng(seed)
    return [[(rng.standard_normal((8, DP_SIZES[0])).astype(np.float32),
              rng.standard_normal((8, DP_SIZES[-1])).astype(np.float32))
             for _r in range(2)] for _s in range(steps)]


def _torch_dp(groups, params, batches, track=False, momenta=None):
    """Two port members, each on its own thread and batch -> (losses by
    member, drivers)."""
    from brpc_tpu_torch.models.tensor_service import LayeredMLP
    from brpc_tpu_torch.runtime.step_driver import CollectiveStepDriver

    ds = [CollectiveStepDriver(g, LayeredMLP(DP_SIZES, device="cpu"),
                               lr=LR, momentum=MU, track=track)
          for g in groups]
    for d in ds:
        d.prime(params, momenta)
    losses = _on_threads(2, lambda r: [
        ds[r].step(torch.from_numpy(b[r][0]), torch.from_numpy(b[r][1]))
        for b in batches])
    for n, p in ds[0].params().items():
        assert torch.equal(p, ds[1].params()[n]), f"members diverged: {n}"
    return losses, ds


def _ring(world=2, **kw):
    from brpc_tpu_torch.models.tp_layers import LocalRing

    r = LocalRing(world, **kw)
    return [r.member(i) for i in range(world)]


def test_collective_driver_matches_jax_from_mid_trajectory():
    from brpc_tpu.models.tensor_service import LayeredMLP as JLayered
    from brpc_tpu.models.tp_layers import LocalRing as JRing
    from brpc_tpu.runtime.step_driver import CollectiveStepDriver as JDrv

    params, _ = _jax_init(DP_SIZES)
    batches = _dp_batches(4)
    _l, ds = _torch_dp(_ring(), params, batches[:2])
    mid_p, mid_m = driver_state_to_numpy(ds[0])
    losses, ds = _torch_dp(_ring(), mid_p, batches[2:], momenta=mid_m)

    jr = JRing(2)
    jds = [JDrv(jr.member(r), JLayered(DP_SIZES, seed=0), lr=LR,
                momentum=MU) for r in range(2)]
    for d in jds:
        d._params = {k: v.copy() for k, v in mid_p.items()}
        d._momenta = {k: v.copy() for k, v in mid_m.items()}
    jlosses = _on_threads(2, lambda r: [
        jds[r].step(jnp.asarray(b[r][0]), jnp.asarray(b[r][1]))
        for b in batches[2:]])
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=1e-6)
    got, _ = driver_state_to_numpy(ds[0])
    for n, p in jds[0].params().items():
        np.testing.assert_allclose(got[n], p, rtol=1e-5, atol=1e-6)


def test_tracked_equals_untracked_bit_for_bit():
    params, _ = _jax_init(DP_SIZES)
    batches = _dp_batches(3)
    l_op, d_op = _torch_dp(_ring(), params, batches)
    l_tr, d_tr = _torch_dp(_ring(), params, batches, track=True)
    assert l_op == l_tr
    for n, p in d_op[0].params().items():
        assert torch.equal(d_tr[0].params()[n], p), n
        assert torch.equal(d_tr[0].momenta()[n], d_op[0].momenta()[n]), n
    for n, log in d_tr[0].last_chunk_log.items():
        assert sorted(i for i, _s in log) == [0, 1]
        assert sum(ln for _i, (_o, ln) in log) == params[n].size
    assert not [e for e in d_tr[0].last_trace.events
                if e[0].startswith("opt:")]


def test_int8_error_feedback_beats_the_naive_requantizer():
    params, _ = _jax_init(DP_SIZES)
    batches = _dp_batches(4)
    _l, raw = _torch_dp(_ring(), params, batches)
    _l, qef = _torch_dp(_ring(codec="int8"), params, batches)
    _l, qnv = _torch_dp(_ring(codec="int8", ef=False), params, batches)
    d_ef = max(float((raw[0].params()[k] - qef[0].params()[k]).abs().max())
               for k in params)
    d_nv = max(float((raw[0].params()[k] - qnv[0].params()[k]).abs().max())
               for k in params)
    assert 0.0 < d_ef < d_nv


def test_driver_over_live_group_equals_local_ring(drv_env):
    from brpc_tpu_torch.collectives.group import CollectiveGroup
    from brpc_tpu_torch.fleet import RegistryHub, clear_registry

    params, _ = _jax_init(DP_SIZES)
    batches = _dp_batches(2)
    l_ring, d_ring = _torch_dp(_ring(), params, batches)
    hub = RegistryHub()
    hub.start()
    groups = [CollectiveGroup(hub.hostport, tag="tdrv_live",
                              arena_bytes=16 << 20,
                              client_arena_bytes=8 << 20)
              for _ in range(2)]
    try:
        _on_threads(2, lambda r: groups[r].sync(expect=2, timeout_s=20))
        groups.sort(key=lambda g: g.rank)
        l_live, d_live = _torch_dp(groups, params, batches)
    finally:
        _on_threads(2, lambda r: groups[r].close())
        clear_registry()
        hub.stop()
    assert l_live == l_ring
    for n, p in d_ring[0].params().items():
        assert torch.equal(d_live[0].params()[n], p), n
    lanes = set(d_live[0].last_trace.lane_busy_s)
    assert lanes == {"wire:ar0", "wire:ar1"}
