"""The port's step scheduler and step drivers against the JAX package's.

Pure half: the port's ``run_graph`` runs the same graphs to the same
results serial and overlapped, cancels exactly a failed node's
dependents, surfaces a dead wire lane, and really runs a compute node
and a wire node at once (a handshake that can only finish concurrently —
the span overlap read off ``RunTrace``, no timing threshold).

Drivers, on CPU tensors (the plain K1/K2 versions):

  * ``OverlappedStepDriver`` of each package over its own parameter
    server, from the same numpy parameters and batches, 3 steps: losses
    and server state within rtol 1e-5, atol 1e-6 — the tolerance at which
    the port's ``LayeredMLP`` meets the JAX one (XLA:CPU and torch order
    a matmul's sums differently);
  * inside the port, overlapped == serial bit for bit, raw and int8;
  * a parameter retired under a running driver: ``PartialPushError``
    with the other layers' versions applied;
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
    assert lanes == {ts.COMPUTE, ts.WIRE}


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
