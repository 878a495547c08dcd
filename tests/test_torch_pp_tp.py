"""The port's pipeline and tensor-parallel regimes against the JAX
package's, on CPU tensors.

  * the 1F1B schedule, its node order, the bubble closed form and the
    slot simulator equal the JAX package's for every (S, M) in a grid;
  * a PP(2) x M(4) trajectory over ``MemoryPipe`` of each package, from
    the same numpy weights and batch, agrees within the JAX package's
    pinned PP tolerance (losses rtol 2e-5; weights rtol 2e-5, atol 1e-6),
    and both meet the single-process baseline there;
  * a 2-stage ``WirePipe`` run (registry discovery, typed tensors over
    the wire) equals the ``MemoryPipe`` run bit for bit;
  * ``tp_allreduce`` is the exact sum; under int8 members agree;
  * a TP(2) trajectory of each package on a ``LocalRing`` agrees at the
    same tolerance, members bit-identical; at world 1 the TP chain is the
    full-matrix torch chain bit for bit.
"""

import threading

import numpy as np
import pytest
import torch

from brpc_tpu.runtime import pp_sched as jpp
from brpc_tpu_torch.models.tp_layers import (LocalRing, TPShardedMLP,
                                             shard_span, tp_allreduce)
from brpc_tpu_torch.runtime import pp_sched as tpp
from brpc_tpu_torch.runtime.state import (stage_params, tensors_to_numpy,
                                          tp_shards)

PP_SIZES = [16, 32, 24, 32, 8]
TP_SIZES = [32, 48, 40, 24, 16]
LR, MU = 0.01, 0.9
GRID = [(1, 1), (1, 4), (2, 1), (2, 2), (2, 4), (3, 5), (4, 4), (4, 8)]


def _on_threads(n, fn):
    out, errs = {}, []

    def worker(r):
        try:
            out[r] = fn(r)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append((r, e))

    ts = [threading.Thread(target=worker, args=(r,)) for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs, errs
    return [out[r] for r in range(n)]


def _jax_init(sizes, batch=16):
    from brpc_tpu.models.tensor_service import LayeredMLP

    h = LayeredMLP(list(sizes), seed=0)
    x, y = h.data(batch, seed=1)
    return tensors_to_numpy(h.init_params()), np.asarray(x), np.asarray(y)


# ---------------------------------------------------------------------------
# Schedules.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,m", GRID)
def test_schedule_and_bubble_match_jax(s, m):
    for stage in range(s):
        assert tpp.stage_schedule(stage, s, m) == \
            jpp.stage_schedule(stage, s, m)
        assert tpp.stage_node_order(stage, s, m) == \
            jpp.stage_node_order(stage, s, m)
        stub = dict(fwd=lambda mb, a: a, bwd=lambda mb, g: g,
                    send_act=lambda mb, a: None, recv_act=lambda mb: None,
                    send_grad=lambda mb, a: None, recv_grad=lambda mb: None)
        assert tpp.build_stage_graph(stage, s, m, **stub).serial_order() \
            == jpp.build_stage_graph(stage, s, m, **stub).serial_order()
    sim = tpp.simulate_slots(s, m)
    assert sim == jpp.simulate_slots(s, m)
    assert sim["total_idle"] == tpp.bubble_slots(s, m) == \
        jpp.bubble_slots(s, m)
    assert tpp.bubble_fraction(s, m) == jpp.bubble_fraction(s, m)
    for layers in (s, s + 1, 3 * s + 2):
        assert tpp.stage_layers(layers, s) == jpp.stage_layers(layers, s)


def test_memory_pipe_recv_times_out():
    pipe = tpp.MemoryPipe(2, timeout_s=0.05)
    with pytest.raises(tpp.PipeTimeout):
        pipe.port(1).recv_act(0, 0)


# ---------------------------------------------------------------------------
# PP trajectories.
# ---------------------------------------------------------------------------

def _torch_pp(params, ports, x, y, steps, microbatches=4):
    from brpc_tpu_torch.models.pipeline import StagedMLP

    stages = len(ports)
    drivers = [tpp.PipelineStageDriver(
        s, stages, StagedMLP(PP_SIZES, s, stages,
                             params=stage_params(params, PP_SIZES, s,
                                                 stages), device="cpu"),
        ports[s], microbatches=microbatches, lr=LR, momentum=MU)
        for s in range(stages)]
    out = _on_threads(stages, lambda s: [
        drivers[s].step(x=torch.tensor(x) if s == 0 else None,
                        y=torch.tensor(y) if s == stages - 1 else None)
        for _ in range(steps)])
    merged = {}
    for d in drivers:
        merged.update(tensors_to_numpy(d.harness.params()))
    return out[-1], merged, drivers


def _jax_pp(params, x, y, steps, microbatches=4):
    from brpc_tpu.models.pipeline import StagedMLP

    pipe = jpp.MemoryPipe(2)
    drivers = []
    for s in range(2):
        h = StagedMLP(PP_SIZES, s, 2, seed=0)
        for n in h.names:
            h.set_param(n, params[n])
        drivers.append(jpp.PipelineStageDriver(
            s, 2, h, pipe.port(s), microbatches=microbatches, lr=LR,
            momentum=MU))
    out = _on_threads(2, lambda s: [
        drivers[s].step(x=x if s == 0 else None, y=y if s == 1 else None)
        for _ in range(steps)])
    merged = {}
    for d in drivers:
        merged.update(d.harness.params())
    return out[-1], merged


def _baseline(params, x, y, steps):
    """Full-batch port LayeredMLP grads + the plain momentum update."""
    from brpc_tpu_torch.models.tensor_service import LayeredMLP
    from brpc_tpu_torch.ops.fused_update import momentum_update_reference

    full = LayeredMLP(PP_SIZES, device="cpu")
    p = {n: torch.tensor(v) for n, v in params.items()}
    m = {n: torch.zeros_like(v) for n, v in p.items()}
    losses = []
    for _ in range(steps):
        gs, loss = full.grads(p, torch.tensor(x), torch.tensor(y))
        losses.append(loss)
        for n in p:
            p[n], m[n] = momentum_update_reference(p[n], m[n], gs[n],
                                                   lr=LR, beta=MU)
    return losses, tensors_to_numpy(p)


def _close_params(a, b):
    assert sorted(a) == sorted(b)
    for n in a:
        np.testing.assert_allclose(a[n], b[n], rtol=2e-5, atol=1e-6)


def test_pp_trajectory_matches_jax_and_baseline():
    params, x, y = _jax_init(PP_SIZES)
    pipe = tpp.MemoryPipe(2)
    losses, merged, drivers = _torch_pp(params, [pipe.port(0),
                                                 pipe.port(1)], x, y, 3)
    jlosses, jmerged = _jax_pp(params, x, y, 3)
    blosses, bparams = _baseline(params, x, y, 3)
    np.testing.assert_allclose(losses, jlosses, rtol=2e-5)
    np.testing.assert_allclose(losses, blosses, rtol=2e-5)
    _close_params(merged, jmerged)
    _close_params(merged, bparams)
    st = drivers[0].last_stats
    assert st["bubble_frac_theory"] == tpp.bubble_fraction(2, 4)
    assert st["bubble_s"] >= 0.0


@pytest.fixture(scope="module")
def pp_hub():
    from conftest import require_native_lib
    require_native_lib()
    from brpc_tpu_torch.fleet import RegistryHub, clear_registry
    hub = RegistryHub()
    hub.start()
    try:
        yield hub
    finally:
        clear_registry()
        hub.stop()


def test_wire_pipe_two_stage_matches_memory_pipe(pp_hub):
    params, x, y = _jax_init(PP_SIZES)
    pipe = tpp.MemoryPipe(2)
    mem_losses, mem_params, _d = _torch_pp(
        params, [pipe.port(0), pipe.port(1)], x, y, 2)
    pipes = [tpp.WirePipe(pp_hub.hostport, s, 2, tag="tpp_wire",
                          arena_bytes=8 << 20, client_arena_bytes=4 << 20,
                          device="cpu") for s in range(2)]
    try:
        _on_threads(2, lambda s: pipes[s].sync(timeout_s=15.0))
        wire_losses, wire_params, _d = _torch_pp(params, pipes, x, y, 2)
    finally:
        for p in pipes:
            p.close()
    assert wire_losses == mem_losses
    for n in mem_params:
        assert wire_params[n].tobytes() == mem_params[n].tobytes(), n


# ---------------------------------------------------------------------------
# TP.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,size", [(2, 97), (3, 100), (1, 13)])
def test_tp_allreduce_is_exact_sum(world, size):
    ring = LocalRing(world)
    xs = [torch.arange(size, dtype=torch.float32) * (r + 1) - 7.5 * r
          for r in range(world)]
    outs = _on_threads(world, lambda r: tp_allreduce(ring.member(r), "t",
                                                     xs[r]))
    want = sum(xs)
    for o in outs:
        assert torch.equal(o, want)


def test_tp_allreduce_int8_members_identical():
    ring = LocalRing(2, codec="int8")
    rng = np.random.default_rng(5)
    xs = [torch.tensor(rng.standard_normal(4096).astype(np.float32))
          for _ in range(2)]
    outs = _on_threads(2, lambda r: tp_allreduce(ring.member(r), "q",
                                                 xs[r]))
    assert torch.equal(outs[0], outs[1])
    step = float((xs[0] + xs[1]).abs().max()) / 127.0
    assert float((outs[0] - (xs[0] + xs[1])).abs().max()) < step * 3


def test_tp_shards_are_shard_span_slices():
    params, _x, _y = _jax_init(TP_SIZES)
    for world in (1, 2, 3):
        for rank in range(world):
            sh = tp_shards(params, rank, world)
            ring = LocalRing(world)
            tp = TPShardedMLP(TP_SIZES, ring.member(rank), params,
                              device="cpu")
            for layer in tp.layers:
                assert layer.span == shard_span(
                    params[layer.name].shape[layer.axis], rank, world)
                assert np.array_equal(layer.w.numpy(), sh[layer.name])


def test_tp_world1_is_the_full_chain_bit_for_bit():
    from brpc_tpu_torch.models.tensor_service import LayeredMLP

    params, x, y = _jax_init(TP_SIZES)
    tp = TPShardedMLP(TP_SIZES, LocalRing(1).member(0), params,
                      device="cpu")
    gs, loss = tp.grads(x, y)
    full = LayeredMLP(TP_SIZES, device="cpu")
    ref, ref_loss = full.grads({n: torch.tensor(v) for n, v in
                                params.items()}, torch.tensor(x),
                               torch.tensor(y))
    assert loss == ref_loss
    for n, g in gs.items():
        assert torch.equal(g, ref[n]), n


def test_tp_trajectory_matches_jax():
    from brpc_tpu.models.tp_layers import LocalRing as JRing
    from brpc_tpu.models.tp_layers import TPShardedMLP as JTP

    params, x, y = _jax_init(TP_SIZES)
    steps = 3
    ring = LocalRing(2)

    def member(r):
        tp = TPShardedMLP(TP_SIZES, ring.member(r), params, lr=LR,
                          momentum=MU, device="cpu")
        losses = [tp.train_step(x, y) for _ in range(steps)]
        return losses, tensors_to_numpy(tp.gather_params())

    (l0, p0), (l1, p1) = _on_threads(2, member)
    jring = JRing(2)

    def jmember(r):
        tp = JTP(TP_SIZES, jring.member(r), params, lr=LR, momentum=MU)
        return ([tp.train_step(x, y) for _ in range(steps)],
                tp.gather_params())

    (jl, jp), _ = _on_threads(2, jmember)
    assert l0 == l1, "members must agree exactly"
    np.testing.assert_allclose(l0, jl, rtol=2e-5)
    for n in p0:
        assert p0[n].tobytes() == p1[n].tobytes(), n
    _close_params(p0, {n: np.asarray(v) for n, v in jp.items()})
