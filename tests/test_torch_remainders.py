"""Small remainders of the port's surface, each against the JAX package's
meaning: mesh placements (``replicated`` / ``sharded_on`` give the
``torch.distributed.tensor`` placements of the JAX package's
``NamedSharding`` specs), ``SpanHandle.trace_hex``, and ``WirePipe``'s
link emulation (a send holds for its bytes' time at the modeled rate, as
the JAX pipe's does). Values cross exactly (tolerance 0); the emulated
time is a lower bound, since the send also stages and ships its bytes.
"""

import time

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from brpc_tpu.observability import tracing as jtracing
from brpc_tpu.parallel import mesh as jmesh
from brpc_tpu_torch.observability import tracing as ttracing
from brpc_tpu_torch.parallel import mesh as tmesh
from brpc_tpu_torch.parallel.launch import one_rank_group


def _jax_spec(sharding):
    return tuple(sharding.spec)


def test_mesh_placements_mirror_the_jax_shardings():
    jm = jmesh.ring_mesh()
    assert _jax_spec(jmesh.replicated(jm)) == ()
    assert _jax_spec(jmesh.sharded_on(jm, jmesh.SHARD_AXIS, 1)) == (
        None, jmesh.SHARD_AXIS)
    with one_rank_group("cpu"):
        ring = tmesh.ring_mesh()
        assert tmesh.replicated(ring) == [Replicate()]
        assert tmesh.sharded_on(ring, tmesh.SHARD_AXIS, 1) == [Shard(1)]
        grid = tmesh.make_mesh(client=1, shard=1)
        assert tmesh.replicated(grid) == [Replicate(), Replicate()]
        assert tmesh.sharded_on(grid, tmesh.SHARD_AXIS) == [Replicate(),
                                                            Shard(0)]
        assert tmesh.sharded_on(grid, tmesh.CLIENT_AXIS, 2) == [Shard(2),
                                                                Replicate()]
        with pytest.raises(ValueError, match="no dimension"):
            tmesh.sharded_on(ring, "model")


def test_span_handle_trace_hex_matches_jax():
    for trace_id in (0, 1, 0xDEADBEEF, 2**64 - 1):
        got = ttracing.SpanHandle(trace_id, 7).trace_hex
        assert got == jtracing.SpanHandle(trace_id, 7).trace_hex
        assert len(got) == 16 and int(got, 16) == trace_id


@pytest.fixture
def hub():
    from conftest import require_native_lib
    require_native_lib()
    from brpc_tpu_torch.fleet import RegistryHub, clear_registry
    h = RegistryHub()
    h.start()
    try:
        yield h
    finally:
        clear_registry()
        h.stop()


def test_wire_pipe_link_emulation_holds_each_send(hub):
    import threading

    from brpc_tpu_torch.runtime import pp_sched as tpp

    gbps = 0.002  # 2 MB/s: 32 KB take 16 ms on the modeled link
    pipes = [tpp.WirePipe(hub.hostport, s, 2, tag="tpp_emulated",
                          arena_bytes=8 << 20, client_arena_bytes=4 << 20,
                          emulate_wire_gbps=gbps if s == 0 else None,
                          device="cpu") for s in range(2)]
    try:
        threads = [threading.Thread(target=p.sync, kwargs={"timeout_s": 15})
                   for p in pipes]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        x = torch.arange(8192, dtype=torch.float32)
        t0 = time.monotonic()
        for mb in range(3):
            pipes[0].send_act(0, mb, x + mb)
        sent_s = time.monotonic() - t0
        for mb in range(3):
            assert torch.equal(pipes[1].recv_act(0, mb), x + mb)
        assert sent_s >= 3 * x.numel() * 4 / (gbps * 1e9)
        assert pipes[0].emulate_wire_gbps == gbps
        assert pipes[1].emulate_wire_gbps is None
    finally:
        for p in pipes:
            p.close()
