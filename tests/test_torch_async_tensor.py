"""The port's async tensor RPC surface: twins of tests/test_async_tensor.py
for ``TensorFuture.done()``, ``result(timeout_ms=)``, ``call_async(on_done=)``
and ``TensorChannel.place_with_meta``, plus the exactly-once release of a
response under cancel and destroy.

A port tensor server echoes ``2 * x`` (Echo) or answers after 0.4 s
(Slow). Arena accounting shows the release discipline: a response range
returns to its allocator only when its view was released, once. Echoed
values are exact (a float32 doubling), so equality is bit for bit.
"""

import threading
import time

import numpy as np
import pytest

from brpc_tpu.runtime import tensor as jtensor
from brpc_tpu_torch.runtime import native
from brpc_tpu_torch.runtime.tensor import (TensorArena, TensorChannel,
                                           _bind_tensor_api, _decode_meta_ex,
                                           _encode_meta, add_tensor_service)


@pytest.fixture(scope="module")
def env():
    from conftest import require_native_lib
    require_native_lib()
    server = native.Server()
    release_slow = threading.Event()

    def echo(method, request, att):
        if att is None:
            return b"none:" + request, None
        return request, np.asarray(att) * 2

    def slow(method, request, att):
        release_slow.wait(0.4)
        return b"slow", None

    echo_arena = add_tensor_service(server, "Echo", echo)
    add_tensor_service(server, "Slow", slow, arena=echo_arena)
    port = server.start("127.0.0.1:0")
    ch = TensorChannel(f"tpu://127.0.0.1:{port}", TensorArena(64 << 20))
    yield ch, port, echo_arena
    ch.close()
    server.stop()


def _drain(arena, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while arena.busy_bytes() and time.monotonic() < deadline:
        time.sleep(0.02)
    return arena.busy_bytes()


def _inflight():
    return _bind_tensor_api(native.lib()).tbrpc_async_inflight()


def _wait_inflight_zero(timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while _inflight() and time.monotonic() < deadline:
        time.sleep(0.02)
    return _inflight()


def test_place_with_meta_stages_what_the_jax_package_stages(env):
    """The staged bytes and the header describing them equal the JAX
    package's for the same array."""
    ch, _, _ = env
    x = np.arange(4096, dtype=np.float32).reshape(64, 64)
    off, length, host = ch.place_with_meta(x)
    try:
        assert length == x.nbytes
        np.testing.assert_array_equal(host, x)
        assert _encode_meta(host) == jtensor._encode_meta(x)
        staged = ch.arena.view(off, length).view(np.float32).reshape(64, 64)
        np.testing.assert_array_equal(staged, x)
    finally:
        ch.arena.free(off)


def test_call_async_matches_sync(env):
    ch, _, _ = env
    x = np.arange(1 << 16, dtype=np.float32)
    _, sync_arr = ch.call("Echo/Mul2", x)
    off, length, host = ch.place_with_meta(x)
    fut = ch.call_async("Echo/Mul2", _encode_meta(host) + b"t", off, length)
    probe = fut.done()  # one read: done() may flip between evaluations
    assert probe in (True, False)
    payload, view = fut.result()
    ch.arena.free(off)
    with view:
        meta, rest = _decode_meta_ex(payload)
        assert rest == b"t"
        arr = np.array(view.ndarray().view(np.dtype(meta["dtype"])).reshape(
            tuple(meta["shape"])))
    fut.close()
    np.testing.assert_array_equal(arr, sync_arr)
    np.testing.assert_array_equal(arr, x * 2)
    assert fut.done()  # taken: done stays true without a native probe
    p2, v2 = fut.result()  # cached: the same objects
    assert p2 is payload and v2 is view


def test_future_timed_wait_then_result(env):
    ch, _, _ = env
    fut = ch.call_async("Slow/Z")
    with pytest.raises(TimeoutError):
        fut.result(timeout_ms=30)
    assert not fut.done()  # a timed-out wait consumed nothing
    payload, view = fut.result()
    assert payload == b"slow"
    view.release()
    view.release()  # idempotent
    fut.close()
    fut.close()


def test_on_done_fires_before_the_future_is_waitable(env):
    ch, _, _ = env
    fired = []
    event = threading.Event()

    def hook(status):
        fired.append(status)
        event.set()

    fut = ch.call_async("Slow/Z", on_done=hook)
    assert event.wait(5), "on_done never fired"
    assert fired == [0]
    assert fut.done()  # the notification precedes waitability
    payload, view = fut.result(timeout_ms=0)
    assert payload == b"slow"
    view.release()
    fut.close()
    # The trampoline unanchored itself once it fired.
    from brpc_tpu_torch.runtime import tensor as ttensor
    assert not ttensor._live_done_cbs


def test_on_done_reports_an_rpc_failure_and_swallows_hook_errors(env):
    ch, _, _ = env
    statuses = []
    event = threading.Event()

    def bad_hook(status):
        statuses.append(status)
        event.set()
        raise RuntimeError("a hook that fails must not unwind")

    fut = ch.call_async("Nope/X", on_done=bad_hook)
    assert event.wait(5)
    assert statuses and statuses[0] != 0
    with pytest.raises(native.RpcError):
        fut.result()
    fut.close()
    payload, _ = ch.call("Echo/Nop", request=b"ok")  # the channel lives on
    assert payload == b"none:ok"


def test_cancel_after_completion_releases_view_once(env):
    ch, _, echo_arena = env
    x = np.ones(1 << 18, np.float32)
    off, length, host = ch.place_with_meta(x)
    fut = ch.call_async("Echo/Mul2", _encode_meta(host), off, length)
    # Wait for the response WITHOUT touching the future (done() would
    # consume a ready result into the cache).
    assert _wait_inflight_zero() == 0
    fut.cancel()  # releases the unconsumed response view exactly once
    with pytest.raises(native.RpcError):
        fut.result()
    fut.close()  # must not release again
    ch.arena.free(off)
    assert _drain(ch.arena) == 0
    assert _drain(echo_arena) == 0


def test_destroy_in_flight_releases_on_completion(env):
    ch, _, echo_arena = env
    fut = ch.call_async("Slow/Z")
    fut.close()  # destroyed before completion: the completion cleans up
    assert _wait_inflight_zero() == 0
    assert _drain(echo_arena) == 0
