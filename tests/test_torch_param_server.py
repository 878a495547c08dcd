"""The port's parameter server and client against the JAX package's.

Both servers are seeded through numpy with the same parameters (a few
tensors: some eligible for the quantized wire, some too small) and driven
by the same client sequence — a raw push, an int8 push, a pull, a
``pull_all`` over ``PullQ`` and a ``push_all`` (window 4) over ``PushQ``.
Every pairing of server and client package must end with the versions
and parameters of the all-JAX run, and pull the same values on the way.
Tolerance 0: both packages apply the same float32 update with the same
two roundings, dequantize with one multiply, and carry identical
error-feedback residuals, so any difference is a fault.
"""

import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from brpc_tpu.runtime import param_server as jps
from brpc_tpu_torch.observability import tracing
from brpc_tpu_torch.ops import fused_update as tfu
from brpc_tpu_torch.ops import quantize as tq
from brpc_tpu_torch.runtime import native as tnative
from brpc_tpu_torch.runtime import param_server as tps
from brpc_tpu_torch.runtime.state import state_from_numpy, state_to_numpy

LR, BETA = 0.05, 0.8
SHAPES = {"w_a": (64, 64), "w_b": (37, 300), "bias": (100,),
          "vec": (1023,)}  # 16 KB and 44 KB eligible; 400 B and 4092 B not


@pytest.fixture(scope="module", autouse=True)
def _needs_native():
    from conftest import require_native_lib
    require_native_lib()


def _arrays(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


PARAMS = _arrays(0)
GRADS = [_arrays(10 + k, scale=0.1) for k in range(3)]


def _start_server(impl):
    if impl == "jax":
        ps = jps.ParameterServer({k: jnp.asarray(v) for k, v in PARAMS.items()},
                                 lr=LR, momentum=BETA)
    else:
        ps = tps.ParameterServer(state_from_numpy(PARAMS, device="cpu"),
                                 lr=LR, momentum=BETA)
    return ps, ps.start()


def _server_state(impl, ps):
    if impl == "jax":
        return ({k: np.asarray(v) for k, v in ps._params.items()},
                dict(ps._version))
    params, _mom, versions = state_to_numpy(ps.state())
    return params, versions


def _client(impl, port, codec=None):
    addr = f"tpu://127.0.0.1:{port}"
    if impl == "jax":
        return jps.ParameterClient(addr, codec=codec)
    return tps.ParameterClient(addr, codec=codec, device="cpu")


def _grad(impl, a):
    return jnp.asarray(a) if impl == "jax" else torch.from_numpy(a.copy())


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _drive(server_impl, client_impl):
    """The client sequence; returns what it observed and the end state."""
    ps, port = _start_server(server_impl)
    raw = _client(client_impl, port)
    quant = _client(client_impl, port, codec="int8")
    seen = {}
    try:
        seen["raw_push"] = raw.push_grad("w_a", _grad(client_impl,
                                                      GRADS[0]["w_a"]))
        seen["q_push"] = quant.push_grad("w_b", _grad(client_impl,
                                                      GRADS[0]["w_b"]))
        v, t = raw.pull("w_a")
        seen["pull"] = (v, _host(t))
        seen["pull_all_q"] = {k: (v, _host(t))
                              for k, (v, t) in quant.pull_all().items()}
        for g in GRADS[1:]:
            seen.setdefault("push_all", []).append(quant.push_all(
                {k: _grad(client_impl, a) for k, a in g.items()},
                window=4))
        seen["pull_all_raw"] = {k: (v, _host(t))
                                for k, (v, t) in raw.pull_all().items()}
        state = _server_state(server_impl, ps)
    finally:
        raw.close()
        quant.close()
        ps.stop()
    return seen, state


@pytest.fixture(scope="module")
def reference():
    return _drive("jax", "jax")


@pytest.mark.parametrize("server_impl,client_impl",
                         [("torch", "torch"), ("jax", "torch"),
                          ("torch", "jax")])
def test_port_matches_jax_end_to_end(reference, server_impl, client_impl):
    ref_seen, (ref_params, ref_versions) = reference
    seen, (params, versions) = _drive(server_impl, client_impl)
    assert versions == ref_versions
    assert versions == {"w_a": 3, "w_b": 3, "bias": 2, "vec": 2}
    for k in SHAPES:
        np.testing.assert_array_equal(params[k], ref_params[k])
    assert seen["raw_push"] == ref_seen["raw_push"] == 1
    assert seen["q_push"] == ref_seen["q_push"] == 1
    assert seen["push_all"] == ref_seen["push_all"]
    assert seen["pull"][0] == ref_seen["pull"][0]
    np.testing.assert_array_equal(seen["pull"][1], ref_seen["pull"][1])
    for key in ("pull_all_q", "pull_all_raw"):
        assert seen[key].keys() == ref_seen[key].keys()
        for k, (v, arr) in seen[key].items():
            assert v == ref_seen[key][k][0]
            assert arr.dtype == np.float32 and arr.shape == SHAPES[k]
            np.testing.assert_array_equal(arr, ref_seen[key][k][1])
    # The raw pull returns the server's tensors exactly.
    for k, (_v, arr) in seen["pull_all_raw"].items():
        np.testing.assert_array_equal(arr, params[k])


def test_port_server_on_cpu_takes_the_plain_versions():
    tfu.LAUNCHES.reset()
    tq.LAUNCHES_INT8.reset()
    seen, (params, versions) = _drive("torch", "torch")
    assert sum(versions.values()) == 10
    # CPU tensors never launch a kernel: the plain versions ran.
    assert tfu.LAUNCHES.value == 0 and tq.LAUNCHES_INT8.value == 0


def test_port_server_answers_unported_methods_with_e_no_such():
    ps, port = _start_server("torch")
    cl = _client("torch", port)
    try:
        # Only what the JAX server lacks too answers E_NO_SUCH: a method
        # neither serves, one-sided reads on a server that publishes none,
        # and the handshake on a name the server does not hold.
        for method, request in (
                ("Nope", b"{}"), ("Oneside", b""),
                ("Handoff", b'{"name": "missing"}'), ("Commit", b"missing")):
            with pytest.raises(tnative.RpcError) as ei:
                cl.channel.call(f"ParamService/{method}", request=request)
            assert ei.value.code == tps.E_NO_SUCH
        with pytest.raises(tnative.RpcError) as ei:
            cl.pull("missing")
        assert ei.value.code == tps.E_NO_SUCH
        assert cl.meta()["w_b"] == {"shape": [37, 300], "dtype": "float32",
                                    "version": 0}
        assert cl.epoch() == 1
        # The byte-RPC channel reaches the same service.
        ch = tnative.Channel(f"127.0.0.1:{port}")
        try:
            assert ch.call("ParamService/Epoch") == (b'{"epoch": 1}', b"")
        finally:
            ch.close()
        # A span body and a stage run around a call; with rpcz off (the
        # default) the span is inert.
        with tracing.trace_span("pull") as span, tracing.stage("x"):
            assert cl.pull("bias")[0] == 0
        if not tracing.rpcz_enabled():
            assert (span.trace_id, span.span_id) == (0, 0)
    finally:
        cl.close()
        ps.stop()


def test_partial_pull_and_push_errors_keep_the_survivors():
    ps, port = _start_server("torch")
    cl = _client("torch", port, codec="int8")
    try:
        with pytest.raises(tps.PartialPullError) as ei:
            cl.pull_all(["w_a", "ghost", "w_b"])
        assert ei.value.code == tps.E_NO_SUCH
        assert set(ei.value.partial) == {"w_a", "w_b"}
        assert ei.value.missing == ["ghost"]
        grads = {"w_a": torch.zeros(64, 64), "ghost": torch.zeros(64, 64)}
        with pytest.raises(tps.PartialPushError) as ei:
            cl.push_all(grads)
        assert ei.value.applied == {"w_a": 1}
        assert ei.value.unpushed == ["ghost"]
    finally:
        cl.close()
        ps.stop()


@pytest.mark.parametrize("path", ["push_grad", "push_all", "push_all_q"],
                         ids=["push_grad", "push_all-per-tensor",
                              "push_all-grouped"])
def test_each_eligible_gradient_counts_one_encode(path):
    """Every client-side gradient encode is the ``encode`` stage: one
    call per eligible gradient (w_a, w_b) and none for the ones riding
    raw, whether the gradient rides alone or in a PushQ group."""
    from brpc_tpu_torch.observability import metrics

    ps, port = _start_server("torch")
    cl = _client("torch", port, codec="int8")
    grads = {k: _grad("torch", a) for k, a in GRADS[0].items()}
    calls = metrics.counter("torch_stage_encode_calls")
    try:
        assert cl.negotiated_codec() == "int8" and cl._srv_pushq
        before = calls.value()
        if path == "push_grad":
            versions = {k: cl.push_grad(k, g) for k, g in grads.items()}
        else:
            versions = cl.push_all(grads, group=8 if path == "push_all_q"
                                   else 1)
        added = calls.value() - before
    finally:
        cl.close()
        ps.stop()
    assert versions == {k: 1 for k in SHAPES}
    assert added == 2


def test_native_library_links_libstdcxx_dynamically(tmp_path):
    # The port shares one process with torch, so it only loads a library
    # that takes libstdc++ from the process; a statically linked one is not.
    tnative.lib()
    assert tnative.links_shared_libstdcxx(tnative.library_path())
    src = tmp_path / "s.cpp"
    src.write_text('#include <iostream>\nvoid f() { std::cout << 1; }\n')
    so = tmp_path / "libs.so"
    subprocess.run(["g++", "-shared", "-fPIC", "-static-libstdc++",
                    "-static-libgcc", str(src), "-o", str(so)], check=True)
    assert not tnative.links_shared_libstdcxx(str(so))


# ---- fp16 parameters ---------------------------------------------------
#
# fp16 crosses the wire as '<f2' in both packages, and the JAX server
# applies the update in the parameters' dtype (its numpy path on this
# host). The port's server applies K1's plain fp16 version, which rounds
# the constants and every operation to fp16 as numpy does: tolerance 0.

HALF = {k: (a * np.float32(0.5)).astype(np.float16) for k, a in PARAMS.items()}
HALF_GRADS = [{k: a.astype(np.float16) for k, a in g.items()} for g in GRADS]


def _drive_fp16(server_impl, client_impl):
    if server_impl == "jax":
        ps = jps.ParameterServer({k: jnp.asarray(v) for k, v in HALF.items()},
                                 lr=LR, momentum=BETA)
    else:
        ps = tps.ParameterServer(state_from_numpy(HALF, device="cpu"),
                                 lr=LR, momentum=BETA)
    port = ps.start()
    cl = _client(client_impl, port)
    try:
        versions = [cl.push_grad("w_a", _grad(client_impl, HALF_GRADS[0]
                                              ["w_a"]))]
        for g in HALF_GRADS[1:]:
            versions.append(cl.push_all({k: _grad(client_impl, a)
                                         for k, a in g.items()}))
        v, t = cl.pull("w_a")
        pulled = (v, _host(t))
        if server_impl == "jax":
            state = ({k: np.asarray(a) for k, a in ps._params.items()},
                     {k: np.asarray(a) for k, a in ps._momenta.items()})
        else:
            params, momenta, _v = state_to_numpy(ps.state())
            state = (params, momenta)
    finally:
        cl.close()
        ps.stop()
    return versions, pulled, state


@pytest.mark.parametrize("client_impl", ["torch", "jax"])
def test_fp16_server_matches_jax_server_bit_for_bit(client_impl):
    want_v, want_pull, (want_p, want_m) = _drive_fp16("jax", "jax")
    got_v, got_pull, (got_p, got_m) = _drive_fp16("torch", client_impl)
    assert got_v == want_v
    assert want_v[-1] == {"w_a": 3, "w_b": 2, "bias": 2, "vec": 2}
    assert got_pull[0] == want_pull[0] == 3
    assert got_pull[1].dtype == np.float16
    np.testing.assert_array_equal(got_pull[1].view(np.int16),
                                  want_pull[1].view(np.int16))
    for k in SHAPES:
        assert got_p[k].dtype == got_m[k].dtype == np.float16
        np.testing.assert_array_equal(got_p[k].view(np.int16),
                                      want_p[k].view(np.int16))
        np.testing.assert_array_equal(got_m[k].view(np.int16),
                                      want_m[k].view(np.int16))
