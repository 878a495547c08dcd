"""Codec negotiation and its self-heals: the port's client against a port
server and against a JAX server, twins of tests/test_tensor_codec.py's
codec-disabled, stale-advertisement and rollback tests; the port's
``codec_name`` and ``QuantizedView.dequantize`` against the JAX package's.

A server "rolled back" to a build that predates a wire feature is
simulated the way the JAX package's tests do it: the server stops
advertising the feature (its codec list is emptied, or the Meta answer the
client reads loses the key), and the failing call answers as that build
would (E_UNDECODABLE, TRPC_EINTERNAL, or E_NO_SUCH for a method or a
marked name it does not know). Pulled and pushed values are compared at
tolerance 0: raw rides bit for bit, and the servers' updates are the
same float32 arithmetic.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from brpc_tpu.runtime import codec as jcodec
from brpc_tpu.runtime import param_server as jps
from brpc_tpu_torch.runtime import codec as tcodec
from brpc_tpu_torch.runtime import native as tnative
from brpc_tpu_torch.runtime import param_server as tps
from brpc_tpu_torch.runtime.state import state_from_numpy, state_to_numpy
from brpc_tpu_torch.runtime.tensor import E_UNDECODABLE

LR, BETA = 0.05, 0.8
SHAPES = {"w00": (64, 64), "w01": (40, 300), "b00": (100,)}


@pytest.fixture(scope="module", autouse=True)
def _needs_native():
    from conftest import require_native_lib
    require_native_lib()


def _params(seed=1):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _server(impl, params, **kw):
    if impl == "jax":
        ps = jps.ParameterServer({k: jnp.asarray(v) for k, v in params.items()},
                                 lr=LR, momentum=BETA, **kw)
    else:
        ps = tps.ParameterServer(state_from_numpy(params, device="cpu"),
                                 lr=LR, momentum=BETA, **kw)
    return ps, ps.start()


def _state(impl, ps):
    if impl == "jax":
        return {k: np.asarray(v) for k, v in ps._params.items()}
    return state_to_numpy(ps.state())[0]


def _client(port, **kw):
    return tps.ParameterClient(f"tpu://127.0.0.1:{port}", device="cpu", **kw)


def _strip_meta(cl, *keys):
    """Make ``cl`` read the server's Meta without ``keys`` — the answer of
    a build that predates those advertisements."""
    real = cl.channel.call

    def call(method, *a, **k):
        payload, arr = real(method, *a, **k)
        if method == "ParamService/Meta":
            doc = json.loads(payload.decode())
            for key in keys:
                doc.pop(key, None)
            payload = json.dumps(doc).encode()
        return payload, arr

    cl.channel.call = call


# ---- codec ids and the host decode ------------------------------------

def test_codec_name_matches_jax():
    for cid in (tcodec.CODEC_RAW, tcodec.CODEC_INT8, tcodec.CODEC_FP8E4M3,
                99):
        assert tcodec.codec_name(cid) == jcodec.codec_name(cid)
    for name in ("int8", "fp8e4m3"):
        assert tcodec.codec_name(tcodec.codec_id(name)) == name


@pytest.mark.parametrize("codec", ["int8", "fp8e4m3"])
@pytest.mark.parametrize("dtype", ["<f4", "<f2"])
def test_quantized_view_dequantize_matches_jax(codec, dtype):
    """Tolerance 0: one widening and one float32 multiply per value on
    both sides, then the header's dtype."""
    n = 256 * 9 + 31
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    enc = jcodec.encode(x, codec, min_bytes=0)
    meta = {"dtype": dtype, "shape": [n], "codec": codec, "block": enc.block}
    got = tcodec.QuantizedView(meta, enc.wire).dequantize()
    want = jcodec.QuantizedView(meta, enc.wire).dequantize()
    assert got.dtype == want.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tcodec.decode(meta, enc.wire))


def test_server_codecs_intersect_with_the_build():
    for codecs, want in ((None, list(tcodec.supported_codecs())),
                         ((), []), (("bogus", "int8"), ["int8"])):
        ps, port = _server("torch", _params(), codecs=codecs)
        cl = _client(port)
        try:
            doc = json.loads(cl.channel.call("ParamService/Meta")[0])
            assert doc["codecs"] == want
        finally:
            cl.close()
            ps.stop()


# ---- twins of tests/test_tensor_codec.py, against both servers ---------

@pytest.mark.parametrize("server_impl", ["torch", "jax"])
def test_codec_disabled_server_degrades_transparently(server_impl):
    params = _params()
    ps, port = _server(server_impl, params, codecs=())
    cl = _client(port, codec="int8")
    try:
        assert cl.negotiated_codec() is None  # nothing advertised
        _v, t = cl.pull("w00")
        np.testing.assert_array_equal(t.numpy(), params["w00"])  # raw
        assert cl.pull_all()["w01"][1].numpy().tobytes() == \
            params["w01"].tobytes()
        # Pushes degrade too: a raw gradient, the plain update.
        g = np.ones_like(params["w00"])
        assert cl.push_grad("w00", torch.from_numpy(g)) == 1
        assert cl.push_all({"w01": torch.ones(40, 300)}) == {"w01": 1}
        want = params["w00"] - np.float32(LR) * g
        np.testing.assert_array_equal(_state(server_impl, ps)["w00"], want)
    finally:
        cl.close()
        ps.stop()


@pytest.mark.parametrize("server_impl", ["torch", "jax"])
def test_stale_codec_advertisement_self_heals_on_push(server_impl):
    """A server restarted without codec support answers quantized pushes
    with E_UNDECODABLE; the client drops its cached advertisement and
    renegotiates (to raw) on the next call instead of failing every
    push."""
    ps, port = _server(server_impl, _params())
    cl = _client(port, codec="int8")
    g = torch.zeros(SHAPES["w00"])
    codec_module = ("brpc_tpu.runtime.codec" if server_impl == "jax"
                    else "brpc_tpu_torch.runtime.codec")
    try:
        assert cl.negotiated_codec() == "int8"
        assert cl.push_grad("w00", g) == 1
        assert cl._ef.residual("w00") is not None
        # Stop advertising AND decoding (the server side only: the
        # client's encoder never splits a wire).
        ps._codecs = ()
        with pytest.MonkeyPatch.context() as mp:
            def no_split(_meta, _payload):
                raise ValueError("simulated: build lost codec support")
            mp.setattr(f"{codec_module}.split_wire", no_split)
            with pytest.raises(tnative.RpcError) as ei:
                cl.push_grad("w00", g)
            assert ei.value.code == E_UNDECODABLE
        # The next call re-reads Meta (a full one: the advertisement is
        # repopulated) and rides raw.
        assert cl.negotiated_codec() is None
        assert cl._srv_codecs == ()
        assert cl.push_grad("w00", g) == 2
        # The raw stream owes nothing: the residual is dropped.
        assert cl._ef.residual("w00") is None
    finally:
        cl.close()
        ps.stop()


@pytest.mark.parametrize("server_impl", ["torch", "jax"])
def test_precodec_rollback_push_self_heals(server_impl):
    """A build that predates the codec has no E_UNDECODABLE answer: its
    update math dies on the flat codes as TRPC_EINTERNAL. The client
    re-reads the advertisement once: it heals when the codec is gone, and
    keeps the negotiation when it is not (a genuine handler fault must not
    degrade the wire)."""
    ps, port = _server(server_impl, _params())
    cl = _client(port, codec="int8")
    g = torch.zeros(SHAPES["w00"])
    try:
        assert cl.negotiated_codec() == "int8"
        real_push = cl.channel.push_device

        def precodec_push(*a, **k):
            raise tnative.RpcError(tps.TRPC_EINTERNAL,
                                   "operands could not be broadcast")

        cl.channel.push_device = precodec_push
        with pytest.raises(tnative.RpcError):
            cl.push_grad("w00", g)
        assert cl.negotiated_codec() == "int8"  # negative control first
        ps._codecs = ()
        with pytest.raises(tnative.RpcError):
            cl.push_grad("w00", g)
        assert cl.negotiated_codec() is None
        cl.channel.push_device = real_push
        assert cl.push_grad("w00", g) == 1
    finally:
        cl.close()
        ps.stop()


# ---- the pull and PushQ heals -----------------------------------------

@pytest.mark.parametrize("server_impl", ["torch", "jax"])
def test_precodec_rollback_pull_self_heals(server_impl):
    """A build that predates the codec reads ``name\\x00int8`` as an
    unknown name and has no PullQ: every negotiated pull answers E_NO_SUCH
    though raw would work. The client re-reads Meta once and, the codec
    gone, retries raw — ``pull`` and ``pull_all`` both; a genuine miss
    keeps its error and the negotiation."""
    params = _params()
    ps, port = _server(server_impl, params)
    cl = _client(port, codec="int8")
    try:
        assert cl.negotiated_codec() == "int8"
        with pytest.raises(tnative.RpcError) as ei:
            cl.pull("ghost")
        assert ei.value.code == tps.E_NO_SUCH
        assert cl.negotiated_codec() == "int8"  # genuine miss: kept
        # The rollback: the marked name and PullQ are unknown, and Meta
        # carries no codec.
        real_raw, real_async = cl.channel.call_raw, cl.channel.call_async

        def old_build(real):
            def call(method, request=b"", *a, **k):
                if method == "ParamService/PullQ" or b"\x00" in request:
                    method = "ParamService/Unknown"
                return real(method, request, *a, **k)
            return call

        cl.channel.call_raw = old_build(real_raw)
        cl.channel.call_async = old_build(real_async)
        _strip_meta(cl, "codecs")
        v, t = cl.pull("w00")
        assert v == 0 and cl.negotiated_codec() is None
        np.testing.assert_array_equal(t.numpy(), params["w00"])
        # pull_all: a fresh negotiation against the old build heals too.
        cl._srv_codecs = ("int8",)
        got = cl.pull_all()
        assert cl.negotiated_codec() is None
        for k, a in params.items():
            assert got[k][0] == 0
            np.testing.assert_array_equal(got[k][1].numpy(), a)
    finally:
        cl.close()
        ps.stop()


@pytest.mark.parametrize("server_impl", ["torch", "jax"])
def test_pushq_rollback_push_all_self_heals(server_impl):
    """A build with the codec but without the PushQ method answers every
    grouped push E_NO_SUCH. The client re-reads Meta once and, PushQ gone,
    re-sends the unconfirmed gradients per tensor, still quantized: each
    name is applied exactly once."""
    params = _params()
    ps, port = _server(server_impl, params)
    ref, ref_port = _server(server_impl, params)
    cl = _client(port, codec="int8")
    rc = _client(ref_port)
    # Integers in [-127, 127] with 127 in every 256-value block: int8
    # carries them exactly (scale 1), so the failed attempt leaves no
    # error-feedback residual and the healed pushes equal raw ones.
    grads = {}
    for k, s in SHAPES.items():
        g = np.random.default_rng(3).integers(-127, 128, s).astype(
            np.float32).reshape(-1)
        g[::256] = 127.0
        grads[k] = torch.from_numpy(g.reshape(s))
    try:
        assert cl.negotiated_codec() == "int8" and cl._srv_pushq
        real_async = cl.channel.call_async

        def no_pushq(method, *a, **k):
            if method == "ParamService/PushQ":
                method = "ParamService/Unknown"
            return real_async(method, *a, **k)

        cl.channel.call_async = no_pushq
        # Negative control: PushQ still advertised -> the error stands.
        with pytest.raises(tps.PartialPushError) as ei:
            cl.push_all(grads)
        assert ei.value.code == tps.E_NO_SUCH and cl._srv_pushq
        assert set(ei.value.applied) == {"b00"}  # the raw single landed
        # The rollback: Meta no longer advertises PushQ.
        _strip_meta(cl, "pushq")
        got = cl.push_all({k: g for k, g in grads.items() if k != "b00"})
        assert got == {"w00": 1, "w01": 1} and not cl._srv_pushq
        # The same gradients, raw, into a twin server: every name was
        # applied exactly once.
        assert rc.push_all(grads) == {k: 1 for k in SHAPES}
        a, b = _state(server_impl, ps), _state(server_impl, ref)
        for k in SHAPES:
            np.testing.assert_array_equal(a[k], b[k])
    finally:
        cl.close()
        rc.close()
        ps.stop()
        ref.stop()
