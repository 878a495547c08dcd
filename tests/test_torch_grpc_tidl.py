"""The RPC core's remaining Python surface through the port: the gRPC
client protocol, TLS on a port server, the loopback echo benchmarks, and
tidl — the port's wire runtime against the JAX package's, and a stub
generated by tools/tidl_gen.cpp running over the port.

Encodings are compared byte for byte (tolerance 0: the same integer and
IEEE packing on both sides). The generated stub runs in this process
against a port server, and in a subprocess that blocks ``brpc_tpu`` and
``jax`` to show it needs neither.
"""

import os
import subprocess
import sys
from concurrent import futures

import numpy as np
import pytest

from brpc_tpu.runtime import tidl as jtidl
from brpc_tpu_torch.runtime import native
from brpc_tpu_torch.runtime import tidl as ttidl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEMA = os.path.join(ROOT, "examples", "echo.tidl")


def _ident(b):
    return b


@pytest.fixture(scope="module")
def _native_lib():
    from conftest import require_native_lib
    require_native_lib()


# ---- gRPC ----------------------------------------------------------------

@pytest.fixture(scope="module")
def grpcio_server():
    grpc = pytest.importorskip("grpc")

    def echo(request, context):
        return request

    def fail(request, context):
        context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, "boom")

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        "EchoService",
        {"Echo": grpc.unary_unary_rpc_method_handler(echo),
         "Fail": grpc.unary_unary_rpc_method_handler(fail)}),))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    yield f"127.0.0.1:{port}"
    server.stop(grace=None)


def test_grpc_channel_calls_a_grpcio_server(_native_lib, grpcio_server):
    ch = native.Channel(grpcio_server, timeout_ms=10000, protocol="grpc")
    try:
        for i in range(5):
            payload = (f"m{i}-" + "x" * (i * 777)).encode()
            assert ch.call("EchoService/Echo", payload) == (payload, b"")
        with pytest.raises(native.RpcError) as ei:
            ch.call("EchoService/Fail", b"x")
        # RESOURCE_EXHAUSTED maps to the concurrency-limit code.
        assert ei.value.code == native.TRPC_ELIMIT and "boom" in ei.value.text
    finally:
        ch.close()


def test_grpc_channel_calls_a_port_server(_native_lib):
    srv = native.Server()
    srv.add_echo_service()
    port = srv.start()
    ch = native.Channel(f"127.0.0.1:{port}", timeout_ms=10000,
                        protocol="grpc")
    try:
        payload = os.urandom(1 << 16)
        assert ch.call("EchoService/Echo", payload)[0] == payload
    finally:
        ch.close()
        srv.close()


def test_channel_refuses_an_unknown_protocol(_native_lib):
    with pytest.raises(ValueError, match="unknown protocol"):
        native.Channel("127.0.0.1:1", protocol="thrift")


@pytest.fixture(scope="module")
def tls_material(tmp_path_factory):
    """A self-signed localhost certificate made on the fly."""
    pytest.importorskip("cryptography",
                        reason="TLS tests need the cryptography package")
    import datetime
    import ipaddress

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    d = tmp_path_factory.mktemp("tls")
    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "localhost")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(days=1))
            .not_valid_after(now + datetime.timedelta(days=365))
            .add_extension(x509.SubjectAlternativeName(
                [x509.DNSName("localhost"),
                 x509.IPAddress(ipaddress.ip_address("127.0.0.1"))]),
                critical=False)
            .sign(key, hashes.SHA256()))
    cert_pem = cert.public_bytes(serialization.Encoding.PEM)
    cert_path, key_path = d / "cert.pem", d / "key.pem"
    cert_path.write_bytes(cert_pem)
    key_path.write_bytes(key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption()))
    return str(cert_path), str(key_path), cert_pem


def test_tls_port_server_accepts_a_grpcio_tls_client(_native_lib,
                                                     tls_material):
    grpc = pytest.importorskip("grpc")
    cert_path, key_path, cert_pem = tls_material
    srv = native.Server()
    srv.add_echo_service()
    port = srv.start("127.0.0.1:0", ssl_cert=cert_path, ssl_key=key_path)
    try:
        creds = grpc.ssl_channel_credentials(root_certificates=cert_pem)
        opts = (("grpc.ssl_target_name_override", "localhost"),)
        with grpc.secure_channel(f"127.0.0.1:{port}", creds,
                                 options=opts) as channel:
            call = channel.unary_unary("/EchoService/Echo",
                                       request_serializer=_ident,
                                       response_deserializer=_ident)
            for i in range(4):
                payload = (f"tls-{i}-" + "y" * (i * 531)).encode()
                assert call(payload, timeout=10) == payload
        # The sniffing listener still answers plaintext on the same port.
        ch = native.Channel(f"127.0.0.1:{port}", timeout_ms=10000)
        try:
            assert ch.call("EchoService/Echo", b"plain")[0] == b"plain"
        finally:
            ch.close()
    finally:
        srv.close()


def test_bench_echo_bindings_measure_a_loopback_echo(_native_lib):
    bps, qps, p50, p99 = native.bench_echo_ex(4096, seconds=1,
                                              concurrency=1)
    assert bps > 0 and qps > 0 and 0 < p50 <= p99


# ---- tidl: the wire runtime ----------------------------------------------

def _values(seed):
    rng = np.random.default_rng(seed)
    ints = [0, 1, 127, 128, 300, 2**31 - 1, 2**31, 2**63 - 1, -1, -2**31,
            -2**63] + [int(v) for v in rng.integers(-2**62, 2**62, 32)]
    floats = [0.0, -0.0, 1.5, float("inf"), 3.4e38, 1e-45] + [
        float(v) for v in rng.standard_normal(16) * 1e6]
    blobs = [b"", b"x", "héllo".encode(), bytes(rng.integers(
        0, 256, 300, dtype=np.uint8))]
    return ints, floats, blobs


@pytest.mark.parametrize("kind", ["uint", "sint", "bytes", "f64", "f32",
                                  "varint", "tag"])
def test_tidl_encode_is_byte_identical_to_jax(kind):
    ints, floats, blobs = _values(seed=len(kind))
    cases = {"uint": ints, "sint": ints, "bytes": blobs, "f64": floats,
             "f32": [float(np.float32(f)) for f in floats],
             "varint": [abs(v) for v in ints],
             "tag": [(f, wt) for f in (1, 15, 16, 2047, 536870911)
                     for wt in (0, 1, 2, 5)]}[kind]
    for field, v in enumerate(cases, start=1):
        a, b = bytearray(), bytearray()
        if kind == "varint":
            ttidl.put_varint(a, v)
            jtidl.put_varint(b, v)
        elif kind == "tag":
            ttidl.put_tag(a, *v)
            jtidl.put_tag(b, *v)
        else:
            getattr(ttidl, f"put_{kind}")(a, field, v)
            getattr(jtidl, f"put_{kind}")(b, field, v)
        assert bytes(a) == bytes(b), (kind, v)
        # And the port's reader takes back what either wrote.
        r = ttidl.Reader(bytes(b))
        if kind == "varint":
            assert r.varint() == v
        elif kind == "tag":
            assert r.tag() == v
        else:
            assert r.tag()[0] == field
            got = {"uint": lambda: ttidl.to_int64(r.varint()),
                   "sint": lambda: ttidl.unzigzag(r.varint()),
                   "bytes": r.bytes, "f64": r.f64, "f32": r.f32}[kind]()
            if isinstance(v, float) and v != v:
                assert got != got
            else:
                assert got == v, (kind, v, got)
        assert r.done()


def test_tidl_helpers_and_reader_errors_match_jax():
    for v in (-2**63, -5, -1, 0, 1, 5, 2**63 - 1):
        assert ttidl.zigzag(v) == jtidl.zigzag(v)
        assert ttidl.unzigzag(ttidl.zigzag(v)) == v
    for v in (0, 2**31, 2**32 + 7, 2**63, 2**64 - 1):
        assert ttidl.to_int32(v) == jtidl.to_int32(v)
        assert ttidl.to_int64(v) == jtidl.to_int64(v)
    for data, op in ((b"\x80", "varint"), (b"\x0a\x05ab", "skip_len"),
                     (b"\x00", "tag"), (b"\x01\x02", "f64")):
        for mod in (ttidl, jtidl):
            r = mod.Reader(data)
            with pytest.raises(ValueError):
                if op == "skip_len":
                    r.skip(r.tag()[1])
                elif op == "f64":
                    r.f64()
                else:
                    getattr(r, op)()
    with pytest.raises(ValueError, match="bad wire type"):
        ttidl.Reader(b"").skip(3)


# ---- tidl: a generated stub over the port ---------------------------------

@pytest.fixture(scope="module")
def echo_stub(tmp_path_factory):
    path = ttidl.generate(SCHEMA, str(tmp_path_factory.mktemp("tidl_out")))
    with open(path) as f:
        assert "from brpc_tpu.runtime import tidl as _rt" in f.read()
    return path


def test_generated_stub_runs_over_a_port_server(_native_lib, echo_stub):
    stub = ttidl.load_stub(echo_stub, "echo_tidl_over_port")
    assert stub._native is native and stub._rt is ttidl

    class Impl:
        def __init__(self):
            self.served = 0

        def Echo(self, request, attachment):
            self.served += 1
            return stub.EchoResponse(
                message=request.message, serial=request.serial,
                stats=stub.Stats(served=self.served,
                                 mean_len=len(request.message) / 2)), \
                attachment

    srv = native.Server()
    stub.add_EchoService(srv, Impl())
    port = srv.start()
    ch = native.Channel(f"127.0.0.1:{port}", timeout_ms=5000)
    try:
        client = stub.EchoServiceStub(ch)
        for i in range(3):
            resp, att = client.Echo(
                stub.EchoRequest(message=f"msg{i}", serial=-i,
                                 history=list(range(i))),
                attachment=b"side")
            assert (resp.message, resp.serial, resp.stats.served,
                    att) == (f"msg{i}", -i, i + 1, b"side")
    finally:
        ch.close()
        srv.close()
    # The port's encoding of a message equals the JAX runtime's.
    req = stub.EchoRequest(message="héllo", serial=-3,
                           history=[1, 2, 300000])
    jax_side = ttidl.load_stub(echo_stub, "echo_tidl_probe")
    jax_side._rt = jtidl  # the same generated code over the JAX runtime
    assert req.encode() == jax_side.EchoRequest(
        message="héllo", serial=-3, history=[1, 2, 300000]).encode()
    assert stub.EchoRequest.decode(req.encode()) == req


def test_generated_stub_needs_neither_jax_nor_brpc_tpu(echo_stub):
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['brpc_tpu'] = None\n"
        "from brpc_tpu_torch.runtime import native, tidl\n"
        f"stub = tidl.load_stub({echo_stub!r})\n"
        "srv = native.Server()\n"
        "class Impl:\n"
        "    def Echo(self, request, attachment):\n"
        "        return stub.EchoResponse(message=request.message[::-1]),"
        " b''\n"
        "stub.add_EchoService(srv, Impl())\n"
        "ch = native.Channel(f'127.0.0.1:{srv.start()}', timeout_ms=5000)\n"
        "resp, _ = stub.EchoServiceStub(ch).Echo("
        "stub.EchoRequest(message='abc'))\n"
        "assert resp.message == 'cba', resp\n"
        "assert not any(m.split('.')[0] in ('jax', 'brpc_tpu')\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "ch.close(); srv.close()\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split()[-1] == "ok"
