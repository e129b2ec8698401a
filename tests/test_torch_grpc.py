"""The port's counterpart of the JAX package's ``tests/test_grpc.py``:
every case runs against the port's servers and clients.

gRPC / HTTP/2 protocol tests: HPACK RFC 7541 vectors, h2 framing, and
client+server integration over real loopback sockets (the reference's
per-protocol conformance pattern, test/brpc_http_rpc_protocol_unittest.cpp).

Beside them: gRPC between the packages (a JAX client against a port server
and a port client against a JAX server, on the Python h2 lane and on the
engines' h2 lanes, response bytes equal), and the two faults of the
reference's Python h2 layer, raw h2 frames at a Python listener of each
package: a SETTINGS_INITIAL_WINDOW_SIZE of 2^31 (the port answers GOAWAY
with FLOW_CONTROL_ERROR, the reference adopts it) and streams past the
advertised MAX_CONCURRENT_STREAMS (the port refuses them with
RST_STREAM(REFUSED_STREAM), the reference opens every one)."""

import socket as _socket
import struct
import threading
import time

import numpy as np
import pytest

import brpc_tpu.rpc as jrpc
from brpc_tpu.proto import echo_pb2 as jecho_pb2
from brpc_tpu.rpc import native_transport as jnative_transport

from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.policy import h2 as _h2
from brpc_tpu_torch.policy.compress import COMPRESS_GZIP
from brpc_tpu_torch.policy.grpc_protocol import (
    BRPC_TO_GRPC,
    decode_timeout,
    encode_timeout,
)
from brpc_tpu_torch.policy.hpack import (
    HpackDecoder,
    HpackEncoder,
    HpackError,
    huffman_decode,
    huffman_encode,
)
from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import native_transport as port_native_transport
from brpc_tpu_torch.rpc import (
    Channel,
    ChannelOptions,
    Controller,
    RpcError,
    Server,
    ServerOptions,
    Service,
    Stub,
    errors,
)

ECHO_DESC = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]


# ---------------------------------------------------------------- HPACK unit
class TestHuffman:
    # RFC 7541 Appendix C reference encodings
    VECTORS = [
        (b"www.example.com", "f1e3c2e5f23a6ba0ab90f4ff"),
        (b"no-cache", "a8eb10649cbf"),
        (b"custom-key", "25a849e95ba97d7f"),
        (b"custom-value", "25a849e95bb8e8b4bf"),
        (b"302", "6402"),
        (b"private", "aec3771a4b"),
        (b"Mon, 21 Oct 2013 20:13:21 GMT",
         "d07abe941054d444a8200595040b8166e082a62d1bff"),
        (b"https://www.example.com", "9d29ad171863c78f0b97c8e9ae82ae43d3"),
        (b"gzip", "9bd9ab"),
    ]

    def test_rfc_vectors(self):
        for raw, hexenc in self.VECTORS:
            assert huffman_encode(raw).hex() == hexenc
            assert huffman_decode(bytes.fromhex(hexenc)) == raw

    def test_all_bytes_roundtrip(self):
        data = bytes(range(256)) * 3
        assert huffman_decode(huffman_encode(data)) == data

    def test_bad_padding_rejected(self):
        with pytest.raises(HpackError):
            huffman_decode(huffman_encode(b"abc") + b"\x00")


class TestHpack:
    def test_rfc_c3_request_sequence(self):
        d = HpackDecoder()
        h1 = d.decode(bytes.fromhex(
            "828684410f7777772e6578616d706c652e636f6d"))
        assert h1 == [(":method", "GET"), (":scheme", "http"),
                      (":path", "/"), (":authority", "www.example.com")]
        h2 = d.decode(bytes.fromhex("828684be58086e6f2d6361636865"))
        assert h2[-1] == ("cache-control", "no-cache")
        h3 = d.decode(bytes.fromhex(
            "828785bf400a637573746f6d2d6b65790c637573746f6d2d76616c7565"))
        assert h3[1] == (":scheme", "https")
        assert h3[-1] == ("custom-key", "custom-value")

    def test_rfc_c6_response_sequence_with_eviction(self):
        d = HpackDecoder(max_table_size=256)
        r1 = d.decode(bytes.fromhex(
            "488264025885aec3771a4b6196d07abe941054d444a8200595040b8166"
            "e082a62d1bff6e919d29ad171863c78f0b97c8e9ae82ae43d3"))
        assert r1[0] == (":status", "302")
        assert r1[3] == ("location", "https://www.example.com")
        r2 = d.decode(bytes.fromhex("4883640effc1c0bf"))
        assert r2[0] == (":status", "307")

    def test_encoder_decoder_roundtrip_with_dynamic_table(self):
        enc, dec = HpackEncoder(), HpackDecoder()
        headers = [(":method", "POST"), (":path", "/pkg.Echo/Call"),
                   ("content-type", "application/grpc"),
                   ("x-request-id", "abc-123-def")]
        for _ in range(3):  # later rounds hit the dynamic table
            assert dec.decode(enc.encode(headers)) == headers
        # second block should be far smaller (all indexed)
        first = HpackEncoder().encode(headers)
        enc2 = HpackEncoder()
        enc2.encode(headers)
        assert len(enc2.encode(headers)) < len(first) / 3


# ------------------------------------------------------------------- h2 unit
class TestH2Framing:
    def test_frame_roundtrip(self):
        f = _h2.pack_frame(_h2.DATA, _h2.FLAG_END_STREAM, 5, b"hello")
        assert len(f) == 9 + 5
        n = (f[0] << 16) | (f[1] << 8) | f[2]
        assert n == 5 and f[3] == _h2.DATA and f[4] == _h2.FLAG_END_STREAM
        assert struct.unpack("!I", f[5:9])[0] == 5
        assert f[9:] == b"hello"

    def test_grpc_timeout_codec(self):
        assert decode_timeout(encode_timeout(250)) == 250
        assert decode_timeout("2S") == 2000
        assert decode_timeout("90M") == 90 * 60000
        assert decode_timeout("500u") == 1  # sub-ms rounds up
        assert decode_timeout("oops") is None


# -------------------------------------------------------------- integration
class GrpcEchoImpl(Service):
    DESCRIPTOR = ECHO_DESC

    def __init__(self):
        super().__init__()
        self.calls = 0

    def Echo(self, cntl, request, done):
        self.calls += 1
        if request.message == "fail":
            cntl.set_failed(errors.EINTERNAL, "requested failure")
            return None
        if request.sleep_us:
            time.sleep(request.sleep_us / 1e6)
        return echo_pb2.EchoResponse(
            message=request.message, payload=request.payload)


@pytest.fixture()
def grpc_server():
    impl = GrpcEchoImpl()
    server = Server().add_service(impl).start("127.0.0.1:0")
    yield server, impl
    server.stop()
    server.join(timeout=2)


def grpc_stub(server, **opts):
    opts.setdefault("protocol", "grpc")
    ch = Channel(ChannelOptions(**opts)).init(str(server.listen_endpoint()))
    return ch, Stub(ch, ECHO_DESC)


class TestGrpcEndToEnd:
    def test_unary_echo(self, grpc_server):
        server, impl = grpc_server
        _, stub = grpc_stub(server)
        resp = stub.Echo(echo_pb2.EchoRequest(message="hello-grpc"))
        assert resp.message == "hello-grpc"
        assert impl.calls == 1

    def test_many_calls_multiplex_one_connection(self, grpc_server):
        server, impl = grpc_server
        _, stub = grpc_stub(server)
        for i in range(32):
            assert stub.Echo(echo_pb2.EchoRequest(message=f"m{i}")).message == f"m{i}"
        assert server.connection_count() == 1  # h2 multiplexes
        assert impl.calls == 32

    def test_concurrent_streams(self, grpc_server):
        server, _ = grpc_server
        _, stub = grpc_stub(server, timeout_ms=5000)
        results, lock = [], threading.Lock()

        def worker(i):
            r = stub.Echo(echo_pb2.EchoRequest(message=f"c{i}", sleep_us=10000))
            with lock:
                results.append(r.message)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sorted(results) == sorted(f"c{i}" for i in range(16))

    def test_async_call(self, grpc_server):
        server, _ = grpc_server
        _, stub = grpc_stub(server)
        ev = threading.Event()
        got = []

        def on_done(cntl):
            got.append(cntl)
            ev.set()

        stub.Echo(echo_pb2.EchoRequest(message="async"), done=on_done)
        assert ev.wait(5)
        assert not got[0].failed()
        assert got[0].response.message == "async"

    def test_error_maps_to_grpc_status_and_back(self, grpc_server):
        server, _ = grpc_server
        _, stub = grpc_stub(server)
        with pytest.raises(RpcError) as ei:
            stub.Echo(echo_pb2.EchoRequest(message="fail"))
        assert ei.value.error_code == errors.EINTERNAL
        assert "requested failure" in str(ei.value)

    def test_no_such_method_is_unimplemented(self, grpc_server):
        server, _ = grpc_server
        ch, _ = grpc_stub(server)
        from brpc_tpu_torch.rpc.channel import MethodDescriptor

        md = MethodDescriptor("EchoService", "Nope",
                              echo_pb2.EchoRequest, echo_pb2.EchoResponse)
        cntl = Controller()
        with pytest.raises(RpcError):
            ch.call_method(md, echo_pb2.EchoRequest(message="x"),
                           controller=cntl)
        assert cntl.error_code == errors.ENOMETHOD

    def test_large_payload_flow_control(self, grpc_server):
        # 4 MB payload: exceeds the default 64 KB peer window before the
        # server's SETTINGS arrive -> exercises queued sends + WINDOW_UPDATE
        server, _ = grpc_server
        _, stub = grpc_stub(server, timeout_ms=15000)
        blob = bytes(range(256)) * (4 * 1024 * 16)  # 4 MiB
        resp = stub.Echo(echo_pb2.EchoRequest(message="big", payload=blob))
        assert resp.payload == blob

    def test_gzip_compression(self, grpc_server):
        server, _ = grpc_server
        _, stub = grpc_stub(server, compress_type=COMPRESS_GZIP)
        blob = b"z" * 100000
        resp = stub.Echo(echo_pb2.EchoRequest(message="zip", payload=blob))
        assert resp.payload == blob

    def test_deadline_exceeded(self, grpc_server):
        server, _ = grpc_server
        _, stub = grpc_stub(server, timeout_ms=80, max_retry=0)
        cntl = Controller()
        with pytest.raises(RpcError):
            stub.Echo(echo_pb2.EchoRequest(message="slow", sleep_us=500000),
                      controller=cntl)
        assert cntl.error_code == errors.ERPCTIMEDOUT

    def test_mixed_protocols_same_server(self, grpc_server):
        # one server port speaks trpc_std AND grpc simultaneously
        server, impl = grpc_server
        _, gstub = grpc_stub(server)
        ch = Channel(ChannelOptions()).init(str(server.listen_endpoint()))
        tstub = Stub(ch, ECHO_DESC)
        assert gstub.Echo(echo_pb2.EchoRequest(message="g")).message == "g"
        assert tstub.Echo(echo_pb2.EchoRequest(message="t")).message == "t"
        assert impl.calls == 2


class TestGrpcWire:
    """Craft raw h2/gRPC bytes against the server — wire conformance from a
    from-scratch client (nothing shared with our client stack)."""

    def test_handmade_grpc_client(self, grpc_server):
        import socket as pysocket

        server, _ = grpc_server
        ep = server.listen_endpoint()
        enc, dec = HpackEncoder(), HpackDecoder()
        s = pysocket.create_connection((ep.host, ep.port), timeout=5)
        try:
            req = echo_pb2.EchoRequest(message="raw-wire").SerializeToString()
            body = b"\x00" + len(req).to_bytes(4, "big") + req
            block = enc.encode([
                (":method", "POST"), (":scheme", "http"),
                (":path", "/EchoService/Echo"), (":authority", "test"),
                ("content-type", "application/grpc"), ("te", "trailers"),
            ])
            s.sendall(
                _h2.PREFACE
                + _h2.pack_settings([])
                + _h2.pack_frame(_h2.HEADERS,
                                 _h2.FLAG_END_HEADERS, 1, block)
                + _h2.pack_frame(_h2.DATA, _h2.FLAG_END_STREAM, 1, body))
            # read frames until stream 1's trailers (END_STREAM headers)
            buf = b""
            data = b""
            trailers = {}
            deadline = time.time() + 5
            done = False
            while not done and time.time() < deadline:
                chunk = s.recv(65536)
                assert chunk, "server closed early"
                buf += chunk
                while len(buf) >= 9:
                    n = (buf[0] << 16) | (buf[1] << 8) | buf[2]
                    if len(buf) < 9 + n:
                        break
                    ftype, flags = buf[3], buf[4]
                    sid = struct.unpack("!I", buf[5:9])[0] & 0x7FFFFFFF
                    payload = buf[9:9 + n]
                    buf = buf[9 + n:]
                    if ftype == _h2.SETTINGS and not flags & _h2.FLAG_ACK:
                        s.sendall(_h2.pack_settings([], ack=True))
                    elif ftype == _h2.DATA and sid == 1:
                        data += payload
                    elif ftype == _h2.HEADERS and sid == 1:
                        hdrs = dict(dec.decode(payload))
                        if flags & _h2.FLAG_END_STREAM:
                            trailers = hdrs
                            done = True
            assert trailers.get("grpc-status") == "0", trailers
            assert data[0] == 0
            resp = echo_pb2.EchoResponse()
            resp.ParseFromString(data[5:])
            assert resp.message == "raw-wire"
        finally:
            s.close()


class TestGrpcHealth:
    def test_builtin_health_check(self, grpc_server):
        from brpc_tpu_torch.proto import health_pb2

        server, _ = grpc_server
        ch = Channel(ChannelOptions(protocol="grpc")).init(
            str(server.listen_endpoint()))
        stub = Stub(ch, health_pb2.DESCRIPTOR.services_by_name["Health"])
        resp = stub.Check(health_pb2.HealthCheckRequest())
        assert resp.status == health_pb2.HealthCheckResponse.SERVING
        resp = stub.Check(health_pb2.HealthCheckRequest(
            service="grpc.health.v1.Health"))
        assert resp.status == health_pb2.HealthCheckResponse.SERVING
        resp = stub.Check(health_pb2.HealthCheckRequest(service="Nope"))
        assert resp.status == health_pb2.HealthCheckResponse.SERVICE_UNKNOWN


class TestPlainHttp2Dashboard:
    def test_h2_get_health(self, grpc_server):
        """A non-grpc HTTP/2 GET (curl --http2 style) reaches the builtin
        dashboard on the same port."""
        import socket as _socket
        import struct as _struct

        from brpc_tpu_torch.policy.h2 import PREFACE, pack_frame, pack_settings
        from brpc_tpu_torch.policy.hpack import HpackDecoder, HpackEncoder

        server, _impl = grpc_server
        ep = server.listen_endpoint()
        enc = HpackEncoder()
        hdrs = enc.encode([(":method", "GET"), (":scheme", "http"),
                           (":path", "/health"), (":authority", "t")])
        with _socket.create_connection((ep.host, ep.port), timeout=5) as s:
            s.sendall(PREFACE + pack_settings([]) +
                      pack_frame(1, 0x4 | 0x1, 1, hdrs))
            s.settimeout(5)
            buf = b""
            status = None
            body = b""
            dec = HpackDecoder()
            done = False
            while not done:
                chunk = s.recv(65536)
                if not chunk:
                    break
                buf += chunk
                while len(buf) >= 9:
                    ln = (buf[0] << 16) | (buf[1] << 8) | buf[2]
                    if len(buf) < 9 + ln:
                        break
                    ftype, flags = buf[3], buf[4]
                    payload = buf[9:9 + ln]
                    buf = buf[9 + ln:]
                    if ftype == 1:  # HEADERS
                        got = dict(dec.decode(payload))
                        status = got.get(":status")
                    elif ftype == 0:  # DATA
                        body += payload
                        if flags & 0x1:
                            done = True
                            break
        assert status == "200", status
        assert body  # /health answered over plain h2


# ---------------------------------------------------------------------------
#  gRPC between the packages
# ---------------------------------------------------------------------------
class _JaxEcho(jrpc.Service):
    DESCRIPTOR = jecho_pb2.DESCRIPTOR.services_by_name["EchoService"]

    def Echo(self, cntl, request, done):
        return jecho_pb2.EchoResponse(message=request.message,
                                      payload=request.payload)


_PKGS = {
    "port": (Server, ServerOptions, Channel, ChannelOptions, Stub,
             echo_pb2, GrpcEchoImpl),
    "jax": (jrpc.Server, jrpc.ServerOptions, jrpc.Channel,
            jrpc.ChannelOptions, jrpc.Stub, jecho_pb2, _JaxEcho),
}


@pytest.fixture(scope="module", autouse=True)
def _close_native_clients():
    """Both engines' shared gRPC client conns go with the module."""
    yield
    for mod in (jnative_transport, port_native_transport):
        dp = mod._dataplane
        if dp is None:
            continue
        with dp._conn_map_lock:
            socks = list(dp._conn_map.values())
            dp._conn_map.clear()
        for sock in socks:
            if not sock.failed:
                sock.close()


class TestPackagePairings:
    """A gRPC client of one package against a server of the other, on the
    Python h2 lane (Python client and acceptor) and on the engines' h2
    lanes (``native_transport=True`` client, ``native_dataplane=True``
    server): the response bytes equal the port-to-port call's."""

    @pytest.mark.parametrize("native", [False, True],
                             ids=["python_h2", "engine_h2"])
    def test_four_pairings_answer_the_same_bytes(self, native):
        rng = np.random.default_rng(29)
        payload = rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes()
        got = {}
        for spkg in ("port", "jax"):
            srv_cls, opts_cls, *_, impl = _PKGS[spkg]
            srv = srv_cls(opts_cls(native_dataplane=native))
            srv.add_service(impl())
            srv.start("127.0.0.1:0")
            try:
                for cpkg in ("port", "jax"):
                    _, _, ch_cls, ch_opts, stub_cls, pb, _ = _PKGS[cpkg]
                    ch = ch_cls(ch_opts(protocol="grpc", timeout_ms=15000,
                                        max_retry=0,
                                        native_transport=native))
                    ch.init(str(srv.listen_endpoint()))
                    stub = stub_cls(
                        ch, pb.DESCRIPTOR.services_by_name["EchoService"])
                    resp = stub.Echo(pb.EchoRequest(message=f"{cpkg}>{spkg}",
                                                    payload=payload))
                    got[(cpkg, spkg)] = pb.EchoResponse(
                        message="", payload=resp.payload).SerializeToString()
                    assert resp.message == f"{cpkg}>{spkg}"
            finally:
                srv.stop()
                srv.join()
        want = got[("port", "port")]
        assert echo_pb2.EchoResponse.FromString(want).payload == payload
        for key, val in got.items():
            assert val == want, key


# ---------------------------------------------------------------------------
#  The Python h2 layer's two faults, raw frames at a Python listener
# ---------------------------------------------------------------------------
def _frames(sock, until, timeout=10.0):
    """Read h2 frames (type, flags, sid, payload) until ``until(frame)``,
    EOF or the deadline; returns (frames, "match" | "eof" | "timeout")."""
    got, buf = [], b""
    deadline = time.monotonic() + timeout
    while True:
        while len(buf) >= 9:
            n = int.from_bytes(buf[:3], "big")
            if len(buf) < 9 + n:
                break
            f = (buf[3], buf[4], int.from_bytes(buf[5:9], "big") & 0x7FFFFFFF,
                 buf[9:9 + n])
            buf = buf[9 + n:]
            got.append(f)
            if until(f):
                return got, "match"
        left = deadline - time.monotonic()
        if left <= 0:
            return got, "timeout"
        sock.settimeout(left)
        try:
            chunk = sock.recv(1 << 16)
        except _socket.timeout:
            return got, "timeout"
        except OSError:
            return got, "eof"
        if not chunk:
            return got, "eof"
        buf += chunk


def _request_headers(enc):
    return enc.encode([(":method", "POST"), (":scheme", "http"),
                       (":path", "/EchoService/Echo"), (":authority", "t"),
                       ("content-type", "application/grpc"),
                       ("te", "trailers")])


@pytest.fixture(params=["jax", "port"])
def python_h2_server(request):
    """A plain (Python acceptor) server of either package."""
    srv_cls, opts_cls, *_, impl = _PKGS[request.param]
    srv = srv_cls(opts_cls())
    srv.add_service(impl())
    srv.start("127.0.0.1:0")
    yield request.param, srv
    srv.stop()
    srv.join()


class TestPythonH2Faults:
    """The same frames at both packages' Python h2 layers: the reference
    shows the fault, the port refuses as its engine does."""

    def test_initial_window_size_above_2_31(self, python_h2_server):
        pkg, srv = python_h2_server
        ep = srv.listen_endpoint()
        enc, dec = HpackEncoder(), HpackDecoder()
        req = echo_pb2.EchoRequest(message="w").SerializeToString()
        with _socket.create_connection((ep.host, ep.port), timeout=10) as s:
            s.sendall(_h2.PREFACE + _h2.pack_settings(
                [(_h2.S_INITIAL_WINDOW_SIZE, 1 << 31)]))
            s.sendall(_h2.pack_frame(_h2.HEADERS, _h2.FLAG_END_HEADERS, 1,
                                     _request_headers(enc))
                      + _h2.pack_frame(_h2.DATA, _h2.FLAG_END_STREAM, 1,
                                       b"\x00" + len(req).to_bytes(4, "big")
                                       + req))
            got, why = _frames(s, lambda f: f[0] == _h2.GOAWAY or (
                f[0] == _h2.HEADERS and f[2] == 1
                and f[1] & _h2.FLAG_END_STREAM))
        assert why == "match", (why, got)
        last = got[-1]
        if pkg == "jax":
            # the reference adopts the window and answers the request
            assert last[0] == _h2.HEADERS
            trailers = None
            for f in got:
                if f[0] == _h2.HEADERS:
                    trailers = dict(dec.decode(f[3]))
            assert trailers.get("grpc-status") == "0"
        else:
            assert last[0] == _h2.GOAWAY
            assert int.from_bytes(last[3][4:8], "big") == \
                _h2.FLOW_CONTROL_ERROR
            assert not any(f[0] == _h2.HEADERS for f in got)

    def test_max_concurrent_streams_enforced(self, python_h2_server):
        pkg, srv = python_h2_server
        ep = srv.listen_endpoint()
        enc = HpackEncoder()
        with _socket.create_connection((ep.host, ep.port), timeout=10) as s:
            s.sendall(_h2.PREFACE + _h2.pack_settings([]))
            # 1100 open streams (HEADERS without END_STREAM) against the
            # advertised MAX_CONCURRENT_STREAMS
            s.sendall(b"".join(
                _h2.pack_frame(_h2.HEADERS, _h2.FLAG_END_HEADERS, sid,
                               _request_headers(enc))
                for sid in range(1, 1 + 2 * 1100, 2)))
            s.sendall(_h2.pack_frame(_h2.PING, 0, 0, b"pingpong"))
            got, why = _frames(s, lambda f: f[0] == _h2.PING
                               and f[1] & _h2.FLAG_ACK)
        assert why == "match"
        settings = next(f for f in got if f[0] == _h2.SETTINGS
                        and not f[1] & _h2.FLAG_ACK)
        advertised = dict(struct.unpack_from("!HI", settings[3], off)
                          for off in range(0, len(settings[3]), 6))
        refused = [f[2] for f in got if f[0] == _h2.RST_STREAM
                   and int.from_bytes(f[3], "big") == _h2.REFUSED_STREAM]
        if pkg == "jax":
            assert advertised[_h2.S_MAX_CONCURRENT_STREAMS] == 1 << 20
            assert refused == []
        else:
            assert advertised[_h2.S_MAX_CONCURRENT_STREAMS] == 1024
            assert refused == list(range(1 + 2 * 1024, 1 + 2 * 1100, 2))
