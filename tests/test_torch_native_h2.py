"""The port's native h2/gRPC data plane: every case of the JAX package's
``tests/test_native_h2.py`` against the port's engine
(``brpc_tpu_torch/native/dataplane.cpp``) and its Python surface. The
engine owns h2 framing, HPACK and flow control; grpc unary requests ride
the EV_REQUEST fast path and the native-echo registry (reference
semantics: ``src/brpc/policy/http2_rpc_protocol.cpp`` and
``details/hpack.cpp``). The engine is no optional accelerator in the port:
it is built on first use and a failed build raises, so nothing here skips.

Covered here:
- Python grpc client (Python transport) -> native listener: the engine
  sniffs the h2 preface, decodes HPACK, dispatches to the Python service,
  encodes the h2 response.
- Python grpc client over the NATIVE lane (dp_connect_grpc): the client
  h2 framing happens in C++ too (sync = engine-parked dp_call_sync).
- Window-parked responses (payload >> the client's 65535 initial window).
- Error mapping (unknown method -> UNIMPLEMENTED -> ENOMETHOD).
- Stream multiplexing (concurrent sync calls share one h2 conn).
- Non-grpc h2 on a native listener detaches to the Python h2 stack with
  the raw bytes replayed (dashboard-over-h2 still works).
- The C++ grpc load generator end to end (native client + native server
  h2, Python service).
"""

import threading

import pytest

from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Controller, Server,
                                ServerOptions, Service, Stub, errors)
from brpc_tpu_torch.rpc.channel import RpcError

from brpc_tpu_torch.rpc.native_transport import bench_echo_native

ECHO_DESC = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]


class EchoImpl(Service):
    DESCRIPTOR = ECHO_DESC

    def Echo(self, cntl, request, done):
        return echo_pb2.EchoResponse(message=request.message,
                                     payload=request.payload)


@pytest.fixture
def native_server():
    srv = Server(ServerOptions(native_dataplane=True, usercode_inline=True))
    srv.add_service(EchoImpl())
    srv.start("127.0.0.1:0")
    yield srv
    srv.stop()
    srv.join()


def _stub(server, **opts):
    opts.setdefault("protocol", "grpc")
    opts.setdefault("timeout_ms", 10000)
    ch = Channel(ChannelOptions(**opts))
    ch.init(str(server.listen_endpoint()))
    return Stub(ch, ECHO_DESC)


class TestNativeH2Server:
    def test_py_grpc_client_echo(self, native_server):
        stub = _stub(native_server)
        r = stub.Echo(echo_pb2.EchoRequest(message="hello", payload=b"p"))
        assert r.message == "hello" and r.payload == b"p"

    def test_window_parked_response(self, native_server):
        # 200KB >> the Python client's 65535 initial stream window: the
        # engine parks DATA and drains on WINDOW_UPDATE (h2_pump)
        stub = _stub(native_server)
        big = bytes(range(256)) * 800
        r = stub.Echo(echo_pb2.EchoRequest(message="big", payload=big))
        assert r.payload == big

    def test_unserved_service_maps_to_unimplemented(self):
        # a native server WITHOUT EchoService: grpc UNIMPLEMENTED comes
        # back and reverse-maps to ENOMETHOD (grpc_protocol.GRPC_TO_BRPC)
        srv = Server(ServerOptions(native_dataplane=True,
                                   usercode_inline=True))
        srv.start("127.0.0.1:0")
        try:
            stub = _stub(srv)
            with pytest.raises(RpcError) as ei:
                stub.Echo(echo_pb2.EchoRequest(message="x"))
            assert ei.value.error_code in (errors.ENOSERVICE,
                                           errors.ENOMETHOD)
        finally:
            srv.stop()
            srv.join()

    def test_multiplexed_concurrent_sync_calls(self, native_server):
        stub = _stub(native_server, native_transport=True)
        outs, errs = [], []

        def worker(i):
            try:
                r = stub.Echo(echo_pb2.EchoRequest(message=f"m{i}"))
                outs.append(r.message)
            except BaseException as e:  # noqa: BLE001 - collected
                errs.append(e)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errs, errs
        assert sorted(outs) == [f"m{i}" for i in range(8)]

    def test_native_client_lane(self, native_server):
        # dp_connect_grpc: the CLIENT h2 framing is C++ too
        stub = _stub(native_server, native_transport=True)
        r = stub.Echo(echo_pb2.EchoRequest(message="native", payload=b"zz"))
        assert r.message == "native" and r.payload == b"zz"

    def test_native_client_big_request_and_response(self, native_server):
        stub = _stub(native_server, native_transport=True)
        big = b"\xa5" * 300000
        r = stub.Echo(echo_pb2.EchoRequest(message="b", payload=big))
        assert r.payload == big

    def test_cpp_loadgen_grpc(self, native_server):
        host, port = str(native_server.listen_endpoint()).rsplit(":", 1)
        res = bench_echo_native(host, int(port), conns=2, depth=4,
                                payload=16, duration_ms=400, grpc=True)
        assert res is not None and res["qps"] > 100, res

    def test_non_grpc_h2_detaches_to_python(self, native_server):
        # an h2 GET (no grpc content-type) must reach the Python h2 stack
        # (builtin dashboard) — the engine replays the sniffed bytes
        import socket

        from brpc_tpu_torch.policy import h2 as _h2
        from brpc_tpu_torch.policy.hpack import HpackEncoder

        host, port = str(native_server.listen_endpoint()).rsplit(":", 1)
        s = socket.create_connection((host, int(port)))
        s.settimeout(10)
        enc = HpackEncoder()
        block = enc.encode([(":method", "GET"), (":scheme", "http"),
                            (":path", "/status"), (":authority", "x")])
        s.sendall(b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"
                  + _h2.pack_settings([])
                  + _h2.pack_frame(_h2.HEADERS,
                                   _h2.FLAG_END_HEADERS | _h2.FLAG_END_STREAM,
                                   1, block))
        buf = b""
        while b"grpc" not in buf and len(buf) < 200:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
        s.close()
        # the Python h2 stack answered (its SETTINGS frame + a HEADERS
        # with :status 200 somewhere in the stream)
        assert len(buf) > 9, "no h2 reply after detach"

    def test_grpc_and_trpc_share_the_port(self, native_server):
        # the same native listener serves trpc_std AND grpc
        grpc_stub = _stub(native_server)
        std_stub = _stub(native_server, protocol="trpc_std",
                         native_transport=True)
        r1 = grpc_stub.Echo(echo_pb2.EchoRequest(message="g"))
        r2 = std_stub.Echo(echo_pb2.EchoRequest(message="t"))
        assert (r1.message, r2.message) == ("g", "t")


class TestNativeGrpcEcho:
    def test_native_echo_service_grpc(self):
        # C++ end to end: native echo registry answers grpc in-engine
        srv = Server(ServerOptions(native_dataplane=True))
        srv.add_service(EchoImpl())
        srv.start("127.0.0.1:0")
        try:
            srv.register_native_echo("EchoService", "Echo")
            stub = _stub(srv)
            r = stub.Echo(echo_pb2.EchoRequest(message="cpp",
                                               payload=b"123"))
            assert r.message == "cpp" and r.payload == b"123"
        finally:
            srv.stop()
            srv.join()
