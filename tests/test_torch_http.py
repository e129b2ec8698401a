"""The port's HTTP protocol family (brpc_tpu_torch/policy/http_protocol.py,
http_server.py, rpc/progressive.py, builtin/): every case of the JAX
package's ``tests/test_http.py`` with each server the port's: parser
conformance (the reference's per-protocol wire-byte unittests,
test/brpc_http_rpc_protocol_unittest.cpp), json2pb, flags, builtin
services served off the same RPC port, JSON and pb-over-HTTP calls,
rpcz, rpc_dump, progressive attachments. Beside them, the wire against
the JAX package's on numpy-seeded messages: both render the same request
and response bytes, and both parsers cut the same messages from the same
bytes, at every split point."""

import json
import time

import pytest

from brpc_tpu_torch import flags as _flags
from brpc_tpu_torch import json2pb
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.policy.http_protocol import (
    CONTENT_JSON,
    CONTENT_PROTO,
    HttpProtocol,
    http_fetch,
    parse_http_message,
    render_request,
    render_response,
)
from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import (
    Channel,
    ChannelOptions,
    Server,
    ServerOptions,
    Service,
    Stub,
    errors,
)
from brpc_tpu_torch.rpc.protocol import (
    PARSE_BAD,
    PARSE_NOT_ENOUGH_DATA,
    PARSE_TRY_OTHERS,
)

ECHO_DESC = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]


class EchoServiceImpl(Service):
    DESCRIPTOR = ECHO_DESC

    def Echo(self, cntl, request, done):
        cntl.response_attachment = cntl.request_attachment
        return echo_pb2.EchoResponse(message=request.message,
                                     payload=request.payload)


@pytest.fixture()
def http_server():
    server = Server().add_service(EchoServiceImpl()).start("127.0.0.1:0")
    yield server
    server.stop()
    server.join(timeout=2)


def addr(server):
    return str(server.listen_endpoint())


# ---------------------------------------------------------------- wire parser
class TestHttpParser:
    def test_request_roundtrip(self):
        raw = render_request("POST", "/Svc/M?x=1&y=b", "h", b"body",
                             extra_headers={"X-Foo": "bar"})
        buf = IOBuf(raw)
        rc, msg = parse_http_message(buf)
        assert rc == 0
        assert msg.method == "POST" and msg.path == "/Svc/M"
        assert msg.query == {"x": "1", "y": "b"}
        assert msg.header("x-foo") == "bar"
        assert msg.body == b"body"
        assert len(buf) == 0

    def test_response_roundtrip(self):
        raw = render_response(404, "text/plain", "nope")
        rc, msg = parse_http_message(IOBuf(raw))
        assert rc == 0
        assert not msg.is_request
        assert msg.status == 404
        assert msg.body == b"nope"

    def test_incremental_feed(self):
        raw = render_request("GET", "/vars", "h")
        for cut in (1, 10, len(raw) - 1):
            buf = IOBuf(raw[:cut])
            rc, _ = parse_http_message(buf)
            assert rc == PARSE_NOT_ENOUGH_DATA
        rc, msg = parse_http_message(IOBuf(raw))
        assert rc == 0 and msg.method == "GET"

    def test_other_protocol_bytes(self):
        rc, _ = parse_http_message(IOBuf(b"TRPC\x00\x00\x00\x01"))
        assert rc == PARSE_TRY_OTHERS
        # TRAC could still become TRACE -> not enough data yet
        rc, _ = parse_http_message(IOBuf(b"TRAC"))
        assert rc == PARSE_NOT_ENOUGH_DATA

    def test_bad_header(self):
        rc, _ = parse_http_message(
            IOBuf(b"GET /x HTTP/1.1\r\nbroken line\r\n\r\n"))
        assert rc == PARSE_BAD

    def test_chunked_body(self):
        raw = (b"POST /x HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n"
               b"4\r\nWiki\r\n5\r\npedia\r\n0\r\n\r\n")
        rc, msg = parse_http_message(IOBuf(raw))
        assert rc == 0
        assert msg.body == b"Wikipedia"

    def test_chunked_incomplete(self):
        raw = (b"POST /x HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n"
               b"4\r\nWi")
        rc, _ = parse_http_message(IOBuf(raw))
        assert rc == PARSE_NOT_ENOUGH_DATA

    def test_pipelined_requests(self):
        raw = render_request("GET", "/a", "h") + render_request("GET", "/b", "h")
        buf = IOBuf(raw)
        rc, m1 = parse_http_message(buf)
        rc2, m2 = parse_http_message(buf)
        assert (rc, rc2) == (0, 0)
        assert m1.path == "/a" and m2.path == "/b"


# -------------------------------------------------------------------- json2pb
class TestJson2Pb:
    def test_roundtrip(self):
        req = echo_pb2.EchoRequest(message="hi", payload=b"\x01\x02")
        text = json2pb.pb_to_json(req)
        back = json2pb.json_to_pb(text, echo_pb2.EchoRequest)
        assert back == req

    def test_bad_json(self):
        with pytest.raises(json2pb.Json2PbError):
            json2pb.json_to_pb("{not json", echo_pb2.EchoRequest)

    def test_unknown_fields_ignored(self):
        msg = json2pb.json_to_pb('{"message": "x", "bogus": 1}',
                                 echo_pb2.EchoRequest)
        assert msg.message == "x"


# ---------------------------------------------------------------------- flags
class TestFlags:
    def test_define_get_set(self):
        f = _flags.define("test_flag_xyz", 5, "help", reloadable=True)
        assert _flags.get("test_flag_xyz") == 5
        _flags.set_flag("test_flag_xyz", "7")
        assert f.value == 7

    def test_validator_rejects(self):
        _flags.define("test_flag_pos", 1.0, validator=lambda v: v > 0)
        with pytest.raises(_flags.FlagError):
            _flags.set_flag("test_flag_pos", "-2.0")
        assert _flags.get("test_flag_pos") == 1.0

    def test_non_reloadable(self):
        _flags.define("test_flag_frozen", "a")
        with pytest.raises(_flags.FlagError):
            _flags.set_flag("test_flag_frozen", "b")

    def test_bool_parsing(self):
        f = _flags.define("test_flag_bool", False, reloadable=True)
        _flags.set_flag("test_flag_bool", "true")
        assert f.value is True
        _flags.set_flag("test_flag_bool", "0")
        assert f.value is False


# ----------------------------------------------------------- builtin services
class TestBuiltinServices:
    def test_index_lists_services(self, http_server):
        resp = http_fetch(addr(http_server), "GET", "/")
        assert resp.status == 200
        assert b"/status" in resp.body and b"/vars" in resp.body

    def test_status(self, http_server):
        resp = http_fetch(addr(http_server), "GET", "/status")
        assert resp.status == 200
        assert b"EchoService" in resp.body

    def test_health_version(self, http_server):
        assert http_fetch(addr(http_server), "GET", "/health").body == b"OK\n"
        assert b"brpc_tpu" in http_fetch(addr(http_server), "GET",
                                         "/version").body

    def test_vars(self, http_server):
        from brpc_tpu_torch.metrics import Status

        Status(42).expose("test_http_var")
        resp = http_fetch(addr(http_server), "GET", "/vars")
        assert b"test_http_var : 42" in resp.body
        resp = http_fetch(addr(http_server), "GET", "/vars/test_http_var")
        assert resp.body == b"test_http_var : 42\n"

    def test_flags_list_and_set(self, http_server):
        resp = http_fetch(addr(http_server), "GET", "/flags")
        assert b"circuit_breaker_enabled" in resp.body
        resp = http_fetch(addr(http_server), "GET",
                          "/flags/idle_timeout_s?setvalue=30")
        assert resp.status == 200
        assert _flags.get("idle_timeout_s") == 30.0
        _flags.set_flag("idle_timeout_s", "-1")

    def test_flags_set_rejected(self, http_server):
        resp = http_fetch(addr(http_server), "GET",
                          "/flags/rpcz_sample_ratio?setvalue=2.0")
        assert resp.status == 403

    def test_connections_and_sockets(self, http_server):
        resp = http_fetch(addr(http_server), "GET", "/connections")
        assert resp.status == 200
        resp = http_fetch(addr(http_server), "GET", "/sockets")
        assert resp.status == 200

    def test_prometheus(self, http_server):
        resp = http_fetch(addr(http_server), "GET", "/brpc_metrics")
        assert resp.status == 200

    def test_protobufs(self, http_server):
        resp = http_fetch(addr(http_server), "GET", "/protobufs")
        assert b"EchoService.Echo" in resp.body

    def test_unknown_builtin_falls_through_to_404(self, http_server):
        resp = http_fetch(addr(http_server), "GET", "/no_such_thing")
        assert resp.status == 404


# ------------------------------------------------------------------- JSON RPC
class TestJsonRpc:
    def test_json_call(self, http_server):
        body = json.dumps({"message": "json hello"}).encode()
        resp = http_fetch(addr(http_server), "POST", "/EchoService/Echo",
                          body=body, content_type=CONTENT_JSON)
        assert resp.status == 200
        data = json.loads(resp.body)
        assert data["message"] == "json hello"

    def test_json_call_bad_body(self, http_server):
        resp = http_fetch(addr(http_server), "POST", "/EchoService/Echo",
                          body=b"{oops", content_type=CONTENT_JSON)
        assert resp.status == 400
        assert json.loads(resp.body)["error_code"] == errors.EREQUEST

    def test_no_such_method(self, http_server):
        resp = http_fetch(addr(http_server), "POST", "/EchoService/Nope",
                          body=b"{}", content_type=CONTENT_JSON)
        assert resp.status == 404

    def test_no_such_service(self, http_server):
        resp = http_fetch(addr(http_server), "POST", "/Nope/Echo",
                          body=b"{}", content_type=CONTENT_JSON)
        assert resp.status == 404


# --------------------------------------------------------------- pb-over-http
class TestPbOverHttp:
    def test_channel_http_protocol(self, http_server):
        ch = Channel(ChannelOptions(protocol="http")).init(addr(http_server))
        stub = Stub(ch, ECHO_DESC)
        resp = stub.Echo(echo_pb2.EchoRequest(message="over http"))
        assert resp.message == "over http"

    def test_attachment_over_http(self, http_server):
        from brpc_tpu_torch.rpc import Controller, MethodDescriptor

        ch = Channel(ChannelOptions(protocol="http")).init(addr(http_server))
        md = MethodDescriptor.from_pb(ECHO_DESC.methods_by_name["Echo"])
        cntl = Controller()
        cntl.request_attachment = b"side-channel"
        resp = ch.call_method(md, echo_pb2.EchoRequest(message="x"),
                              controller=cntl)
        assert resp.message == "x"
        assert cntl.response_attachment == b"side-channel"

    def test_many_sequential_calls_one_connection(self, http_server):
        ch = Channel(ChannelOptions(protocol="http")).init(addr(http_server))
        stub = Stub(ch, ECHO_DESC)
        for i in range(20):
            assert stub.Echo(echo_pb2.EchoRequest(message=str(i))).message == str(i)


# ----------------------------------------------------------------------- rpcz
class TestRpcz:
    def test_spans_recorded_and_rendered(self, http_server):
        from brpc_tpu_torch.trace import span as _span

        _span.reset_for_test()
        ch = Channel().init(addr(http_server))
        stub = Stub(ch, ECHO_DESC)
        stub.Echo(echo_pb2.EchoRequest(message="traced"))
        # the server span is recorded just after the response is written —
        # wait for it
        deadline = time.time() + 2
        while time.time() < deadline:
            spans = _span.recent_spans(10)
            if {s.kind for s in spans} >= {"client", "server"}:
                break
            time.sleep(0.01)
        kinds = {s.kind for s in spans}
        assert "client" in kinds and "server" in kinds
        client = next(s for s in spans if s.kind == "client")
        server_span = next(s for s in spans if s.kind == "server")
        # propagation: same trace, parent chain intact
        assert client.trace_id == server_span.trace_id
        assert server_span.parent_span_id == client.span_id
        resp = http_fetch(addr(http_server), "GET", "/rpcz")
        assert b"EchoService.Echo" in resp.body
        resp = http_fetch(addr(http_server), "GET",
                          f"/rpcz/{client.trace_id:x}")
        assert resp.status == 200


# ------------------------------------------------------------------- rpc_dump
class TestRpcDump:
    def test_dump_and_load(self, tmp_path):
        from brpc_tpu_torch.trace.rpc_dump import RpcDumpLoader

        _flags.set_flag("rpc_dump_ratio", "1.0")
        try:
            server = (Server(ServerOptions(rpc_dump_dir=str(tmp_path)))
                      .add_service(EchoServiceImpl()).start("127.0.0.1:0"))
            try:
                ch = Channel().init(str(server.listen_endpoint()))
                stub = Stub(ch, ECHO_DESC)
                for i in range(5):
                    stub.Echo(echo_pb2.EchoRequest(message=f"dump{i}"))
                deadline = time.time() + 2
                while server.rpc_dumper.sampled_count < 5 and time.time() < deadline:
                    time.sleep(0.01)
                server.rpc_dumper.close()
                records = list(RpcDumpLoader(str(tmp_path)))
                assert len(records) == 5
                meta, body = records[0]
                assert meta.request.service_name == "EchoService"
                req = echo_pb2.EchoRequest()
                req.ParseFromString(body)
                assert req.message.startswith("dump")
            finally:
                server.stop()
                server.join(timeout=2)
        finally:
            _flags.set_flag("rpc_dump_ratio", "0.0")


class TestProgressiveAttachment:
    def test_chunked_streaming_download(self):
        """Handler finishes the RPC, then streams body chunks from another
        thread (reference progressive_attachment.cpp); the client sees the
        assembled chunked body and the connection stays keep-alive."""
        import socket as _socket
        import threading

        from brpc_tpu_torch.proto import echo_pb2
        from brpc_tpu_torch.rpc import Server, Service

        chunks = [b"alpha-", b"beta-", b"g" * 5000, b"-end"]
        started = threading.Event()

        class Downloader(Service):
            DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]

            def Echo(self, cntl, request, done):
                pa = cntl.create_progressive_attachment()
                assert pa.write(chunks[0]) == 0  # buffered pre-headers

                def pump():
                    started.wait(5)
                    for c in chunks[1:]:
                        assert pa.write(c) == 0
                    assert pa.close() == 0

                threading.Thread(target=pump, daemon=True).start()
                return echo_pb2.EchoResponse(message="ignored")

        server = Server().add_service(Downloader()).start("127.0.0.1:0")
        try:
            ep = server.listen_endpoint()
            with _socket.create_connection((ep.host, ep.port),
                                           timeout=5) as s:
                s.sendall(b"POST /EchoService/Echo HTTP/1.1\r\n"
                          b"Host: t\r\nContent-Type: application/json\r\n"
                          b"Content-Length: 2\r\n\r\n{}")
                s.settimeout(5)
                data = b""
                while b"\r\n\r\n" not in data:
                    data += s.recv(4096)
                head, _, rest = data.partition(b"\r\n\r\n")
                assert b"Transfer-Encoding: chunked" in head
                started.set()  # let the pump stream the remaining chunks
                while b"0\r\n\r\n" not in rest:
                    chunk = s.recv(4096)
                    if not chunk:
                        break
                    rest += chunk
                # decode chunked framing
                body = b""
                pos = 0
                while True:
                    nl = rest.index(b"\r\n", pos)
                    size = int(rest[pos:nl], 16)
                    if size == 0:
                        break
                    body += rest[nl + 2:nl + 2 + size]
                    pos = nl + 2 + size + 2
                assert body == b"".join(chunks)
                # keep-alive: the SAME connection serves another request
                s.sendall(b"GET /health HTTP/1.1\r\nHost: t\r\n\r\n")
                more = s.recv(4096)
                assert more.startswith(b"HTTP/1.1 200")
        finally:
            server.stop()
            server.join(timeout=2)

    def test_write_after_close_rejected(self):
        from brpc_tpu_torch.rpc import errors
        from brpc_tpu_torch.rpc.progressive import ProgressiveAttachment

        pa = ProgressiveAttachment()
        pa.write(b"x")
        pa.close()
        assert pa.write(b"y") == errors.ESTREAMCLOSED

    def test_progressive_rejected_on_binary_protocol(self):
        from brpc_tpu_torch.proto import echo_pb2
        from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Server, Service,
                                  Stub)

        seen = {}

        class Svc(Service):
            DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]

            def Echo(self, cntl, request, done):
                try:
                    cntl.create_progressive_attachment()
                    seen["raised"] = False
                except ValueError:
                    seen["raised"] = True
                return echo_pb2.EchoResponse(message="ok")

        server = Server().add_service(Svc()).start("127.0.0.1:0")
        try:
            ch = Channel(ChannelOptions(timeout_ms=3000))
            ch.init(str(server.listen_endpoint()))
            stub = Stub(ch, echo_pb2.DESCRIPTOR.services_by_name["EchoService"])
            assert stub.Echo(echo_pb2.EchoRequest(message="x")).message == "ok"
            assert seen["raised"] is True
        finally:
            server.stop()
            server.join(timeout=2)


# ------------------------------------------------ the wire against the JAX's
def _seeded_messages(seed, n=40):
    """(render kwargs, is_request) drawn from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        body = rng.bytes(int(rng.choice([0, 1, 17, 300, 5000])))
        headers = {f"X-H{j}": "v" * int(rng.integers(1, 9))
                   for j in range(int(rng.integers(4)))}
        if rng.integers(2):
            q = "&".join(f"k{j}={int(rng.integers(100))}"
                         for j in range(int(rng.integers(1, 4))))
            path = f"/Svc{int(rng.integers(9))}/M?{q}"
            out.append((dict(method=str(rng.choice(["GET", "POST", "PUT"])),
                             path=path, host="h", body=body,
                             content_type=str(rng.choice(
                                 [CONTENT_JSON, CONTENT_PROTO, ""])),
                             extra_headers=headers), True))
        else:
            out.append((dict(status=int(rng.choice([200, 400, 404, 503])),
                             content_type="text/plain", body=body,
                             extra_headers=headers,
                             keep_alive=bool(rng.integers(2))), False))
    return out


def _fields(msg):
    return (msg.is_request, msg.method, msg.uri, msg.path, msg.query,
            msg.version, msg.status, msg.reason, msg.headers, msg.body)


@pytest.mark.parametrize("seed", range(3))
def test_render_and_parse_equal_the_jax_packages(seed):
    import numpy as np

    from brpc_tpu.butil.iobuf import IOBuf as JaxIOBuf
    from brpc_tpu.policy import http_protocol as jax_http

    rng = np.random.default_rng(1000 + seed)
    for kw, is_request in _seeded_messages(seed):
        if is_request:
            raw = render_request(**kw)
            assert raw == jax_http.render_request(**kw)
        else:
            raw = render_response(**kw)
            assert raw == jax_http.render_response(**kw)
        rc, msg = parse_http_message(IOBuf(raw))
        jrc, jmsg = jax_http.parse_http_message(JaxIOBuf(raw))
        assert rc == jrc == 0
        assert _fields(msg) == _fields(jmsg)
        for cut in sorted({int(c) for c in rng.integers(1, len(raw),
                                                        size=5)}):
            rc, _ = parse_http_message(IOBuf(raw[:cut]))
            jrc, _ = jax_http.parse_http_message(JaxIOBuf(raw[:cut]))
            assert rc == jrc, cut


@pytest.mark.parametrize("client,server", [("jax", "port"), ("port", "jax")])
def test_pb_over_http_between_the_packages(client, server):
    """A ``protocol="http"`` Channel of either package against a Server
    of the other: the echo, its attachment and a JSON call agree."""
    import brpc_tpu.rpc as jax_rpc
    from brpc_tpu.policy.http_protocol import http_fetch as jax_fetch
    from brpc_tpu.proto import echo_pb2 as jax_echo

    if server == "jax":
        class JaxEcho(jax_rpc.Service):
            DESCRIPTOR = jax_echo.DESCRIPTOR.services_by_name["EchoService"]

            def Echo(self, cntl, request, done):
                cntl.response_attachment = cntl.request_attachment
                return jax_echo.EchoResponse(message=request.message,
                                             payload=request.payload)

        srv = jax_rpc.Server().add_service(JaxEcho()).start("127.0.0.1:0")
    else:
        srv = Server().add_service(EchoServiceImpl()).start("127.0.0.1:0")
    try:
        ep = str(srv.listen_endpoint())
        if client == "jax":
            crpc, cpb, fetch = jax_rpc, jax_echo, jax_fetch
        else:
            import brpc_tpu_torch.rpc as crpc

            cpb, fetch = echo_pb2, http_fetch
        ch = crpc.Channel(crpc.ChannelOptions(protocol="http")).init(ep)
        md = crpc.MethodDescriptor.from_pb(
            cpb.DESCRIPTOR.services_by_name["EchoService"]
            .methods_by_name["Echo"]) if client == "jax" else \
            crpc.MethodDescriptor("EchoService", "Echo", cpb.EchoRequest,
                                  cpb.EchoResponse)
        cntl = crpc.Controller()
        cntl.request_attachment = b"side"
        resp = ch.call_method(md, cpb.EchoRequest(message="x",
                                                  payload=b"\x00\x01"),
                              controller=cntl)
        assert (resp.message, resp.payload) == ("x", b"\x00\x01")
        assert cntl.response_attachment == b"side"
        got = fetch(ep, "POST", "/EchoService/Echo",
                    body=b'{"message": "j", "payload": "AAE="}')
        assert json.loads(got.body) == {"message": "j", "payload": "AAE="}
    finally:
        srv.stop()
        srv.join(timeout=2)
