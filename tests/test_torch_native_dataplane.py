"""The port's native C++ dataplane (``brpc_tpu_torch/native/dataplane.cpp``
behind ``rpc/native_transport.py``), on every case of
``tests/test_native_dataplane.py``: real loopback sockets, client and
server through the public API, no mock transport. Both lanes (native
engine / Python stack) in every pairing, the C++ native-service fast path,
the DETACH to HTTP on a native port, failure fanout, the TPUC tunnel and
its stress, idle sweep, failover, garbage and shutdown cases.

Beside them: the {JAX, port} x {JAX, port} native client/server pairings
over TCP and the tunnel (response bytes equal); the tunnel's four
{Python, native} pairings on the port and on the reference, whose mixed
pairings fail (the reference engine frames the tunnel in handshake v1, its
Python lane in v2/v3; ROADMAP Queue 3); and the five h2 faults of the
reference engine's parser, each driven by raw h2 frames at a native
listener and shown on both engines.
"""

import ctypes
import json
import os
import socket as _socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import brpc_tpu.rpc as jrpc
from brpc_tpu.proto import echo_pb2 as jecho_pb2
from brpc_tpu.rpc import native_transport as jnative_transport
from brpc_tpu_torch.proto import echo_pb2
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
from brpc_tpu_torch.rpc import native_transport as port_native_transport
from brpc_tpu_torch.rpc.native_transport import (
    bench_echo_native,
    get_dataplane,
)

ECHO = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]


class EchoImpl(Service):
    DESCRIPTOR = ECHO

    def Echo(self, cntl, request, done):
        cntl.response_attachment = cntl.request_attachment
        return echo_pb2.EchoResponse(message=request.message,
                                     payload=request.payload)


@pytest.fixture()
def native_server():
    server = Server(ServerOptions(native_dataplane=True))
    server.add_service(EchoImpl())
    server.start("127.0.0.1:0")
    yield server
    server.stop()
    server.join()


def _stub(server, native=False, timeout_ms=10000):
    ch = Channel(ChannelOptions(protocol="trpc_std", timeout_ms=timeout_ms,
                                native_transport=native))
    ch.init(str(server.listen_endpoint()))
    return Stub(ch, ECHO)


class TestNativeServer:
    def test_python_client_native_server(self, native_server):
        stub = _stub(native_server, native=False)
        r = stub.Echo(echo_pb2.EchoRequest(message="py", payload=b"p" * 1000))
        assert r.message == "py" and r.payload == b"p" * 1000

    def test_native_client_native_server(self, native_server):
        stub = _stub(native_server, native=True)
        r = stub.Echo(echo_pb2.EchoRequest(message="nn", payload=b"n" * 1000))
        assert r.message == "nn" and r.payload == b"n" * 1000

    def test_native_client_python_server(self):
        server = Server(ServerOptions())
        server.add_service(EchoImpl())
        server.start("127.0.0.1:0")
        try:
            stub = _stub(server, native=True)
            r = stub.Echo(echo_pb2.EchoRequest(message="np"))
            assert r.message == "np"
        finally:
            server.stop()
            server.join()

    def test_attachment_roundtrip(self, native_server):
        stub = _stub(native_server, native=True)
        att = bytes(range(256)) * 64
        cntl = Controller()
        cntl.request_attachment = att
        r = stub.Echo(echo_pb2.EchoRequest(message="a"), controller=cntl)
        assert r.message == "a"
        assert cntl.response_attachment == att

    def test_large_payload(self, native_server):
        stub = _stub(native_server, native=True, timeout_ms=30000)
        payload = b"\x5a" * (8 << 20)
        r = stub.Echo(echo_pb2.EchoRequest(message="big", payload=payload))
        assert r.payload == payload

    def test_concurrent_calls(self, native_server):
        stub = _stub(native_server, native=True)
        errs = []

        def worker(i):
            try:
                for k in range(30):
                    msg = f"t{i}.{k}"
                    r = stub.Echo(echo_pb2.EchoRequest(message=msg))
                    assert r.message == msg
            except Exception as e:  # pragma: no cover
                errs.append(e)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errs

    def test_native_echo_fastpath(self, native_server):
        """C++-answered service: correct wire response, no Python handler."""
        native_server.register_native_echo("EchoService", "Echo")
        calls_before = native_server.requests_processed.get_value()
        stub = _stub(native_server, native=True)
        att = b"fast" * 100
        cntl = Controller()
        cntl.request_attachment = att
        r = stub.Echo(echo_pb2.EchoRequest(message="cxx", payload=b"zz"),
                      controller=cntl)
        assert r.message == "cxx" and r.payload == b"zz"
        assert cntl.response_attachment == att
        # the Python service never saw it
        assert native_server.requests_processed.get_value() == calls_before

    def test_server_stop_fails_clients(self, native_server):
        stub = _stub(native_server, native=True, timeout_ms=2000)
        stub.Echo(echo_pb2.EchoRequest(message="ok"))
        native_server.stop()
        native_server.join()
        with pytest.raises(RpcError):
            for _ in range(5):  # conn teardown may race the first call
                stub.Echo(echo_pb2.EchoRequest(message="down"))
                time.sleep(0.1)


class TestDetach:
    def test_http_on_native_port(self, native_server):
        """Non-TRPC bytes on a native port detach to the Python stack: the
        builtin HTTP dashboard answers on the same listener."""
        ep = native_server.listen_endpoint()
        with _socket.create_connection((ep.host, ep.port), timeout=5) as s:
            s.sendall(b"GET /health HTTP/1.1\r\nHost: t\r\n"
                      b"Connection: close\r\n\r\n")
            s.settimeout(5)
            data = b""
            while True:
                try:
                    chunk = s.recv(4096)
                except (TimeoutError, OSError):
                    break
                if not chunk:
                    break
                data += chunk
        assert data.startswith(b"HTTP/1.1 200")

    def test_trpc_still_works_after_detach(self, native_server):
        self.test_http_on_native_port(native_server)
        stub = _stub(native_server, native=True)
        assert stub.Echo(echo_pb2.EchoRequest(message="after")).message \
            == "after"


class TestNativeLaneBench:
    def test_bench_echo_native_smoke(self, native_server):
        native_server.register_native_echo("EchoService", "Echo")
        ep = native_server.listen_endpoint()
        res = bench_echo_native(ep.host, ep.port, conns=2, depth=2,
                                payload=64, duration_ms=200)
        assert res is not None
        assert res["qps"] > 100, res
        assert res["p99_us"] > 0


class TestEngineBasics:
    def test_connect_refused(self):
        dp = get_dataplane()
        # grab a port that is closed: bind+close
        s = _socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        from brpc_tpu_torch.butil.endpoint import EndPoint

        with pytest.raises(ConnectionError):
            dp.connect(EndPoint.from_ip_port("127.0.0.1", port),
                       timeout_ms=500)

    def test_peer_close_errors_pending(self, native_server):
        """Kill the server mid-call: pending ids get errored, not hung."""
        stub = _stub(native_server, native=True, timeout_ms=3000)
        stub.Echo(echo_pb2.EchoRequest(message="warm"))
        native_server.stop()
        native_server.join()
        with pytest.raises(RpcError) as ei:
            stub.Echo(echo_pb2.EchoRequest(message="x"))
        # failed fast via socket error, not the 3s timeout
        assert ei.value.error_code != errors.ERPCTIMEDOUT


class TestNativeTpuTunnel:
    """The graft's native lane: TPUC shm tunnel in the C++ engine
    (reference RdmaEndpoint blueprint) + interop with the Python
    transport implementation of the same wire format."""

    @pytest.fixture()
    def tpu_native_server(self):
        server = Server(ServerOptions(native_dataplane=True))
        server.add_service(EchoImpl())
        server.start("tpu://127.0.0.1:0/0")
        yield server
        server.stop()
        server.join()

    def test_native_client_native_server(self, tpu_native_server):
        stub = _stub(tpu_native_server, native=True, timeout_ms=15000)
        r = stub.Echo(echo_pb2.EchoRequest(message="nn",
                                           payload=b"t" * 500000))
        assert r.message == "nn" and len(r.payload) == 500000

    def test_python_client_native_server(self, tpu_native_server):
        stub = _stub(tpu_native_server, native=False, timeout_ms=15000)
        r = stub.Echo(echo_pb2.EchoRequest(message="pn",
                                           payload=b"p" * 300000))
        assert r.message == "pn" and len(r.payload) == 300000

    def test_native_client_python_server(self):
        server = Server(ServerOptions())  # Python tpu transport end
        server.add_service(EchoImpl())
        server.start("tpu://127.0.0.1:0/0")
        try:
            stub = _stub(server, native=True, timeout_ms=15000)
            r = stub.Echo(echo_pb2.EchoRequest(message="np",
                                               payload=b"q" * 300000))
            assert r.message == "np" and len(r.payload) == 300000
        finally:
            server.stop()
            server.join()

    def test_attachment_and_fastpath(self, tpu_native_server):
        tpu_native_server.register_native_echo("EchoService", "Echo")
        stub = _stub(tpu_native_server, native=True, timeout_ms=15000)
        att = bytes(range(256)) * 2048  # 512KB through the block path
        cntl = Controller()
        cntl.request_attachment = att
        r = stub.Echo(echo_pb2.EchoRequest(message="fast"), controller=cntl)
        assert r.message == "fast" and cntl.response_attachment == att

    def test_ordinal_mismatch_refused(self, tpu_native_server):
        ep = tpu_native_server.listen_endpoint()
        from brpc_tpu_torch.butil.endpoint import EndPoint
        from brpc_tpu_torch.rpc.native_transport import get_dataplane

        wrong = EndPoint.from_tpu(ep.host, 7, port=ep.port)
        with pytest.raises(ConnectionError):
            get_dataplane().connect_tpu(wrong, timeout_ms=3000)

    def test_server_stop_fails_tunnel_clients(self, tpu_native_server):
        stub = _stub(tpu_native_server, native=True, timeout_ms=3000)
        stub.Echo(echo_pb2.EchoRequest(message="ok"))
        tpu_native_server.stop()
        tpu_native_server.join()
        with pytest.raises(RpcError):
            for _ in range(5):
                stub.Echo(echo_pb2.EchoRequest(message="down"))
                time.sleep(0.1)


class TestTunnelStress:
    def test_concurrent_mixed_sizes_shared_tunnel(self):
        """8 threads × mixed payload sizes over ONE shared tunnel conn:
        stream ordering, credit accounting, and payload integrity must
        hold under contention."""
        server = Server(ServerOptions(native_dataplane=True))
        server.add_service(EchoImpl())
        server.start("tpu://127.0.0.1:0/0")
        try:
            stub = _stub(server, native=True, timeout_ms=30000)
            sizes = [7, 1000, 65536, 300000, 1 << 20]
            errs = []

            def worker(seed):
                try:
                    for k in range(12):
                        size = sizes[(seed + k) % len(sizes)]
                        fill = bytes([(seed * 31 + k) & 0xFF])
                        cntl = Controller()
                        cntl.timeout_ms = 30000
                        cntl.request_attachment = fill * size
                        r = stub.Echo(echo_pb2.EchoRequest(
                            message=f"{seed}.{k}"), controller=cntl)
                        assert r.message == f"{seed}.{k}"
                        assert cntl.response_attachment == fill * size, \
                            f"payload corrupted at {seed}.{k}"
                except Exception as e:  # pragma: no cover
                    errs.append(e)

            ts = [threading.Thread(target=worker, args=(i,))
                  for i in range(8)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            assert not errs, errs
        finally:
            server.stop()
            server.join()

    def test_idle_sweep_closes_native_conns(self):
        server = Server(ServerOptions(native_dataplane=True,
                                      idle_timeout_s=1))
        server.add_service(EchoImpl())
        server.start("127.0.0.1:0")
        try:
            stub = _stub(server, native=True, timeout_ms=3000)
            stub.Echo(echo_pb2.EchoRequest(message="warm"))
            dp = server._native_dp
            assert len(dp.server_socks(server)) >= 1
            deadline = time.monotonic() + 12  # sweep ticks every 5s
            while time.monotonic() < deadline:
                left = len(dp.server_socks(server))
                if left == 0:
                    break
                time.sleep(0.3)
            assert left == 0, f"{left} native conns survived the idle sweep"
        finally:
            server.stop()
            server.join()

    def test_cpp_fastpath_traffic_keeps_conn_alive(self):
        """Traffic answered entirely in C++ never touches Python's
        last_active — the sweep must consult the engine's counters, not
        kill a busy conn (regression for the sweep's blind spot)."""
        server = Server(ServerOptions(native_dataplane=True,
                                      idle_timeout_s=1))
        server.add_service(EchoImpl())
        server.start("127.0.0.1:0")
        server.register_native_echo("EchoService", "Echo")
        try:
            stub = _stub(server, native=True, timeout_ms=3000)
            deadline = time.monotonic() + 7  # beyond limit + sweep tick
            while time.monotonic() < deadline:
                r = stub.Echo(echo_pb2.EchoRequest(message="alive"))
                assert r.message == "alive"
                time.sleep(0.05)
            assert len(server._native_dp.server_socks(server)) >= 1
        finally:
            server.stop()
            server.join()


class TestNativeFailover:
    def test_lb_retry_steers_around_dead_native_server(self):
        """Two native servers behind an rr LB; one dies under continuous
        load — retries + feedback keep every call succeeding on the
        survivor (reference failure-detection story on the native lane)."""

        class NamedEcho(Service):
            DESCRIPTOR = ECHO

            def __init__(self, name):
                super().__init__()
                self.name = name

            def Echo(self, cntl, request, done):
                return echo_pb2.EchoResponse(message=self.name)

        servers = []
        for name in ("a", "b"):
            s = Server(ServerOptions(native_dataplane=True))
            s.add_service(NamedEcho(name))
            s.start("127.0.0.1:0")
            servers.append(s)
        try:
            url = ",".join(str(s.listen_endpoint()) for s in servers)
            ch = Channel(ChannelOptions(timeout_ms=3000, max_retry=3,
                                        native_transport=True))
            ch.init(f"list://{url}", "rr")
            stub = Stub(ch, ECHO)
            seen = set()
            for _ in range(10):
                seen.add(stub.Echo(echo_pb2.EchoRequest(message="x")).message)
            assert seen == {"a", "b"}
            servers[0].stop()
            servers[0].join()
            after = set()
            for _ in range(20):
                after.add(stub.Echo(
                    echo_pb2.EchoRequest(message="x")).message)
            assert after == {"b"}, after  # every call succeeded via retry
        finally:
            for s in servers:
                s.stop()
                s.join(timeout=2)


class TestTunnelGarbageResilience:
    def test_garbage_on_tpu_listener_kills_only_that_conn(self):
        """Raw TCP garbage at a native tpu listener must fail that conn
        alone; real tunnel clients keep working."""
        import socket as _socket

        server = Server(ServerOptions(native_dataplane=True))
        server.add_service(EchoImpl())
        server.start("tpu://127.0.0.1:0/0")
        try:
            ep = server.listen_endpoint()
            stub = _stub(server, native=True, timeout_ms=10000)
            stub.Echo(echo_pb2.EchoRequest(message="before"))
            for payload in (b"TPUC" + b"\xff" * 64,        # bad frame
                            b"TPUC\x03" + b"\x7f\xff\xff\xff",  # huge len
                            b"\x00" * 32):                 # not TPUC at all
                with _socket.create_connection((ep.host, ep.port),
                                               timeout=5) as s:
                    s.sendall(payload)
                    s.settimeout(2)
                    try:
                        while s.recv(4096):
                            pass
                    except (TimeoutError, OSError):
                        pass
            r = stub.Echo(echo_pb2.EchoRequest(message="after"))
            assert r.message == "after"  # the real tunnel survived
        finally:
            server.stop()
            server.join()

    def test_malformed_zero_copy_data_frames(self):
        """The zero-copy DATA route parses peer-controlled block refs and
        an embedded TRPC header straight out of pool memory — hostile
        geometries (bad indices, lying lengths, split headers, random
        fuzz) must fail ONLY the offending conn, never the process or
        innocent tunnels (round-3 surface; reference trust model is
        rdma_endpoint.cpp's, ours must still not crash)."""
        import random
        import socket as _socket
        import struct as _struct

        server = Server(ServerOptions(native_dataplane=True))
        server.add_service(EchoImpl())
        server.start("tpu://127.0.0.1:0/0")
        server.register_native_echo("EchoService", "Echo")
        try:
            ep = server.listen_endpoint()
            stub = _stub(server, native=True, timeout_ms=10000)
            stub.Echo(echo_pb2.EchoRequest(message="before"))

            def data_frame(body: bytes) -> bytes:
                return b"TPUC\x03" + _struct.pack("!I", len(body)) + body

            def hello() -> bytes:
                j = (b'{"v": 1, "pool": "nonexistent_pool_zz", '
                     b'"bs": 4096, "bc": 4, "ordinal": 0, "pid": 1}')
                return b"TPUC\x01" + _struct.pack("!I", len(j)) + j

            rng = random.Random(7)
            attacks = [
                # block index beyond the pool
                _struct.pack("!II", 0, 1) + _struct.pack("!II", 9999, 64),
                # length beyond the block size
                _struct.pack("!II", 0, 1) + _struct.pack("!II", 0, 1 << 30),
                # nsegs lies about the body size
                _struct.pack("!II", 0, 4096),
                # zero-length segment
                _struct.pack("!II", 0, 2) + _struct.pack("!II", 0, 0) * 2,
            ] + [bytes(rng.randrange(256) for _ in range(rng.randrange(
                1, 128))) for _ in range(20)]
            for body in attacks:
                with _socket.create_connection((ep.host, ep.port),
                                               timeout=5) as s:
                    s.sendall(hello())
                    s.sendall(data_frame(body))
                    s.settimeout(1)
                    try:
                        while s.recv(4096):
                            pass
                    except (TimeoutError, OSError):
                        pass
            r = stub.Echo(echo_pb2.EchoRequest(message="after"))
            assert r.message == "after"  # engine + real tunnel survived
        finally:
            server.stop()
            server.join()


class TestShutdownQuiesce:
    """dp_rt_shutdown must quiesce TPUC sender workers mid-traffic
    (ADVICE r2 medium: detached senders leaked threads/conns/shm and could
    UAF the Runtime at shutdown)."""

    def test_shutdown_under_tunnel_load_returns_promptly(self):
        from brpc_tpu_torch import native

        lib = native.load_dataplane()
        rt = lib.dp_rt_create(2, 0)
        lid = lib.dp_listen(rt, b"127.0.0.1", 0)
        assert lid >= 0
        lib.dp_listener_set_tpu(rt, lid, 0)
        lib.dp_register_echo(rt, lid, b"EchoService", b"Echo")
        port = lib.dp_listen_port(rt, lid)

        # drive large echoes through the tunnel from a separate bench
        # runtime so per-conn sender workers are live when we shut down
        result = {}

        def bench():
            outs = [ctypes.c_double() for _ in range(5)]
            result["rc"] = lib.dp_bench_echo2(
                b"127.0.0.1", port, 1, 2, 4, 1 << 20, 8000,
                b"EchoService", b"Echo",
                *[ctypes.byref(o) for o in outs])

        t = threading.Thread(target=bench, daemon=True)
        t.start()
        time.sleep(1.0)  # let traffic flow

        done = threading.Event()

        def shut():
            lib.dp_rt_shutdown(rt)
            done.set()

        s = threading.Thread(target=shut, daemon=True)
        s.start()
        assert done.wait(15), "dp_rt_shutdown hung (sender quiesce broken)"
        t.join(timeout=20)
        assert not t.is_alive()


# ---------------------------------------------------------------------------
#  The two packages' engines against each other, and the tunnel's pairings
# ---------------------------------------------------------------------------
LANES = ["127.0.0.1:0", "tpu://127.0.0.1:0/0"]


class _JaxEchoImpl(jrpc.Service):
    DESCRIPTOR = jecho_pb2.DESCRIPTOR.services_by_name["EchoService"]

    def Echo(self, cntl, request, done):
        cntl.response_attachment = cntl.request_attachment
        return jecho_pb2.EchoResponse(message=request.message,
                                      payload=request.payload)


_PKGS = {
    "port": (Server, ServerOptions, Channel, ChannelOptions, Stub,
             Controller, echo_pb2, EchoImpl),
    "jax": (jrpc.Server, jrpc.ServerOptions, jrpc.Channel,
            jrpc.ChannelOptions, jrpc.Stub, jrpc.Controller, jecho_pb2,
            _JaxEchoImpl),
}


def _start(pkg, lane, native):
    srv_cls, opts_cls = _PKGS[pkg][0], _PKGS[pkg][1]
    srv = srv_cls(opts_cls(native_dataplane=native))
    srv.add_service(_PKGS[pkg][7]())
    srv.start(lane)
    return srv


def _call(pkg, server, native, message, payload, att, timeout_ms=15000):
    (_, _, ch_cls, ch_opts, stub_cls, cntl_cls, pb,
     _) = _PKGS[pkg]
    ch = ch_cls(ch_opts(protocol="trpc_std", timeout_ms=timeout_ms,
                        max_retry=0, native_transport=native))
    ch.init(str(server.listen_endpoint()))
    stub = stub_cls(ch, pb.DESCRIPTOR.services_by_name["EchoService"])
    cntl = cntl_cls()
    cntl.request_attachment = att
    resp = stub.Echo(pb.EchoRequest(message=message, payload=payload),
                     controller=cntl)
    return resp.SerializeToString(), bytes(cntl.response_attachment)


def _stop(server):
    server.stop()
    server.join()


def _close_native_clients():
    """Close every pooled/shared client conn of both engines (their
    tunnels' shared-memory pools go with them)."""
    for mod in (jnative_transport, port_native_transport):
        dp = mod._dataplane
        if dp is None:
            continue
        with dp._conn_map_lock:
            socks = list(dp._conn_map.values())
            dp._conn_map.clear()
            for pool in dp._conn_pools.values():
                socks += pool
            dp._conn_pools.clear()
        for s in socks:
            if not s.failed:
                s.close()


@pytest.fixture(scope="module", autouse=True)
def _no_leaked_tunnel_pools():
    """Every tunnel pool this module's engines made is unlinked by its
    end: servers stopped and joined, client conns closed."""
    yield
    _close_native_clients()
    mine = f"brpctpu_{os.getpid():x}_"
    deadline = time.monotonic() + 10
    left = [n for n in os.listdir("/dev/shm") if n.startswith(mine)]
    while left and time.monotonic() < deadline:
        threading.Event().wait(0.05)
        left = [n for n in os.listdir("/dev/shm") if n.startswith(mine)]
    assert not left, f"leaked tunnel pools: {left}"


class TestPackagePairings:
    """Native client of one package against a native server of the other,
    over TCP and the tunnel: the response bytes equal the same call's
    between two port engines (the port's engine frames the tunnel to what
    the peer advertises, so it speaks the reference engine's v1)."""

    @pytest.mark.parametrize("lane", LANES, ids=["tcp", "tunnel"])
    def test_four_pairings_answer_the_same_bytes(self, lane):
        rng = np.random.default_rng(23)
        payload = rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes()
        att = rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes()
        got = {}
        for spkg in ("port", "jax"):
            srv = _start(spkg, lane, native=True)
            try:
                for cpkg in ("port", "jax"):
                    got[(cpkg, spkg)] = _call(cpkg, srv, True, "pair",
                                              payload, att)
            finally:
                _stop(srv)
        want = got[("port", "port")]
        assert want[1] == att
        assert echo_pb2.EchoResponse.FromString(want[0]).payload == payload
        for key, val in got.items():
            assert val == want, key


class TestTunnelInterop:
    """All four {Python, native} client x server pairings over the tunnel.
    The port's pass; the reference's mixed pairings fail on the same
    inputs (its engine sends handshake v1 frames with no epoch word, its
    Python lane reads the first word of every DATA/ACK body as the
    epoch)."""

    CASES = []
    for _pkg in ("port", "jax"):
        for _cn in (False, True):
            for _sn in (False, True):
                _marks = []
                if _pkg == "jax" and _cn != _sn:
                    _marks = [pytest.mark.xfail(
                        strict=True, reason="reference fault: its engine's "
                        "TPUC tunnel and its Python lane do not interoperate "
                        "(ROADMAP Queue 3)")]
                CASES.append(pytest.param(
                    _pkg, _cn, _sn, marks=_marks,
                    id=f"{_pkg}-{'native' if _cn else 'python'}_client-"
                       f"{'native' if _sn else 'python'}_server"))

    @pytest.mark.parametrize("pkg,client_native,server_native", CASES)
    def test_pairing(self, pkg, client_native, server_native):
        rng = np.random.default_rng(5)
        payload = rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes()
        srv = _start(pkg, "tpu://127.0.0.1:0/0", server_native)
        try:
            body, att = _call(pkg, srv, client_native, "mix", payload,
                              b"a" * 1000, timeout_ms=3000)
        finally:
            _stop(srv)
        pb = _PKGS[pkg][6]
        resp = pb.EchoResponse.FromString(body)
        assert resp.message == "mix" and resp.payload == payload
        assert att == b"a" * 1000

    @pytest.mark.parametrize("n", [7, 16 << 10, 300_000, 5 << 20])
    def test_python_server_native_client_sizes(self, n):
        srv = _start("port", "tpu://127.0.0.1:0/0", False)
        try:
            body, _ = _call("port", srv, True, "sz", b"q" * n, b"")
        finally:
            _stop(srv)
        assert len(echo_pb2.EchoResponse.FromString(body).payload) == n


# ---------------------------------------------------------------------------
#  The h2 parser's faults (ADVICE.md), raw frames at a native listener
# ---------------------------------------------------------------------------
_PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"
H2_DATA, H2_HEADERS, H2_RST, H2_SETTINGS, H2_PING, H2_GOAWAY = \
    0x0, 0x1, 0x3, 0x4, 0x6, 0x7
H2_CONT = 0x9
END_STREAM, END_HEADERS = 0x1, 0x4


def _h2_frame(ftype, flags, sid, payload=b""):
    return (len(payload).to_bytes(3, "big") + bytes([ftype, flags])
            + sid.to_bytes(4, "big") + payload)


def _hp_int(v, prefix, first=0):
    cap = (1 << prefix) - 1
    if v < cap:
        return bytes([first | v])
    out = bytearray([first | cap])
    v -= cap
    while v >= 128:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _hp_lit(name: bytes, value: bytes, huffman_value: bool = False):
    """Literal header field without indexing, new name (RFC 7541 §6.2.2)."""
    v = _hp_int(len(value), 7, 0x80 if huffman_value else 0) + value
    return b"\x00" + _hp_int(len(name), 7) + name + v


def _grpc_headers(path=b"/EchoService/Echo", extra=b""):
    return (_hp_lit(b":method", b"POST") + _hp_lit(b":scheme", b"http")
            + _hp_lit(b":path", path) + _hp_lit(b":authority", b"t")
            + _hp_lit(b"content-type", b"application/grpc")
            + _hp_lit(b"te", b"trailers") + extra)


def _grpc_body(msg: bytes):
    return b"\x00" + len(msg).to_bytes(4, "big") + msg


_HP_STATIC = {8: (b":status", b"200"), 31: (b"content-type", b"")}


def _hp_decode(block: bytes):
    """The subset the engine emits: indexed static fields and literals
    without indexing, no Huffman."""
    out, pos = [], 0

    def read_int(prefix):
        nonlocal pos
        cap = (1 << prefix) - 1
        v = block[pos] & cap
        pos += 1
        if v < cap:
            return v
        shift = 0
        while True:
            b = block[pos]
            pos += 1
            v += (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return v

    def read_str():
        nonlocal pos
        assert not block[pos] & 0x80, "huffman in a response header"
        n = read_int(7)
        s = block[pos:pos + n]
        pos += n
        return s

    while pos < len(block):
        b = block[pos]
        if b & 0x80:
            out.append(_HP_STATIC[read_int(7)])
        else:
            idx = read_int(4)
            name = _HP_STATIC[idx][0] if idx else read_str()
            out.append((name, read_str()))
    return dict(out)


class _H2Conn:
    def __init__(self, ep):
        self.s = _socket.create_connection((ep.host, ep.port), timeout=10)
        self.buf = b""

    def send(self, data):
        """False when the peer has already failed the connection (a
        refusal may land while our frames are still going out)."""
        try:
            self.s.sendall(data)
        except (ConnectionResetError, BrokenPipeError):
            return False
        return True

    def start(self, settings=b""):
        self.send(_PREFACE + _h2_frame(H2_SETTINGS, 0, 0, settings))

    def request(self, sid, msg=b"", path=b"/EchoService/Echo", extra=b""):
        return self.send(_h2_frame(H2_HEADERS, END_HEADERS, sid,
                                   _grpc_headers(path, extra))
                         + _h2_frame(H2_DATA, END_STREAM, sid,
                                     _grpc_body(msg)))

    def frames(self, until, timeout=10.0):
        """Read frames until ``until(frame)`` is true, EOF or the deadline;
        returns (frames, "match" | "eof" | "timeout")."""
        got = []
        deadline = time.monotonic() + timeout
        while True:
            while len(self.buf) >= 9:
                n = int.from_bytes(self.buf[:3], "big")
                if len(self.buf) < 9 + n:
                    break
                f = (self.buf[3], self.buf[4],
                     int.from_bytes(self.buf[5:9], "big") & 0x7FFFFFFF,
                     self.buf[9:9 + n])
                self.buf = self.buf[9 + n:]
                got.append(f)
                if until(f):
                    return got, "match"
            left = deadline - time.monotonic()
            if left <= 0:
                return got, "timeout"
            self.s.settimeout(left)
            try:
                chunk = self.s.recv(1 << 16)
            except _socket.timeout:
                return got, "timeout"
            except OSError:
                return got, "eof"
            if not chunk:
                return got, "eof"
            self.buf += chunk

    def grpc_status(self, sid, timeout=10.0):
        """grpc-status of stream sid's trailers, or "eof"/"timeout"."""
        got, why = self.frames(
            lambda f: f[0] == H2_HEADERS and f[2] == sid and f[1] & 1,
            timeout)
        if why != "match":
            return why, got
        return _hp_decode(got[-1][3]).get(b"grpc-status"), got

    def ping(self, timeout=10.0):
        """True when the peer answers a PING (the conn is alive)."""
        if not self.send(_h2_frame(H2_PING, 0, 0, b"pingpong")):
            return False
        _, why = self.frames(
            lambda f: f[0] == H2_PING and f[1] & 1, timeout)
        return why == "match"

    def close(self):
        self.s.close()


class _TimeoutEcho(Service):
    DESCRIPTOR = ECHO

    def Echo(self, cntl, request, done):
        return echo_pb2.EchoResponse(message=str(cntl.timeout_ms))


class _JaxTimeoutEcho(jrpc.Service):
    DESCRIPTOR = jecho_pb2.DESCRIPTOR.services_by_name["EchoService"]

    def Echo(self, cntl, request, done):
        return jecho_pb2.EchoResponse(message=str(cntl.timeout_ms))


@pytest.fixture(params=["jax", "port"])
def h2_server(request):
    """A native listener of either package: the registered native echo
    answers EchoService.Echo in C++; EchoService.Timeout... is not a
    method, so the Python service answers it (ENOMETHOD)."""
    pkg = request.param
    if pkg == "jax":
        srv = jrpc.Server(jrpc.ServerOptions(native_dataplane=True))
        srv.add_service(_JaxTimeoutEcho())
    else:
        srv = Server(ServerOptions(native_dataplane=True))
        srv.add_service(_TimeoutEcho())
    srv.start("127.0.0.1:0")
    srv.register_native_echo("NativeEcho", "Echo")
    yield pkg, srv
    srv.stop()
    srv.join()


def _engaged(srv):
    """An h2 conn past the sniff: one grpc echo answered in C++."""
    c = _H2Conn(srv.listen_endpoint())
    c.start()
    c.request(1, b"hello", path=b"/NativeEcho/Echo")
    status, _ = c.grpc_status(1)
    assert status == b"0"
    return c


class TestH2Faults:
    """The five faults ADVICE.md names in the reference engine's h2
    parser. Each case drives the same raw frames at both engines: the
    reference shows the fault, the port's copy refuses."""

    def test_continuation_flood_is_capped(self, h2_server):
        pkg, srv = h2_server
        c = _engaged(srv)
        try:
            # a header block that never ends: 400 KB of CONTINUATION
            chunk = b"\x00" * (16 << 10)
            alive = (c.send(_h2_frame(H2_HEADERS, 0, 3, _grpc_headers()))
                     and c.send(b"".join(_h2_frame(H2_CONT, 0, 3, chunk)
                                         for _ in range(25)))
                     and c.ping())
        finally:
            c.close()
        # the reference keeps growing the block; the port fails the conn
        assert alive is (pkg == "jax")

    def test_prelude_before_headers_is_capped(self, h2_server):
        pkg, srv = h2_server
        c = _H2Conn(srv.listen_endpoint())
        try:
            c.start()
            # 70 KB of an unknown frame type before any HEADERS: held for a
            # possible detach until the first request decides
            status = "eof"
            if c.send(_h2_frame(0x0A, 0, 0, b"\x00" * (70 << 10))):
                c.request(1, b"x", path=b"/NativeEcho/Echo")
                status, _ = c.grpc_status(1)
        finally:
            c.close()
        assert status == (b"0" if pkg == "jax" else "eof")

    def test_max_concurrent_streams_enforced(self, h2_server):
        pkg, srv = h2_server
        c = _engaged(srv)
        try:
            # 1100 open streams (HEADERS without END_STREAM) against the
            # advertised MAX_CONCURRENT_STREAMS of 1024
            hdr = _grpc_headers(path=b"/NativeEcho/Echo")
            c.send(b"".join(_h2_frame(H2_HEADERS, END_HEADERS, sid, hdr)
                            for sid in range(3, 3 + 2 * 1100, 2)))
            c.send(_h2_frame(H2_PING, 0, 0, b"pingpong"))
            got, why = c.frames(lambda f: f[0] == H2_PING and f[1] & 1)
        finally:
            c.close()
        assert why == "match"
        refused = [f for f in got if f[0] == H2_RST
                   and int.from_bytes(f[3], "big") == 0x7]
        assert len(refused) == (0 if pkg == "jax" else 1100 - 1024)

    def test_long_method_name(self, h2_server):
        pkg, srv = h2_server
        c = _H2Conn(srv.listen_endpoint())
        try:
            c.start()
            # a 65540-byte method wraps the reference's u16 length to 4:
            # the Python side reads method "ZZZZ" and a misaligned body
            c.request(1, b"", path=b"/EchoService/" + b"Z" * 65540)
            status, got = c.grpc_status(1)
        finally:
            c.close()
        # reference: UNIMPLEMENTED for the wrapped name; port:
        # INVALID_ARGUMENT, refused before the packed event is built
        assert status == (b"12" if pkg == "jax" else b"3")
        if pkg == "port":
            msg = _hp_decode(got[-1][3]).get(b"grpc-message", b"")
            assert b"too long" in msg

    def test_initial_window_size_above_2_31(self, h2_server):
        pkg, srv = h2_server
        c = _H2Conn(srv.listen_endpoint())
        try:
            c.start(settings=(4).to_bytes(2, "big")
                    + (0xFFFFFFFF).to_bytes(4, "big"))
            if pkg == "jax":
                # adopted: the next request is answered
                c.request(1, b"w", path=b"/NativeEcho/Echo")
                status, got = c.grpc_status(1)
            else:
                # refused before any request: GOAWAY, then the close
                got, status = c.frames(lambda f: False)
        finally:
            c.close()
        if pkg == "jax":
            assert status == b"0"
        else:
            assert status == "eof"
            goaway = [f for f in got if f[0] == H2_GOAWAY]
            assert goaway and goaway[0][3][4:8] == (3).to_bytes(4, "big")

    def test_dynamic_table_size_update_above_settings(self, h2_server):
        pkg, srv = h2_server
        c = _H2Conn(srv.listen_endpoint())
        try:
            c.start()
            # RFC 7541 §6.3 size update to 8192 > the default 4096
            c.send(_h2_frame(H2_HEADERS, END_HEADERS, 1,
                             _hp_int(8192, 5, 0x20)
                             + _grpc_headers(b"/NativeEcho/Echo"))
                   + _h2_frame(H2_DATA, END_STREAM, 1, _grpc_body(b"t")))
            status, _ = c.grpc_status(1)
        finally:
            c.close()
        assert status == (b"0" if pkg == "jax" else "eof")

    def test_sub_millisecond_grpc_timeout(self, h2_server):
        pkg, srv = h2_server
        c = _H2Conn(srv.listen_endpoint())
        try:
            c.start()
            c.request(1, b"", extra=_hp_lit(b"grpc-timeout", b"500u"))
            got, why = c.frames(
                lambda f: f[0] == H2_HEADERS and f[1] & 1 and f[2] == 1)
        finally:
            c.close()
        assert why == "match"
        data = b"".join(f[3] for f in got if f[0] == H2_DATA and f[2] == 1)
        pb = jecho_pb2 if pkg == "jax" else echo_pb2
        seen = pb.EchoResponse.FromString(data[5:]).message
        # reference: 500us floors to 0 = no deadline; port: 1 ms
        assert seen == ("0" if pkg == "jax" else "1")

    def test_hpack_padding_longer_than_7_bits(self, h2_server):
        pkg, srv = h2_server
        c = _H2Conn(srv.listen_endpoint())
        try:
            c.start()
            # "a" in Huffman is 00011; 0x1f pads 3 bits, 0xff 8 more: 11
            # bits of padding (RFC 7541 §5.2: a decoding error)
            c.request(1, b"p", path=b"/NativeEcho/Echo",
                      extra=_hp_lit(b"x-pad", b"\x1f\xff",
                                    huffman_value=True))
            status, _ = c.grpc_status(1)
        finally:
            c.close()
        assert status == (b"0" if pkg == "jax" else "eof")

    def test_valid_padding_and_timeouts_still_served(self, h2_server):
        pkg, srv = h2_server
        c = _H2Conn(srv.listen_endpoint())
        try:
            c.start()
            c.request(1, b"p", path=b"/NativeEcho/Echo",
                      extra=_hp_lit(b"x-pad", b"\x1f", huffman_value=True))
            assert c.grpc_status(1)[0] == b"0"
            c.request(3, b"", extra=_hp_lit(b"grpc-timeout", b"250m"))
            got, why = c.frames(
                lambda f: f[0] == H2_HEADERS and f[1] & 1 and f[2] == 3)
        finally:
            c.close()
        assert why == "match"
        data = b"".join(f[3] for f in got if f[0] == H2_DATA and f[2] == 3)
        pb = jecho_pb2 if pkg == "jax" else echo_pb2
        assert pb.EchoResponse.FromString(data[5:]).message == "250"


# ---------------------------------------------------------------------------
#  The transport sweep example and the native lane bench, on the CPU
# ---------------------------------------------------------------------------
class TestExampleAndBench:
    @pytest.mark.parametrize("serve", ["127.0.0.1:0", "tpu://127.0.0.1:0/0"],
                             ids=["tcp", "tunnel"])
    def test_transport_sweep_example(self, serve, capsys):
        from brpc_tpu_torch.examples.transport_sweep import client

        assert client.main(["--serve", serve, "--native", "--seconds",
                            "0.2", "--threads", "2", "--sizes",
                            "64,65536", "--attachment"]) == 0
        out = capsys.readouterr().out.splitlines()
        assert out[0].startswith("# sweep against ") and "native=True" in \
            out[0]
        assert [line.split()[0] for line in out[1:]] == ["64B", "65536B"]

    def test_native_lane_bench_runs_on_the_cpu(self):
        """bench/native_lane.py as run (a fresh interpreter, its server a
        child): both lanes' rows and the gRPC rows, the data plane over
        the native tunnel held to its counts (no copy launch on the CPU),
        no JAX loaded."""
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        res = subprocess.run(
            [sys.executable, "brpc_tpu_torch/bench/native_lane.py", "--cpu",
             "--ms", "100"], cwd=root, capture_output=True, text=True,
            timeout=300)
        assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
        rows = {}
        for line in res.stdout.splitlines():
            rows.update(json.loads(line))
        for lane in ("native_tcp", "native_tunnel"):
            row = rows[lane]
            assert set(row["sizes"]) == {"64", "4096", "65536",
                                          str(1 << 20), str(16 << 20)}
            assert row["gb_per_s_1mib"] > 0 and row["qps_64b"] > 0
            for handler in ("python_echo", "null_echo"):
                # phase 20's Python client at phase 20's shapes
                assert set(row[handler]["sizes"]) == set(row["sizes"])
                assert row[handler]["gb_per_s_1mib"] > 0
        # the engine's C++ gRPC client at the same shapes, and phase 20's
        # client over grpc on the Python and the engine's h2 lanes
        grpc = rows["native_grpc"]
        assert set(grpc["sizes"]) == set(rows["native_tcp"]["sizes"])
        assert grpc["gb_per_s_1mib"] > 0 and grpc["qps_64b"] > 0
        for name in ("python_h2", "engine_h2"):
            assert set(grpc[name]["sizes"]) == set(grpc["sizes"])
            assert grpc[name]["gb_per_s_1mib"] > 0
        calls = rows["native_served"]["python_echo_calls"]
        assert calls[:2] == [0, 0] and calls[4:] == [0, 0] and \
            min(calls[2:4]) > 0
        assert rows["native_data_plane"]["pump_checksum"] != 0
        assert not any(rows["native_served"]["launches"].values())
        assert rows["native_served"]["foreign_modules"] == []


_EXIT_CHILD = r"""
import os, sys
sys.path.insert(0, sys.argv[1])
from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Server,
                                ServerOptions, Service, Stub)

class Echo(Service):
    DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]
    def Echo(self, cntl, req, done):
        return echo_pb2.EchoResponse(payload=req.payload)

srv = Server(ServerOptions(native_dataplane=True))
srv.add_service(Echo())
srv.start("tpu://127.0.0.1:0/0")
ch = Channel(ChannelOptions(native_transport=True, timeout_ms=10000))
ch.init(str(srv.listen_endpoint()))
stub = Stub(ch, echo_pb2.DESCRIPTOR.services_by_name["EchoService"])
assert len(stub.Echo(echo_pb2.EchoRequest(payload=b"z" * 300000)).payload) \
    == 300000
print(os.getpid(), flush=True)
os._exit(0)   # no stop, no close: both tunnel ends still up
"""


def test_an_exit_with_open_tunnels_leaves_no_shm_segment():
    """Each end unlinks its pool's name once the peer has mapped it, so a
    process that exits with both tunnel ends up (a client that never
    closes, a crash) leaves nothing in /dev/shm."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _EXIT_CHILD, root],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    pid = int(res.stdout.split()[0])
    left = [n for n in os.listdir("/dev/shm")
            if n.startswith(f"brpctpu_{pid:x}_")]
    assert not left, left
