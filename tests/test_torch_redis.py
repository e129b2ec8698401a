"""The port's counterpart of the JAX package's ``tests/test_redis.py``:
every case runs against the port's servers and clients.

Redis protocol tests: RESP codec units, pipelined client over loopback,
and server-side RedisService answering a raw RESP client (the reference's
test/brpc_redis_unittest.cpp pattern)."""

import socket as pysocket
import threading
import time

import pytest

from brpc_tpu_torch.policy.redis_protocol import (
    REPLY_ARRAY,
    REPLY_BULK,
    REPLY_ERROR,
    REPLY_INTEGER,
    REPLY_STRING,
    RedisReply,
    RedisRequest,
    RedisResponse,
    RedisService,
    count_commands,
    pack_command,
    pack_reply,
    parse_reply,
    redis_method,
)
from brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, ServerOptions, errors
from brpc_tpu_torch.rpc.channel import RpcError


# ------------------------------------------------------------------ codec
class TestRespCodec:
    def test_pack_command(self):
        assert pack_command("SET", "k", "v") == \
            b"*3\r\n$3\r\nSET\r\n$1\r\nk\r\n$1\r\nv\r\n"
        assert pack_command("INCRBY", "c", 42) == \
            b"*3\r\n$6\r\nINCRBY\r\n$1\r\nc\r\n$2\r\n42\r\n"

    def test_parse_simple_types(self):
        r, p = parse_reply(b"+OK\r\n", 0)
        assert r.type == REPLY_STRING and r.value == "OK" and p == 5
        r, _ = parse_reply(b"-ERR boom\r\n", 0)
        assert r.is_error() and r.value == "ERR boom"
        r, _ = parse_reply(b":1234\r\n", 0)
        assert r.type == REPLY_INTEGER and r.value == 1234
        r, _ = parse_reply(b"$5\r\nhello\r\n", 0)
        assert r.type == REPLY_BULK and r.value == b"hello"
        r, _ = parse_reply(b"$-1\r\n", 0)
        assert r.type == REPLY_BULK and r.is_nil()

    def test_parse_nested_array(self):
        wire = b"*2\r\n*2\r\n:1\r\n:2\r\n$3\r\nabc\r\n"
        r, p = parse_reply(wire, 0)
        assert p == len(wire)
        assert r.type == REPLY_ARRAY
        assert r.value[0].value[1].value == 2
        assert r.value[1].value == b"abc"

    def test_incomplete_returns_none(self):
        assert parse_reply(b"$10\r\nhel", 0)[0] is None
        assert parse_reply(b"*2\r\n:1\r\n", 0)[0] is None

    def test_reply_roundtrip(self):
        replies = [
            RedisReply(REPLY_STRING, "OK"),
            RedisReply(REPLY_ERROR, "ERR no"),
            RedisReply(REPLY_INTEGER, -7),
            RedisReply(REPLY_BULK, b"\x00binary\xff"),
            RedisReply(REPLY_BULK, None),
            RedisReply(REPLY_ARRAY, [RedisReply(REPLY_INTEGER, 1),
                                     RedisReply(REPLY_BULK, b"x")]),
        ]
        wire = b"".join(pack_reply(r) for r in replies)
        resp = RedisResponse()
        resp.ParseFromString(wire)
        assert resp.reply_size == len(replies)
        assert resp.reply(3).value == b"\x00binary\xff"
        assert resp.reply(4).is_nil()
        assert resp.reply(5).value[1].value == b"x"

    def test_count_commands(self):
        req = RedisRequest()
        req.add_command("SET", "a", "1").add_command("GET", "a")
        assert count_commands(req.SerializeToString()) == 2


# --------------------------------------------------------------- server side
def make_kv_service():
    store = {}
    svc = RedisService()
    svc.add_command_handler(
        "set", lambda a: (store.__setitem__(a[1], a[2]),
                          RedisReply(REPLY_STRING, "OK"))[1])
    svc.add_command_handler(
        "get", lambda a: RedisReply(REPLY_BULK, store.get(a[1])))
    svc.add_command_handler(
        "del", lambda a: RedisReply(
            REPLY_INTEGER, 1 if store.pop(a[1], None) is not None else 0))
    return svc, store


@pytest.fixture()
def redis_server():
    svc, store = make_kv_service()
    server = Server(ServerOptions(redis_service=svc)).start("127.0.0.1:0")
    yield server, store
    server.stop()
    server.join(timeout=2)


class TestRedisClientServer:
    def test_pipelined_set_get(self, redis_server):
        server, _ = redis_server
        ch = Channel(ChannelOptions(protocol="redis")).init(
            str(server.listen_endpoint()))
        req = RedisRequest()
        req.add_command("SET", "k1", "v1")
        req.add_command("GET", "k1")
        req.add_command("GET", "missing")
        resp = ch.call_method(redis_method(), req, RedisResponse())
        assert resp.reply_size == 3
        assert resp.reply(0).value == "OK"
        assert resp.reply(1).value == b"v1"
        assert resp.reply(2).is_nil()

    def test_many_rpcs_one_connection(self, redis_server):
        server, _ = redis_server
        ch = Channel(ChannelOptions(protocol="redis")).init(
            str(server.listen_endpoint()))
        for i in range(50):
            req = RedisRequest().add_command("SET", f"k{i}", f"v{i}")
            req.add_command("GET", f"k{i}")
            resp = ch.call_method(redis_method(), req, RedisResponse())
            assert resp.reply(1).value == f"v{i}".encode()
        assert server.connection_count() == 1

    def test_concurrent_clients_keep_order(self, redis_server):
        server, _ = redis_server
        ch = Channel(ChannelOptions(protocol="redis", timeout_ms=5000)).init(
            str(server.listen_endpoint()))
        bad = []

        def worker(i):
            for j in range(20):
                req = RedisRequest().add_command("SET", f"w{i}", f"{i}.{j}")
                req.add_command("GET", f"w{i}")
                r = ch.call_method(redis_method(), req, RedisResponse())
                if r.reply(1).value != f"{i}.{j}".encode():
                    bad.append((i, j, r.reply(1).value))

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not bad

    def test_unknown_command_is_error_reply(self, redis_server):
        server, _ = redis_server
        ch = Channel(ChannelOptions(protocol="redis")).init(
            str(server.listen_endpoint()))
        resp = ch.call_method(redis_method(),
                              RedisRequest().add_command("FLUSHALL"),
                              RedisResponse())
        assert resp.reply(0).is_error()

    def test_builtin_ping(self, redis_server):
        server, _ = redis_server
        ch = Channel(ChannelOptions(protocol="redis")).init(
            str(server.listen_endpoint()))
        resp = ch.call_method(redis_method(),
                              RedisRequest().add_command("PING"),
                              RedisResponse())
        assert resp.reply(0).value == "PONG"

    def test_raw_resp_client_like_redis_cli(self, redis_server):
        """A plain socket speaking RESP (what redis-cli sends)."""
        server, _ = redis_server
        ep = server.listen_endpoint()
        s = pysocket.create_connection((ep.host, ep.port), timeout=5)
        try:
            s.sendall(pack_command("SET", "raw", "yes")
                      + pack_command("GET", "raw"))
            got = b""
            while b"yes" not in got:
                chunk = s.recv(4096)
                assert chunk
                got += chunk
            assert got == b"+OK\r\n$3\r\nyes\r\n"
        finally:
            s.close()

    def test_timeout_then_recovery(self, redis_server):
        server, _ = redis_server
        svc = server.options.redis_service
        gate = threading.Event()
        svc.add_command_handler("slow", lambda a: (gate.wait(3),
                                                   RedisReply(REPLY_STRING, "done"))[1])
        ch = Channel(ChannelOptions(protocol="redis", timeout_ms=100,
                                    max_retry=0)).init(
            str(server.listen_endpoint()))
        with pytest.raises(RpcError) as ei:
            ch.call_method(redis_method(),
                           RedisRequest().add_command("SLOW"),
                           RedisResponse())
        assert ei.value.error_code == errors.ERPCTIMEDOUT
        gate.set()
        # the late reply for the timed-out call must be discarded and the
        # next RPC must still line up correctly
        time.sleep(0.1)
        resp = ch.call_method(redis_method(),
                              RedisRequest().add_command("PING"),
                              RedisResponse())
        assert resp.reply(0).value == "PONG"


class TestReviewRegressions:
    def test_nil_bulk_command_does_not_desync_batch(self, redis_server):
        """A $-1 element inside a command must not drop the batch's replies
        (positional correlation would desync for every later RPC)."""
        server, _ = redis_server
        ch = Channel(ChannelOptions(protocol="redis", timeout_ms=2000)).init(
            str(server.listen_endpoint()))
        import socket as pysocket

        ep = server.listen_endpoint()
        s = pysocket.create_connection((ep.host, ep.port), timeout=5)
        try:
            s.sendall(pack_command("SET", "nb", "1")
                      + b"*1\r\n$-1\r\n"
                      + pack_command("GET", "nb"))
            got = b""
            while got.count(b"\r\n") < 3:
                chunk = s.recv(4096)
                assert chunk, f"connection died after {got!r}"
                got += chunk
            assert got.startswith(b"+OK\r\n-ERR")
            assert got.endswith(b"$1\r\n1\r\n")
        finally:
            s.close()

    def test_mixed_stateful_protocols_same_endpoint(self, redis_server):
        """grpc and redis channels to the same host:port must not share a
        socket (each connection-scoped protocol owns its connection)."""
        server, _ = redis_server
        ep = str(server.listen_endpoint())
        rch = Channel(ChannelOptions(protocol="redis")).init(ep)
        from brpc_tpu_torch.proto import health_pb2
        from brpc_tpu_torch.rpc import Stub

        gch = Channel(ChannelOptions(protocol="grpc")).init(ep)
        hstub = Stub(gch, health_pb2.DESCRIPTOR.services_by_name["Health"])
        for _ in range(3):  # interleave the two protocols
            r = rch.call_method(redis_method(),
                                RedisRequest().add_command("PING"),
                                RedisResponse())
            assert r.reply(0).value == "PONG"
            assert hstub.Check(health_pb2.HealthCheckRequest()).status == 1
        assert server.connection_count() == 2
