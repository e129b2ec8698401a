"""The port's counterpart of the JAX package's ``tests/test_multiprotocol_port.py``:
every case runs against the port's servers and clients.

Single-port multiprotocol soak: one Server simultaneously serving
trpc_std RPC, HTTP/1.1 JSON RPC, gRPC (h2), the h2 dashboard, redis,
mongo, and RTMP
from concurrent clients — the reference's single-port story under
cross-protocol concurrency."""

import threading

import pytest

from brpc_tpu_torch.policy.mongo_protocol import (MongoRequest, MongoService,
                                                  mongo_method)
from brpc_tpu_torch.policy.redis_protocol import (REPLY_BULK, REPLY_STRING,
                                                   RedisReply, RedisService)
from brpc_tpu_torch.policy.rtmp import MSG_VIDEO, RtmpClient, RtmpService
from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Server, ServerOptions,
                                Service, Stub)

ECHO = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]


class EchoImpl(Service):
    DESCRIPTOR = ECHO

    def Echo(self, cntl, request, done):
        return echo_pb2.EchoResponse(message=request.message)


@pytest.fixture()
def kitchen_sink_server():
    kv = {}
    redis = RedisService()

    def _set(args):
        kv[args[1]] = args[2]
        return RedisReply(REPLY_STRING, "OK")

    redis.add_command_handler("SET", _set)
    redis.add_command_handler(
        "GET", lambda args: RedisReply(REPLY_BULK, kv.get(args[1])))
    server = Server(ServerOptions(redis_service=redis,
                                  mongo_service=MongoService(),
                                  rtmp_service=RtmpService()))
    server.add_service(EchoImpl())
    server.start("127.0.0.1:0")
    yield server
    server.stop()
    server.join(timeout=2)


def test_six_protocols_concurrently(kitchen_sink_server):
    server = kitchen_sink_server
    ep = server.listen_endpoint()
    addr = str(ep)
    errs = []
    rounds = 15

    def guard(fn):
        def run():
            try:
                fn()
            except Exception as e:  # pragma: no cover
                errs.append((fn.__name__, repr(e)))
        return run

    @guard
    def trpc_client():
        stub = Stub(Channel(ChannelOptions(timeout_ms=5000)).init(addr),
                    ECHO)
        for i in range(rounds):
            assert stub.Echo(echo_pb2.EchoRequest(
                message=f"t{i}")).message == f"t{i}"

    @guard
    def http_client():
        import json
        import urllib.request

        for i in range(rounds):
            req = urllib.request.Request(
                f"http://{addr}/EchoService/Echo",
                data=json.dumps({"message": f"h{i}"}).encode(),
                headers={"Content-Type": "application/json"})
            body = json.load(urllib.request.urlopen(req, timeout=5))
            assert body["message"] == f"h{i}"

    @guard
    def grpc_client():
        stub = Stub(Channel(ChannelOptions(protocol="grpc",
                                           timeout_ms=5000)).init(addr),
                    ECHO)
        for i in range(rounds):
            assert stub.Echo(echo_pb2.EchoRequest(
                message=f"g{i}")).message == f"g{i}"

    @guard
    def redis_client():
        from brpc_tpu_torch.policy.redis_protocol import (RedisRequest,
                                                          RedisResponse,
                                                          redis_method)

        ch = Channel(ChannelOptions(protocol="redis",
                                    timeout_ms=5000)).init(addr)
        for i in range(rounds):
            req = RedisRequest().add_command("SET", f"k{i}", f"v{i}")
            req.add_command("GET", f"k{i}")
            resp = ch.call_method(redis_method(), req,
                                  response=RedisResponse())
            assert resp.reply(1).value == f"v{i}".encode()

    @guard
    def mongo_client():
        ch = Channel(ChannelOptions(protocol="mongo",
                                    timeout_ms=5000)).init(addr)
        for _ in range(rounds):
            assert ch.call_method(mongo_method(),
                                  MongoRequest({"ping": 1})).ok

    @guard
    def h2_dashboard_client():
        # plain HTTP/2 (no grpc content-type) hits the builtin dashboard
        import socket as _socket

        from brpc_tpu_torch.policy.h2 import PREFACE, pack_frame, pack_settings
        from brpc_tpu_torch.policy.hpack import HpackEncoder

        for _ in range(max(3, rounds // 5)):
            enc = HpackEncoder()
            hdrs = enc.encode([(":method", "GET"), (":scheme", "http"),
                               (":path", "/health"), (":authority", "t")])
            with _socket.create_connection((ep.host, ep.port),
                                           timeout=5) as s:
                s.sendall(PREFACE + pack_settings([]) +
                          pack_frame(1, 0x4 | 0x1, 1, hdrs))
                s.settimeout(5)
                data = b""
                while b"OK" not in data:
                    chunk = s.recv(4096)
                    if not chunk:
                        break
                    data += chunk
                assert b"OK" in data

    @guard
    def rtmp_pair():
        pub = RtmpClient(ep.host, ep.port)
        sub = RtmpClient(ep.host, ep.port)
        try:
            got = threading.Event()
            sub.on_frame = lambda t, s, p: got.set()
            psid = pub.create_stream()
            pub.publish("mix", psid)
            ssid = sub.create_stream()
            sub.play("mix", ssid)
            # keep sending until the subscriber sees a frame: play() is
            # fire-and-forget, so a one-shot burst could race an
            # un-registered subscriber on a loaded machine
            import time as _time

            deadline = _time.monotonic() + 10
            i = 0
            while not got.is_set() and _time.monotonic() < deadline:
                pub.send_frame(MSG_VIDEO, psid, b"\x17" + bytes(200),
                               timestamp=i * 33)
                i += 1
                _time.sleep(0.02)
            assert got.wait(1)
        finally:
            pub.close()
            sub.close()

    threads = [threading.Thread(target=fn) for fn in
               (trpc_client, http_client, grpc_client, redis_client,
                mongo_client, h2_dashboard_client, rtmp_pair)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads), "client thread hung"
    assert not errs, errs
