"""The port's RPC front (brpc_tpu_torch.rpc) against the JAX package's, on
127.0.0.1:0: a unary echo over trpc_std and a stream echo, in all four
pairings of {JAX, port} Channel × {JAX, port} Server. Each side's echo
service builds its replies from its own message classes; the responses
(read raw, as bytes) and the stream frames must be equal as bytes in
every pairing. The error paths answer with the reference's codes:
ENOMETHOD, EREQUEST on a garbled body, ERPCTIMEDOUT on a handler that
sleeps past ``timeout_ms`` and ELOGOFF after ``stop()``. A dial the
port cannot make raises rather than falling back.
"""

import threading
import time
import types

import pytest

import brpc_tpu.rpc as jax_rpc
import brpc_tpu.rpc.stream as jax_stream
import brpc_tpu_torch.rpc as port_rpc
import brpc_tpu_torch.rpc.stream as port_stream
from brpc_tpu.proto import echo_pb2 as jax_echo
from brpc_tpu_torch import flags as port_flags
from brpc_tpu_torch.proto import echo_pb2 as port_echo
from brpc_tpu_torch.rpc import errors

SIDES = {
    "jax": types.SimpleNamespace(rpc=jax_rpc, stream=jax_stream,
                                 pb=jax_echo),
    "port": types.SimpleNamespace(rpc=port_rpc, stream=port_stream,
                                  pb=port_echo),
}
PAIRINGS = [(c, s) for c in ("jax", "port") for s in ("jax", "port")]
IDS = [f"{c}-channel-{s}-server" for c, s in PAIRINGS]
STREAM_MSGS = [("one", b"\x00\x01"), ("", b""), ("dré✓", bytes(range(200))),
               ("x" * 3000, b"\xff" * 5000)]


def _echo_service(side):
    pb, stream = side.pb, side.stream

    class EchoService(side.rpc.Service):
        DESCRIPTOR = pb.DESCRIPTOR.services_by_name["EchoService"]

        def Echo(self, cntl, request, done):
            if request.sleep_us:
                time.sleep(request.sleep_us / 1e6)
            meta = getattr(cntl, "_srv_meta", None)
            if meta is not None and meta.stream_settings.stream_id:
                def on_received(sid, msgs):
                    for raw in msgs:
                        req = pb.EchoRequest.FromString(raw)
                        stream.stream_write(sid, pb.EchoResponse(
                            message=req.message.upper(),
                            payload=req.payload[::-1]).SerializeToString())

                stream.stream_accept(cntl, stream.StreamOptions(
                    on_received=on_received))
            return pb.EchoResponse(message="echo:" + request.message,
                                   payload=request.payload * 2)

    return EchoService()


@pytest.fixture(scope="module")
def servers():
    out = {name: side.rpc.Server().add_service(_echo_service(side))
           .start("127.0.0.1:0") for name, side in SIDES.items()}
    yield out
    for server in out.values():
        server.stop()
        server.join(timeout=2)


def _raw_method(side, method="Echo"):
    return side.rpc.MethodDescriptor(
        "EchoService", method, side.pb.EchoRequest, side.rpc.RawMessage)


def _call_raw(side, server, request, method="Echo", cntl=None,
              timeout_ms=5000):
    """(error code, raw response bytes) of one call through ``side``."""
    ch = side.rpc.Channel(side.rpc.ChannelOptions(timeout_ms=timeout_ms,
                                                  max_retry=0))
    ch.init(str(server.listen_endpoint()))
    resp = side.rpc.RawMessage()
    try:
        ch.call_method(_raw_method(side, method), request, response=resp,
                       controller=cntl)
    except side.rpc.RpcError as e:
        return e.error_code, b""
    return errors.OK, resp.data


@pytest.mark.parametrize("client,server", PAIRINGS, ids=IDS)
def test_echo_bytes_equal_in_every_pairing(servers, client, server):
    side = SIDES[client]
    got = []
    for msg, payload in STREAM_MSGS:
        req = side.pb.EchoRequest(message=msg, payload=payload)
        code, data = _call_raw(side, servers[server], req)
        assert code == errors.OK
        got.append(data)
    want = [jax_echo.EchoResponse(message="echo:" + m,
                                  payload=p * 2).SerializeToString()
            for m, p in STREAM_MSGS]
    assert got == want


@pytest.mark.parametrize("client,server", PAIRINGS, ids=IDS)
def test_stream_echo_frames_equal_in_every_pairing(servers, client,
                                                   server):
    side = SIDES[client]
    frames = []
    all_in = threading.Event()

    def on_received(sid, msgs):
        frames.extend(msgs)
        if len(frames) >= len(STREAM_MSGS):
            all_in.set()

    sid = side.stream.stream_create(side.stream.StreamOptions(
        on_received=on_received))
    cntl = side.rpc.Controller()
    cntl.stream_id = sid
    code, data = _call_raw(side, servers[server],
                           side.pb.EchoRequest(message="open"), cntl=cntl)
    assert code == errors.OK
    assert data == jax_echo.EchoResponse(
        message="echo:open").SerializeToString()
    for msg, payload in STREAM_MSGS:
        assert side.stream.stream_write(sid, side.pb.EchoRequest(
            message=msg, payload=payload).SerializeToString()) == 0
    assert all_in.wait(10), f"{len(frames)} frames"
    side.stream.stream_close(sid)
    assert frames == [jax_echo.EchoResponse(
        message=m.upper(), payload=p[::-1]).SerializeToString()
        for m, p in STREAM_MSGS]


@pytest.mark.parametrize("client,server", PAIRINGS, ids=IDS)
def test_unknown_method_is_enomethod(servers, client, server):
    side = SIDES[client]
    code, _ = _call_raw(side, servers[server], side.pb.EchoRequest(),
                        method="NoSuchMethod")
    assert code == errors.ENOMETHOD == jax_rpc.errors.ENOMETHOD


@pytest.mark.parametrize("client,server", PAIRINGS, ids=IDS)
def test_garbled_body_is_erequest(servers, client, server):
    side = SIDES[client]
    for garbled in (b"\xff", b"\x0a\x05ab", b"\x1a\x80"):
        code, _ = _call_raw(side, servers[server],
                            side.rpc.RawMessage(garbled))
        assert code == errors.EREQUEST == jax_rpc.errors.EREQUEST


@pytest.mark.parametrize("client,server", PAIRINGS, ids=IDS)
def test_handler_past_the_deadline_is_erpctimedout(servers, client, server):
    side = SIDES[client]
    t0 = time.monotonic()
    code, _ = _call_raw(side, servers[server],
                        side.pb.EchoRequest(sleep_us=1_000_000),
                        timeout_ms=100)
    assert code == errors.ERPCTIMEDOUT == jax_rpc.errors.ERPCTIMEDOUT
    assert time.monotonic() - t0 < 0.9  # before the handler returns


@pytest.mark.parametrize("client,server", PAIRINGS, ids=IDS)
def test_stopped_server_answers_elogoff(client, server):
    side, srv_side = SIDES[client], SIDES[server]
    srv = srv_side.rpc.Server().add_service(_echo_service(srv_side)) \
        .start("127.0.0.1:0")
    try:
        ch = side.rpc.Channel(side.rpc.ChannelOptions(max_retry=0))
        ch.init(str(srv.listen_endpoint()))
        md = _raw_method(side)
        ch.call_method(md, side.pb.EchoRequest(message="up"),
                       response=side.rpc.RawMessage())
        srv.stop()  # the connection stays; new requests are refused
        with pytest.raises(side.rpc.RpcError) as ei:
            ch.call_method(md, side.pb.EchoRequest(message="down"),
                           response=side.rpc.RawMessage())
        assert ei.value.error_code == errors.ELOGOFF == \
            jax_rpc.errors.ELOGOFF
    finally:
        srv.stop()
        srv.join(timeout=2)


def test_typed_stub_round_trip_on_the_port():
    srv = port_rpc.Server().add_service(_echo_service(SIDES["port"])) \
        .start("127.0.0.1:0")
    try:
        ch = port_rpc.Channel().init(str(srv.listen_endpoint()))
        stub = port_rpc.Stub(
            ch, port_echo.DESCRIPTOR.services_by_name["EchoService"])
        resp = stub.Echo(port_echo.EchoRequest(message="hi", payload=b"ab"))
        assert isinstance(resp, port_echo.EchoResponse)
        assert (resp.message, resp.payload) == ("echo:hi", b"abab")
        box, ev = [], threading.Event()
        cntl = stub.Echo(port_echo.EchoRequest(message="async"),
                         done=lambda c: (box.append(c), ev.set()))
        assert ev.wait(5) and box[0] is cntl and not cntl.failed()
        assert cntl.response.message == "echo:async"
    finally:
        srv.stop()
        srv.join(timeout=2)


def test_what_is_not_ported_refuses():
    # a dial of the engine's gRPC lane that fails raises rather than
    # falling back; the sharded dispatch plane is ported and starts its
    # workers with the server, no longer refused
    from brpc_tpu_torch.rpc.native_transport import bench_echo_native
    with pytest.raises(RuntimeError, match="dp_bench_echo failed"):
        bench_echo_native("127.0.0.1", 1, grpc=True, duration_ms=100)
    port_flags.set_flag("tpu_shard_workers", "2")
    try:
        srv = port_rpc.Server().start("127.0.0.1:0")
        try:
            assert srv._shard_plane.wait_ready(30.0)
            assert len(srv._shard_plane.workers) == 2
        finally:
            srv.stop()
            srv.join(timeout=2)
        assert srv._shard_plane is None
    finally:
        port_flags.set_flag("tpu_shard_workers", "0")
    # the reference's eleven protocols in its order, HTTP probed last
    import brpc_tpu.policy as jax_policy
    from brpc_tpu.rpc.protocol import list_protocols as jax_list
    from brpc_tpu_torch.rpc.protocol import list_protocols
    jax_policy.ensure_registered()
    assert [p.name for p in list_protocols()] == \
        [p.name for p in jax_list()] == [
            "trpc_std", "trpc_stream", "tpu_ctrl", "grpc", "redis", "mongo",
            "rtmp", "thrift", "memcache", "nshead", "http"]


# The shard plane's flags, which the port once left undefined, are now
# defined with the reference's defaults and validators: a value the
# reference refuses is refused here too.
_UNPORTED_FLAGS = (
    "tpu_shard_rebalance_pct",
    "tpu_shard_respawn_backoff_ms", "tpu_shard_respawn_max",
    "tpu_shard_ring_mb", "tpu_shard_forward_max", "shard_vars_interval_s")


@pytest.mark.parametrize("name", _UNPORTED_FLAGS)
def test_flags_of_unported_features_are_refused(name):
    import brpc_tpu.flags as jax_flags

    assert port_flags.get(name) == jax_flags.get(name)
    for bad in ("-1", "0") if name != "tpu_shard_respawn_max" else ("-1",):
        with pytest.raises(jax_flags.FlagError):
            jax_flags.set_flag(name, bad)
        with pytest.raises(port_flags.FlagError):
            port_flags.set_flag(name, bad)
    assert port_flags.get(name) == jax_flags.get(name)


# The tunnel's flags (tpu/transport.py, rpc/circuit_breaker.py) came with
# the tpu:// lane: defined with the reference's defaults, reloadability
# and validators.
_TUNNEL_FLAGS = (
    "circuit_breaker_enabled", "tpu_tunnel_auto_heal",
    "tpu_reconnect_backoff_ms", "tpu_reconnect_backoff_max_ms",
    "tpu_reconnect_window_s", "tpu_doorbell_coalesce_us")


# The prefix cache's and the speculative lane's flags came with the
# serving engine's defaults, on the same terms.
_SERVING_FLAGS = (
    "serving_prefix_cache_enabled", "serving_prefix_evict_watermark",
    "serving_prefix_thrash_rate", "serving_spec_accept_rate_min")


# KV migration's flags came with the disaggregated serving plane.
_MIGRATION_FLAGS = ("serving_migrate_window_mb", "serving_migrate_timeout_ms",
                    "serving_migrate_backlog_max")


@pytest.mark.parametrize("name", _TUNNEL_FLAGS)
def test_flags_of_the_tunnel_match_the_reference(name):
    _flag_matches_the_reference(name)


@pytest.mark.parametrize("name", _SERVING_FLAGS)
def test_flags_of_the_prefix_cache_and_spec_match_the_reference(name):
    _flag_matches_the_reference(name)


@pytest.mark.parametrize("name", _MIGRATION_FLAGS)
def test_flags_of_kv_migration_match_the_reference(name):
    _flag_matches_the_reference(name)


# The shard-skew bound came with the sharded KV cache and its watch rule.
@pytest.mark.parametrize("name", ["serving_shard_skew_ratio"])
def test_flags_of_sharded_serving_match_the_reference(name):
    _flag_matches_the_reference(name)


# The starvation bound came with multi-tenant QoS and its watch rule.
@pytest.mark.parametrize("name", ["serving_qos_starvation_ms"])
def test_flags_of_qos_match_the_reference(name):
    _flag_matches_the_reference(name)


# The health checker's interval came with the load balancers.
@pytest.mark.parametrize("name", ["health_check_interval_s"])
def test_flags_of_health_check_match_the_reference(name):
    _flag_matches_the_reference(name)


def _flag_matches_the_reference(name):
    import brpc_tpu.flags as jax_flags

    j, p = jax_flags.find(name), port_flags.find(name)
    assert p is not None
    assert (p.default, p.reloadable, type(p.default)) == \
        (j.default, j.reloadable, type(j.default))
    for bad in ("0", "-1"):
        jax_ok = port_ok = True
        try:
            jax_flags.set_flag(name, bad)
        except jax_flags.FlagError:
            jax_ok = False
        try:
            port_flags.set_flag(name, bad)
        except port_flags.FlagError:
            port_ok = False
        assert jax_ok == port_ok, (name, bad)
    jax_flags.set_flag(name, str(j.default))
    port_flags.set_flag(name, str(p.default))
    assert port_flags.get(name) == jax_flags.get(name) == j.default


def test_default_watch_rules_read_exported_variables():
    """Every default watch rule reads a variable the port exposes once its
    server has started and its serving package is loaded."""
    import brpc_tpu_torch.serving  # noqa: F401  (the serving variables)
    import brpc_tpu_torch.serving.migration  # noqa: F401  (loaded lazily)
    import brpc_tpu_torch.shard.plane  # noqa: F401  (the plane's variables)
    import brpc_tpu_torch.tpu.transport  # noqa: F401  (the tunnel's)
    from brpc_tpu_torch.metrics import variable
    from brpc_tpu_torch.metrics.watch import global_watch

    srv = port_rpc.Server().start("127.0.0.1:0")
    try:
        rules = [r for r in global_watch().rules()
                 if not r.name.startswith("slo_burn_")]
        assert [r.name for r in rules] == ["block_pool_exhaustion",
                                           "deadline_expiry_rate",
                                           "serving_kv_exhaustion",
                                           "serving_migrate_backlog",
                                           "serving_prefix_thrash",
                                           "serving_qos_starvation",
                                           "serving_shard_skew",
                                           "serving_spec_collapse",
                                           "shard_worker_death",
                                           "tunnel_healer_trips"]
        for r in rules:
            assert variable.get_exposed(r.var) is not None, r.var
    finally:
        srv.stop()
        srv.join(timeout=2)
