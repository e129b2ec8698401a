"""The serving main path and the device data plane on the port's native
engine, on the CPU: the port's Server with ``native_dataplane=True`` over
TCP and the engine's TPUC tunnel (``tpu://127.0.0.1:0/0``), at the
llm_server example's widths with weights from seed 0.

- The recorder's schedule (tools/record_serving_corpus.SCHEDULE) as
  streamed and as unary Generates, called by the port's native Channel and
  by the JAX package's native Channel: tokens equal the JAX server's (a JAX
  native server over the same lanes), exactly; streamed frames join to
  their response.
- DeviceDataService Put/Copy/Pump over the native tunnel, the port's
  server against the JAX one on one script, answers equal (tolerance 0;
  the JAX Pump's unwritten tail rows are the reference fault held in
  tests/test_torch_tpusocket.py), the cases of tests/test_device_lane.py.
- Stream echo over each native lane (tests/test_stream.py
  ::TestStreamingOverNativeLanes), with the Python client on the tunnel.
- Generate over JSON on a native port: the HTTP connection is DETACHed
  from the engine to the port's HTTP stack on the same listener.
"""

import json
import threading
import types

import numpy as np
import pytest

import brpc_tpu.rpc as jax_rpc
import brpc_tpu.rpc.stream as jax_stream
import brpc_tpu_torch.rpc as port_rpc
import brpc_tpu_torch.rpc.stream as port_stream
from brpc_tpu.proto import device_lane_pb2 as jax_dpb
from brpc_tpu.proto import serving_pb2 as jax_serving
from brpc_tpu.rpc import native_transport as jax_nt
from brpc_tpu.serving import EngineConfig as JaxEngineConfig
from brpc_tpu.serving import KVCacheConfig as JaxKVConfig
from brpc_tpu.serving import LlmServingService as JaxLlmService
from brpc_tpu.serving import ModelConfig as JaxModelConfig
from brpc_tpu.serving import PagedKVCache as JaxKV
from brpc_tpu.serving import ServingEngine as JaxEngine
from brpc_tpu.serving import TinyTransformer as JaxModel
from brpc_tpu.tpu import device_lane as jax_dl
from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.policy.http_protocol import CONTENT_JSON, http_fetch
from brpc_tpu_torch.proto import device_lane_pb2 as port_dpb
from brpc_tpu_torch.proto import echo_pb2, serving_pb2
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc import native_transport as port_nt
from brpc_tpu_torch.serving import (EngineConfig, KVCacheConfig,
                                    ModelConfig, PagedKVCache,
                                    ServingEngine, TinyTransformer)
from brpc_tpu_torch.serving.service import LlmServingService
from brpc_tpu_torch.tpu import device_lane as port_dl
from brpc_tpu_torch.tpu import mesh
from brpc_tpu_torch.tpu import pallas_ops
from tools import record_serving_corpus as recorder

LLM_SERVER = dict(vocab=512, d_model=64, n_heads=4, n_layers=2)
KV_BLOCKS, BLOCK = 256, 16
TOKEN_BUDGET = 1024
LANES = {"tcp": "127.0.0.1:0", "tunnel": "tpu://127.0.0.1:0/0"}

SIDES = {
    "jax": types.SimpleNamespace(rpc=jax_rpc, stream=jax_stream,
                                 pb=jax_serving),
    "port": types.SimpleNamespace(rpc=port_rpc, stream=port_stream,
                                  pb=serving_pb2),
}


def _close_native_clients():
    """Close both engines' cached client conns (and their tunnel pools):
    a later module must not find a conn to a server that is gone."""
    for mod in (jax_nt, port_nt):
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
def _close_clients_at_end():
    yield
    _close_native_clients()


def _port_engine():
    mcfg = ModelConfig(attn="reference", seed=0, **LLM_SERVER)
    kv = PagedKVCache(KVCacheConfig(BLOCK, KV_BLOCKS), mcfg.n_layers,
                      mcfg.kv_dim, device="cpu")
    kv._check = True
    return ServingEngine(TinyTransformer(mcfg, kv), kv, EngineConfig(
        max_batch=8, token_budget=TOKEN_BUDGET, idle_wait_s=0.005)).start()


def _jax_engine():
    jcfg = JaxModelConfig(attn="reference", **LLM_SERVER)
    jkv = JaxKV(JaxKVConfig(BLOCK, KV_BLOCKS), jcfg.n_layers, jcfg.kv_dim)
    return JaxEngine(JaxModel(jcfg, jkv), jkv, JaxEngineConfig(
        max_batch=8, token_budget=TOKEN_BUDGET, idle_wait_s=0.005),
        prefix_cache=False).start()


def _stub(side, server, timeout_ms=60000):
    ch = side.rpc.Channel(side.rpc.ChannelOptions(
        timeout_ms=timeout_ms, native_transport=True))
    ch.init(str(server.listen_endpoint()))
    return side.rpc.Stub(ch, side.pb.DESCRIPTOR.services_by_name[
        "LlmService"])


def _generate(side, stub, request, streamed):
    """One Generate: (response or RpcError, [TokenDelta])."""
    if not streamed:
        try:
            return stub.Generate(request), []
        except side.rpc.RpcError as e:
            return e, []
    frames = []
    last = threading.Event()

    def on_received(sid, msgs):
        for raw in msgs:
            delta = side.pb.TokenDelta.FromString(raw)
            frames.append(delta)
            if delta.done:
                last.set()

    sid = side.stream.stream_create(side.stream.StreamOptions(
        on_received=on_received))
    cntl = side.rpc.Controller()
    cntl.stream_id = sid
    try:
        resp = stub.Generate(request, controller=cntl)
    except side.rpc.RpcError as e:
        side.stream.stream_close(sid)
        return e, frames
    assert last.wait(10), "the last TokenDelta never arrived"
    side.stream.stream_close(sid)
    return resp, frames


def _serve_schedule(side, server, streamed):
    """The recorder's schedule as concurrent Generates at its gap."""
    stub = _stub(side, server)
    out = [None] * len(recorder.SCHEDULE)

    def run(i, plen, max_new):
        out[i] = _generate(side, stub, side.pb.GenerateRequest(
            prompt_len=plen, max_new_tokens=max_new), streamed)

    threads = []
    gap = threading.Event()
    for i, (plen, max_new) in enumerate(recorder.SCHEDULE):
        t = threading.Thread(target=run, args=(i, plen, max_new))
        t.start()
        threads.append(t)
        gap.wait(recorder.GAP_S)
    for t in threads:
        t.join(120)
        assert not t.is_alive(), "a Generate never returned"
    return out


@pytest.fixture(scope="module")
def jax_tokens():
    """The JAX server's tokens for the schedule: its engine behind a JAX
    Server on its native TCP lane, called by its native Channel."""
    jeng = _jax_engine()
    jserver = jax_rpc.Server(jax_rpc.ServerOptions(native_dataplane=True))
    jserver.add_service(JaxLlmService(jeng)).start("127.0.0.1:0")
    try:
        out = _serve_schedule(SIDES["jax"], jserver, streamed=True)
    finally:
        jserver.stop()
        jserver.join(timeout=2)
        jeng.stop()
    return [list(r.tokens) for r, _ in out]


@pytest.fixture(scope="module", params=sorted(LANES))
def native_llm(request):
    engine = _port_engine()
    server = port_rpc.Server(port_rpc.ServerOptions(native_dataplane=True))
    server.add_service(LlmServingService(engine)).start(
        LANES[request.param])
    yield request.param, server, engine
    server.stop()
    server.join(timeout=2)
    engine.stop()
    engine.kv.assert_idle("native serving teardown")


@pytest.mark.parametrize("client", ["port", "jax"])
@pytest.mark.parametrize("streamed", [True, False],
                         ids=["streamed", "unary"])
def test_schedule_tokens_equal_the_jax_server(native_llm, jax_tokens,
                                              client, streamed):
    lane, server, _ = native_llm
    assert str(server.listen_endpoint()).startswith(
        "tpu://" if lane == "tunnel" else "127.0.0.1:")
    side = SIDES[client]
    got = _serve_schedule(side, server, streamed)
    for (plen, max_new), want, (g, gf) in zip(recorder.SCHEDULE,
                                              jax_tokens, got):
        assert isinstance(g, side.pb.GenerateResponse), g
        assert list(g.tokens) == want, (plen, max_new)
        assert (g.prompt_len, g.steps, g.finish_reason) == \
            (plen, max_new, "length")
        if streamed:
            assert [t for f in gf for t in f.tokens] == list(g.tokens)
            assert [f.step for f in gf] == list(range(1, max_new + 1))
            assert [f.done for f in gf] == [False] * (max_new - 1) + [True]
        else:
            assert gf == []


def test_native_method_stats_and_status_page(native_llm):
    lane, server, _ = native_llm
    server.register_native_echo("EchoService", "Echo")
    ch = port_rpc.Channel(port_rpc.ChannelOptions(
        timeout_ms=10000, native_transport=True))
    ch.init(str(server.listen_endpoint()))
    stub = port_rpc.Stub(ch, echo_pb2.DESCRIPTOR.services_by_name[
        "EchoService"])
    for i in range(3):
        assert stub.Echo(echo_pb2.EchoRequest(message=str(i))).message \
            == str(i)
    stats = dict(((s, m), st) for s, m, st in server.native_method_stats())
    assert stats[("EchoService", "Echo")]["requests"] >= 3
    ep = server.listen_endpoint()
    page = http_fetch(f"{ep.host}:{ep.port}", "GET", "/status", timeout=30)
    assert page.status == 200
    assert b"[EchoService] (native)" in bytes(page.body)
    conns = http_fetch(f"{ep.host}:{ep.port}", "GET", "/connections",
                       timeout=30)
    assert b"-- native engine conns --" in bytes(conns.body)


def test_json_generate_on_the_native_port_detaches_to_http(native_llm,
                                                           jax_tokens):
    lane, server, _ = native_llm
    ep = server.listen_endpoint()
    out = [None] * len(recorder.SCHEDULE)

    def run(i, plen, max_new):
        resp = http_fetch(f"{ep.host}:{ep.port}", "POST",
                          "/LlmService/Generate",
                          body=json.dumps({"prompt_len": plen,
                                           "max_new_tokens": max_new})
                          .encode(), content_type=CONTENT_JSON, timeout=120)
        out[i] = resp

    threads = [threading.Thread(target=run, args=(i, p, m))
               for i, (p, m) in enumerate(recorder.SCHEDULE)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
        assert not t.is_alive()
    for resp, want in zip(out, jax_tokens):
        assert resp.status == 200, resp.body
        assert resp.content_type == CONTENT_JSON
        assert json.loads(resp.body)["tokens"] == want


# ---------------------------------------------------------------------------
#  DeviceDataService over the native tunnel (tests/test_device_lane.py)
# ---------------------------------------------------------------------------
PUMP_ROWS = 600   # crosses the JAX copy's 512-row blocks
TAIL_CALL = 8
DSIDES = {"jax": (jax_rpc, jax_dpb, jax_dl), "port": (port_rpc, port_dpb,
                                                      port_dl)}


@pytest.fixture()
def cpu_ordinals():
    mesh.use_cpu(8)
    yield
    jax_dl.global_store().fence()
    port_dl.global_store("cpu").fence()
    mesh.use_cpu(0)


def _payload(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _rpc_script(dpb):
    H = dpb.DeviceHandle
    return [
        ("Put", H(), _payload(3 * 8192 + 11, seed=8)),        # handle 1
        ("Put", H(), bytes(range(256)) * 512),                # handle 2
        ("Put", H(), _payload(PUMP_ROWS * 8192, seed=12)),    # handle 3
        ("Copy", H(handle=1, nbytes=0), b""),                 # handle 4
        ("Copy", H(handle=1, nbytes=-1), b""),
        ("Copy", H(handle=2, nbytes=-40), b""),               # 32 + 8
        ("Copy", H(handle=77, nbytes=0), b""),                # ENOMETHOD
        ("Pump", dpb.PumpRequest(handle=2, rounds=3), b""),
        ("Pump", dpb.PumpRequest(handle=3, rounds=1), b""),   # the tail
        ("Get", H(handle=4), b""),
        ("Get", H(handle=77), b""),                           # ENOMETHOD
        ("Stats", dpb.DeviceStatsRequest(fence=False), b""),
        ("Free", H(handle=4), b""),
        ("Free", H(handle=4), b""),                           # handle 0
        ("Stats", dpb.DeviceStatsRequest(fence=True), b""),
    ]


def _run_script(side, target):
    rpc, dpb, _ = DSIDES[side]
    ch = rpc.Channel(rpc.ChannelOptions(protocol="trpc_std",
                                        timeout_ms=60000,
                                        native_transport=True)).init(target)
    stub = rpc.Stub(ch, dpb.DESCRIPTOR.services_by_name["DeviceDataService"])
    results = []
    for method, req, att in _rpc_script(dpb):
        cntl = rpc.Controller()
        cntl.request_attachment = att
        try:
            resp = getattr(stub, method)(req, controller=cntl)
        except rpc.RpcError as e:
            results.append((e.error_code, b"", b""))
            continue
        results.append((0, resp.SerializeToString(),
                        bytes(cntl.response_attachment)))
    return results


def _tail_checksum():
    words = np.frombuffer(_payload(PUMP_ROWS * 8192, seed=12), np.int32)
    return int(np.array([words[0], words[-1]], np.int32).sum(
        dtype=np.int32))


def test_device_data_service_over_the_native_tunnel_equals_jax(
        cpu_ordinals):
    out = {}
    for side in ("jax", "port"):
        rpc, _, dl = DSIDES[side]
        store = dl.DeviceStore() if side == "jax" else dl.DeviceStore("cpu")
        srv = rpc.Server(rpc.ServerOptions(native_dataplane=True))
        srv.add_service(dl.DeviceDataService(store))
        srv.start(LANES["tunnel"])
        try:
            assert srv._native_lid is not None
            out[side] = _run_script(side, str(srv.listen_endpoint()))
        finally:
            srv.stop()
            srv.join()
            store.fence()
    jres, pres = out["jax"], out["port"]
    assert [r[0] for r in pres].count(errors.ENOMETHOD) == 2
    jtail, ptail = (port_dpb.PumpResult.FromString(r[TAIL_CALL][1])
                    for r in (jres, pres))
    # the port copies every row; the JAX loop leaves rows 512..599 unwritten
    assert ptail.checksum == _tail_checksum()
    assert jtail.checksum != _tail_checksum()
    assert ptail.moved_bytes == jtail.moved_bytes == 4 * PUMP_ROWS * 8192
    keep = [i for i in range(len(pres)) if i != TAIL_CALL]
    assert [pres[i] for i in keep] == [jres[i] for i in keep]
    assert pres[9][2] == _rpc_script(port_dpb)[0][2]  # Get == the Put


def test_device_service_over_the_native_tcp_lane(cpu_ordinals):
    """tests/test_device_lane.py's RPC cases on the port: copies stay
    device-side, Pump's checksum is the same at any round count, an
    unknown handle is ENOMETHOD; on the CPU no copy launch is counted."""
    srv = port_rpc.Server(port_rpc.ServerOptions(native_dataplane=True))
    srv.add_service(port_dl.DeviceDataService(port_dl.DeviceStore("cpu")))
    srv.start(LANES["tcp"])
    before = pallas_ops.launches.snapshot()
    try:
        ch = port_rpc.Channel(port_rpc.ChannelOptions(
            protocol="trpc_std", timeout_ms=30000, native_transport=True))
        ch.init(str(srv.listen_endpoint()))
        stub = port_rpc.Stub(ch, port_dpb.DESCRIPTOR.services_by_name[
            "DeviceDataService"])
        blob = bytes(range(256)) * 1024
        cntl = port_rpc.Controller()
        cntl.request_attachment = blob
        put = stub.Put(port_dpb.DeviceHandle(), controller=cntl)
        h = put.handle
        for _ in range(4):
            h = stub.Copy(port_dpb.DeviceHandle(handle=h)).handle
        st = stub.Stats(port_dpb.DeviceStatsRequest(fence=True))
        assert st.moved_bytes >= 2 * 4 * len(blob)
        cg = port_rpc.Controller()
        got = stub.Get(port_dpb.DeviceHandle(handle=h), controller=cg)
        assert got.nbytes == len(blob) and cg.response_attachment == blob
        r1 = stub.Pump(port_dpb.PumpRequest(handle=put.handle, rounds=1))
        r3 = stub.Pump(port_dpb.PumpRequest(handle=put.handle, rounds=3))
        assert r1.checksum == r3.checksum
        assert r3.moved_bytes == 3 * r1.moved_bytes > 0
        with pytest.raises(port_rpc.RpcError) as ei:
            stub.Copy(port_dpb.DeviceHandle(handle=999999))
        assert ei.value.error_code == errors.ENOMETHOD
    finally:
        srv.stop()
        srv.join()
    assert pallas_ops.launches.snapshot() == before


# ---------------------------------------------------------------------------
#  Stream echo over each native lane (tests/test_stream.py)
# ---------------------------------------------------------------------------
class _StreamingEcho(port_rpc.Service):
    DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]

    def Echo(self, cntl, request, done):
        def on_received(sid, msgs):
            for m in msgs:
                port_stream.stream_write(sid, m)

        port_stream.stream_accept(cntl, port_stream.StreamOptions(
            on_received=on_received))
        return echo_pb2.EchoResponse(message="stream-accepted")


@pytest.mark.parametrize("listen,native_client", [
    ("127.0.0.1:0", True),            # native TCP lane
    ("tpu://127.0.0.1:0/0", True),    # native shm tunnel lane
    ("tpu://127.0.0.1:0/0", False),   # python client, native server
], ids=["tcp-native", "tunnel-native", "tunnel-python_client"])
def test_stream_echo_on_native_lane(listen, native_client):
    server = port_rpc.Server(port_rpc.ServerOptions(native_dataplane=True))
    server.add_service(_StreamingEcho())
    server.start(listen)
    try:
        got = []
        done = threading.Event()

        def on_received(sid, msgs):
            got.extend(msgs)
            if len(got) >= 8:
                done.set()

        sid = port_stream.stream_create(port_stream.StreamOptions(
            on_received=on_received))
        cntl = port_rpc.Controller()
        cntl.stream_id = sid
        ch = port_rpc.Channel(port_rpc.ChannelOptions(
            timeout_ms=10000, native_transport=native_client)).init(
            str(server.listen_endpoint()))
        stub = port_rpc.Stub(ch, echo_pb2.DESCRIPTOR.services_by_name[
            "EchoService"])
        resp = stub.Echo(echo_pb2.EchoRequest(message="open"),
                         controller=cntl)
        assert resp.message == "stream-accepted"
        payloads = [bytes([i]) * (1000 * (i + 1)) for i in range(8)]
        for p in payloads:
            assert port_stream.stream_write(sid, p) == 0
        assert done.wait(10), f"echoed {len(got)}/8"
        assert sorted(got) == sorted(payloads)
        port_stream.stream_close(sid)
    finally:
        server.stop()
        server.join(timeout=2)


def test_the_engines_grpc_lane_waits_for_item_2b6():
    """The engine's gRPC client lane (dp_connect_grpc) now has its Python
    surface: a dial to a closed port raises ConnectionError from the
    engine, and a grpc Channel on the native transport inits and then
    fails its call there, with no fallback to the Python h2 lane."""
    with pytest.raises(ConnectionError, match="native grpc connect"):
        port_nt.get_dataplane().connect_grpc(
            EndPoint.from_ip_port("127.0.0.1", 1))
    ch = port_rpc.Channel(port_rpc.ChannelOptions(
        protocol="grpc", native_transport=True, max_retry=0,
        timeout_ms=2000)).init("127.0.0.1:1")
    stub = port_rpc.Stub(ch, echo_pb2.DESCRIPTOR.services_by_name[
        "EchoService"])
    with pytest.raises(port_rpc.RpcError) as ei:
        stub.Echo(echo_pb2.EchoRequest(message="x"))
    assert "native grpc connect" in str(ei.value)
