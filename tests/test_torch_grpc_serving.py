"""The serving main path over gRPC on the port, on the CPU: unary
``LlmService.Generate`` over h2 reaches ``LlmServingService`` on the
port's engine at the llm_server example's widths, weights from seed 0.

- On the Python h2 lane (a plain Server, ``Channel(protocol="grpc")``)
  and on the engine's h2 lane (a ``native_dataplane=True`` Server, a
  ``native_transport=True`` grpc Channel), called by the port's client
  and by the JAX package's: the recorder's schedule
  (tools/record_serving_corpus.SCHEDULE) as concurrent unary Generates,
  tokens equal the JAX engine's Generate over gRPC (its engine behind a
  JAX Server, its grpc Channel), list for list, no tolerance.
- Health ``Check`` answers SERVING over gRPC on both lanes.
- A Generate with no prompt is EREQUEST: the server's trailers carry
  grpc-status INVALID_ARGUMENT (raw h2 frames read back), and the
  client maps it back to EREQUEST.
- ``/status`` over plain h2 (no ``application/grpc``) counts every
  Generate, on both lanes: the engine detaches such a connection to the
  port's ``GrpcProtocol``.
"""

import socket
import threading
import time
import types

import pytest

import brpc_tpu.rpc as jax_rpc
from brpc_tpu.proto import serving_pb2 as jax_serving
from brpc_tpu.rpc import native_transport as jax_nt
from brpc_tpu.serving import EngineConfig as JaxEngineConfig
from brpc_tpu.serving import KVCacheConfig as JaxKVConfig
from brpc_tpu.serving import LlmServingService as JaxLlmService
from brpc_tpu.serving import ModelConfig as JaxModelConfig
from brpc_tpu.serving import PagedKVCache as JaxKV
from brpc_tpu.serving import ServingEngine as JaxEngine
from brpc_tpu.serving import TinyTransformer as JaxModel
import brpc_tpu_torch.rpc as port_rpc
from brpc_tpu_torch.policy import grpc_protocol
from brpc_tpu_torch.policy import h2 as _h2
from brpc_tpu_torch.policy.hpack import HpackDecoder, HpackEncoder
from brpc_tpu_torch.proto import health_pb2, serving_pb2
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc import native_transport as port_nt
from brpc_tpu_torch.serving import (EngineConfig, KVCacheConfig,
                                    ModelConfig, PagedKVCache,
                                    ServingEngine, TinyTransformer)
from brpc_tpu_torch.serving.service import LlmServingService
from tools import record_serving_corpus as recorder

LLM_SERVER = dict(vocab=512, d_model=64, n_heads=4, n_layers=2)
KV_BLOCKS, BLOCK = 256, 16
TOKEN_BUDGET = 1024

SIDES = {
    "jax": types.SimpleNamespace(rpc=jax_rpc, pb=jax_serving),
    "port": types.SimpleNamespace(rpc=port_rpc, pb=serving_pb2),
}


@pytest.fixture(scope="module", autouse=True)
def _close_clients_at_end():
    """Both engines' shared gRPC client conns go with the module."""
    yield
    for mod in (jax_nt, port_nt):
        dp = mod._dataplane
        if dp is None:
            continue
        with dp._conn_map_lock:
            socks = list(dp._conn_map.values())
            dp._conn_map.clear()
        for s in socks:
            if not s.failed:
                s.close()


def _stub(side, server, native, service="LlmService", pb=None,
          timeout_ms=60000):
    ch = side.rpc.Channel(side.rpc.ChannelOptions(
        protocol="grpc", timeout_ms=timeout_ms, max_retry=0,
        native_transport=native))
    ch.init(str(server.listen_endpoint()))
    return side.rpc.Stub(ch, (pb or side.pb).DESCRIPTOR.services_by_name[
        service])


def _serve_schedule(side, server, native):
    """The recorder's schedule as concurrent unary Generates at its gap."""
    stub = _stub(side, server, native)
    out = [None] * len(recorder.SCHEDULE)

    def run(i, plen, max_new):
        out[i] = stub.Generate(side.pb.GenerateRequest(
            prompt_len=plen, max_new_tokens=max_new))

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
    """The JAX engine's tokens for the schedule, Generate over gRPC: its
    engine behind a JAX Server, called by its grpc Channel."""
    jcfg = JaxModelConfig(attn="reference", **LLM_SERVER)
    jkv = JaxKV(JaxKVConfig(BLOCK, KV_BLOCKS), jcfg.n_layers, jcfg.kv_dim)
    jeng = JaxEngine(JaxModel(jcfg, jkv), jkv, JaxEngineConfig(
        max_batch=8, token_budget=TOKEN_BUDGET, idle_wait_s=0.005),
        prefix_cache=False).start()
    jserver = jax_rpc.Server()
    jserver.add_service(JaxLlmService(jeng)).start("127.0.0.1:0")
    try:
        out = _serve_schedule(SIDES["jax"], jserver, native=False)
    finally:
        jserver.stop()
        jserver.join(timeout=2)
        jeng.stop()
    return [list(r.tokens) for r in out]


@pytest.fixture(scope="module", params=["python_h2", "engine_h2"])
def grpc_llm(request):
    """The port's engine behind a plain Server (the Python h2 lane) or a
    native one (the engine's h2 lane)."""
    native = request.param == "engine_h2"
    mcfg = ModelConfig(attn="reference", seed=0, **LLM_SERVER)
    kv = PagedKVCache(KVCacheConfig(BLOCK, KV_BLOCKS), mcfg.n_layers,
                      mcfg.kv_dim, device="cpu")
    kv._check = True
    engine = ServingEngine(TinyTransformer(mcfg, kv), kv, EngineConfig(
        max_batch=8, token_budget=TOKEN_BUDGET, idle_wait_s=0.005)).start()
    server = port_rpc.Server(port_rpc.ServerOptions(native_dataplane=native))
    server.add_service(LlmServingService(engine)).start("127.0.0.1:0")
    yield native, server, engine
    server.stop()
    server.join(timeout=2)
    engine.stop()
    engine.kv.assert_idle("grpc serving teardown")


@pytest.mark.parametrize("client", ["port", "jax"])
def test_schedule_tokens_equal_the_jax_engine_over_grpc(grpc_llm, jax_tokens,
                                                        client):
    native, server, _ = grpc_llm
    side = SIDES[client]
    got = _serve_schedule(side, server, native)
    for (plen, max_new), want, g in zip(recorder.SCHEDULE, jax_tokens, got):
        assert isinstance(g, side.pb.GenerateResponse), g
        assert list(g.tokens) == want, (plen, max_new)
        assert (g.prompt_len, g.steps, g.finish_reason) == \
            (plen, max_new, "length")


def test_health_check_serving_over_grpc(grpc_llm):
    native, server, _ = grpc_llm
    stub = _stub(SIDES["port"], server, native, "Health", health_pb2)
    resp = stub.Check(health_pb2.HealthCheckRequest())
    assert resp.status == health_pb2.HealthCheckResponse.SERVING
    resp = stub.Check(health_pb2.HealthCheckRequest(service="LlmService"))
    assert resp.status == health_pb2.HealthCheckResponse.SERVING


def _raw_h2(ep, headers, body=None, timeout=30.0):
    """One h2 request on a fresh connection, HPACK by the port's codec:
    (response headers, DATA bytes, trailers)."""
    enc, dec = HpackEncoder(), HpackDecoder()
    block = enc.encode(headers)
    out = (_h2.PREFACE + _h2.pack_settings([])
           + _h2.pack_frame(_h2.HEADERS, _h2.FLAG_END_HEADERS
                            | (0 if body is not None else _h2.FLAG_END_STREAM),
                            1, block))
    if body is not None:
        out += _h2.pack_frame(_h2.DATA, _h2.FLAG_END_STREAM, 1, body)
    heads, data, trailers = None, b"", None
    buf = b""
    deadline = time.monotonic() + timeout
    with socket.create_connection((ep.host, ep.port), timeout=timeout) as s:
        s.sendall(out)
        while trailers is None and time.monotonic() < deadline:
            chunk = s.recv(1 << 16)
            if not chunk:
                break
            buf += chunk
            while len(buf) >= 9:
                n = int.from_bytes(buf[:3], "big")
                if len(buf) < 9 + n:
                    break
                ftype, flags = buf[3], buf[4]
                sid = int.from_bytes(buf[5:9], "big") & 0x7FFFFFFF
                payload, buf = buf[9:9 + n], buf[9 + n:]
                if ftype == _h2.SETTINGS and not flags & _h2.FLAG_ACK:
                    s.sendall(_h2.pack_settings([], ack=True))
                elif ftype == _h2.HEADERS and sid == 1:
                    got = dict(dec.decode(payload))
                    if heads is None:
                        heads = got
                    if flags & _h2.FLAG_END_STREAM:
                        trailers = got
                elif ftype == _h2.DATA and sid == 1:
                    data += payload
                    if flags & _h2.FLAG_END_STREAM:
                        trailers = {}
    assert heads is not None, "no response on stream 1"
    return heads, data, trailers


def test_missing_prompt_is_erequest_over_grpc(grpc_llm):
    native, server, _ = grpc_llm
    # the wire: grpc-status INVALID_ARGUMENT in the trailers
    req = serving_pb2.GenerateRequest(max_new_tokens=4).SerializeToString()
    heads, _, trailers = _raw_h2(server.listen_endpoint(), [
        (":method", "POST"), (":scheme", "http"),
        (":path", "/brpc_tpu.LlmService/Generate"), (":authority", "t"),
        ("content-type", "application/grpc"), ("te", "trailers")],
        b"\x00" + len(req).to_bytes(4, "big") + req)
    status = (trailers or {}).get("grpc-status", heads.get("grpc-status"))
    assert status == str(grpc_protocol.G_INVALID_ARGUMENT)
    assert grpc_protocol.BRPC_TO_GRPC[errors.EREQUEST] == \
        grpc_protocol.G_INVALID_ARGUMENT
    # and back: the client's error is EREQUEST
    stub = _stub(SIDES["port"], server, native)
    with pytest.raises(port_rpc.RpcError) as ei:
        stub.Generate(serving_pb2.GenerateRequest(max_new_tokens=4))
    assert ei.value.error_code == errors.EREQUEST
    assert "prompt" in str(ei.value)


def _settled_count(method, want=None, timeout=10.0):
    """The method's call count once it stops moving (or reaches
    ``want``): the server records a call after its response is out."""
    deadline = time.monotonic() + timeout
    last = method.latency.count()
    while time.monotonic() < deadline:
        time.sleep(0.05)
        now = method.latency.count()
        if (want is not None and now == want) or \
                (want is None and now == last):
            return now
        last = now
    return method.latency.count()


def test_status_over_plain_h2_counts_the_generates(grpc_llm):
    native, server, _ = grpc_llm
    method = server.find_service("LlmService").find_method("Generate")
    base = _settled_count(method)
    stub = _stub(SIDES["port"], server, native)
    for plen in (16, 32):
        stub.Generate(serving_pb2.GenerateRequest(prompt_len=plen,
                                                  max_new_tokens=2))
    count = _settled_count(method, want=base + 2)
    assert count == base + 2
    heads, body, _ = _raw_h2(server.listen_endpoint(), [
        (":method", "GET"), (":scheme", "http"), (":path", "/status"),
        (":authority", "t")])
    assert heads[":status"] == "200"
    line = next(l for l in body.decode().splitlines()
                if l.strip().startswith("Generate:"))
    assert f"count={count} " in line, line
