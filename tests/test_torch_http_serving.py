"""The serving main path over HTTP on the port, on the CPU: POST
``/LlmService/Generate`` with a JSON body reaches ``LlmServingService`` on
the port's engine through json2pb, and its tokens equal the JAX engine's
at the llm_server example's widths (the JAX model's weights carried
across by ``serving/weights.py:params_from_jax``; no tolerance, both run
float32 with plain attention). Beside it: a binary-pb Generate over
``Channel(protocol="http")`` equals its trpc_std call; the builtin Health
and view services answer over trpc_std (and Health over HTTP as JSON);
``/serving``, ``/vars``, ``/status`` and ``/rpcz`` report the engine and
the calls; the JAX package's ``/fault`` and ``/rpcz`` HTTP-surface cases
(``tests/test_fault.py``, ``tests/test_trace.py``) on the port's server;
each HTTP response of the port's server parsed by both packages'
parsers to the same message.
"""

import json
import threading
import time

import numpy as np
import pytest

from brpc_tpu.butil.iobuf import IOBuf as JaxIOBuf
from brpc_tpu.policy import http_protocol as jax_http
from brpc_tpu.serving import EngineConfig as JaxEngineConfig
from brpc_tpu.serving import KVCacheConfig as JaxKVConfig
from brpc_tpu.serving import ModelConfig as JaxModelConfig
from brpc_tpu.serving import PagedKVCache as JaxKV
from brpc_tpu.serving import ServingEngine as JaxEngine
from brpc_tpu.serving import TinyTransformer as JaxModel
from brpc_tpu_torch import fault
from brpc_tpu_torch import flags as _flags
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.policy.http_protocol import (CONTENT_JSON, http_fetch,
                                                 parse_http_message,
                                                 render_request)
from brpc_tpu_torch.proto import (builtin_view_pb2, echo_pb2, health_pb2,
                                  serving_pb2)
from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Controller,
                                RpcError, Server, Service, Stub, errors)
from brpc_tpu_torch.serving import (EngineConfig, KVCacheConfig,
                                    ModelConfig, PagedKVCache,
                                    ServingEngine, TinyTransformer)
from brpc_tpu_torch.serving.service import LlmServingService
from brpc_tpu_torch.serving.weights import params_from_jax
from brpc_tpu_torch.trace import span as _span
from tools import record_serving_corpus as recorder

# examples/llm_server/server.py's widths; token_budget as chip_smoke.py
LLM_SERVER = dict(vocab=512, d_model=64, n_heads=4, n_layers=2)
KV_BLOCKS, BLOCK = 256, 16
TOKEN_BUDGET = 1024
LLM_DESC = serving_pb2.DESCRIPTOR.services_by_name["LlmService"]
ECHO = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]


@pytest.fixture(scope="module")
def engines():
    """The JAX engine and the port's (the JAX weights carried across),
    each at the llm_server widths, the prefix cache off; the port's
    behind a Server."""
    jcfg = JaxModelConfig(attn="reference", **LLM_SERVER)
    jkv = JaxKV(JaxKVConfig(BLOCK, KV_BLOCKS), jcfg.n_layers, jcfg.kv_dim)
    jmodel = JaxModel(jcfg, jkv)
    jeng = JaxEngine(jmodel, jkv, JaxEngineConfig(
        max_batch=8, token_budget=TOKEN_BUDGET, idle_wait_s=0.005),
        prefix_cache=False).start()
    cfg = ModelConfig(attn="reference", **LLM_SERVER)
    kv = PagedKVCache(KVCacheConfig(BLOCK, KV_BLOCKS), cfg.n_layers,
                      cfg.kv_dim, device="cpu")
    kv._check = True
    model = TinyTransformer(cfg, kv)
    model.load_params(params_from_jax(
        {k: np.asarray(v) for k, v in jmodel._params.items()}, "cpu"))
    eng = ServingEngine(model, kv, EngineConfig(
        max_batch=8, token_budget=TOKEN_BUDGET, idle_wait_s=0.005),
        prefix_cache=False).start()
    server = Server().add_service(LlmServingService(eng)) \
        .start("127.0.0.1:0")
    yield jeng, eng, server
    server.stop()
    server.join(timeout=2)
    eng.stop()
    jeng.stop()
    kv.assert_idle("http serving teardown")
    model.close()
    jmodel.close()


def _jax_tokens(jeng, schedule):
    """Each (prompt_len, max_new) of ``schedule`` through the JAX engine,
    submitted together; token lists in order."""
    evs, boxes = [], []
    for plen, max_new in schedule:
        ev, box = threading.Event(), {}
        code, _ = jeng.submit(jeng.model.synth_prompt(plen), max_new,
                              done=lambda r, b=box, e=ev: (b.update(r=r),
                                                           e.set()))
        assert code == 0
        evs.append(ev)
        boxes.append(box)
    for ev in evs:
        assert ev.wait(300)
    return [list(b["r"].tokens) for b in boxes]


def _json_generate(ep, plen, max_new):
    resp = http_fetch(ep, "POST", "/LlmService/Generate",
                      body=json.dumps({"prompt_len": plen,
                                       "max_new_tokens": max_new}).encode(),
                      content_type=CONTENT_JSON, timeout=120)
    assert resp.status == 200, resp.body
    assert resp.content_type == CONTENT_JSON
    return json.loads(resp.body)


def _concurrently(fn, schedule):
    out = [None] * len(schedule)

    def run(i, plen, max_new):
        out[i] = fn(plen, max_new)

    threads = [threading.Thread(target=run, args=(i, p, m))
               for i, (p, m) in enumerate(schedule)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    return out


def test_json_generate_tokens_equal_the_jax_engine(engines):
    """The recorder's schedule as concurrent JSON Generates: each
    response is the GenerateResponse's JSON (int64 fields as strings, as
    json2pb writes them), its tokens the JAX engine's, list for list."""
    jeng, eng, server = engines
    ep = str(server.listen_endpoint())
    want = _jax_tokens(jeng, recorder.SCHEDULE)
    got = _concurrently(lambda p, m: _json_generate(ep, p, m),
                        recorder.SCHEDULE)
    for (plen, max_new), g, w in zip(recorder.SCHEDULE, got, want):
        assert g["tokens"] == w, (plen, max_new)
        assert (g["prompt_len"], g["steps"], g["finish_reason"]) == \
            (plen, max_new, "length")
        assert isinstance(g["seq_id"], str) and int(g["seq_id"]) > 0
        assert int(g["ttft_us"]) > 0


def test_binary_pb_over_http_equals_the_trpc_std_call(engines):
    """The same Generate as binary pb through ``protocol="http"`` and
    through trpc_std: the responses' tokens and fields agree, and the
    JSON form's."""
    _, _, server = engines
    ep = str(server.listen_endpoint())
    stubs = {proto: Stub(Channel(ChannelOptions(
        protocol=proto, timeout_ms=120000)).init(ep), LLM_DESC)
        for proto in ("http", "trpc_std")}
    for plen, max_new in [(5, 8), (17, 12), (100, 16)]:
        req = serving_pb2.GenerateRequest(prompt_len=plen,
                                          max_new_tokens=max_new)
        via_http = stubs["http"].Generate(req)
        via_trpc = stubs["trpc_std"].Generate(req)
        assert list(via_http.tokens) == list(via_trpc.tokens)
        assert (via_http.prompt_len, via_http.steps,
                via_http.finish_reason) == (via_trpc.prompt_len,
                                            via_trpc.steps,
                                            via_trpc.finish_reason)
        assert _json_generate(ep, plen, max_new)["tokens"] == \
            list(via_trpc.tokens)


def test_a_failed_generate_over_http_carries_the_rpc_error(engines):
    """An EREQUEST from the service reaches an HTTP client as HTTP 400
    with the error code in JSON, and a ``protocol="http"`` client as the
    RpcError trpc_std raises."""
    _, _, server = engines
    ep = str(server.listen_endpoint())
    resp = http_fetch(ep, "POST", "/LlmService/Generate",
                      body=b'{"max_new_tokens": 4}', timeout=30)
    assert resp.status == 400
    assert json.loads(resp.body)["error_code"] == errors.EREQUEST
    for proto in ("http", "trpc_std"):
        stub = Stub(Channel(ChannelOptions(protocol=proto,
                                           timeout_ms=30000)).init(ep),
                    LLM_DESC)
        with pytest.raises(RpcError) as ei:
            stub.Generate(serving_pb2.GenerateRequest(max_new_tokens=4))
        assert ei.value.error_code == errors.EREQUEST


def test_the_builtins_report_the_engine_and_the_calls(engines):
    """While a Generate is in flight ``/serving?format=json`` answers;
    after it the engine's step and token counts on the page equal
    ``engine.snapshot()``, ``/status`` counts the Generate calls,
    ``/vars`` lists the serving gauges and ``/rpcz`` the spans."""
    _, eng, server = engines
    ep = str(server.listen_endpoint())
    ratio = _flags.get("rpcz_sample_ratio")
    _flags.set_flag("rpcz_sample_ratio", "1.0")
    try:
        before = eng.snapshot()
        box = {}
        t = threading.Thread(target=lambda: box.update(
            r=_json_generate(ep, 300, 32)))
        t.start()
        page = http_fetch(ep, "GET", "/serving?format=json", timeout=30)
        assert page.status == 200
        assert len(json.loads(page.body)["engines"]) >= 1
        t.join(120)
        assert len(box["r"]["tokens"]) == 32
        deadline = time.monotonic() + 10
        while eng.running_count and time.monotonic() < deadline:
            time.sleep(0.01)
        snap = eng.snapshot()
        page = json.loads(http_fetch(ep, "GET", "/serving?format=json")
                          .body)["engines"]
        mine = [e for e in page if e["steps"] == snap["steps"]
                and e["tokens_generated"] == snap["tokens_generated"]]
        assert mine, (page, snap)
        assert snap["tokens_generated"] - before["tokens_generated"] == 32
        status = http_fetch(ep, "GET", "/status").body.decode()
        count = None
        for line in status.splitlines():
            if line.strip().startswith("Generate: count="):
                count = int(line.split("count=")[1].split()[0])
        entry = server.find_service("LlmService").find_method("Generate")
        eng_count = entry.latency.count()
        assert count == eng_count > 0
        assert "[Health]" in status and "[BuiltinViewService]" in status
        vars_body = http_fetch(ep, "GET", "/vars").body
        assert b"g_serving_running" in vars_body
        rpcz = http_fetch(ep, "GET", "/rpcz?method=LlmService").body
        assert b"LlmService.Generate" in rpcz
    finally:
        _flags.set_flag("rpcz_sample_ratio", str(ratio))


def test_health_and_view_services_answer_over_trpc_std(engines):
    """The builtin services every port Server adds at ``start``: Health
    says SERVING (and SERVICE_UNKNOWN for a service it lacks) over
    trpc_std and over HTTP as JSON; the view service renders the same
    pages the HTTP port does."""
    _, _, server = engines
    ep = str(server.listen_endpoint())
    ch = Channel(ChannelOptions(timeout_ms=30000)).init(ep)
    health = Stub(ch, health_pb2.DESCRIPTOR.services_by_name["Health"])
    assert health.Check(health_pb2.HealthCheckRequest()).status == \
        health_pb2.HealthCheckResponse.SERVING
    assert health.Check(health_pb2.HealthCheckRequest(
        service="brpc_tpu.serving.LlmService")).status == \
        health_pb2.HealthCheckResponse.SERVING
    assert health.Check(health_pb2.HealthCheckRequest(
        service="NoSuchService")).status == \
        health_pb2.HealthCheckResponse.SERVICE_UNKNOWN
    resp = http_fetch(ep, "POST", "/Health/Check", body=b"{}")
    assert json.loads(resp.body) == {"status": "SERVING"}
    view = Stub(ch, builtin_view_pb2.DESCRIPTOR.services_by_name[
        "BuiltinViewService"])
    got = view.Get(builtin_view_pb2.ViewRequest(path="/health"))
    assert (got.status, got.content_type, got.body) == \
        (200, "text/plain", b"OK\n")
    got = view.Get(builtin_view_pb2.ViewRequest(path="/protobufs"))
    assert b"LlmService.Generate(brpc_tpu.serving.GenerateRequest)" \
        in got.body
    assert view.Get(builtin_view_pb2.ViewRequest(
        path="/no_such_page")).status == 404


@pytest.mark.parametrize("page", ["/fleet", "/slo"])
def test_fleet_pages_name_their_roadmap_item(engines, page):
    # the fleet plane is ported: with no observer and no objective each
    # page answers 200 and says how to install one
    _, _, server = engines
    resp = http_fetch(str(server.listen_endpoint()), "GET", page)
    assert resp.status == 200
    assert (b"FleetObserver" if page == "/fleet" else b"slo_objectives") \
        in resp.body
    resp = http_fetch(str(server.listen_endpoint()), "GET",
                      page + "?format=json")
    assert resp.status == 200


@pytest.mark.parametrize("path", ["/health", "/version", "/status",
                                  "/serving?format=json", "/nope"])
def test_both_parsers_read_the_port_servers_responses_alike(engines, path):
    """The raw bytes of a port server's response, cut by the port's and
    the JAX package's parsers: the same status, headers and body."""
    import socket

    _, _, server = engines
    ep = server.listen_endpoint()
    with socket.create_connection((ep.host, ep.port), timeout=10) as s:
        s.sendall(render_request("GET", path, "t"))
        raw = b""
        while True:
            chunk = s.recv(65536)
            raw += chunk
            rc, msg = parse_http_message(IOBuf(raw))
            if rc == 0 or not chunk:
                break
    assert rc == 0
    jrc, jmsg = jax_http.parse_http_message(JaxIOBuf(raw))
    assert jrc == 0
    assert (msg.status, msg.reason, msg.headers, msg.body) == \
        (jmsg.status, jmsg.reason, jmsg.headers, jmsg.body)


# ------------------------------------------ the JAX package's HTTP surfaces
class EchoImpl(Service):
    DESCRIPTOR = ECHO

    def Echo(self, cntl, request, done):
        if request.message == "boom":
            cntl.set_failed(errors.EINTERNAL, "requested failure")
            return None
        cntl.response_attachment = cntl.request_attachment
        return echo_pb2.EchoResponse(message=request.message,
                                     payload=request.payload)


@pytest.fixture()
def echo_server():
    server = Server().add_service(EchoImpl()).start("127.0.0.1:0")
    yield server
    server.stop()
    server.join(timeout=2)
    fault.disarm_all()
    _flags.set_flag("fault_injection_enabled", False)


def test_fault_http_surface(echo_server):
    """``tests/test_fault.py``'s ``/fault`` case on the port's server."""
    addr = str(echo_server.listen_endpoint())
    resp = http_fetch(addr, "GET", "/fault")
    assert resp.status == 200
    state = json.loads(resp.body)
    assert state["enabled"] is False
    points = {r["point"] for r in state["points"]}
    assert "tpu.tunnel.kill" in points
    assert "rpc.handler.crash" in points

    resp = http_fetch(addr, "GET",
                      "/fault/arm?point=x.http&mode=always&delay_ms=5")
    assert resp.status == 200
    rows = {r["point"]: r for r in fault.snapshot()}
    assert rows["x.http"]["armed"]["params"] == {"delay_ms": 5}
    assert http_fetch(addr, "GET", "/fault/disarm?point=x.http").status \
        == 200
    assert http_fetch(addr, "GET", "/fault/disarm?point=x.http").status \
        == 404
    assert http_fetch(addr, "GET", "/fault/arm").status == 400
    assert http_fetch(addr, "GET", "/fault/nonsense").status == 404


@pytest.fixture()
def traced():
    """Sampling wide open, as ``tests/test_trace.py``'s fixture."""
    from brpc_tpu_torch.metrics.collector import global_collector

    _flags.set_flag("rpcz_sample_ratio", "1.0")
    _flags.set_flag("collector_max_samples_per_second", "0")
    global_collector()._deny_until = 0.0
    _span.reset_for_test()
    yield
    _flags.set_flag("collector_max_samples_per_second", "1000")


def _wait_spans(predicate, timeout=3.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        spans = _span.recent_spans(100)
        if predicate(spans):
            return spans
        time.sleep(0.01)
    return _span.recent_spans(100)


class TestRpczHttp:
    """``tests/test_trace.py``'s ``/rpcz`` HTTP-surface cases on the
    port's server."""

    def _traffic(self, server):
        stub = Stub(Channel().init(str(server.listen_endpoint())), ECHO)
        stub.Echo(echo_pb2.EchoRequest(message="ok"))
        with pytest.raises(RpcError):
            stub.Echo(echo_pb2.EchoRequest(message="boom"),
                      controller=Controller())
        _wait_spans(lambda ss: any(s.error_code for s in ss
                                   if s.kind == "server"))

    def test_filters(self, echo_server, traced):
        self._traffic(echo_server)
        a = str(echo_server.listen_endpoint())
        assert b"EchoService.Echo" in http_fetch(a, "GET", "/rpcz").body
        assert b"EchoService.Echo" in http_fetch(
            a, "GET", "/rpcz?method=EchoService").body
        body = http_fetch(a, "GET", "/rpcz?method=NoSuchService").body
        assert b"EchoService.Echo" not in body
        body = http_fetch(a, "GET", "/rpcz?min_latency_us=999999999").body
        assert b"EchoService.Echo" not in body
        doc = json.loads(http_fetch(
            a, "GET", "/rpcz?error_only=1&format=json").body)
        assert doc["spans"] and all(s["error_code"] for s in doc["spans"])
        resp = http_fetch(a, "GET", "/rpcz?count=notanumber")
        assert resp.status == 400

    def test_json_export_and_trace_fetch(self, echo_server, traced):
        self._traffic(echo_server)
        a = str(echo_server.listen_endpoint())
        doc = json.loads(http_fetch(a, "GET", "/rpcz?format=json").body)
        span = next(s for s in doc["spans"]
                    if s["method"] == "Echo" and not s["error_code"])
        assert "phases" in span and "events" in span
        trace = json.loads(http_fetch(
            a, "GET", f"/rpcz/{span['trace_id']}?format=json").body)
        assert trace["trace_id"] == span["trace_id"]
        assert any(s["span_id"] == span["span_id"]
                   for s in trace["spans"])
