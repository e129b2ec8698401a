"""The port's ``tools/rpc_press`` against the JAX package's, both ways
across packages (the port's tool pressing a JAX ``Server``, the JAX tool
pressing the port's): echo, a method read from the vendored descriptor
set, a ``.proto`` compiled by ``protoc`` at run time, JSON ``--input`` /
``--output`` over ``list://`` naming with a load balancer, pooled
connections and an attachment; Generate through a descriptor set gives
the JAX tool's tokens on the same requests."""

import io
import json
import os
import shutil
import time
from collections import Counter
from contextlib import redirect_stdout

import pytest

import brpc_tpu.rpc as jax_rpc
import brpc_tpu_torch.rpc as port_rpc
from brpc_tpu.json2pb import json_to_pb as jax_json_to_pb
from brpc_tpu.proto import echo_pb2 as jax_echo
from brpc_tpu.proto import serving_pb2 as jax_serving
from brpc_tpu.serving import EngineConfig as JaxEngineConfig
from brpc_tpu.serving import KVCacheConfig as JaxKVConfig
from brpc_tpu.serving import LlmServingService as JaxLlmService
from brpc_tpu.serving import ModelConfig as JaxModelConfig
from brpc_tpu.serving import PagedKVCache as JaxKV
from brpc_tpu.serving import ServingEngine as JaxEngine
from brpc_tpu.serving import TinyTransformer as JaxModel
from brpc_tpu_torch.json2pb import json_to_pb as port_json_to_pb
from brpc_tpu_torch.proto import _message
from brpc_tpu_torch.proto import echo_pb2 as port_echo
from brpc_tpu_torch.proto import serving_pb2 as port_serving
from brpc_tpu_torch.serving import (EngineConfig, KVCacheConfig, ModelConfig,
                                    PagedKVCache, ServingEngine,
                                    TinyTransformer)
from brpc_tpu_torch.serving.service import LlmServingService
from brpc_tpu_torch.tools import rpc_press as port_press
from tests.test_torch_tracemalloc_guard import (  # noqa: F401
    no_leaked_tracemalloc, no_leaked_tracemalloc_in_module)
from tools import rpc_press as jax_press

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
TOOLS = {"jax": jax_press, "port": port_press}
PAIRS = [("port", "jax"), ("jax", "port")]  # (the tool, the server)
# the corpus recorders' widths (tools/record_serving_corpus.py)
WIDTHS = dict(vocab=256, d_model=32, n_heads=2, n_layers=2)


@pytest.fixture(autouse=True)
def _cold_run_to_completion():
    """Run-to-completion classifies handlers by (service, method) name
    across the process (ROADMAP Queue 3): these tests' fast
    EchoService.Echo traffic would leave the name classified cheap for
    the next test on this worker, whose slow EchoService.Echo then runs
    inline. Each test here starts and leaves both packages'
    classification cold, whatever ran before it on this worker."""
    from brpc_tpu.rpc import run_to_completion as jax_rtc
    from brpc_tpu_torch.rpc import run_to_completion as port_rtc

    jax_rtc._reset_for_test()
    port_rtc._reset_for_test()
    yield
    jax_rtc._reset_for_test()
    port_rtc._reset_for_test()


def _echo_server(side):
    rpc, pb = (jax_rpc, jax_echo) if side == "jax" else (port_rpc,
                                                         port_echo)

    class Echo(rpc.Service):
        DESCRIPTOR = pb.DESCRIPTOR.services_by_name["EchoService"]

        def __init__(self):
            super().__init__()
            self.calls = 0

        def Echo(self, cntl, request, done):
            self.calls += 1
            return pb.EchoResponse(message=request.message)

    impl = Echo()
    server = rpc.Server().add_service(impl).start("127.0.0.1:0")
    return server, impl


@pytest.fixture(params=PAIRS, ids=lambda p: f"{p[0]}-tool-{p[1]}-server")
def pair(request):
    tool, side = request.param
    server, impl = _echo_server(side)
    yield TOOLS[tool], server, impl
    server.stop()
    server.join(timeout=2)


def _main(tool, args):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = tool.main(args)
    return rc, buf.getvalue()


class _ToolClock:
    """The press loop's clock: time passes only in the tool's own sleeps
    (which still sleep as long on the real clock), so a press of ``qps``
    for ``duration`` fires exactly its ``qps x duration`` calls at no
    more than that pace however slowly the worker runs (a worker whose
    threads fought for the GIL once sent 9 of 100 real-time calls). The
    calls themselves, their deadlines and latencies keep the real
    clock."""

    def __init__(self):
        self.now = 0.0

    def monotonic(self):
        return self.now

    def sleep(self, seconds):
        self.now += seconds
        time.sleep(seconds)

    def __getattr__(self, name):
        return getattr(time, name)


def test_echo_press(pair, monkeypatch):
    tool, server, impl = pair
    # 1/256 s and 0.5 s are exact in binary: calls at k/256 s, k < 128
    monkeypatch.setattr(tool, "time", _ToolClock())
    rc, out = _main(tool, ["--server", str(server.listen_endpoint()),
                           "--qps", "256", "--duration", "0.5", "--quiet"])
    assert rc == 0, out
    assert "latency_p99_us" in out
    assert out.startswith("sent 128 ok 128 errors 0\n"), out
    assert impl.calls == 128


def _json_io(tool, server, impl, method_args, tmp_path, monkeypatch):
    monkeypatch.setattr(tool, "time", _ToolClock())  # 128 calls
    inp = tmp_path / "reqs.json"
    inp.write_text('{"message": "a"}\n{"message": "b"}\n')
    outp = tmp_path / "resps.json"
    rc, out = _main(tool, [
        "--server", f"list://{server.listen_endpoint()}",
        "--lb-policy", "rr", *method_args,
        "--full-method", "press.test.EchoService.Echo",
        "--input", str(inp), "--output", str(outp),
        "--connection-type", "pooled", "--attachment-size", "64",
        "--qps", "256", "--duration", "0.5", "--quiet"])
    assert rc == 0, out
    assert "latency_p99_us" in out
    assert out.startswith("sent 128 ok 128 errors 0\n"), out
    lines = [l for l in outp.read_text().splitlines() if l.strip()]
    assert len(lines) == impl.calls == 128
    # the two inputs in turn
    assert Counter(json.loads(l)["message"] for l in lines) == \
        {"a": 64, "b": 64}


def test_descriptor_set_json_io(pair, tmp_path, monkeypatch):
    tool, server, impl = pair
    _json_io(tool, server, impl, ["--descriptor-set",
                                  os.path.join(DATA, "press_echo.desc")],
             tmp_path, monkeypatch)


PRESS_PROTO = ('syntax = "proto3";\n'
               "package press.test;\n"
               "message Req { string message = 1; bytes payload = 2;\n"
               "  int32 sleep_us = 3; }\n"
               "message Resp { string message = 1; bytes payload = 2; }\n"
               "service EchoService { rpc Echo(Req) returns (Resp); }\n")


def test_proto_through_protoc(pair, tmp_path, monkeypatch):
    if shutil.which("protoc") is None:
        pytest.skip("needs protoc")
    tool, server, impl = pair
    proto = tmp_path / "press_echo.proto"
    proto.write_text(PRESS_PROTO)
    _json_io(tool, server, impl, ["--proto", str(proto)], tmp_path,
             monkeypatch)


def test_proto_without_protoc_exits_with_a_message(tmp_path, monkeypatch):
    """No other route: without protoc on PATH, --proto exits non-zero
    naming what is missing, before any call."""
    proto = tmp_path / "press_echo.proto"
    proto.write_text(PRESS_PROTO)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(SystemExit) as e:
        port_press.main(["--server", "127.0.0.1:1", "--proto", str(proto),
                         "--full-method", "press.test.EchoService.Echo",
                         "--duration", "0.1", "--quiet"])
    assert "needs protoc" in str(e.value.code)


def test_an_unknown_method_in_a_descriptor_set_exits():
    with pytest.raises(SystemExit) as e:
        port_press.main(["--server", "127.0.0.1:1", "--descriptor-set",
                         os.path.join(DATA, "press_echo.desc"),
                         "--full-method", "press.test.EchoService.Nope",
                         "--duration", "0.1", "--quiet"])
    assert "press.test.EchoService.Nope" in str(e.value.code)


def _generate_server(side):
    if side == "jax":
        cfg = JaxModelConfig(attn="reference", **WIDTHS)
        kv = JaxKV(JaxKVConfig(16, 256), cfg.n_layers, cfg.kv_dim)
        eng = JaxEngine(JaxModel(cfg, kv), kv, JaxEngineConfig(
            max_batch=8, token_budget=512, idle_wait_s=0.005)).start()
        srv = jax_rpc.Server().add_service(JaxLlmService(eng))
    else:
        cfg = ModelConfig(attn="reference", seed=0, **WIDTHS)
        kv = PagedKVCache(KVCacheConfig(16, 256), cfg.n_layers, cfg.kv_dim,
                          device="cpu")
        eng = ServingEngine(TinyTransformer(cfg, kv), kv, EngineConfig(
            max_batch=8, token_budget=512, idle_wait_s=0.005)).start()
        srv = port_rpc.Server().add_service(LlmServingService(eng))
    return srv.start("127.0.0.1:0"), eng


def test_generate_tokens_equal_the_jax_tools(tmp_path):
    """Each tool presses its own package's server with the same JSON
    Generates through the same descriptor set (serving.proto as the port's
    runtime writes it); every output's tokens equal, prompt by prompt."""
    desc = tmp_path / "serving.desc"
    out = bytearray()
    _message._put_bytes(out, 1, port_serving.DESCRIPTOR.serialized_pb)
    desc.write_bytes(bytes(out))
    inp = tmp_path / "gen.json"
    inp.write_text('{"prompt_len": 16, "max_new_tokens": 4}\n'
                   '{"prompt_len": 32, "max_new_tokens": 8}\n'
                   '{"prompt_tokens": [5, 9, 5, 9, 5], '
                   '"max_new_tokens": 6}\n')
    got = {}
    for side in ("jax", "port"):
        srv, eng = _generate_server(side)
        outp = tmp_path / f"{side}.json"
        try:
            rc, text = _main(TOOLS[side], [
                "--server", str(srv.listen_endpoint()),
                "--descriptor-set", str(desc),
                "--full-method", "brpc_tpu.serving.LlmService.Generate",
                "--input", str(inp), "--output", str(outp),
                "--qps", "30", "--duration", "0.4", "--concurrency", "4",
                "--timeout-ms", "30000", "--quiet"])
        finally:
            srv.stop()
            srv.join(timeout=2)
            eng.stop()
        assert rc == 0, text
        parse, cls = ((jax_json_to_pb, jax_serving.GenerateResponse)
                      if side == "jax" else
                      (port_json_to_pb, port_serving.GenerateResponse))
        resps = [parse(l, cls) for l in outp.read_text().splitlines()
                 if l.strip()]
        assert len(resps) >= 3
        got[side] = {(r.prompt_len, tuple(r.tokens)) for r in resps}
    assert got["port"] == got["jax"] and len(got["port"]) == 3
