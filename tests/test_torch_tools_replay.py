"""The port's ``tools/rpc_replay`` against the JAX package's: the loader
record by record on the three committed corpora; each corpus replayed by
each package's tool into its own package's server (the recorders'
engines, the JAX one on its reference attention) with the same sent, ok,
failed and shed counts, overall and per tenant; the recorded trace ids
on the replayed server spans; and a dump written by either package
replayed through the other's tool."""

import io
import json
import os
import time
from contextlib import redirect_stdout

import pytest

import brpc_tpu.rpc as jax_rpc
import brpc_tpu_torch.rpc as port_rpc
from brpc_tpu import flags as jax_flags
from brpc_tpu.proto import echo_pb2 as jax_echo
from brpc_tpu.serving import EngineConfig as JaxEngineConfig
from brpc_tpu.serving import KVCacheConfig as JaxKVConfig
from brpc_tpu.serving import LlmServingService as JaxLlmService
from brpc_tpu.serving import ModelConfig as JaxModelConfig
from brpc_tpu.serving import PagedKVCache as JaxKV
from brpc_tpu.serving import ServingEngine as JaxEngine
from brpc_tpu.serving import TinyTransformer as JaxModel
from brpc_tpu_torch import flags as port_flags
from brpc_tpu_torch.bench import qos_replay
from brpc_tpu_torch.metrics import collector as port_collector
from brpc_tpu_torch.proto import echo_pb2 as port_echo
from brpc_tpu_torch.serving import (EngineConfig, KVCacheConfig, ModelConfig,
                                    PagedKVCache, ServingEngine,
                                    TinyTransformer)
from brpc_tpu_torch.serving.service import LlmServingService
from brpc_tpu_torch.tools import rpc_replay as port_replay
from brpc_tpu_torch.trace import span as port_span
from tests.test_torch_tracemalloc_guard import (  # noqa: F401
    no_leaked_tracemalloc, no_leaked_tracemalloc_in_module)
from tools import rpc_replay as jax_replay

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
# corpus -> the recorder's spec_k (tools/record_serving_corpus*.py)
CORPORA = {"serving_corpus": 0, "serving_corpus_overload": 0,
           "serving_corpus_spec": 4}
WIDTHS = dict(vocab=256, d_model=32, n_heads=2, n_layers=2)


@pytest.fixture(autouse=True)
def _cold_run_to_completion():
    """Run-to-completion classifies handlers by (service, method) name
    across the process (ROADMAP Queue 3): these tests' fast
    EchoService.Echo traffic would leave the name classified cheap for
    the next test on this worker, whose slow EchoService.Echo then runs
    inline. Each test here leaves both packages' classification cold."""
    from brpc_tpu.rpc import run_to_completion as jax_rtc
    from brpc_tpu_torch.rpc import run_to_completion as port_rtc

    yield
    jax_rtc._reset_for_test()
    port_rtc._reset_for_test()


def _fields(item):
    return (item.md.service_name, item.md.method_name, item.payload,
            item.attachment, item.trace_id, item.parent_span_id,
            item.offset_s, item.tenant, item.priority)


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_load_items_equals_the_jax_loader(corpus):
    path = os.path.join(DATA, corpus)
    ours, skipped = port_replay.load_items(path)
    theirs, jskipped = jax_replay.load_items(path)
    assert skipped == jskipped == 0
    assert [_fields(i) for i in ours] == [_fields(i) for i in theirs]
    assert len(ours) in (12, 40, 8)


def test_qos_replay_reads_the_corpus_through_load_items():
    path = os.path.join(DATA, "serving_corpus_overload")
    recs = qos_replay.load_corpus(path)
    items, _ = jax_replay.load_items(path)
    assert [(r.request.SerializeToString(), r.offset_s, r.tenant,
             r.priority) for r in recs] == [
        (i.payload, i.offset_s, i.tenant, i.priority) for i in items]


def _engine(side, spec_k):
    if side == "jax":
        cfg = JaxModelConfig(attn="reference", **WIDTHS)
        kv = JaxKV(JaxKVConfig(16, 256), cfg.n_layers, cfg.kv_dim)
        eng = JaxEngine(JaxModel(cfg, kv), kv, JaxEngineConfig(
            max_batch=8, token_budget=512, spec_k=spec_k,
            idle_wait_s=0.005)).start()
        return jax_rpc.Server().add_service(JaxLlmService(eng)) \
            .start("127.0.0.1:0"), eng
    cfg = ModelConfig(attn="reference", seed=0, **WIDTHS)
    kv = PagedKVCache(KVCacheConfig(16, 256), cfg.n_layers, cfg.kv_dim,
                      device="cpu")
    eng = ServingEngine(TinyTransformer(cfg, kv), kv, EngineConfig(
        max_batch=8, token_budget=512, spec_k=spec_k,
        idle_wait_s=0.005)).start()
    return port_rpc.Server().add_service(LlmServingService(eng)) \
        .start("127.0.0.1:0"), eng


def _replay(tool, args):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = tool.main(args)
    return rc, buf.getvalue()


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_each_corpus_replays_alike_through_both_tools(corpus, tmp_path):
    counts = {}
    for side, tool in (("jax", jax_replay), ("port", port_replay)):
        server, engine = _engine(side, CORPORA[corpus])
        out = tmp_path / f"{side}.json"
        try:
            rc, text = _replay(tool, [
                "--dump", os.path.join(DATA, corpus),
                "--server", str(server.listen_endpoint()),
                "--timeout-ms", "60000", "--report-interval", "0",
                "--json-out", str(out)])
        finally:
            server.stop()
            server.join(timeout=2)
            engine.stop()
        assert rc == 0, text
        res = json.loads(out.read_text())
        counts[side] = (
            {k: res[k] for k in ("sent", "ok", "fail", "shed", "skipped",
                                 "passes")},
            {t: {k: v[k] for k in ("sent", "ok", "fail", "shed")}
             for t, v in res["tenants"].items()})
        assert f"replayed ok {res['ok']} failed 0 shed 0 skipped 0" in text
    assert counts["port"] == counts["jax"]


def test_replayed_spans_carry_the_recorded_trace_ids():
    """Trace tagging: each replayed call reuses its record's trace id, the
    recorded client span as its parent; --no-trace-tag drops both."""
    corpus = os.path.join(DATA, "serving_corpus")
    items, _ = port_replay.load_items(corpus)
    saved = {k: port_flags.get(k) for k in
             ("rpcz_sample_ratio", "collector_max_samples_per_second")}
    port_flags.set_flag("rpcz_sample_ratio", "1.0")
    port_flags.set_flag("collector_max_samples_per_second", "0")
    port_collector.global_collector()._deny_until = 0.0
    server, engine = _engine("port", 0)
    try:
        for tag in (True, False):
            port_span.reset_for_test()
            rc, _ = _replay(port_replay, [
                "--dump", corpus, "--server",
                str(server.listen_endpoint()), "--timeout-ms", "60000",
                "--report-interval", "0"] + ([] if tag
                                             else ["--no-trace-tag"]))
            assert rc == 0
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                client = [s for s in port_span.recent_spans(200)
                          if s.kind == port_span.KIND_CLIENT]
                if len(client) >= len(items):
                    break
                time.sleep(0.01)
            got = {(s.trace_id, s.parent_span_id) for s in client}
            want = {(i.trace_id, i.parent_span_id) for i in items}
            if tag:
                assert got == want
            else:
                assert not got & want
    finally:
        server.stop()
        server.join(timeout=2)
        engine.stop()
        for k, v in saved.items():
            port_flags.set_flag(k, str(v))


def _echo_server(side, dump_dir=None):
    rpc, pb = (jax_rpc, jax_echo) if side == "jax" else (port_rpc,
                                                         port_echo)

    class Echo(rpc.Service):
        DESCRIPTOR = pb.DESCRIPTOR.services_by_name["EchoService"]

        def __init__(self):
            super().__init__()
            self.seen = []

        def Echo(self, cntl, request, done):
            self.seen.append((request.message, cntl.request_attachment))
            return pb.EchoResponse(message=request.message)

    impl = Echo()
    opts = rpc.ServerOptions(rpc_dump_dir=dump_dir) if dump_dir \
        else rpc.ServerOptions()
    return rpc.Server(opts).add_service(impl).start("127.0.0.1:0"), impl


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_dump_of_either_package_replays_through_the_other(writer,
                                                            tmp_path):
    reader = "port" if writer == "jax" else "jax"
    flags = jax_flags if writer == "jax" else port_flags
    rpc, pb = (jax_rpc, jax_echo) if writer == "jax" else (port_rpc,
                                                           port_echo)
    flags.set_flag("rpc_dump_ratio", "1.0")
    try:
        server, _ = _echo_server(writer, str(tmp_path))
        try:
            stub = rpc.Stub(rpc.Channel().init(str(server.listen_endpoint())),
                            pb.DESCRIPTOR.services_by_name["EchoService"])
            for i in range(3):
                cntl = rpc.Controller()
                cntl.request_attachment = b"att%d" % i
                stub.Echo(pb.EchoRequest(message=f"r{i}"), controller=cntl)
            deadline = time.monotonic() + 3
            while (server.rpc_dumper.sampled_count < 3
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            server.rpc_dumper.close()
        finally:
            server.stop()
            server.join(timeout=2)
    finally:
        flags.set_flag("rpc_dump_ratio", "0.0")
    target, impl = _echo_server(reader)
    try:
        rc, text = _replay(port_replay if reader == "port" else jax_replay,
                           ["--dump", str(tmp_path), "--server",
                            str(target.listen_endpoint()),
                            "--report-interval", "0"])
    finally:
        target.stop()
        target.join(timeout=2)
    assert rc == 0 and "replayed ok 3 failed 0" in text, text
    assert sorted(impl.seen) == [(f"r{i}", b"att%d" % i) for i in range(3)]
