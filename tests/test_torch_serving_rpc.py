"""The serving main path through the port's RPC front on the CPU: the
port's Server with LlmServingService over the port's engine
(``device="cpu"``) at the llm_server example's widths, weights from seed
0, against the JAX server at the same widths. The recorder's schedule
(tools/record_serving_corpus.SCHEDULE) goes through streamed Generates
on each; the token lists must be equal (no tolerance: both run float32
with plain attention) and each request's TokenDelta frames must join to
its response. Also: Stats against the engine's snapshot, the committed
corpus replayed by tools/rpc_replay against the port's server (rc 0,
server spans with prefill_us and decode_us), the deadline rejections, the
EREQUEST refusals, and the over-budget prompt the reference accepts and
never serves.
"""

import threading
import time
import types

import pytest

import brpc_tpu.rpc as jax_rpc
import brpc_tpu.rpc.stream as jax_stream
import brpc_tpu_torch.rpc as port_rpc
import brpc_tpu_torch.rpc.stream as port_stream
from brpc_tpu.proto import serving_pb2 as jax_serving
from brpc_tpu.serving import EngineConfig as JaxEngineConfig
from brpc_tpu.serving import KVCacheConfig as JaxKVConfig
from brpc_tpu.serving import LlmServingService as JaxLlmService
from brpc_tpu.serving import ModelConfig as JaxModelConfig
from brpc_tpu.serving import PagedKVCache as JaxKV
from brpc_tpu.serving import ServingEngine as JaxEngine
from brpc_tpu.serving import TinyTransformer as JaxModel
from brpc_tpu_torch import fault as port_fault
from brpc_tpu_torch import flags as port_flags
from brpc_tpu_torch.metrics import collector as port_collector
from brpc_tpu_torch.proto import serving_pb2
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.serving import (EngineConfig, KVCacheConfig,
                                    ModelConfig, PagedKVCache,
                                    ServingEngine, TinyTransformer)
from brpc_tpu_torch.serving import engine as port_engine_mod
from brpc_tpu_torch.serving.service import LlmServingService
from brpc_tpu_torch.trace import span as port_span
from tools import record_serving_corpus as recorder

# examples/llm_server/server.py's defaults; token_budget as chip_smoke.py
LLM_SERVER = dict(vocab=512, d_model=64, n_heads=4, n_layers=2)
KV_BLOCKS, BLOCK = 256, 16
TOKEN_BUDGET = 1024

SIDES = {
    "jax": types.SimpleNamespace(rpc=jax_rpc, stream=jax_stream,
                                 pb=jax_serving),
    "port": types.SimpleNamespace(rpc=port_rpc, stream=port_stream,
                                  pb=serving_pb2),
}


def _port_engine(widths=LLM_SERVER, token_budget=TOKEN_BUDGET, start=True,
                 **cfg):
    mcfg = ModelConfig(attn="reference", seed=0, **widths)
    kv = PagedKVCache(KVCacheConfig(BLOCK, KV_BLOCKS), mcfg.n_layers,
                      mcfg.kv_dim, device="cpu")
    kv._check = True
    cfg.setdefault("idle_wait_s", 0.005)
    eng = ServingEngine(TinyTransformer(mcfg, kv), kv, EngineConfig(
        max_batch=8, token_budget=token_budget, **cfg))
    return eng.start() if start else eng


def _jax_engine(token_budget=TOKEN_BUDGET):
    jcfg = JaxModelConfig(attn="reference", **LLM_SERVER)
    jkv = JaxKV(JaxKVConfig(BLOCK, KV_BLOCKS), jcfg.n_layers, jcfg.kv_dim)
    return JaxEngine(JaxModel(jcfg, jkv), jkv, JaxEngineConfig(
        max_batch=8, token_budget=token_budget, idle_wait_s=0.005),
        prefix_cache=False).start()


def _stub(side, server, timeout_ms=60000):
    ch = side.rpc.Channel(side.rpc.ChannelOptions(timeout_ms=timeout_ms))
    ch.init(str(server.listen_endpoint()))
    return side.rpc.Stub(ch, side.pb.DESCRIPTOR.services_by_name[
        "LlmService"])


def _generate(side, stub, request):
    """One streamed Generate: (response or RpcError, [TokenDelta])."""
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


def _serve_schedule(side, server):
    """The recorder's schedule as concurrent streamed Generates, at its
    inter-arrival gap."""
    stub = _stub(side, server)
    out = [None] * len(recorder.SCHEDULE)

    def run(i, plen, max_new):
        out[i] = _generate(side, stub, side.pb.GenerateRequest(
            prompt_len=plen, max_new_tokens=max_new))

    threads = []
    for i, (plen, max_new) in enumerate(recorder.SCHEDULE):
        t = threading.Thread(target=run, args=(i, plen, max_new))
        t.start()
        threads.append(t)
        time.sleep(recorder.GAP_S)
    for t in threads:
        t.join(120)
    return out


@pytest.fixture(scope="module")
def port_server():
    engine = _port_engine()
    server = port_rpc.Server().add_service(LlmServingService(engine)) \
        .start("127.0.0.1:0")
    yield server, engine
    server.stop()
    server.join(timeout=2)
    engine.stop()
    engine.kv.assert_idle("port server teardown")


def test_schedule_tokens_equal_the_jax_server(port_server):
    server, _ = port_server
    jeng = _jax_engine()
    jserver = jax_rpc.Server().add_service(JaxLlmService(jeng)) \
        .start("127.0.0.1:0")
    try:
        want = _serve_schedule(SIDES["jax"], jserver)
    finally:
        jserver.stop()
        jserver.join(timeout=2)
        jeng.stop()
    got = _serve_schedule(SIDES["port"], server)
    for (plen, max_new), (w, wf), (g, gf) in zip(recorder.SCHEDULE, want,
                                                 got):
        assert isinstance(g, serving_pb2.GenerateResponse), g
        assert list(g.tokens) == list(w.tokens), (plen, max_new)
        assert (g.prompt_len, g.steps, g.finish_reason) == \
            (w.prompt_len, w.steps, w.finish_reason) == \
            (plen, max_new, "length")
        # frames join to the response, one token each, the last one done
        assert [t for f in gf for t in f.tokens] == list(g.tokens)
        assert [f.step for f in gf] == list(range(1, max_new + 1))
        assert [f.done for f in gf] == [False] * (max_new - 1) + [True]
        assert {f.seq_id for f in gf} == {g.seq_id}
        assert 0 < g.ttft_us
        # the JAX frames join the same way, to the same tokens
        assert [t for f in wf for t in f.tokens] == list(w.tokens)


def test_stats_match_the_engine_snapshot(port_server):
    server, engine = port_server
    stub = _stub(SIDES["port"], server)
    resp, _ = _generate(SIDES["port"], stub, serving_pb2.GenerateRequest(
        prompt_tokens=[5, 6, 7], max_new_tokens=3))
    assert len(resp.tokens) == 3 and resp.prompt_len == 3
    deadline = time.monotonic() + 5
    while engine.running_count and time.monotonic() < deadline:
        time.sleep(0.01)
    stats = stub.Stats(serving_pb2.ServingStatsRequest())
    snap = engine.snapshot()
    assert (stats.seqs_running, stats.seqs_waiting, stats.kv_blocks_total,
            stats.kv_blocks_used, stats.steps, stats.tokens_generated) == \
        (snap["running"], snap["queue_depth"], snap["kv"]["blocks_total"],
         snap["kv"]["blocks_used"], snap["steps"], snap["tokens_generated"])
    assert stats.kv_blocks_total == KV_BLOCKS and stats.kv_blocks_used == 0


def test_neither_prompt_field_is_erequest(port_server):
    server, _ = port_server
    stub = _stub(SIDES["port"], server)
    for req in (serving_pb2.GenerateRequest(max_new_tokens=4),
                serving_pb2.GenerateRequest(prompt_len=0, max_new_tokens=4)):
        err, frames = _generate(SIDES["port"], stub, req)
        assert isinstance(err, port_rpc.RpcError)
        assert err.error_code == errors.EREQUEST and not frames
        assert "prompt_tokens or prompt_len" in err.controller.error_text()


def test_migration_and_resume_fail_until_ported(port_server):
    server, _ = port_server
    stub = _stub(SIDES["port"], server)
    for call, req, code in (
            (stub.MigrateOpen, serving_pb2.MigrateRequest(seq_id=1),
             errors.ENOMETHOD),
            (stub.MigrateCommit, serving_pb2.MigrateCommitRequest(seq_id=1),
             errors.ENOMETHOD),
            (stub.Generate, serving_pb2.GenerateRequest(
                resume_seq_id=3, max_new_tokens=2), errors.EREQUEST)):
        with pytest.raises(port_rpc.RpcError) as ei:
            call(req)
        assert ei.value.error_code == code


def test_qos_identity_is_accepted(port_server):
    server, _ = port_server
    stub = _stub(SIDES["port"], server)
    cntl = port_rpc.Controller()
    cntl.tenant_id, cntl.priority = "tenant-a", 7
    resp = stub.Generate(serving_pb2.GenerateRequest(
        prompt_len=8, max_new_tokens=2), controller=cntl)
    assert len(resp.tokens) == 2


def test_spent_deadline_is_rejected_at_admission(port_server):
    server, _ = port_server
    stub = _stub(SIDES["port"], server)
    before = port_engine_mod.g_serving_deadline_rejects.get_value()
    # the handler starts 300 ms after arrival, past the 200 ms budget the
    # server stamped as cntl.deadline_mono: the engine refuses the request
    port_flags.set_flag("fault_injection_enabled", "true")
    port_fault.arm("rpc.handler.delay", delay_ms=300)
    try:
        cntl = port_rpc.Controller()
        cntl.timeout_ms = 200
        with pytest.raises(port_rpc.RpcError) as ei:
            stub.Generate(serving_pb2.GenerateRequest(
                prompt_len=8, max_new_tokens=2), controller=cntl)
        assert ei.value.error_code == errors.ERPCTIMEDOUT
        deadline = time.monotonic() + 2
        while (port_engine_mod.g_serving_deadline_rejects.get_value()
               == before and time.monotonic() < deadline):
            time.sleep(0.01)
    finally:
        port_fault.disarm("rpc.handler.delay")
        port_flags.set_flag("fault_injection_enabled", "false")
    assert port_engine_mod.g_serving_deadline_rejects.get_value() == \
        before + 1


def test_deadline_expired_in_the_queue_fails_the_rpc():
    eng = _port_engine(start=False)
    eng.running = True  # accept submits without a step loop
    cntl = port_rpc.Controller()
    cntl.deadline_mono = time.monotonic() + 0.02
    box = []
    code, seq = eng.submit(eng.model.synth_prompt(8), 2, cntl=cntl,
                           done=box.append)
    assert code == 0 and seq is not None
    time.sleep(0.05)
    with eng._cv:
        assert eng._admit_locked() == []
    assert box == [None]
    assert cntl.error_code == errors.ERPCTIMEDOUT
    assert "deadline expired in serving queue" in cntl.error_text()
    eng.kv.assert_idle("deadline in the queue")
    past = port_rpc.Controller()
    past.deadline_mono = time.monotonic() - 1
    assert eng.submit(eng.model.synth_prompt(8), 2, cntl=past)[0] == \
        errors.ERPCTIMEDOUT


def test_over_budget_prompt_is_refused_by_the_port(port_server):
    server, engine = port_server
    assert engine.submit(engine.model.synth_prompt(TOKEN_BUDGET + 1), 2)[0] \
        == errors.EREQUEST
    small = _port_engine(token_budget=64, start=False)
    small.running = True
    assert small.submit(small.model.synth_prompt(65), 2)[0] == \
        errors.EREQUEST
    assert small.submit(small.model.synth_prompt(64), 2)[0] == 0
    # through the RPC front: a failed RPC with that code
    srv = port_rpc.Server().add_service(LlmServingService(
        _port_engine(token_budget=64))).start("127.0.0.1:0")
    try:
        err, frames = _generate(SIDES["port"], _stub(SIDES["port"], srv),
                                serving_pb2.GenerateRequest(
                                    prompt_len=100, max_new_tokens=2))
        assert isinstance(err, port_rpc.RpcError) and not frames
        assert err.error_code == errors.EREQUEST
    finally:
        srv.stop()
        srv.join(timeout=2)
        next(iter(srv.services.values())).engine.stop()


def test_over_budget_prompt_is_never_served_by_the_reference():
    """The reference's behaviour the port refuses: a prompt longer than
    token_budget is admitted and never pulled from the FIFO queue."""
    jeng = _jax_engine(token_budget=64)
    try:
        ev = threading.Event()
        code, _ = jeng.submit(jeng.model.synth_prompt(100), 2,
                              done=lambda _r: ev.set())
        assert code == 0
        assert not ev.wait(2.0)
        assert jeng.queue_depth == 1
    finally:
        jeng.stop()


def test_corpus_replays_against_the_port_server():
    """The committed corpus (recorded at the recorder's own widths)
    replays through tools/rpc_replay against the port's server with rc 0,
    and the replayed server spans carry the engine's phases."""
    from tools import rpc_replay

    import os
    corpus = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "data", "serving_corpus")
    saved = {k: port_flags.get(k) for k in
             ("rpcz_sample_ratio", "collector_max_samples_per_second")}
    port_flags.set_flag("rpcz_sample_ratio", "1.0")
    port_flags.set_flag("collector_max_samples_per_second", "0")
    port_collector.global_collector()._deny_until = 0.0
    engine = _port_engine(widths=dict(vocab=256, d_model=32, n_heads=2,
                                      n_layers=2), token_budget=512)
    try:
        port_span.reset_for_test()
        server = port_rpc.Server().add_service(LlmServingService(engine)) \
            .start("127.0.0.1:0")
        try:
            rc = rpc_replay.main([
                "--dump", corpus,
                "--server", str(server.listen_endpoint()),
                "--rate-mult", "2", "--timeout-ms", "30000",
                "--report-interval", "0"])
            assert rc == 0
            deadline = time.monotonic() + 5.0
            while (len([s for s in port_span.recent_spans(200)
                        if s.kind == port_span.KIND_SERVER])
                   < len(recorder.SCHEDULE)
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        finally:
            server.stop()
            server.join(timeout=2)
        spans = [s for s in port_span.recent_spans(200)
                 if s.kind == port_span.KIND_SERVER]
        assert len(spans) >= len(recorder.SCHEDULE)
        with_phases = [s for s in spans if "prefill_us" in s.phases
                       and "decode_us" in s.phases]
        assert len(with_phases) >= len(recorder.SCHEDULE)
        assert engine.tokens_generated == sum(
            n for _, n in recorder.SCHEDULE)
    finally:
        engine.stop()
        engine.kv.assert_idle("corpus replay teardown")
        for k, v in saved.items():
            port_flags.set_flag(k, str(v))


def test_example_server_and_client(monkeypatch):
    """brpc_tpu_torch.examples.llm_server: build_engine places the engine
    on the CPU only when asked (with no card the default raises), and the
    client's streamed generate reads the frames of a real server."""
    import torch

    from brpc_tpu_torch.examples.llm_server import client, server

    args = server.parse_args(["--vocab", "64", "--d_model", "16",
                              "--n_heads", "2", "--n_layers", "1",
                              "--num_blocks", "32"])
    assert (args.token_budget, args.max_batch, args.port) == (512, 8, 8011)
    engine = server.build_engine(args, device="cpu")
    srv = port_rpc.Server().add_service(LlmServingService(engine)) \
        .start("127.0.0.1:0")
    try:
        stub = port_rpc.Stub(port_rpc.Channel().init(
            str(srv.listen_endpoint())), client.DESC)
        g = client.generate(stub, serving_pb2.GenerateRequest(
            prompt_len=12, max_new_tokens=5))
        assert g.response is not None and g.frames == 5
        assert g.frame_tokens == list(g.response.tokens)
        assert g.t_call < g.t_first and g.t_call < g.t_done
        bad = client.generate(stub, serving_pb2.GenerateRequest(
            max_new_tokens=5))
        assert bad.response is None and bad.error_code == errors.EREQUEST
    finally:
        srv.stop()
        srv.join(timeout=2)
        engine.stop()
    assert engine.kv.store.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.build_engine(args)


def test_rpc_front_bench_runs_its_windows_on_the_cpu():
    """``bench/rpc_front.py --cpu`` (the card script's logic, at a small
    window): every run kind serves its requests through the closed loop,
    the summary has one line per kind, and the tokens agree."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "brpc_tpu_torch/bench/rpc_front.py", "--cpu",
         "--rounds", "1", "--requests", "8"], cwd=repo, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    lines = [json.loads(x) for x in res.stdout.splitlines()
             if x.startswith("{")]
    runs = [x for x in lines if "run" in x]
    assert sorted(x["run"] for x in runs) == sorted(
        ["direct", "rpc", "rpc_no_stream", "rpc_switch_0.5ms",
         "rpc_no_profiler", "rpc_client_process"])
    for x in runs:
        assert x["requests"] == 8 and x["tokens"] == 172, x
        assert x["steps"] > 0 and x["tokens_per_s"] > 0, x
        streamed = x["run"] not in ("direct", "rpc_no_stream")
        assert (x["frame_write_us_per_step"] > 0) == streamed, x
    assert [x["summary"] for x in lines if "summary" in x] == [
        "direct", "rpc", "rpc_no_stream", "rpc_switch_0.5ms",
        "rpc_no_profiler", "rpc_client_process"]
    assert lines[-1] == {"token_mismatches": 0}
