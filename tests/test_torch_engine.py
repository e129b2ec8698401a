"""Port ServingEngine (brpc_tpu_torch.serving.engine) on the CPU: token
lists equal to the JAX package's engine on the same requests, the
per-step dispatch audit, continuous batching, admission refusals and
teardown.

Greedy tokens must be equal (no tolerance): both engines run the same
weights in float32 with plain attention, and the JAX engine runs with
``attn="reference"`` and no prefix cache, the port's main path on the
CPU.
"""

import threading
import time

import numpy as np
import pytest
import torch

from brpc_tpu.serving import EngineConfig as JaxEngineConfig
from brpc_tpu.serving import KVCacheConfig as JaxKVConfig
from brpc_tpu.serving import ModelConfig as JaxModelConfig
from brpc_tpu.serving import PagedKVCache as JaxKV
from brpc_tpu.serving import ServingEngine as JaxEngine
from brpc_tpu.serving import TinyTransformer as JaxModel
from brpc_tpu_torch import errors
from brpc_tpu_torch.serving import (EngineConfig, GenerateResult,
                                    KVCacheConfig, ModelConfig,
                                    PagedKVCache, ServingEngine,
                                    TinyTransformer)
from brpc_tpu_torch.tpu import device_lane

CORPUS = dict(vocab=256, d_model=32, n_heads=2, n_layers=2)
REQUESTS = [(4, 5), (9, 8), (16, 3), (12, 12), (30, 6), (27, 10)]


def _port_engine(start=True, num_blocks=64, **cfg):
    mcfg = ModelConfig(attn="reference", **CORPUS)
    kv = PagedKVCache(KVCacheConfig(16, num_blocks), mcfg.n_layers,
                      mcfg.kv_dim, device="cpu")
    kv._check = True
    cfg.setdefault("idle_wait_s", 0.005)
    eng = ServingEngine(TinyTransformer(mcfg, kv), kv, EngineConfig(**cfg))
    return eng.start() if start else eng


def _run_all(engine, requests, timeout=120.0):
    """Submit every (prompt_len, max_new) request; wait for all dones."""
    results = {}
    ev = threading.Event()
    lock = threading.Lock()

    def done_for(i):
        def done(resp):
            with lock:
                results[i] = resp
                if len(results) == len(requests):
                    ev.set()
        return done

    for i, (plen, max_new) in enumerate(requests):
        code, _ = engine.submit(engine.model.synth_prompt(plen), max_new,
                                done=done_for(i))
        assert code == 0, code
    assert ev.wait(timeout), "generation never completed"
    return [results[i] for i in range(len(requests))]


def test_token_lists_equal_the_jax_engine():
    jcfg = JaxModelConfig(attn="reference", **CORPUS)
    jkv = JaxKV(JaxKVConfig(16, 64), jcfg.n_layers, jcfg.kv_dim)
    jeng = JaxEngine(JaxModel(jcfg, jkv), jkv,
                     JaxEngineConfig(idle_wait_s=0.005),
                     prefix_cache=False).start()
    try:
        want = _run_all(jeng, REQUESTS)
    finally:
        jeng.stop()
    eng = _port_engine()
    try:
        got = _run_all(eng, REQUESTS)
    finally:
        eng.stop()
    for (plen, max_new), w, g in zip(REQUESTS, want, got):
        assert isinstance(g, GenerateResult) and g.error_code == 0
        assert g.tokens == list(w.tokens), (plen, max_new)
        assert (g.prompt_len, g.steps, g.finish_reason) == \
            (w.prompt_len, w.steps, w.finish_reason) == \
            (plen, max_new, "length")
    eng.kv.assert_idle()


def test_dispatch_audit_holds_under_an_armed_ledger():
    eng = _port_engine()
    assert eng.kv._check
    before = device_lane.step_dispatch.snapshot()
    try:
        results = _run_all(eng, REQUESTS[:3])
    finally:
        eng.stop()
    # a violated (1, 1) contract fails the step's sequences (EINTERNAL)
    assert all(r.error_code == 0 for r in results)
    launches, _, syncs = device_lane.step_dispatch.delta(
        before, device_lane.step_dispatch.snapshot())
    # one launch + one sync per prefill and per decode step
    assert launches == syncs >= 3 + max(n for _, n in REQUESTS[:3]) - 1
    eng.kv.assert_idle()


def test_short_request_overtakes_long():
    """A 2-token request submitted AFTER a 40-token one completes first:
    admission happens between decode steps, not behind the running gang."""
    eng = _port_engine()
    order = []
    evs = [threading.Event(), threading.Event()]

    def done_for(tag, ev):
        def done(resp):
            order.append(tag)
            ev.set()
        return done

    try:
        assert eng.submit(eng.model.synth_prompt(16), 40,
                          done=done_for("long", evs[0]))[0] == 0
        assert eng.submit(eng.model.synth_prompt(16), 2,
                          done=done_for("short", evs[1]))[0] == 0
        for ev in evs:
            assert ev.wait(60.0)
    finally:
        eng.stop()
    assert order[0] == "short"


def test_static_scheduling_gives_the_same_tokens():
    eng = _port_engine(scheduling="static", max_batch=2)
    try:
        static = _run_all(eng, REQUESTS[:4])
    finally:
        eng.stop()
    eng = _port_engine()
    try:
        continuous = _run_all(eng, REQUESTS[:4])
    finally:
        eng.stop()
    assert [r.tokens for r in static] == [r.tokens for r in continuous]


def test_stop_fails_in_flight_requests_and_returns_every_block():
    eng = _port_engine()
    box = []
    ev = threading.Event()

    def done(resp):
        box.append(resp)
        ev.set()

    assert eng.submit(eng.model.synth_prompt(8), 400, done=done)[0] == 0
    deadline = time.monotonic() + 30.0
    while not eng.kv.used_blocks and time.monotonic() < deadline:
        time.sleep(0.001)  # wait until admitted: its blocks are allocated
    assert eng.kv.used_blocks
    eng.stop()
    assert ev.wait(10.0)
    assert box[0].error_code == errors.ELOGOFF
    assert box[0].finish_reason == "error"
    eng.kv.assert_idle("after stop")
    assert eng.submit(eng.model.synth_prompt(4), 2)[0] == errors.ELOGOFF


@pytest.mark.parametrize("plen,max_new", [(0, 4), (4, 0), (1020, 8)])
def test_bad_requests_are_refused(plen, max_new):
    eng = _port_engine(start=False)
    eng.running = True  # accept submits without a step loop
    code, seq = eng.submit(np.ones(plen, np.int32), max_new)
    assert code == errors.EREQUEST and seq is None


def test_queue_cap_and_watermark_refuse_overcrowded():
    eng = _port_engine(start=False, max_queue=2, num_blocks=8)
    eng.running = True  # no step loop: submits stay queued
    assert eng.submit(eng.model.synth_prompt(4), 2)[0] == 0
    # 8 blocks at watermark 0.9 admit 7; queued 4 + 120 tokens need 8
    assert eng.submit(eng.model.synth_prompt(120), 2)[0] == \
        errors.EOVERCROWDED
    assert eng.submit(eng.model.synth_prompt(4), 2)[0] == 0
    assert eng.submit(eng.model.synth_prompt(4), 2)[0] == \
        errors.EOVERCROWDED
    snap = eng.snapshot()
    assert snap["queue_depth"] == 2 and snap["rejected"] == 2
    assert snap["kv"]["admission_rejects"] == 1


def test_default_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_lane.global_store()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache(KVCacheConfig(16, 8), 2, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_lane.DeviceStore()
    assert device_lane.resolve_device("cpu").type == "cpu"
