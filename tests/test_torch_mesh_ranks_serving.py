"""Mesh serving with a rank per position (brpc_tpu_torch.serving's
MeshTransformer and ShardedKVCache over a launched rank mesh) against
the JAX package on the CPU.

The JAX side is the reference's mesh stack on the conftest's 8 virtual
CPU devices (``serving_mesh()``: dp 2, sp 2, tp 2), as in
``tests/test_torch_mesh_serving.py``. The port side runs as 8 gloo
ranks on the CPU, launched ONCE for the module (the ``served`` fixture,
120 s timeout): the engine, the ledgers and the model object on rank 0,
each dp shard's pools on its own rank, every prefill and decode step a
program over the ranks. The fixture drives every case's port side and
keeps its results; each test compares its own case.

What is held: the corpus schedule (``tools/record_serving_corpus``) at
the reference test's widths gives the JAX mesh engine's greedy tokens
and the port's single-device engine's, list for list, with the ledger
armed and idle after and every decode step (1 launch, 1 host sync) on
rank 0's engine thread; both shards serve; each shard's pools live on
the shard's first rank and no other; the engine at the reference's
defaults (prefix cache on, ``spec_k=4``) equals the JAX mesh engine; a
long prompt through the ring over the sp ranks equals the JAX mesh
ring's first token and decode, with the owner's pools within 1e-5 of
JAX's and the other shard's untouched.

Tolerance: tokens and ledger records exact; pools atol 1e-5 (float32
on both sides, the same products summed in another order by XLA and
torch; block 0, the pad scatter target, left out).
"""

import threading

import numpy as np
import pytest

from brpc_tpu.serving import EngineConfig as JaxEngineConfig
from brpc_tpu.serving import KVCacheConfig as JaxKVConfig
from brpc_tpu.serving import MeshTransformer as JaxMeshModel
from brpc_tpu.serving import ModelConfig as JaxModelConfig
from brpc_tpu.serving import ServingEngine as JaxEngine
from brpc_tpu.serving import ShardedKVCache as JaxShardedKV
from brpc_tpu_torch.serving import (EngineConfig, KVCacheConfig,
                                    MeshTransformer, ModelConfig,
                                    PagedKVCache, ServingEngine,
                                    ShardedKVCache, TinyTransformer)
from brpc_tpu_torch.serving.weights import params_from_jax
from brpc_tpu_torch.tpu import launch
from brpc_tpu_torch.tpu.device_lane import step_dispatch
from tests.test_torch_tracemalloc_guard import (  # noqa: F401
    no_leaked_tracemalloc, no_leaked_tracemalloc_in_module)
from tools.record_serving_corpus import SCHEDULE

CFG = dict(vocab=256, d_model=32, n_heads=2, n_layers=2)
AXES = {"dp": 2, "sp": 2, "tp": 2}
BLOCK = 16
ATOL = 1e-5
RING_LEN = 77   # past ring_threshold 64, odd: padded to the sp ranks


def _jax_params(jm):
    return {name: np.asarray(a) for name, a in jm._params.items()}


def _run(model, schedule, engine_cls, config_cls, passes=1,
         prefix_cache=False, spec_k=0, audit=None):
    """Drive one engine through ``schedule``: each sequence's greedy
    tokens in submit order, and the engine's last snapshot. With
    ``audit`` (a list) each decode step's (launches, host syncs) on the
    engine thread is appended to it."""
    kw = {} if prefix_cache else {"prefix_cache": False}
    engine = engine_cls(model, model.kv, config_cls(
        max_batch=8, token_budget=512, idle_wait_s=0.002, spec_k=spec_k),
        **kw)
    if audit is not None:
        orig = model.decode_step

        def audited(tokens, positions, tables):
            before = step_dispatch.thread_snapshot()
            out = orig(tokens, positions, tables)
            launches, _, syncs = step_dispatch.delta(
                before, step_dispatch.thread_snapshot())
            audit.append((launches, syncs))
            return out

        model.decode_step = audited
    engine.start()
    out = []
    try:
        for _ in range(passes):
            evs, seqs = [], []
            for plen, max_new in schedule:
                ev = threading.Event()
                code, seq = engine.submit(model.synth_prompt(plen), max_new,
                                          done=lambda _r, ev=ev: ev.set())
                assert code == 0, f"submit rejected: {code}"
                evs.append(ev)
                seqs.append(seq)
            for ev in evs:
                assert ev.wait(300), "schedule run stalled"
            out += [[int(t) for t in s.out_tokens] for s in seqs]
        snap = engine.snapshot()
    finally:
        engine.stop()
        if audit is not None:
            del model.decode_step
    model.kv.assert_idle()
    return out, snap


@pytest.fixture(scope="module")
def jax_stack():
    jcfg = JaxModelConfig(**CFG)
    jkv = JaxShardedKV(JaxKVConfig(BLOCK, 256), jcfg.n_layers, jcfg.kv_dim)
    jkv._check = True
    jm = JaxMeshModel(jcfg, jkv)
    yield jm
    jm.close()
    jkv.close()


def _ring_case(jm_params, mesh):
    """The ring lane's prompt on a fresh rank-mesh model and on the JAX
    mesh model: (port first token and 3 decode tokens, JAX's, the port's
    pools of both shards, JAX's, the owner shard)."""
    jcfg = JaxModelConfig(ring_threshold=64, **CFG)
    jkv = JaxShardedKV(JaxKVConfig(BLOCK, 32), jcfg.n_layers, jcfg.kv_dim)
    jm = JaxMeshModel(jcfg, jkv)
    c = ModelConfig(ring_threshold=64, **CFG)
    kv = ShardedKVCache(KVCacheConfig(BLOCK, 32), c.n_layers, c.kv_dim,
                        mesh=mesh)
    tm = MeshTransformer(c, kv)
    tm.load_params(params_from_jax(jm_params, "cpu"))
    try:
        sid = next(s for s in range(1, 100) if kv.shard_of(s) == 1)
        prompt = tm.synth_prompt(RING_LEN)
        jt = jkv.alloc_sequence(sid, RING_LEN)
        tt = kv.alloc_sequence(sid, RING_LEN)
        before = step_dispatch.snapshot()
        got = [tm.prefill(prompt, tt)]
        launches, _, syncs = step_dispatch.delta(before,
                                                 step_dispatch.snapshot())
        want = [jm.prefill(prompt, jt)]
        pos = RING_LEN
        for _ in range(3):
            jt = jkv.extend_sequence(sid, pos + 1)
            tt = kv.extend_sequence(sid, pos + 1)
            want.append(int(np.asarray(jm.decode_step(
                np.array([want[-1]], np.int32), np.array([pos], np.int32),
                [jt]))[0]))
            got.append(int(tm.decode_step(
                np.array([got[-1]], np.int32), np.array([pos], np.int32),
                [tt])[0]))
            pos += 1
        pools = [[t.numpy() for t in kv.shard_pools(i)] for i in range(2)]
        jpools = [np.asarray(jkv.k_pools), np.asarray(jkv.v_pools)]
        kv.free_sequence(sid)
        jkv.free_sequence(sid)
        kv.assert_idle()
        return {"tokens": got, "jax_tokens": want, "pools": pools,
                "jax_pools": jpools, "dispatch": (launches, syncs)}
    finally:
        tm.close()
        kv.close()
        jm.close()
        jkv.close()


@pytest.fixture(scope="module")
def served(jax_stack):
    """Every case's port side over one launch of 8 CPU ranks."""
    params = _jax_params(jax_stack)
    out = {}
    group = launch.launch(AXES, device="cpu")
    try:
        c = ModelConfig(**CFG)
        kv = ShardedKVCache(KVCacheConfig(BLOCK, 256), c.n_layers, c.kv_dim,
                            mesh=group.mesh)
        kv._check = True
        model = MeshTransformer(c, kv)
        model.load_params(params_from_jax(params, "cpu"))
        out["describe"] = group.describe()
        out["pool_ranks"] = kv.pool_ranks()
        audit = []
        out["corpus"] = _run(model, SCHEDULE, ServingEngine, EngineConfig,
                             audit=audit)
        out["audit"] = audit
        out["defaults"] = _run(model, SCHEDULE, ServingEngine, EngineConfig,
                               passes=2, prefix_cache=True, spec_k=4)
        try:
            kv.pool_views(None)
        except RuntimeError as e:
            out["pool_views"] = str(e)
        model.close()
        kv.close()
        out["ring"] = _ring_case(params, group.mesh)
    finally:
        group.close()
    return out


@pytest.fixture(scope="module")
def jax_corpus(jax_stack):
    return _run(jax_stack, SCHEDULE, JaxEngine, JaxEngineConfig)


def _single_device(params):
    kv = PagedKVCache(KVCacheConfig(BLOCK, 256), CFG["n_layers"],
                      CFG["d_model"], device="cpu")
    kv._check = True
    model = TinyTransformer(ModelConfig(**CFG), kv)
    model.load_params(params_from_jax(params, "cpu"))
    try:
        return _run(model, SCHEDULE, ServingEngine, EngineConfig)[0]
    finally:
        model.close()


def test_corpus_tokens_equal_jax_mesh_and_single_device(served, jax_corpus,
                                                        jax_stack):
    got, _ = served["corpus"]
    assert got == jax_corpus[0]
    assert got == _single_device(_jax_params(jax_stack))


def test_every_decode_step_is_one_launch_one_sync_on_rank_0(served):
    audit = served["audit"]
    assert audit and all(d == (1, 1) for d in audit)


def test_both_shards_serve(served, jax_corpus):
    steps = served["corpus"][1]["shard_steps"]
    assert sorted(steps) == [0, 1]
    assert all(s["seq_steps"] for s in steps.values())
    assert sorted(jax_corpus[1]["shard_steps"]) == [0, 1]


def test_each_shard_pools_live_on_its_own_rank(served):
    # the shard's first rank (dp i, sp 0, tp 0): ranks 0 and 4
    assert served["pool_ranks"] == {0: 0, 1: 4}
    assert "live on their ranks" in served["pool_views"]
    assert served["describe"]["backend"] == "gloo"


def test_engine_at_the_reference_defaults_equals_jax(served, jax_stack):
    want, jsnap = _run(jax_stack, SCHEDULE, JaxEngine, JaxEngineConfig,
                       passes=2, prefix_cache=True, spec_k=4)
    got, snap = served["defaults"]
    assert got == want
    assert got == served["corpus"][0] * 2
    assert snap["prefix"]["hit_seqs"] > 0 and snap["spec"]["accepted"] > 0


def test_ring_prefill_over_sp_ranks_equals_jax_mesh_ring(served):
    r = served["ring"]
    assert r["tokens"] == r["jax_tokens"]
    assert r["dispatch"] == (CFG["n_layers"], 1)
    for mine, theirs in zip(r["pools"][1], r["jax_pools"]):
        np.testing.assert_allclose(mine[:, BLOCK:], theirs[1, :, BLOCK:],
                                   atol=ATOL, rtol=0)
    assert not any(p.any() for p in r["pools"][0])
