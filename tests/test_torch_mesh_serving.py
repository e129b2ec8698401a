"""Mesh-sharded serving on the port (brpc_tpu_torch.serving.mesh_model,
ShardedKVCache, ShardedPrefixCache) against the JAX package on the CPU.

The JAX side is the reference's own stack on the conftest's 8 virtual
CPU devices: ``serving_mesh()`` is the real dp=2 / sp=2 / tp=2 split,
one ``MeshTransformer`` over an armed ``ShardedKVCache`` shared by the
module (its compiles per bucket are the slow part). The port lays 8
positions on the CPU (``mesh.use_cpu(8)``) and replays them in one
process, over the JAX model's weights carried by ``serving/weights.py``.

What is held (the reference's ``tests/test_serving_mesh.py`` cases that
need no router, its ``/serving`` per-shard view on the port's page, the
sharded cases of ``tests/test_serving_prefix.py`` and
``tests/test_serving_spec.py``, and more):

- the corpus schedule (``tools/record_serving_corpus.SCHEDULE``) at the
  reference test's widths: the port's mesh engine gives the JAX mesh
  engine's greedy tokens and the port's single-device engine's, list for
  list, with the ledger armed and idle after; every decode step audits
  (1 launch, 1 host sync); both shards serve and tick ``shard_steps``;
- prefill runs one attention call per tp head slice per layer, on
  strided views of the fused QKV product, and writes the owner's slice
  of the stacked pools only (pools within 1e-5 of JAX's);
- the ledger: routing, forks, copy-on-write through the stacked pools,
  migration export and adopt, truncation, skew and snapshots equal the
  JAX ``ShardedKVCache``'s on the same calls and numpy-seeded pools;
- the engine at the reference's defaults (prefix cache on, ``spec_k=4``)
  equals the JAX mesh engine, and a chain migrated between two port mesh
  engines decodes to the co-located tokens with blocks and bytes exact;
- a long prompt through the mesh ring (sp 2) equals the JAX mesh ring's
  first token, decode and pools (1e-5), and the port's one-position ring.

Tolerance: tokens, ledger records and block bytes exact; pools atol 1e-5
(float32 on both sides, the same products summed in another order by
XLA and torch; block 0, the pad scatter target, left out).
"""

import threading

import numpy as np
import pytest
import torch

from brpc_tpu.serving import EngineConfig as JaxEngineConfig
from brpc_tpu.serving import KVCacheConfig as JaxKVConfig
from brpc_tpu.serving import MeshTransformer as JaxMeshModel
from brpc_tpu.serving import ModelConfig as JaxModelConfig
from brpc_tpu.serving import ServingEngine as JaxEngine
from brpc_tpu.serving import ShardedKVCache as JaxShardedKV
from brpc_tpu.serving import ShardedPrefixCache as JaxShardedPrefix
from brpc_tpu.tpu import mesh as jax_mesh
from brpc_tpu_torch import flags as port_flags
from brpc_tpu_torch.rpc import Server
from brpc_tpu_torch.serving import (EngineConfig, KVCacheConfig,
                                    MeshTransformer, ModelConfig,
                                    PagedKVCache, PrefixCache,
                                    ServingEngine, ShardedKVCache,
                                    ShardedPrefixCache, ShardTable,
                                    TinyTransformer, build_prefix_cache)
from brpc_tpu_torch.serving.kv_cache import _fleet_skew
from brpc_tpu_torch.serving.migration import KVMigrator, chain_block_bytes
from brpc_tpu_torch.serving.service import LlmServingService
from brpc_tpu_torch.serving.weights import params_from_jax
from brpc_tpu_torch.shard.plane import shard_for
from brpc_tpu_torch.tpu import mesh, pallas_ops
from brpc_tpu_torch.tpu.device_lane import DispatchCounter, step_dispatch
from tools.record_serving_corpus import SCHEDULE

CFG = dict(vocab=256, d_model=32, n_heads=2, n_layers=2)
BLOCK = 16
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def cpu8():
    mesh.use_cpu(8)
    yield
    mesh.use_cpu(0)


def _jax_params(jm):
    return {name: np.asarray(a) for name, a in jm._params.items()}


def _port_mesh_model(jm, num_blocks=256, **cfg):
    """A port MeshTransformer over an armed ShardedKVCache on the 8 CPU
    positions' serving mesh, holding the JAX model's weights."""
    c = ModelConfig(**dict(CFG, **cfg))
    kv = ShardedKVCache(KVCacheConfig(BLOCK, num_blocks), c.n_layers,
                        c.kv_dim)
    kv._check = True
    model = MeshTransformer(c, kv)
    model.load_params(params_from_jax(_jax_params(jm), "cpu"))
    return model, kv


@pytest.fixture(scope="module")
def stacks():
    """(JAX mesh model, port mesh model): armed, shared by the module."""
    jcfg = JaxModelConfig(**CFG)
    jkv = JaxShardedKV(JaxKVConfig(BLOCK, 256), jcfg.n_layers, jcfg.kv_dim)
    jkv._check = True
    jm = JaxMeshModel(jcfg, jkv)
    tm, _ = _port_mesh_model(jm)
    yield jm, tm
    jm.close()
    jkv.close()
    tm.close()
    tm.kv.close()


def _run(model, schedule, engine_cls, config_cls, passes=1,
         prefix_cache=False, spec_k=0):
    """Drive one engine of either package through ``schedule`` (``passes``
    times, each pass after the last finished); each sequence's greedy
    tokens in submit order, and the engine's last snapshot."""
    kw = {} if prefix_cache else {"prefix_cache": False}
    engine = engine_cls(model, model.kv, config_cls(
        max_batch=8, token_budget=512, idle_wait_s=0.002, spec_k=spec_k),
        **kw).start()
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
    model.kv.assert_idle()
    return out, snap


def _port(model, schedule, **kw):
    return _run(model, schedule, ServingEngine, EngineConfig, **kw)


def _jax(model, schedule, **kw):
    return _run(model, schedule, JaxEngine, JaxEngineConfig, **kw)


def _single_device(jm, schedule):
    kv = PagedKVCache(KVCacheConfig(BLOCK, 256), CFG["n_layers"],
                      CFG["d_model"], device="cpu")
    kv._check = True
    model = TinyTransformer(ModelConfig(**CFG), kv)
    model.load_params(params_from_jax(_jax_params(jm), "cpu"))
    try:
        return _port(model, schedule)[0]
    finally:
        model.close()


# ------------------------------------------------------------ equivalence
class TestMeshEquivalence:
    def test_mesh_is_dp2_sp2_tp2(self, stacks):
        jm, tm = stacks
        assert tm.kv.n_shards == 2 == jm.kv.n_shards
        assert tm.mesh.shape == {"dp": 2, "sp": 2, "tp": 2} \
            == dict(jm.mesh.shape)
        assert (tm.dp, tm.tp) == (jm.dp, jm.tp)

    def test_corpus_tokens_equal_jax_mesh_and_single_device(self, stacks):
        """The acceptance gate: the port's mesh engine gives the JAX mesh
        engine's greedy tokens and the port's single-device engine's, list
        for list, on the corpus schedule; both armed pools end idle."""
        jm, tm = stacks
        want, _ = _jax(jm, SCHEDULE)
        got, snap = _port(tm, SCHEDULE)
        assert got == want
        assert got == _single_device(jm, SCHEDULE)
        # both shards held sequences and ticked their decode steps
        assert sorted(snap["shard_steps"]) == [0, 1]
        assert all(s["steps"] > 0 and s["seq_steps"] > 0
                   for s in snap["shard_steps"].values())
        assert snap["kv"]["n_shards"] == 2

    def test_dispatch_invariant_one_launch_one_sync_per_step(self, stacks):
        """Every decode step costs ONE launch and ONE host sync of the
        engine thread, for both dp groups together (asserted from outside
        the engine; the armed engine also asserts it per step)."""
        _, tm = stacks
        orig = tm.decode_step
        deltas = []

        def audited(tokens, positions, tables):
            before = step_dispatch.thread_snapshot()
            out = orig(tokens, positions, tables)
            deltas.append(DispatchCounter.delta(
                before, step_dispatch.thread_snapshot()))
            return out

        tm.decode_step = audited
        try:
            _port(tm, SCHEDULE[:6])
        finally:
            del tm.decode_step
        assert deltas, "no decode steps ran"
        assert all((launches, syncs) == (1, 1)
                   for launches, _ops, syncs in deltas), deltas

    def test_prefill_attends_per_tp_slice_on_strided_views(self, stacks,
                                                          monkeypatch):
        """One attention call per tp head slice per layer, each on an
        (S, H / tp, hd) view of the fused QKV product (no copy: its data
        begins i * H/tp * hd floats into the q, k or v view), and only the
        owner's slice of the stacked pools is written; the pools equal the
        JAX mesh prefill's."""
        jm, _ = stacks
        tm, kv = _port_mesh_model(jm, num_blocks=32, attn="flash")
        calls = []
        real = pallas_ops.flash_attention

        def recorder(q, k, v, causal=False, **kw):
            calls.append((tuple(q.shape), q.stride(), q.is_contiguous()))
            return real(q, k, v, causal=causal, **kw)

        monkeypatch.setattr(pallas_ops, "flash_attention", recorder)
        jcfg = JaxModelConfig(**CFG)
        jkv = JaxShardedKV(JaxKVConfig(BLOCK, 32), jcfg.n_layers,
                           jcfg.kv_dim)
        jm2 = JaxMeshModel(jcfg, jkv)
        try:
            sid = next(s for s in range(1, 100) if kv.shard_of(s) == 1)
            prompt = tm.synth_prompt(40)
            tt = kv.alloc_sequence(sid, 40)
            jt = jkv.alloc_sequence(sid, 40)
            assert tt.shard == jt.shard == 1 and list(tt) == list(jt)
            first = tm.prefill(prompt, tt)
            assert first == jm2.prefill(prompt, jt)
            hl = CFG["n_heads"] // 2
            assert len(calls) == tm.tp * CFG["n_layers"]
            for shape, stride, contiguous in calls:
                assert shape == (64, hl, CFG["d_model"] // CFG["n_heads"])
                assert stride[0] == 3 * CFG["d_model"] and not contiguous
            assert not kv.k_pools[0].any() and not kv.v_pools[0].any()
            for tp, jp in ((kv.k_pools, jkv.k_pools),
                           (kv.v_pools, jkv.v_pools)):
                np.testing.assert_allclose(
                    tp[1, :, BLOCK:].numpy(), np.asarray(jp)[1, :, BLOCK:],
                    atol=ATOL, rtol=0)
            kv.free_sequence(sid)
            jkv.free_sequence(sid)
            kv.assert_idle()
        finally:
            tm.close()
            kv.close()
            jm2.close()
            jkv.close()

    def test_tp_head_slices_equal_a_full_launch(self, stacks):
        """The tp split changes no head's attention: per-slice outputs,
        concatenated, equal the all-heads call bit for bit."""
        _, tm = stacks
        rng = np.random.default_rng(11)
        qkv = torch.from_numpy(rng.normal(size=(128, 3 * 32)).astype(
            np.float32))
        q, k, v = (t.view(128, 2, 16) for t in qkv.split(32, dim=-1))
        whole = TinyTransformer._attend(tm, q, k, v, False)
        assert torch.equal(tm._attend(q, k, v, False), whole)

    def test_init_checks_match_jax(self):
        cfg = ModelConfig(**CFG)
        kv = ShardedKVCache(KVCacheConfig(BLOCK, 8), cfg.n_layers,
                            cfg.kv_dim)
        try:
            with pytest.raises(ValueError, match="'sp' axis"):
                MeshTransformer(cfg, kv, mesh=mesh.make_mesh(
                    {"dp": 2, "tp": 4}))
            with pytest.raises(ValueError, match="must divide tp"):
                MeshTransformer(cfg, kv, mesh=mesh.make_mesh(
                    {"dp": 2, "sp": 1, "tp": 4}))
            with pytest.raises(ValueError, match="kv shards"):
                MeshTransformer(cfg, kv, mesh=mesh.make_mesh(
                    {"dp": 4, "sp": 1, "tp": 2}))
        finally:
            kv.close()
        jcfg = JaxModelConfig(**CFG)
        jkv = JaxShardedKV(JaxKVConfig(BLOCK, 8), jcfg.n_layers, jcfg.kv_dim)
        try:
            with pytest.raises(ValueError, match="'sp' axis"):
                JaxMeshModel(jcfg, jkv, mesh=jax_mesh.make_mesh(
                    {"dp": 2, "tp": 4}))
            with pytest.raises(ValueError, match="kv shards"):
                JaxMeshModel(jcfg, jkv, mesh=jax_mesh.make_mesh(
                    {"dp": 4, "sp": 1, "tp": 2}))
        finally:
            jkv.close()
    def test_serving_builtin_reports_per_shard_occupancy(self, stacks):
        """The reference's ``/serving`` case on the port's page: the
        per-device view (per-shard occupancy, the block-table shard map,
        per-shard step latency) in the JSON and text views; the shards'
        block counts equal the JAX page's after the same run, the device
        names aside."""
        jm, tm = stacks
        snap, text = _page_run(tm, ServingEngine, EngineConfig,
                               port_page())
        assert snap["kv"]["n_shards"] == 2
        shards = snap["kv"]["shards"]
        assert [s["shard"] for s in shards] == [0, 1]
        assert all(s["blocks_total"] > 0 and s["devices"] for s in shards)
        # every completed sequence freed its blocks again; what stays
        # used is exactly the prefix cache's committed chains
        assert all(s["blocks_used"] == s["blocks_cached"] for s in shards)
        assert "shard_steps" in snap and snap["shard_steps"]
        assert "sharded: n_shards=2" in text
        assert "[shard 0]" in text and "[shard 1]" in text
        jsnap, jtext = _page_run(jm, JaxEngine, JaxEngineConfig,
                                 jax_page())

        # the JAX page's fields, the device names aside (the port's
        # shards also count copy-on-write splits and refused admissions)
        jshards = jsnap["kv"]["shards"]
        assert [{k: sh[k] for k in jsh if k != "devices"}
                for sh, jsh in zip(shards, jshards)] == \
            [{k: v for k, v in jsh.items() if k != "devices"}
             for jsh in jshards]

        def shard_keys(page):
            return [[w.split("=")[0] for w in line.split() if "=" in w]
                    for line in page.splitlines()
                    if line.strip().startswith("[shard")]

        assert shard_keys(text) == shard_keys(jtext)


def port_page():
    from brpc_tpu_torch.builtin.services import serving_service

    return serving_service


def jax_page():
    from brpc_tpu.builtin.services import serving_service

    return serving_service


def _page_run(model, engine_cls, config_cls, page):
    """SCHEDULE[:4] through an engine of either package at the
    reference's defaults (the prefix cache on), the page read while the
    engine still runs: (the JSON view's last engine, the text view)."""
    import json as _json
    import sys
    import types

    # a sequence's dp shard is splitmix64 of its id, drawn from a
    # process-wide counter per package: start both packages' counters
    # alike, or the engines other tests ran in this process decide which
    # shard holds which chain
    seq_cls = sys.modules[engine_cls.__module__].Sequence
    with seq_cls._ids_lock:
        seq_cls._ids[0] = 0
    engine = engine_cls(model, model.kv, config_cls(
        max_batch=8, token_budget=512, idle_wait_s=0.002)).start()
    try:
        evs = []
        for plen, max_new in SCHEDULE[:4]:
            ev = threading.Event()
            code, _ = engine.submit(model.synth_prompt(plen), max_new,
                                    done=lambda _r, ev=ev: ev.set())
            assert code == 0
            evs.append(ev)
        for ev in evs:
            assert ev.wait(300)
        status, _ctype, body = page(None, types.SimpleNamespace(
            query={"format": "json"}, path="/serving"))
        assert status == 200
        status, _ctype, text = page(None, types.SimpleNamespace(
            query={}, path="/serving"))
        assert status == 200
        return _json.loads(body)["engines"][-1], text
    finally:
        engine.stop()
        model.kv.assert_idle()


# ------------------------------------------------------ skew watch rule
class TestShardSkewWatchRule:
    def test_rule_installed_with_reloadable_bound(self):
        from brpc_tpu_torch.metrics.watch import (KIND_THRESHOLD,
                                                  global_watch,
                                                  install_default_rules)

        install_default_rules()
        rules = {r.name: r for r in global_watch().rules()}
        rule = rules.get("serving_shard_skew")
        assert rule is not None, sorted(rules)
        assert rule.var == "g_serving_kv_shard_skew"
        assert rule.kind == KIND_THRESHOLD
        assert rule.bound() == port_flags.get("serving_shard_skew_ratio")
        old = port_flags.get("serving_shard_skew_ratio")
        try:
            port_flags.set_flag("serving_shard_skew_ratio", "0.5")
            assert rule.bound() == 0.5
            assert "0.5" in rule.condition()
        finally:
            port_flags.set_flag("serving_shard_skew_ratio", str(old))
        assert rule.bound() == old

    def test_value_fn_failure_falls_back_to_static_bound(self):
        from brpc_tpu_torch.metrics.watch import KIND_THRESHOLD, WatchRule

        boom = WatchRule("t_boom", "v", KIND_THRESHOLD, ">", 0.25,
                         value_fn=lambda: (_ for _ in ()).throw(
                             RuntimeError("flag gone")))
        assert boom.bound() == 0.25

    def test_skew_gauge_tracks_unbalanced_pools(self):
        from brpc_tpu_torch.metrics import variable

        assert variable.get_exposed("g_serving_kv_shard_skew") is not None
        kv = ShardedKVCache(KVCacheConfig(block_size=16, num_blocks=32),
                            1, 8)
        jkv = JaxShardedKV(JaxKVConfig(block_size=16, num_blocks=32), 1, 8)
        try:
            assert _fleet_skew() == 0.0  # idle fleet: balanced
            # pin blocks onto ONE shard: ids whose route lands on shard 0
            sids = [s for s in range(1, 200) if kv.shard_of(s) == 0][:4]
            assert sids == [s for s in range(1, 200)
                            if jkv.shard_of(s) == 0][:4]
            for s in sids:
                kv.alloc_sequence(s, 64)
                jkv.alloc_sequence(s, 64)
            assert _fleet_skew() > 0.2
            assert kv.snapshot()["shard_skew"] == \
                jkv.snapshot()["shard_skew"]
            for s in sids:
                kv.free_sequence(s)
                jkv.free_sequence(s)
            assert _fleet_skew() == 0.0
        finally:
            kv.close()
            jkv.close()


# ------------------------------------------------------ routing stability
class TestRoutingStability:
    def test_versioned_cid_reuse_spreads_across_shards(self):
        cids = [(v << 32) for v in range(1, 129)]
        shards = [shard_for(c, 2) for c in cids]
        assert set(shards) == {0, 1}
        share = sum(shards) / len(shards)
        assert 0.3 < share < 0.7, f"skewed spread: {share}"
        assert [shard_for(c, 2) for c in cids] == shards  # stable

    def test_block_table_routing_stable_under_cid_reuse(self):
        kv = ShardedKVCache(KVCacheConfig(block_size=16, num_blocks=32),
                            1, 8)
        jkv = JaxShardedKV(JaxKVConfig(block_size=16, num_blocks=32), 1, 8)
        try:
            seen = set()
            for v in range(1, 41):
                cid = v << 32
                table = kv.alloc_sequence(cid, 20)
                jt = jkv.alloc_sequence(cid, 20)
                assert isinstance(table, ShardTable)
                assert (table.shard, list(table)) == (jt.shard, list(jt))
                assert table.shard == kv.shard_of(cid)
                assert kv.block_table(cid).shard == table.shard
                seen.add(table.shard)
                kv.free_sequence(cid)
                jkv.free_sequence(cid)
                # the SAME cid re-allocated lands on the SAME shard
                again = kv.alloc_sequence(cid, 20)
                assert again.shard == table.shard
                _same(again, jkv.alloc_sequence(cid, 20))
                kv.free_sequence(cid)
                jkv.free_sequence(cid)
            assert seen == {0, 1}
            kv.assert_idle()
        finally:
            kv.close()
            jkv.close()


# --------------------------------------------------- the sharded ledger
def _pair_kv(num_blocks=32, block_size=16, layers=2, kv_dim=8):
    kv = ShardedKVCache(KVCacheConfig(block_size=block_size,
                                      num_blocks=num_blocks), layers, kv_dim)
    jkv = JaxShardedKV(JaxKVConfig(block_size=block_size,
                                   num_blocks=num_blocks), layers, kv_dim)
    kv._check = jkv._check = True
    return kv, jkv


def _same(a, b):
    """One ledger call's result on both packages: tables as (shard,
    blocks), anything else as is."""
    if isinstance(a, list):
        assert (getattr(a, "shard", None), list(a)) == \
            (getattr(b, "shard", None), list(b))
    elif isinstance(a, tuple):
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


def _snap_equal(kv, jkv):
    keys = ("blocks_total", "blocks_used", "blocks_free", "sequences",
            "blocks_cached", "n_shards", "shard_skew", "shard_map")
    s, j = kv.snapshot(), jkv.snapshot()
    assert {k: s[k] for k in keys} == {k: j[k] for k in keys}
    shard_keys = ("shard", "blocks_used", "sequences", "used_ratio",
                  "blocks_cached")
    assert [{k: x[k] for k in shard_keys} for x in s["shards"]] == \
        [{k: x[k] for k in shard_keys} for x in j["shards"]]
    assert all(len(x["devices"]) == 4 for x in s["shards"])


class TestShardedLedger:
    def test_sharded_truncate_routes_to_owner(self):
        kv, jkv = _pair_kv(num_blocks=32, block_size=8, layers=1)
        try:
            for c in (kv, jkv):
                c.alloc_sequence(5, 10)
                c.extend_sequence(5, 40)
                assert c.truncate_sequence(5, 10) == 3
                c.free_sequence(5)
                c.assert_idle("sharded truncate teardown")
        finally:
            kv.close()
            jkv.close()

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_seeded_op_stream_equals_jax(self, seed):
        """A numpy-seeded stream of allocs, extends, forks, copy-on-write
        splits, truncations, frees and migration exports and adopts on
        both sharded ledgers: every result (or the exception raised) and
        snapshot equal, and the stacked pools (numpy-seeded, then copied
        page by page) bit-equal."""
        import jax.numpy as jnp

        rng = np.random.default_rng(seed)
        kv, jkv = _pair_kv()
        init = rng.normal(size=tuple(kv.k_pools.shape)).astype(np.float32)
        kv.update_pools(torch.from_numpy(init.copy()),
                        torch.from_numpy(-init))
        jkv.update_pools(jnp.asarray(init), jnp.asarray(-init))

        def call(name, *args):
            try:
                got = getattr(kv, name)(*args)
            except Exception as e:
                with pytest.raises(Exception) as info:
                    getattr(jkv, name)(*args)
                assert type(info.value).__name__ == type(e).__name__
                return None
            _same(got, getattr(jkv, name)(*args))
            return got

        live, next_id = [], 1
        try:
            for _ in range(60):
                op = rng.choice(["alloc", "extend", "fork", "cow", "free",
                                 "truncate", "migrate"])
                if op == "alloc" or not live:
                    if call("alloc_sequence", next_id,
                            int(rng.integers(1, 60))) is not None:
                        live.append(next_id)
                    next_id += 1
                    continue
                sid = live[int(rng.integers(len(live)))]
                if op == "extend":
                    call("extend_sequence", sid,
                         kv.seq_len(sid) + int(rng.integers(1, 20)))
                elif op == "fork":
                    call("fork_sequence", sid, next_id)
                    live.append(next_id)
                    next_id += 1
                elif op == "cow":
                    call("cow_block", sid,
                         int(rng.integers(len(kv.block_table(sid)))))
                elif op == "truncate":
                    call("truncate_sequence", sid,
                         max(1, kv.seq_len(sid) - int(rng.integers(0, 20))))
                elif op == "free":
                    call("free_sequence", sid)
                    live.remove(sid)
                else:  # export, adopt under a new id, release the source
                    call("quiesce_sequence", sid)
                    chain, ntok = call("export_chain", sid)
                    call("adopt_sequence", next_id, chain, ntok)
                    call("release_exported", sid)
                    live.remove(sid)
                    live.append(next_id)
                    next_id += 1
                _snap_equal(kv, jkv)
            np.testing.assert_array_equal(kv.k_pools.numpy(),
                                          np.asarray(jkv.k_pools))
            np.testing.assert_array_equal(kv.v_pools.numpy(),
                                          np.asarray(jkv.v_pools))
            for sid in live:
                call("free_sequence", sid)
            kv.assert_idle()
            jkv.assert_idle()
        finally:
            kv.close()
            jkv.close()

    def test_adopt_without_a_shard_is_refused(self):
        kv, jkv = _pair_kv()
        try:
            for c in (kv, jkv):
                with pytest.raises(ValueError, match="owning shard"):
                    c.adopt_sequence(1, [1, 2], 20)
            with pytest.raises(ValueError, match="outside"):
                kv.pin_shard(1, 2)
        finally:
            kv.close()
            jkv.close()


# ---------------------------------------------------- sharded prefix cache
def test_sharded_fork_pins_the_sequence_to_the_chain_shard():
    kv = ShardedKVCache(KVCacheConfig(block_size=16, num_blocks=64), 1, 8)
    jkv = JaxShardedKV(JaxKVConfig(block_size=16, num_blocks=64), 1, 8)
    kv._check = jkv._check = True
    try:
        for c, spc in ((kv, ShardedPrefixCache(kv)),
                       (jkv, JaxShardedPrefix(jkv))):
            toks = list(range(1, 33))  # 2 full blocks
            shard = spc.route_shard(toks + [0])
            assert shard is not None
            c.alloc_sequence(101, 32, shard=shard)
            assert spc.commit(101, toks, 32) == 2
            c.free_sequence(101)
            assert spc.match_len(toks + [0]) == 32
            assert spc.fork(202, toks + [0]) == 32
            assert c.block_table(202).shard == shard
            c.free_sequence(202)
            assert spc.clear() == 2
            c.assert_idle("sharded teardown")
            assert spc.route_shard([1, 2, 3]) is None
        assert ShardedPrefixCache(kv).route_shard(list(range(1, 34))) == \
            JaxShardedPrefix(jkv).route_shard(list(range(1, 34)))
    finally:
        kv.close()
        jkv.close()


def test_build_prefix_cache_dispatches_on_pool_type():
    skv = ShardedKVCache(KVCacheConfig(block_size=16, num_blocks=32), 1, 8)
    try:
        tree = build_prefix_cache(skv)
        assert isinstance(tree, ShardedPrefixCache)
        assert [t.shard for t in tree.trees] == [0, 1]
        assert all(isinstance(t, PrefixCache) for t in tree.trees)
    finally:
        skv.close()


# ------------------------------------------------- reference defaults
def test_mesh_engine_at_the_reference_defaults_equals_jax(stacks):
    """Prefix cache on and ``spec_k=4``, the corpus schedule twice (the
    second pass hits the trees): the port's mesh engine gives the JAX mesh
    engine's tokens, and its cold single-pass tokens."""
    jm, tm = stacks
    want, jsnap = _jax(jm, SCHEDULE, passes=2, prefix_cache=True, spec_k=4)
    got, snap = _port(tm, SCHEDULE, passes=2, prefix_cache=True, spec_k=4)
    assert got == want
    cold, _ = _port(tm, SCHEDULE)
    assert got == cold + cold
    assert snap["prefix"]["hit_seqs"] > 0 and len(snap["prefix"]["shards"]) \
        == 2
    assert snap["spec"]["accepted"] > 0


# ----------------------------------------------------------- migration
def test_chain_migrated_between_mesh_engines_decodes_the_colocated_tokens(
        stacks):
    """A prefill-role mesh engine hands every chain of the corpus schedule
    to a decode-role mesh engine behind the port's Server: tokens equal
    the co-located mesh engine's, the decode engine prefills nothing, and
    the migrated blocks and bytes are exact. Both armed pools end idle."""
    jm, tm = stacks
    ref, _ = _port(tm, SCHEDULE)
    dec, dec_kv = _port_mesh_model(jm, num_blocks=128)
    pre, pre_kv = _port_mesh_model(jm, num_blocks=128)
    d_eng = ServingEngine(dec, dec_kv, EngineConfig(
        max_batch=8, token_budget=512, idle_wait_s=0.002, role="decode"),
        prefix_cache=False).start()
    srv = Server().add_service(LlmServingService(d_eng)).start(
        "127.0.0.1:0")
    p_eng = ServingEngine(pre, pre_kv, EngineConfig(
        max_batch=8, token_budget=512, idle_wait_s=0.002, role="prefill"),
        prefix_cache=False).start()
    p_eng.set_migrator(KVMigrator(f"{srv.listen_endpoint()}"))
    try:
        got = []
        for plen, max_new in SCHEDULE:
            box, ev = {}, threading.Event()
            code, _ = p_eng.submit(
                pre.synth_prompt(plen), max_new,
                done=lambda r, box=box, ev=ev: (box.update(r=r), ev.set()))
            assert code == 0 and ev.wait(300), "prefill stage stalled"
            h = box["r"]
            assert h.finish_reason == "handoff"
            box2, ev2 = {}, threading.Event()
            code, _ = d_eng.submit(
                np.zeros(0, dtype=np.int32), 0, resume_seq_id=h.seq_id,
                done=lambda r, box=box2, ev=ev2: (box.update(r=r),
                                                   ev.set()))
            assert code == 0 and ev2.wait(300), "decode stage stalled"
            got.append(list(h.tokens) + list(box2["r"].tokens))
        assert got == ref
        assert d_eng.prefill_tokens == 0
        assert p_eng.migrator.failed == 0
        assert p_eng.migrator.blocks == sum(pre_kv.blocks_for(p)
                                            for p, _ in SCHEDULE)
        assert p_eng.migrator.bytes == \
            p_eng.migrator.blocks * chain_block_bytes(pre_kv)
    finally:
        p_eng.stop()
        srv.stop()
        srv.join(timeout=2)
        d_eng.stop()
        pre_kv.assert_idle("prefill pool after the mesh migration")
        dec_kv.assert_idle("decode pool after the mesh migration")
        for m in (pre, dec):
            m.close()
            m.kv.close()


# -------------------------------------------------------------- mesh ring
def test_mesh_ring_prefill_equals_jax_mesh_ring_and_one_position():
    """A prompt past ``ring_threshold`` (64) runs the ring over the mesh's
    sp axis (2 positions, an odd length padded to them): its first token
    and three decode steps equal the JAX mesh model's (whose ring runs on
    the 8-device mesh) and the port's one-position ring; the owner's pool
    slice is within 1e-5 of JAX's and the other slice untouched."""
    jcfg = JaxModelConfig(ring_threshold=64, **CFG)
    jkv = JaxShardedKV(JaxKVConfig(BLOCK, 32), jcfg.n_layers, jcfg.kv_dim)
    jm = JaxMeshModel(jcfg, jkv)
    tm, kv = _port_mesh_model(jm, num_blocks=32, ring_threshold=64)
    one_kv = PagedKVCache(KVCacheConfig(BLOCK, 32), CFG["n_layers"],
                          CFG["d_model"], device="cpu")
    one = TinyTransformer(ModelConfig(ring_threshold=64, **CFG), one_kv)
    one.load_params(params_from_jax(_jax_params(jm), "cpu"))
    try:
        sid = next(s for s in range(1, 100) if kv.shard_of(s) == 0)
        length = 77
        prompt = tm.synth_prompt(length)
        jt = jkv.alloc_sequence(sid, length)
        tt = kv.alloc_sequence(sid, length)
        ot = one_kv.alloc_sequence(sid, length)
        before = step_dispatch.snapshot()
        tf = tm.prefill(prompt, tt)
        launches, _, syncs = step_dispatch.delta(before,
                                                 step_dispatch.snapshot())
        assert (launches, syncs) == (CFG["n_layers"], 1)
        assert tf == jm.prefill(prompt, jt) == one.prefill(prompt, ot)
        tok, pos = tf, length
        for _ in range(3):
            jt = jkv.extend_sequence(sid, pos + 1)
            tt = kv.extend_sequence(sid, pos + 1)
            ot = one_kv.extend_sequence(sid, pos + 1)
            want = np.asarray(jm.decode_step(np.array([tok], np.int32),
                                             np.array([pos], np.int32),
                                             [jt]))
            got = tm.decode_step(np.array([tok], np.int32),
                                 np.array([pos], np.int32), [tt])
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                one.decode_step(np.array([tok], np.int32),
                                np.array([pos], np.int32), [ot]), got)
            tok, pos = int(got[0]), pos + 1
        for tp, jp in ((kv.k_pools, jkv.k_pools), (kv.v_pools, jkv.v_pools)):
            np.testing.assert_allclose(tp[0, :, BLOCK:].numpy(),
                                       np.asarray(jp)[0, :, BLOCK:],
                                       atol=ATOL, rtol=0)
        assert not kv.k_pools[1].any()
        for c in (kv, jkv, one_kv):
            c.free_sequence(sid)
            c.assert_idle()
    finally:
        for m in (tm, jm, one):
            m.close()
        kv.close()
        jkv.close()
