"""The port's radix prefix cache (brpc_tpu_torch.serving.prefix_cache) and
the ledger's cache-hold surface, held against the JAX package's on the
CPU: every case of the reference's ``tests/test_serving_prefix.py`` that
the single-pool port covers.

Each ledger and tree case runs the same operations on both packages'
ledgers and trees, asserts the reference's expectations on each, and
requires the two to agree on every block id, refcount and counter. The
copy-on-write page copy is held bit for bit against the JAX one on
numpy-seeded pools, and a numpy-seeded stream of commits, forks,
evictions and frees runs on both with their snapshots equal after every
operation.

The engine cases use the corpus schedule (``tools/record_serving_corpus.
SCHEDULE``: every synth prompt is a prefix of every longer one) at the
corpus widths, the JAX model's weights carried to the port with
``serving/weights.py``. Tokens must be equal (no tolerance; both run
float32 with plain attention on the CPU). Requests are submitted under
the engine's lock, so both engines admit them in one step and their
prefix counters are comparable exactly.

The ``/serving`` builtin's prefix section is read from the port's page
and held to the JAX page's after the same run. The sharded-fork test and
the sharded half of the factory test are in
``tests/test_torch_mesh_serving.py``. Left out, for ROADMAP Queue 1: the
route-agreement test (the client router, item 2(b)8).
"""

import threading
import types

import numpy as np
import pytest
import torch

from brpc_tpu import fault as jax_fault
from brpc_tpu import flags as jax_flags
from brpc_tpu.serving import EngineConfig as JaxEngineConfig
from brpc_tpu.serving import KVCacheConfig as JaxKVConfig
from brpc_tpu.serving import ModelConfig as JaxModelConfig
from brpc_tpu.serving import PagedKVCache as JaxKV
from brpc_tpu.serving import PrefixCache as JaxPrefixCache
from brpc_tpu.serving import ServingEngine as JaxEngine
from brpc_tpu.serving import TinyTransformer as JaxModel
from brpc_tpu.serving import prefix_route_key as jax_route_key
from brpc_tpu_torch import fault as port_fault
from brpc_tpu_torch import flags as port_flags
from brpc_tpu_torch.serving import (EngineConfig, KVCacheConfig,
                                    ModelConfig, PagedKVCache, PrefixCache,
                                    ServingEngine, TinyTransformer,
                                    build_prefix_cache, prefix_route_key)
from brpc_tpu_torch.serving.weights import params_from_jax
from tools.record_serving_corpus import SCHEDULE

SIDES = {
    "jax": types.SimpleNamespace(KV=JaxKV, Config=JaxKVConfig,
                                 Tree=JaxPrefixCache, flags=jax_flags,
                                 fault=jax_fault, kw={}),
    "port": types.SimpleNamespace(KV=PagedKVCache, Config=KVCacheConfig,
                                  Tree=PrefixCache, flags=port_flags,
                                  fault=port_fault, kw={"device": "cpu"}),
}


def _kv(side, num_blocks=64, block_size=8, watermark=1.0, layers=1,
        kv_dim=8):
    s = SIDES[side]
    kv = s.KV(s.Config(block_size=block_size, num_blocks=num_blocks,
                       watermark=watermark), layers, kv_dim, **s.kw)
    kv._check = True  # audit every ledger mutation like BRPC_TPU_CHECK=1
    return kv


def _both(scenario):
    """Run ``scenario(side)`` on each package; the records must agree."""
    got = {side: scenario(side) for side in SIDES}
    assert got["port"] == got["jax"], got
    return got["port"]


# ------------------------------------------------------ ledger cache holds
def test_retain_release_roundtrip():
    def run(side):
        kv = _kv(side)
        t = kv.alloc_sequence(1, 16)  # 2 blocks
        kv.retain_block(t[0])
        rec = [t, kv.cache_held_blocks(), kv.block_ref(t[0])]
        assert rec[1:] == [1, 2]
        assert kv.free_sequence(1) == 1  # t[1] freed; t[0] cache-held
        assert kv.used_blocks == 1
        assert kv.release_block(t[0]) == 1  # last hold: block freed
        kv.assert_idle("after release")
        return rec
    _both(run)


def test_release_without_hold_raises():
    def run(side):
        kv = _kv(side)
        t = kv.alloc_sequence(1, 8)
        with pytest.raises(KeyError):
            kv.release_block(t[0])  # table-held, but no cache hold
        kv.free_sequence(1)
        kv.assert_idle()
        return t
    _both(run)


def test_assert_idle_names_lingering_cache_holds():
    def run(side):
        kv = _kv(side)
        t = kv.alloc_sequence(1, 8)
        kv.retain_block(t[0])
        kv.free_sequence(1)
        with pytest.raises(AssertionError, match="prefix cache") as e:
            kv.assert_idle("cache hold probe")
        kv.release_block(t[0])
        kv.assert_idle()
        return str(e.value)
    _both(run)


def test_adopt_shares_a_cached_chain():
    def run(side):
        kv = _kv(side)
        t = kv.alloc_sequence(1, 24)  # 3 blocks
        for b in t:
            kv.retain_block(b)  # the tree pins the whole chain
        kv.free_sequence(1)
        assert kv.used_blocks == 3  # the chain outlives its sequence
        kv.adopt_sequence(2, t[:2], 16)  # fork: 2 blocks, zero copies
        assert list(kv.block_table(2)) == t[:2]
        assert kv.block_ref(t[0]) == 2 and kv.block_ref(t[2]) == 1
        ext = kv.extend_sequence(2, 17)  # grows a FRESH tail block
        assert ext[:2] == t[:2] and len(ext) == 3 and ext[2] != t[2]
        assert kv.free_sequence(2) == 1  # only the private tail frees
        for b in t:
            kv.release_block(b)
        kv.assert_idle("after adopt teardown")
        return [t, list(ext)]
    _both(run)


def test_adopt_refuses_dead_or_short_chains():
    def run(side):
        kv = _kv(side)
        t = kv.alloc_sequence(1, 16)
        with pytest.raises(ValueError):
            kv.adopt_sequence(2, t, 17)  # 2 blocks cannot cover 17
        with pytest.raises(KeyError):
            kv.adopt_sequence(2, [t[0], 40], 16)  # block 40 is not live
        with pytest.raises(ValueError):
            kv.adopt_sequence(1, t, 16)  # sequence 1 has a table
        kv.free_sequence(1)
        kv.assert_idle()
        return t
    _both(run)


def test_cow_block_splits_shared_then_passes_through():
    def run(side):
        kv = _kv(side)
        copies = []
        kv._cow_copy_fn = lambda dst, src: copies.append((dst, src))
        t = kv.alloc_sequence(1, 16)
        kv.fork_sequence(1, 2)  # both tables share both blocks
        new = kv.cow_block(2, 0)
        assert new != t[0] and copies == [(new, t[0])]
        assert kv.block_ref(t[0]) == 1 and kv.block_ref(new) == 1
        assert list(kv.block_table(2)) == [new, t[1]]
        assert kv.block_ref(t[1]) == 2  # index 1 untouched, still shared
        # sole owner now: passthrough, no second device copy
        assert kv.cow_block(2, 0) == new and len(copies) == 1
        kv.free_sequence(1)
        kv.free_sequence(2)
        kv.assert_idle("after cow teardown")
        return [t, new, copies]
    _both(run)


def test_ensure_writable_maps_position_to_block():
    def run(side):
        kv = _kv(side)
        t = kv.alloc_sequence(1, 24)
        kv.fork_sequence(1, 2)
        copies = []
        kv._cow_copy_fn = lambda dst, src: copies.append((dst, src))
        got = kv.ensure_writable(2, 8)  # position 8 -> block index 1
        assert copies == [(got, t[1])]
        kv.free_sequence(1)
        kv.free_sequence(2)
        kv.assert_idle()
        return [t, got]
    _both(run)


def test_assert_writable_catches_shared_write_ranges():
    def run(side):
        kv = _kv(side)
        kv._cow_copy_fn = lambda dst, src: None
        t = kv.alloc_sequence(1, 16)
        kv.fork_sequence(1, 2)
        with pytest.raises(AssertionError, match="cow violation"):
            kv.assert_writable(t, 0, 16)
        kv.cow_block(2, 0)
        # block index 1 is still shared: writing there must still trip
        with pytest.raises(AssertionError, match="cow violation"):
            kv.assert_writable(kv.block_table(2), 8, 16)
        kv.assert_writable(kv.block_table(2), 0, 8)  # split block: fine
        table = list(kv.block_table(2))
        kv.free_sequence(1)
        kv.free_sequence(2)
        kv.assert_idle()
        return table
    _both(run)


@pytest.mark.parametrize("seed", [0, 1])
def test_cow_page_copy_equals_the_jax_copy(seed):
    """The device page copy itself (no hook): a split block's slots in
    every layer of both pools equal the source's, on numpy-seeded pools,
    bit for bit against the JAX ``.at[].set`` copy; nothing else moves."""
    import jax.numpy as jnp

    layers, bs, nb, d = 3, 8, 16, 12
    rng = np.random.RandomState(seed)
    k = rng.standard_normal((layers, (nb + 1) * bs, d)).astype(np.float32)
    v = rng.standard_normal((layers, (nb + 1) * bs, d)).astype(np.float32)
    out = {}
    for side in SIDES:
        kv = _kv(side, num_blocks=nb, block_size=bs, layers=layers,
                 kv_dim=d)
        if side == "jax":
            kv.update_pools(jnp.asarray(k), jnp.asarray(v))
        else:
            kv.k_pool.copy_(torch.from_numpy(k))
            kv.v_pool.copy_(torch.from_numpy(v))
        t = kv.alloc_sequence(1, 3 * bs)
        kv.fork_sequence(1, 2)
        new = kv.ensure_writable(2, bs + 3)  # block index 1 splits
        out[side] = (new, t, np.asarray(kv.k_pool), np.asarray(kv.v_pool))
        kv.free_sequence(1)
        kv.free_sequence(2)
        kv.assert_idle()
    (jn, jt, jk, jv), (pn, pt, pk, pv) = out["jax"], out["port"]
    assert (pn, pt) == (jn, jt)
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_array_equal(pv, jv)
    src, dst = jt[1] * bs, jn * bs
    np.testing.assert_array_equal(pk[:, dst:dst + bs], k[:, src:src + bs])
    np.testing.assert_array_equal(pv[:, dst:dst + bs], v[:, src:src + bs])
    rest = np.ones(k.shape[1], bool)
    rest[dst:dst + bs] = False
    np.testing.assert_array_equal(pk[:, rest], k[:, rest])


def test_snapshot_counts_cached_blocks_and_splits():
    kv = _kv("port")
    kv._cow_copy_fn = lambda dst, src: None
    t = kv.alloc_sequence(1, 16)
    kv.retain_block(t[0])
    kv.fork_sequence(1, 2)
    kv.cow_block(2, 1)
    snap = kv.snapshot()
    assert (snap["blocks_cached"], snap["cow_splits"],
            snap["blocks_used"]) == (1, 1, 3)
    assert kv.used_ratio() == 3 / 64
    kv.free_sequence(1)
    kv.free_sequence(2)
    kv.release_block(t[0])
    kv.assert_idle()


# ------------------------------------------------------------- radix tree
def _commit_chain(kv, tree, seq_id, tokens):
    """The engine's completion path in miniature: alloc a sequence whose
    K/V is considered fully written, commit its full blocks into the
    tree, then free the sequence (tree holds survive)."""
    kv.alloc_sequence(seq_id, len(tokens))
    inserted = tree.commit(seq_id, tokens, len(tokens))
    kv.free_sequence(seq_id)
    return inserted


def _tree(side, num_blocks=64, block_size=8):
    kv = _kv(side, num_blocks=num_blocks, block_size=block_size)
    return kv, SIDES[side].Tree(kv)


def test_commit_then_match_is_block_aligned_and_proper():
    def run(side):
        kv, tree = _tree(side)
        toks = list(range(1, 21))  # 20 tokens: exactly 2 full blocks
        assert _commit_chain(kv, tree, 1, toks) == 2
        assert kv.used_blocks == 2  # the chain outlives its sequence
        rec = [tree.match_len(toks), tree.match_len(toks[:17]),
               tree.match_len(toks[:16]), tree.match_len(range(100, 120))]
        # a 16-token prompt may only match 8: one suffix token must run
        assert rec == [16, 16, 8, 0]
        tree.clear()
        kv.assert_idle("after clear")
        return rec
    _both(run)


def test_fork_adopts_the_chain_and_counts_hits():
    def run(side):
        kv, tree = _tree(side)
        toks = list(range(1, 25))  # 3 blocks
        _commit_chain(kv, tree, 1, toks)
        assert tree.fork(2, toks + [99]) == 24
        table = list(kv.block_table(2))
        assert len(table) == 3  # the whole chain, no copies
        snap = tree.snapshot()
        assert snap["hit_seqs"] == 1 and snap["hit_blocks"] == 3
        assert snap["hit_tokens"] == 24 and snap["hit_ratio"] == 1.0
        assert tree.fork(3, [7] * 9) == 0  # miss: caller allocates cold
        assert tree.snapshot()["miss_seqs"] == 1
        kv.free_sequence(2)
        tree.clear()
        kv.assert_idle()
        return [table, snap, tree.snapshot()]
    _both(run)


def test_insert_or_share_keeps_the_trees_block():
    def run(side):
        kv, tree = _tree(side)
        toks = list(range(1, 17))
        _commit_chain(kv, tree, 1, toks)
        used = kv.used_blocks
        # a duplicate commit inserts nothing: the committer's blocks
        # free with its sequence, the tree keeps ITS copies
        kv.alloc_sequence(2, 16)
        assert tree.commit(2, toks, 16) == 0
        kv.free_sequence(2)
        assert kv.used_blocks == used
        tree.clear()
        kv.assert_idle()
        return used
    _both(run)


def test_divergent_prompts_share_the_common_prefix():
    def run(side):
        kv, tree = _tree(side)
        a = list(range(1, 17))
        b = a[:8] + [50 + i for i in range(8)]
        _commit_chain(kv, tree, 1, a)
        assert _commit_chain(kv, tree, 2, b) == 1  # first block shared
        assert kv.used_blocks == 3
        assert tree.match_len(a + [0]) == 16
        assert tree.match_len(b + [0]) == 16
        tree.clear()
        kv.assert_idle()
        return tree.snapshot()
    _both(run)


def test_partial_last_block_never_commits():
    def run(side):
        kv, tree = _tree(side)
        toks = list(range(1, 21))  # 20 tokens but only 17 valid
        kv.alloc_sequence(1, 20)
        # valid_len 17: block 2 (tokens 16..19) is partially written
        assert tree.commit(1, toks, 17) == 2
        kv.free_sequence(1)
        assert kv.used_blocks == 2
        tree.clear()
        kv.assert_idle()
        return tree.snapshot()
    _both(run)


def test_eviction_is_lru_over_sole_owner_leaves():
    def run(side):
        kv, tree = _tree(side)
        a, b, c = (list(range(s, s + 8)) for s in (1, 11, 21))
        for sid, toks in ((1, a), (2, b), (3, c)):
            _commit_chain(kv, tree, sid, toks)
        # touch a and c (fork + drop), leaving b least-recently used
        for sid, toks in ((4, a), (5, c)):
            assert tree.fork(sid, toks + [0]) == 8
            kv.free_sequence(sid)
        with tree._lock:
            assert tree._evict_locked(1) == 1
        assert tree.match_len(b + [0]) == 0  # b went first
        assert tree.match_len(a + [0]) == 8
        assert tree.match_len(c + [0]) == 8
        tree.clear()
        kv.assert_idle()
        return tree.snapshot()
    _both(run)


def test_shared_chains_are_never_evicted():
    def run(side):
        kv, tree = _tree(side)
        a = list(range(1, 9))
        _commit_chain(kv, tree, 1, a + [0])
        assert tree.fork(2, a + [0]) == 8  # a live sequence shares it
        with tree._lock:
            assert tree._evict_locked(10) == 0  # refcount 2: untouchable
        kv.free_sequence(2)
        with tree._lock:
            assert tree._evict_locked(10) == 1  # sole owner again
        kv.assert_idle("after final evict")
        return tree.snapshot()
    _both(run)


def test_evict_for_admission_frees_exactly_enough():
    def run(side):
        kv, tree = _tree(side, num_blocks=8)  # block 0 scratch: 7 usable
        chains = [list(range(10 * i + 1, 10 * i + 9)) for i in range(3)]
        for sid, toks in enumerate(chains, start=1):
            _commit_chain(kv, tree, sid, toks)
        assert kv.used_blocks == 3
        assert not kv.can_admit(48)  # 6 blocks > the 5 free
        assert tree.evict_for_admission(48) is True
        assert kv.used_blocks == 2  # gave back exactly one LRU chain
        assert kv.can_admit(48)
        # more than eviction can ever provide fails cleanly
        assert tree.evict_for_admission(9 * 8) is False
        tree.clear()
        kv.assert_idle()
        return tree.snapshot()
    _both(run)


def test_commit_trims_back_under_the_watermark():
    def run(side):
        flags = SIDES[side].flags
        kv, tree = _tree(side, num_blocks=8)
        old = flags.get("serving_prefix_evict_watermark")
        try:
            # 8-block pool, 0.25 watermark: at most 2 blocks may stay
            flags.set_flag("serving_prefix_evict_watermark", "0.25")
            for sid in range(1, 5):
                toks = list(range(100 * sid, 100 * sid + 8))
                _commit_chain(kv, tree, sid, toks)
            assert kv.used_ratio() <= 0.25
            snap = tree.snapshot()
            assert snap["evicted_blocks"] > 0
        finally:
            flags.set_flag("serving_prefix_evict_watermark", str(old))
        tree.clear()
        kv.assert_idle()
        return snap
    _both(run)


def test_kill_switch_flag_bypasses_the_tree():
    def run(side):
        flags = SIDES[side].flags
        kv, tree = _tree(side)
        toks = list(range(1, 17))
        old = flags.get("serving_prefix_cache_enabled")
        try:
            flags.set_flag("serving_prefix_cache_enabled", False)
            kv.alloc_sequence(1, 16)
            assert tree.commit(1, toks, 16) == 0
            kv.free_sequence(1)
            assert tree.fork(2, toks + [0]) == 0
            snap = tree.snapshot()
            assert snap["enabled"] is False
            kv.assert_idle("disabled tree takes no holds")
        finally:
            flags.set_flag("serving_prefix_cache_enabled", old)
        return snap
    _both(run)


def test_evict_fault_point_is_registered():
    points = {p["point"] for p in port_fault.snapshot()}
    assert "serving.prefix.evict" in points


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_operation_stream_matches_jax(seed):
    """A numpy-seeded stream of commits, forks (hit or miss), frees,
    evictions and admission releases over a small alphabet (so prompts
    share prefixes) on both packages: every return value, block table and
    snapshot equal after every operation, the armed ledger auditing each
    mutation."""
    rng = np.random.RandomState(seed)
    ops = []
    for _ in range(120):
        kind = rng.choice(["commit", "fork", "free", "evict", "admit"],
                          p=[0.35, 0.35, 0.15, 0.1, 0.05])
        ops.append((kind, [int(t) for t in rng.randint(
            1, 4, size=int(rng.randint(1, 40)))], int(rng.randint(1, 6))))

    def run(side):
        kv, tree = _tree(side, num_blocks=48, block_size=4)
        live, trace, sid = [], [], 0
        for kind, toks, n in ops:
            if kind == "commit":
                sid += 1
                if not kv.can_admit(len(toks)):
                    trace.append("full")
                    continue
                got = _commit_chain(kv, tree, sid, toks)
            elif kind == "fork":
                sid += 1
                got = tree.fork(sid, toks)
                if got:
                    live.append(sid)
                    got = (got, list(kv.block_table(sid)))
            elif kind == "free":
                got = kv.free_sequence(live.pop(0)) if live else None
            elif kind == "evict":
                with tree._lock:
                    got = tree._evict_locked(n)
            else:
                got = tree.evict_for_admission(n * 16)
            trace.append((got, tree.snapshot(), kv.used_blocks,
                          kv.cache_held_blocks()))
        for s in live:
            kv.free_sequence(s)
        tree.clear()
        kv.assert_idle("after the operation stream")
        return trace
    trace = _both(run)
    assert any(t != "full" and t[1]["hit_seqs"] for t in trace)


# --------------------------------------------------- prefix-hash routing
def test_route_key_none_below_one_block_plus_suffix():
    assert prefix_route_key(list(range(16)), 16) is None
    assert prefix_route_key(list(range(17)), 16) is not None


def test_route_key_depends_only_on_the_first_block():
    a = list(range(1, 40))
    b = a[:16] + [9] * 30
    assert prefix_route_key(a, 16) == prefix_route_key(b, 16)
    c = [2] + a[1:]
    assert prefix_route_key(c, 16) != prefix_route_key(a, 16)


@pytest.mark.parametrize("seed", [0, 1])
def test_route_key_equals_the_jax_key(seed):
    rng = np.random.RandomState(seed)
    for _ in range(50):
        toks = rng.randint(0, 1 << 31, size=int(rng.randint(1, 60)))
        bs = int(rng.choice([4, 8, 16]))
        assert prefix_route_key(toks, bs) == jax_route_key(toks, bs)


def test_single_pool_tree_routes_nowhere():
    kv, tree = _tree("port")
    assert tree.route_shard(list(range(40))) is None


# --------------------------------------------------------- engine wiring
def test_stub_models_get_no_prefix_cache():
    # no prefill_suffix on the model: the engine must not auto-build
    model = types.SimpleNamespace(
        config=types.SimpleNamespace(max_context=4096))
    eng = ServingEngine(model, _kv("port"), EngineConfig())
    assert eng.prefix is None


def test_build_prefix_cache_over_a_single_pool():
    assert isinstance(build_prefix_cache(_kv("port")), PrefixCache)


def test_thrash_watch_rule_installed_with_reloadable_bound():
    from brpc_tpu_torch.metrics.watch import (KIND_RATE, global_watch,
                                              install_default_rules)

    install_default_rules()
    rules = {r.name: r for r in global_watch().rules()}
    rule = rules.get("serving_prefix_thrash")
    assert rule is not None, sorted(rules)
    assert rule.var == "g_serving_prefix_evicted_blocks"
    assert rule.kind == KIND_RATE
    assert rule.bound() == port_flags.get("serving_prefix_thrash_rate")
    old = port_flags.get("serving_prefix_thrash_rate")
    try:
        port_flags.set_flag("serving_prefix_thrash_rate", "5")
        assert rule.bound() == 5.0
    finally:
        port_flags.set_flag("serving_prefix_thrash_rate", str(old))


def test_prefix_variables_are_exposed():
    from brpc_tpu_torch.metrics import variable
    from brpc_tpu_torch.serving import prefix_cache

    for name in ("g_serving_prefix_hit_seqs", "g_serving_prefix_hit_blocks",
                 "g_serving_prefix_hit_tokens", "g_serving_prefix_miss_seqs",
                 "g_serving_prefix_inserted_blocks",
                 "g_serving_prefix_evicted_blocks",
                 "g_serving_prefix_hit_ratio"):
        assert variable.get_exposed(name) is not None, name
    before = prefix_cache.g_serving_prefix_hit_seqs.get_value()
    kv, tree = _tree("port")
    _commit_chain(kv, tree, 1, list(range(1, 17)))
    assert tree.fork(2, list(range(1, 18))) == 16
    assert prefix_cache.g_serving_prefix_hit_seqs.get_value() == before + 1
    assert 0 < prefix_cache.g_serving_prefix_hit_ratio.get_value() <= 1
    kv.free_sequence(2)
    tree.clear()
    kv.assert_idle()


# ------------------------------------------------- real model: the oracle
MODEL_CFG = dict(vocab=256, d_model=32, n_heads=2, n_layers=2)


@pytest.fixture(scope="module")
def stacks():
    """The JAX model and the port's (the JAX weights carried across), each
    over an armed pool; engines are per run."""
    jcfg = JaxModelConfig(**MODEL_CFG)
    jkv = JaxKV(JaxKVConfig(block_size=16, num_blocks=256),
                jcfg.n_layers, jcfg.kv_dim)
    jkv._check = True
    jmodel = JaxModel(jcfg, jkv)
    cfg = ModelConfig(seed=5, **MODEL_CFG)
    kv = PagedKVCache(KVCacheConfig(block_size=16, num_blocks=256),
                      cfg.n_layers, cfg.kv_dim, device="cpu")
    kv._check = True  # armed ledger throughout
    model = TinyTransformer(cfg, kv)
    model.load_params(params_from_jax(
        {k: np.asarray(v) for k, v in jmodel._params.items()}, "cpu"))
    yield {"jax": (jmodel, jkv, JaxEngine, JaxEngineConfig),
           "port": (model, kv, ServingEngine, EngineConfig)}
    jmodel.close()
    model.close()


def _run_schedule(stack, schedule, prefix_cache=None):
    """Drive one engine through the schedule, every request submitted
    under the engine's lock (so admission sees them all at once); returns
    (token lists in submit order, final engine snapshot)."""
    model, kv, engine_cls, config_cls = stack
    engine = engine_cls(model, kv, config_cls(
        max_batch=8, token_budget=512, idle_wait_s=0.002),
        prefix_cache=prefix_cache).start()
    try:
        evs, seqs = [], []
        with engine._cv:
            for plen, max_new in schedule:
                ev = threading.Event()
                code, seq = engine.submit(model.synth_prompt(plen), max_new,
                                          done=lambda _r, ev=ev: ev.set())
                assert code == 0, f"submit rejected: {code}"
                evs.append(ev)
                seqs.append(seq)
        for ev in evs:
            assert ev.wait(300), "schedule run stalled"
        return [list(s.out_tokens) for s in seqs], engine.snapshot()
    finally:
        engine.stop()


@pytest.fixture(scope="module")
def cold_reference(stacks):
    """The port's cold outputs on the corpus schedule, prefix cache off."""
    out, snap = _run_schedule(stacks["port"], SCHEDULE, prefix_cache=False)
    assert snap["prefix"] is None
    stacks["port"][1].assert_idle("cold reference teardown")
    return out


def test_warm_outputs_equal_cold_and_the_jax_engine(stacks, cold_reference):
    """The fork oracle: with the cache on by default, generations that
    fork cached chains equal the cold run's and the JAX engine's, list
    for list, and the prefix counters equal the JAX engine's."""
    warm, snap = _run_schedule(stacks["port"], SCHEDULE * 2)
    jwarm, jsnap = _run_schedule(stacks["jax"], SCHEDULE * 2)
    assert warm == cold_reference * 2
    assert warm == jwarm
    assert snap["prefix"] == jsnap["prefix"]
    pfx = snap["prefix"]
    assert pfx["hit_seqs"] > 0 and pfx["hit_blocks"] > 0, pfx
    assert pfx["inserted_blocks"] > 0
    assert 0 < pfx["hit_ratio"] <= 1
    assert snap["prefill_tokens"] == sum(p for p, _ in SCHEDULE * 2) \
        - pfx["hit_tokens"]
    stacks["port"][1].assert_idle("oracle teardown")  # stop() cleared it
    stacks["jax"][1].assert_idle("JAX oracle teardown")


def test_hits_run_the_suffix_through_one_decode_launch(stacks,
                                                       cold_reference):
    """A hit's prefill is one decode-shaped launch and one host sync (the
    (1, 1) contract of ``decode_step``), and the pool holds the same K/V
    for the hit's suffix as a cold prefill writes (atol 1e-5)."""
    from brpc_tpu_torch.tpu.device_lane import step_dispatch

    model, kv, _, _ = stacks["port"]
    prompt = model.synth_prompt(40)
    cold = kv.alloc_sequence(1, 40)
    first = model.prefill(prompt, cold)
    tree = PrefixCache(kv)
    assert tree.commit(1, list(prompt), 40) == 2
    assert tree.fork(2, list(prompt)) == 32
    table = kv.extend_sequence(2, 40)
    before = step_dispatch.snapshot()
    got = model.prefill_suffix(prompt, table, 32)
    launches, _, syncs = step_dispatch.delta(before,
                                             step_dispatch.snapshot())
    assert (launches, syncs) == (1, 1)
    assert got == first
    bs = 16
    for pool in (kv.k_pool, kv.v_pool):
        np.testing.assert_allclose(
            pool[:, table[2] * bs:table[2] * bs + 8].numpy(),
            pool[:, cold[2] * bs:cold[2] * bs + 8].numpy(),
            atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        model.prefill_suffix(prompt, table, 40)
    kv.free_sequence(1)
    kv.free_sequence(2)
    tree.clear()
    kv.assert_idle()


def test_admission_counts_only_the_suffix(stacks):
    """Admission charges a hit's step budget and watermark demand for its
    suffix only: a warm 32-token prompt costs 16 prefill tokens."""
    model, kv, _, _ = stacks["port"]
    engine = ServingEngine(model, kv, EngineConfig(
        max_batch=8, token_budget=512, idle_wait_s=0.002))
    from brpc_tpu_torch.serving.engine import Sequence

    seq = Sequence(model.synth_prompt(32), 4)
    assert engine._prefill_cost(seq) == 32
    kv.alloc_sequence(99, 32)
    engine.prefix.commit(99, list(model.synth_prompt(32)), 32)
    kv.free_sequence(99)
    assert engine._prefill_cost(seq) == 16
    engine._alloc_for(seq)
    assert seq.prefix_len == 16 and engine._prefill_cost(seq) == 16
    kv.free_sequence(seq.seq_id)
    engine.prefix.clear()
    kv.assert_idle()


def _page_run(stack, page, schedule):
    """Drive one engine of ``stack`` through ``schedule`` at the
    reference's builtin-case settings and read ``page`` (that package's
    ``serving_service``) while the engine still runs: (the JSON view's
    last engine, the text view)."""
    import json as _json

    model, kv, engine_cls, config_cls = stack
    engine = engine_cls(model, kv, config_cls(
        max_batch=8, token_budget=512, idle_wait_s=0.002)).start()
    try:
        evs = []
        for plen, max_new in schedule:
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


def test_serving_builtin_reports_the_prefix_section(stacks):
    """The reference's ``/serving`` case on the port's page: the prefix
    section in the JSON view and the text view, its counts and its line
    equal to the JAX package's page after the same run."""
    from brpc_tpu.builtin.services import serving_service as jax_page
    from brpc_tpu_torch.builtin.services import serving_service

    snap, text = _page_run(stacks["port"], serving_service, SCHEDULE[:4])
    assert snap["prefix"]["enabled"]
    assert snap["prefix"]["inserted_blocks"] > 0
    assert snap["kv"]["blocks_cached"] > 0
    assert "prefix: nodes=" in text and "hit_ratio=" in text
    stacks["port"][1].assert_idle("builtin teardown")
    jsnap, jtext = _page_run(stacks["jax"], jax_page, SCHEDULE[:4])
    stacks["jax"][1].assert_idle("JAX builtin teardown")
    assert snap["prefix"] == jsnap["prefix"]

    def prefix_line(page):
        return [line for line in page.splitlines()
                if line.strip().startswith("prefix:")][-1]

    assert prefix_line(text) == prefix_line(jtext)


# ------------------------------------------------------------------ chaos
@pytest.fixture()
def fault_enabled():
    port_flags.set_flag("fault_injection_enabled", True)
    yield
    port_fault.disarm_all()
    port_flags.set_flag("fault_injection_enabled", False)


def test_eviction_churn_keeps_outputs_and_pool_whole(stacks, cold_reference,
                                                     fault_enabled):
    """Every admission force-evicts radix chains (serving.prefix.evict
    armed always) while the corpus schedule runs warm: outputs equal the
    cold run's, the armed ledger's audits hold throughout, and after
    stop() the pool is whole, no leaked block and no lingering hold."""
    port_fault.arm("serving.prefix.evict", mode="always", blocks=2)
    try:
        churned, snap = _run_schedule(stacks["port"], SCHEDULE * 2)
    finally:
        port_fault.disarm_all()
    assert churned == cold_reference * 2
    assert snap["prefix"]["evicted_blocks"] > 0, snap["prefix"]
    stacks["port"][1].assert_idle("post eviction churn")
