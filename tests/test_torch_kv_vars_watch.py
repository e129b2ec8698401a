"""The two repairs the port's fleet plane needs, against the JAX package.

The five serving KV variables (``g_serving_kv_block_allocs``,
``g_serving_kv_block_frees``, ``g_serving_kv_admission_rejects`` and the
gauges ``g_serving_kv_blocks_total`` / ``g_serving_kv_blocks_used``) are
exported by the port and move exactly as the reference's: the same
numpy-seeded ledger operations (alloc, extend, truncate, fork, the prefix
cache's holds, copy-on-write, free, refusals) give equal deltas in both
packages, on a single pool and on a sharded one (whose gauges sum over
every shard's ledger); an engine's ``serving.kv.exhaust`` refusals count
as the reference's test counts them; and a port serving server's /vars
lists all five. ``install_default_rules()`` gives the same 10 rules, rule
for rule, in both packages.
"""

import contextlib
import gc
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from brpc_tpu.serving import kv_cache as jax_kv
from brpc_tpu_torch.serving import kv_cache as port_kv
from brpc_tpu_torch.tpu import mesh as port_mesh

COUNTERS = ("g_serving_kv_block_allocs", "g_serving_kv_block_frees",
            "g_serving_kv_admission_rejects")
GAUGES = ("g_serving_kv_blocks_total", "g_serving_kv_blocks_used")
NAMES = COUNTERS + GAUGES
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_collection():
    """The gauges sum over every live cache of the process: keep a cycle
    collection from dropping another test's cache mid-window. And leave no
    watch rule of either package firing (rejects fire
    serving_kv_exhaustion)."""
    with quiet_watches():
        gc.collect()
        gc.disable()
        try:
            yield
        finally:
            gc.enable()


def _quiet_new_firing(packages, before):
    """Put back to no-data every watch rule that was not firing before the
    test, in each of ``packages`` ((watch module, series module) pairs),
    and drop its variable's series so the next tick starts from the
    current value: a rule the test's counters would make fire (now, or at
    a tick after the test) stays quiet, and a later test on this worker
    inherits no firing rule."""
    for (watch_mod, series_mod), was in zip(packages, before):
        gs = series_mod.global_series()
        for rule in watch_mod.global_watch().rules():
            if rule.name not in was:
                with gs._lock:
                    gs._series.pop(rule.var, None)
                rule.state = watch_mod.STATE_NO_DATA
                rule.true_streak = rule.false_streak = 0


def _firing(packages):
    return [{r.name for r in w.global_watch().firing()} for w, _ in packages]


@contextlib.contextmanager
def quiet_watches():
    """Around a test: afterwards every watch rule of either package that
    was not firing before is back at no-data, its series dropped (the
    JAX package's tail retention keeps every call while a rule fires, so
    a rule left firing changes later tests on the worker)."""
    from brpc_tpu.metrics import series as jax_series
    from brpc_tpu.metrics import watch as jax_watch
    from brpc_tpu_torch.metrics import series, watch

    packages = [(jax_watch, jax_series), (watch, series)]
    firing = _firing(packages)
    try:
        yield
    finally:
        _quiet_new_firing(packages, firing)


def _read(mod):
    return {n: getattr(mod, n).get_value() for n in NAMES}


def _delta(before, after):
    return {n: after[n] - before[n] for n in NAMES}


def _apply(kv, full_exc, op, *args):
    try:
        return getattr(kv, op)(*args)
    except full_exc:
        return "full"
    except (KeyError, ValueError, IndexError):
        return "refused"


def _ops(seed, n=80):
    """A seeded op list over sequence ids 1..6 (the same for both
    packages; ops a ledger refuses are refused by both)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        sid = int(rng.integers(1, 7))
        k = int(rng.integers(0, 9))
        if k == 0:
            out.append(("alloc_sequence", sid, int(rng.integers(1, 40))))
        elif k == 1:
            out.append(("extend_sequence", sid, int(rng.integers(1, 60))))
        elif k == 2:
            out.append(("truncate_sequence", sid, int(rng.integers(1, 30))))
        elif k == 3:
            out.append(("fork_sequence", sid, int(rng.integers(7, 12))))
        elif k == 4:
            out.append(("cow_block", sid, int(rng.integers(0, 3))))
        elif k == 5:
            out.append(("hold", sid))
        elif k == 6:
            out.append(("note_rejected",))
        else:
            out.append(("free_sequence", sid))
    return out + [("free_sequence", s) for s in range(1, 12)] + [("drop",)]


def _run(kv, full_exc, ops, held):
    """Apply ``ops``; ``held`` carries the prefix-cache holds taken, which
    the closing "drop" releases."""
    results = []
    for op in ops:
        if op[0] == "hold":
            table = _apply(kv, full_exc, "block_table", op[1])
            if table:
                kv.retain_block(table[0])
                held.append(table[0])
            results.append(bool(table))
        elif op[0] == "drop":
            while held:
                kv.release_block(held.pop())
        else:
            r = _apply(kv, full_exc, *op)
            results.append(list(r) if isinstance(r, list) else r)
    return results


@pytest.mark.parametrize("seed", range(6))
def test_single_pool_deltas_equal_the_reference(seed):
    cfg = dict(block_size=4, num_blocks=24, watermark=0.9)
    before = (_read(jax_kv), _read(port_kv))
    jkv = jax_kv.PagedKVCache(jax_kv.KVCacheConfig(**cfg), 2, 8)
    tkv = port_kv.PagedKVCache(port_kv.KVCacheConfig(**cfg), 2, 8,
                               device="cpu")
    try:
        made = (_read(jax_kv), _read(port_kv))
        assert _delta(before[0], made[0]) == _delta(before[1], made[1])
        assert _delta(before[1], made[1])["g_serving_kv_blocks_total"] == 24
        ops = _ops(seed)
        mid = len(ops) // 2
        holds = ([], [])
        for part in (ops[:mid], ops[mid:]):
            j0, t0 = _read(jax_kv), _read(port_kv)
            rj = _run(jkv, jax_kv.KVCacheFull, part, holds[0])
            rt = _run(tkv, port_kv.KVCacheFull, part, holds[1])
            assert rj == rt
            dj, dt = _delta(j0, _read(jax_kv)), _delta(t0, _read(port_kv))
            assert dj == dt
        assert sum(_delta(made[1], _read(port_kv))[n]
                   for n in COUNTERS) > 0
        tkv.assert_idle("after the seeded ops")
    finally:
        jkv.close()
        tkv.close()


@pytest.fixture()
def cpu_mesh():
    port_mesh.use_cpu(8)
    try:
        yield
    finally:
        port_mesh.use_cpu(0)


@pytest.mark.parametrize("seed", range(3))
def test_sharded_gauges_sum_every_shards_ledger(cpu_mesh, seed):
    """A ShardedKVCache counts once (its ledger-only shards are not
    double-counted): total is shards x blocks, used is the sum of the
    shards' used blocks, and the counters move as the reference's."""
    cfg = dict(block_size=16, num_blocks=32)
    before = (_read(jax_kv), _read(port_kv))
    jkv = jax_kv.ShardedKVCache(jax_kv.KVCacheConfig(**cfg), 1, 8)
    tkv = port_kv.ShardedKVCache(port_kv.KVCacheConfig(**cfg), 1, 8)
    try:
        made = (_read(jax_kv), _read(port_kv))
        dt = _delta(before[1], made[1])
        assert dt == _delta(before[0], made[0])
        assert dt["g_serving_kv_blocks_total"] == tkv.n_shards * 32
        rng = np.random.default_rng(seed)
        sids = [int(s) for s in rng.choice(np.arange(1, 400), 12,
                                           replace=False)]
        for s in sids:
            n = int(rng.integers(1, 90))
            assert _apply(jkv, jax_kv.KVCacheFull, "alloc_sequence", s, n) \
                == _apply(tkv, port_kv.KVCacheFull, "alloc_sequence", s, n)
        now = _read(port_kv)
        assert _delta(made[1], now) == _delta(made[0], _read(jax_kv))
        assert now["g_serving_kv_blocks_used"] - made[1][
            "g_serving_kv_blocks_used"] == sum(p.used_blocks
                                               for p in tkv.pools)
        for s in sids:
            jkv.free_sequence(s)
            tkv.free_sequence(s)
        assert _delta(made[1], _read(port_kv)) == \
            _delta(made[0], _read(jax_kv))
    finally:
        jkv.close()
        tkv.close()


@pytest.mark.parametrize("kind", ["paged", "sharded"])
def test_a_closed_cache_leaves_the_pool_gauges_at_once(cpu_mesh, kind):
    """``close()`` takes a cache out of the pool totals then and there:
    the cache is still referenced and no collection runs (the fixture
    disables it), yet both gauges drop by what it held."""
    cfg = port_kv.KVCacheConfig(block_size=4, num_blocks=24)
    before = _read(port_kv)
    if kind == "paged":
        kv = port_kv.PagedKVCache(cfg, 2, 8, device="cpu")
        total = 24
    else:
        kv = port_kv.ShardedKVCache(cfg, 1, 8)
        total = kv.n_shards * 24
    kv.alloc_sequence(7, 10)
    held = _read(port_kv)
    assert _delta(before, held)["g_serving_kv_blocks_total"] == total
    assert _delta(before, held)["g_serving_kv_blocks_used"] == 3
    kv.free_sequence(7)
    kv.close()
    after = _read(port_kv)
    assert after["g_serving_kv_blocks_total"] == \
        before["g_serving_kv_blocks_total"]
    assert after["g_serving_kv_blocks_used"] == \
        before["g_serving_kv_blocks_used"]
    assert kv is not None  # held to the end: no collection took it out


def test_engine_kv_exhaust_counts_rejects_as_the_reference():
    """``tests/test_serving.py``'s exhaust case on both packages' engines:
    two armed refusals answer EOVERCROWDED and add exactly 2 rejects."""
    from brpc_tpu import fault as jax_fault
    from brpc_tpu import flags as jax_flags
    from brpc_tpu_torch import errors
    from brpc_tpu_torch import fault as port_fault
    from brpc_tpu_torch import flags as port_flags
    from tests.test_serving import _stub_engine
    from tests.test_torch_engine import _port_engine

    engines = {"jax": (_stub_engine, jax_fault, jax_flags, jax_kv),
               "port": (_port_engine, port_fault, port_flags, port_kv)}
    deltas = {}
    for side, (make, fault, flags, kvmod) in engines.items():
        flags.set_flag("fault_injection_enabled", True)
        eng = make()
        try:
            before = _read(kvmod)
            fault.arm("serving.kv.exhaust", mode="always", count=2)
            for _ in range(2):
                code, _ = eng.submit(eng.model.synth_prompt(4), 2)
                assert code == errors.EOVERCROWDED, side
            deltas[side] = _delta(before, _read(kvmod))
            done = threading.Event()
            code, _ = eng.submit(eng.model.synth_prompt(4), 2,
                                 done=lambda r: done.set())
            assert code == 0 and done.wait(30), side
        finally:
            fault.disarm_all()
            flags.set_flag("fault_injection_enabled", False)
            eng.stop()
    assert deltas["port"]["g_serving_kv_admission_rejects"] == 2
    assert deltas["port"] == deltas["jax"]


def test_vars_page_of_a_serving_server_lists_the_five():
    """In a fresh process (no earlier test has touched its registry): a
    port serving server's /vars lists the five, with the pool's size."""
    code = (
        "from brpc_tpu_torch.policy.http_protocol import http_fetch\n"
        "from brpc_tpu_torch.rpc import Server\n"
        "from brpc_tpu_torch.serving import (EngineConfig, KVCacheConfig,"
        " ModelConfig, PagedKVCache, ServingEngine, TinyTransformer)\n"
        "from brpc_tpu_torch.serving.service import LlmServingService\n"
        "cfg = ModelConfig(vocab=64, d_model=16, n_heads=2, n_layers=1,"
        " attn='reference')\n"
        "kv = PagedKVCache(KVCacheConfig(16, 24), cfg.n_layers, cfg.kv_dim,"
        " device='cpu')\n"
        "eng = ServingEngine(TinyTransformer(cfg, kv), kv,"
        " EngineConfig()).start()\n"
        "srv = Server().add_service(LlmServingService(eng))"
        ".start('127.0.0.1:0')\n"
        "body = bytes(http_fetch(str(srv.listen_endpoint()), 'GET', '/vars',"
        " timeout=10.0).body).decode()\n"
        "srv.stop(); srv.join(); eng.stop()\n"
        "print(body)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    lines = dict(ln.split(" : ", 1) for ln in out.stdout.splitlines()
                 if " : " in ln)
    for name in NAMES:
        assert name in lines, name
    assert lines["g_serving_kv_blocks_total"].strip() == "24"


def _rule_tuples(watch_mod):
    watch_mod.install_default_rules()
    return sorted((r.name, r.var, r.kind, r.op, r.value, r.bound(),
                   r.window_s, r.for_ticks, r.clear_ticks)
                  for r in watch_mod.global_watch().rules()
                  if not r.name.startswith("slo_burn_"))


def test_default_rules_equal_the_references():
    from brpc_tpu.metrics import watch as jax_watch
    from brpc_tpu_torch.metrics import watch as port_watch

    port = _rule_tuples(port_watch)
    assert port == _rule_tuples(jax_watch)
    assert len(port) == 10
    names = {t[0] for t in port}
    assert {"tunnel_healer_trips", "block_pool_exhaustion",
            "shard_worker_death", "serving_kv_exhaustion"} <= names
