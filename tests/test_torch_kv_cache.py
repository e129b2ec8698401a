"""Port paged KV ledger (brpc_tpu_torch.serving.kv_cache) against the
JAX package's single-device PagedKVCache: the same alloc / extend /
truncate / free / watermark sequence gives equal block tables, free
counts, refusals and teardown audits. Exact equality: the ledger is
integer bookkeeping."""

import numpy as np
import pytest
import torch

from brpc_tpu.serving.kv_cache import KVCacheConfig as JaxKVConfig
from brpc_tpu.serving.kv_cache import KVCacheFull as JaxKVFull
from brpc_tpu.serving.kv_cache import PagedKVCache as JaxKV
from brpc_tpu_torch.serving.kv_cache import (KVCacheConfig, KVCacheFull,
                                             PagedKVCache)
from brpc_tpu_torch.tpu.device_lane import DeviceStore


def _pair(num_blocks=12, block_size=4, watermark=0.75, layers=2, kv_dim=8):
    jkv = JaxKV(JaxKVConfig(block_size, num_blocks, watermark), layers,
                kv_dim)
    tkv = PagedKVCache(KVCacheConfig(block_size, num_blocks, watermark),
                       layers, kv_dim, device="cpu")
    jkv._check = tkv._check = True
    return jkv, tkv


def _apply(kv, full_exc, op, *args):
    """Run one ledger op; a refusal comes back as the string "full"."""
    try:
        return getattr(kv, op)(*args)
    except full_exc:
        return "full"
    except KeyError:
        return "unknown"


@pytest.mark.parametrize("seed", range(6))
def test_random_op_sequences_match(seed):
    rng = np.random.RandomState(seed)
    jkv, tkv = _pair()
    lens = {}
    for _ in range(60):
        choice = rng.randint(5)
        sid = int(rng.randint(1, 7))
        if choice == 0 and sid not in lens:
            n = int(rng.randint(1, 20))
            args = ("alloc_sequence", sid, n)
        elif choice == 1 and sid in lens:
            n = lens[sid] + int(rng.randint(1, 9))
            args = ("extend_sequence", sid, n)
        elif choice == 2 and sid in lens:
            n = max(1, lens[sid] - int(rng.randint(0, 9)))
            args = ("truncate_sequence", sid, n)
        elif choice == 3:
            args = ("free_sequence", sid)
        else:
            n = int(rng.randint(1, 40))
            assert jkv.can_admit(n) == tkv.can_admit(n)
            continue
        got_j = _apply(jkv, JaxKVFull, *args)
        got_t = _apply(tkv, KVCacheFull, *args)
        assert got_j == got_t, args
        if args[0] == "free_sequence":
            lens.pop(sid, None)
        elif got_t not in ("full", "unknown"):
            lens[sid] = args[2]
        assert jkv.free_blocks == tkv.free_blocks
        assert jkv.used_blocks == tkv.used_blocks
        for s in range(1, 7):
            assert jkv.block_table(s) == tkv.block_table(s)
            assert jkv.seq_len(s) == tkv.seq_len(s)
    assert jkv.live_sequences() == tkv.live_sequences()
    for s in list(lens):
        assert jkv.free_sequence(s) == tkv.free_sequence(s)
    jkv.assert_idle("jax")
    tkv.assert_idle("torch")


def test_watermark_admission_matches():
    jkv, tkv = _pair(num_blocks=10, block_size=4, watermark=0.5)
    for n in range(1, 30):
        assert jkv.can_admit(n) == tkv.can_admit(n), n
    jkv.alloc_sequence(1, 12)
    tkv.alloc_sequence(1, 12)
    for n in range(1, 30):
        assert jkv.can_admit(n) == tkv.can_admit(n), n
    tkv.note_rejected()
    assert tkv.snapshot()["admission_rejects"] == 1


def test_leak_is_named_by_assert_idle():
    jkv, tkv = _pair()
    jkv.alloc_sequence(3, 9)
    tkv.alloc_sequence(3, 9)
    for kv in (jkv, tkv):
        with pytest.raises(AssertionError, match="still live"):
            kv.assert_idle("leak")


def test_corrupted_ledger_is_caught_by_the_audit():
    _, tkv = _pair()
    tkv.alloc_sequence(1, 8)
    tkv._ref[tkv.block_table(1)[0]] = 2  # forge a second holder
    with pytest.raises(AssertionError, match="ledger violation"):
        tkv.alloc_sequence(2, 4)


def test_write_guard_rejects_a_shared_block():
    _, tkv = _pair()
    table = tkv.alloc_sequence(1, 8)
    tkv.assert_writable(table, 0, 8)
    tkv.assert_writable_batch([table], [7])
    tkv._ref[table[1]] = 2
    with pytest.raises(AssertionError, match="cow violation"):
        tkv.assert_writable_batch([table], [5])


def test_pools_live_in_the_store_under_stable_handles():
    store = DeviceStore("cpu")
    kv = PagedKVCache(KVCacheConfig(block_size=4, num_blocks=6), layers=3,
                      kv_dim=8, store=store)
    assert tuple(kv.k_pool.shape) == (3, 7 * 4, 8)
    assert kv.k_pool.dtype == torch.float32
    assert store.lookup(kv.k_handle) is kv.k_pool
    assert store.stats()[:2] == (2, 2 * 3 * 28 * 8 * 4)
    k2 = kv.k_pool.clone()
    kv.update_pools(k2, kv.v_pool)
    assert store.lookup(kv.k_handle) is k2
    kv.close()
    assert store.stats()[:2] == (0, 0)


def test_store_put_get_roundtrip_and_fence():
    store = DeviceStore("cpu")
    data = bytes(range(256)) * 3
    h, n = store.put(data)
    assert n == len(data) and store.get(h) == data
    store.fence()
    assert store.free(h) and store.get(h) is None and not store.free(h)
