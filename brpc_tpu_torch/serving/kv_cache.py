"""Paged KV cache over DeviceStore handles, on torch tensors.

The port of the single-device ``PagedKVCache`` of
``brpc_tpu/serving/kv_cache.py``: the K and V pools are two device
tensors of ``num_blocks`` fixed-size blocks, shaped
``(layers, (num_blocks + 1) * block_size, kv_dim)`` fp32 and registered
in a :class:`~brpc_tpu_torch.tpu.device_lane.DeviceStore` under stable
handles. Sequences own *block tables* (host-side lists of physical block
ids) that grow on demand as decode appends tokens; allocation and free
are refcounted.

Admission is watermark-based: a new sequence is admitted only while the
pool, after its prefill blocks, stays under ``watermark`` of capacity;
the slack above is decode headroom for sequences already running.

Physical block 0 is a scratch block: padded lanes of prefill and decode
scatter there, so it is never handed out and never counted in capacity.

Sequences may share blocks: ``fork_sequence`` shares a table,
``adopt_sequence`` registers a table that IS a live chain (a prefix-cache
hit), and ``retain_block`` / ``release_block`` are the radix tree's
holds, audited apart from table holds. A write into a shared block goes
copy-on-write first (``cow_block`` / ``ensure_writable``): a fresh block,
one device page copy across every layer of both pools, and the table
entry swapped, so a shared page is never mutated.

With ``BRPC_TPU_CHECK=1`` in the environment (or ``_check = True``),
every alloc/extend/truncate/free/hold re-audits the invariants, and
:meth:`PagedKVCache.assert_idle` proves at teardown that every block came
back and that no tree hold lingers.

Migration export, as in the reference: ``quiesce_sequence`` audits the
ledger (armed or not) and marks a chain frozen, ``export_chain`` refuses
a chain without that mark, and any write (extend, truncate, copy-on-write,
free) clears it; ``release_exported`` drops the source's ownership once
the destination has adopted the chain, ``unquiesce_sequence`` aborts the
export and leaves the chain local and writable.

**Sharded mode** (:class:`ShardedKVCache`): one block pool per ``dp``
shard of the serving mesh (``tpu/mesh.py``). Each shard keeps its own
ledger-only :class:`PagedKVCache` (``device_pools=False``: free list,
refcounts, watermark, audits, per pool), while the K/V live as ONE
stacked ``(dp, layers, slots, kv_dim)`` pair on the mesh's device,
adopted once in the DeviceStore. Block tables name (shard, block) pairs:
a :class:`ShardTable` is the block-id list plus the owning shard, and a
sequence routes to its shard with the splitmix64 ``shard_for`` of the
shard plane. fork, extend and free touch only the owning shard's
ledger. Both caches hand the model the pools a table indexes
(``pool_views``) and take back the note that they were written
(``pools_written``). The migration reads and writes exactly a chain's
slots (``read_chain`` / ``write_chain``): over a mesh with a rank per
position that is one program on the shard's pool-holding rank, so a
rank-mesh engine migrates as any other does.
"""

from __future__ import annotations

import itertools
import os
import threading
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from brpc_tpu_torch.metrics.reducer import Adder
from brpc_tpu_torch.metrics.status import PassiveStatus
from brpc_tpu_torch.tpu import launch
from brpc_tpu_torch.tpu.device_lane import global_store, resolve_device


g_serving_kv_block_allocs = Adder("g_serving_kv_block_allocs")
g_serving_kv_block_frees = Adder("g_serving_kv_block_frees")
g_serving_kv_admission_rejects = Adder("g_serving_kv_admission_rejects")

_caches: "weakref.WeakSet[PagedKVCache]" = weakref.WeakSet()


def _sum_caches(attr) -> int:
    return sum(attr(c) for c in list(_caches))


g_serving_kv_blocks_total = PassiveStatus(
    lambda: _sum_caches(lambda c: c.num_blocks)) \
    .expose("g_serving_kv_blocks_total")
g_serving_kv_blocks_total.prometheus_type = "gauge"
g_serving_kv_blocks_used = PassiveStatus(
    lambda: _sum_caches(lambda c: c.used_blocks)) \
    .expose("g_serving_kv_blocks_used")
g_serving_kv_blocks_used.prometheus_type = "gauge"


class KVCacheFull(Exception):
    """Raised when the pool cannot satisfy an allocation (maps to
    EOVERCROWDED at the RPC surface)."""


class KVCacheConfig:
    def __init__(self, block_size: int = 16, num_blocks: int = 128,
                 watermark: float = 0.90):
        if block_size < 1 or num_blocks < 1:
            raise ValueError("block_size/num_blocks must be >= 1")
        if not 0.0 < watermark <= 1.0:
            raise ValueError("watermark must be in (0, 1]")
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.watermark = watermark


class PagedKVCache:
    """Block manager + the device-resident K/V pools behind it. The pools
    live on the store's device: the card unless ``device="cpu"`` (or a
    CPU store) is passed.

    ``device_pools=False`` runs ledger-only: the block, refcount,
    watermark and audit machinery with no pools of its own, how
    :class:`ShardedKVCache` gives every shard its own ledger while the
    K/V live in the stacked pools."""

    def __init__(self, config: KVCacheConfig, layers: int, kv_dim: int,
                 store=None, dtype=torch.float32, device=None,
                 device_pools: bool = True):
        self.config = config
        self.layers = layers
        self.kv_dim = kv_dim
        self._lock = threading.Lock()
        self.store = store
        self.k_pool = self.v_pool = None
        self.k_handle = self.v_handle = 0
        if device_pools:
            if store is None:
                self.store = global_store(device)
            # physical block 0 is scratch (pad scatter target): +1 below
            slots = (config.num_blocks + 1) * config.block_size
            self.k_pool = torch.zeros((layers, slots, kv_dim), dtype=dtype,
                                      device=self.store.device)
            self.v_pool = torch.zeros_like(self.k_pool)
            self.k_handle, _ = self.store.adopt(self.k_pool)
            self.v_handle, _ = self.store.adopt(self.v_pool)
        self._free: List[int] = list(range(config.num_blocks, 0, -1))
        self._ref: Dict[int, int] = {}
        self._tables: Dict[int, List[int]] = {}
        self._seq_len: Dict[int, int] = {}
        # blocks held by the prefix cache's radix tree (no table): each
        # hold contributes to _ref, audited as cache-held, not table-held
        self._cache_ref: Dict[int, int] = {}
        # the page copy cow_block runs; None is the pools' own copy
        self._cow_copy_fn = None
        # sequences audited and frozen for export (migration); any write
        # clears the mark, so export_chain only sees a chain with no
        # write since its quiesce
        self._quiesced: set = set()
        self.admission_rejects = 0
        self.cow_splits = 0
        self._check = os.environ.get("BRPC_TPU_CHECK", "") == "1"
        if device_pools:
            # ledger-only shards are accounted by their ShardedKVCache,
            # not double-counted in the fleet totals
            _caches.add(self)

    # ------------------------------------------------------------- geometry
    @property
    def device(self) -> torch.device:
        return self.store.device

    @property
    def num_blocks(self) -> int:
        return self.config.num_blocks

    @property
    def block_size(self) -> int:
        return self.config.block_size

    @property
    def used_blocks(self) -> int:
        with self._lock:
            return self.config.num_blocks - len(self._free)

    @property
    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    def used_ratio(self) -> float:
        return self.used_blocks / float(self.config.num_blocks)

    def blocks_for(self, ntokens: int) -> int:
        bs = self.config.block_size
        return max(1, (ntokens + bs - 1) // bs)

    # ------------------------------------------------------------ admission
    def can_admit(self, ntokens: int, route_key: Optional[int] = None,
                  shard: Optional[int] = None) -> bool:
        """Watermark admission: the pool after this sequence's prefill
        blocks must stay at or under ``watermark`` of capacity.
        (``route_key`` and ``shard`` are the sharded cache's; a single
        pool has nowhere else to route.)"""
        need = self.blocks_for(ntokens)
        limit = int(self.config.watermark * self.config.num_blocks)
        with self._lock:
            used = self.config.num_blocks - len(self._free)
            return used + need <= limit

    def note_rejected(self) -> None:
        with self._lock:
            self.admission_rejects += 1
        g_serving_kv_admission_rejects.put(1)

    # ----------------------------------------------------------- block ops
    def _take_block_locked(self) -> int:
        if not self._free:
            raise KVCacheFull(
                f"kv pool exhausted ({self.config.num_blocks} blocks)")
        b = self._free.pop()
        self._ref[b] = 1
        return b

    def _drop_block_locked(self, b: int) -> int:
        self._ref[b] -= 1
        if self._ref[b]:
            return 0
        del self._ref[b]
        self._free.append(b)
        return 1

    def alloc_sequence(self, seq_id: int, ntokens: int) -> List[int]:
        """Allocate blocks covering an ``ntokens``-long prefix; returns the
        block table (physical ids, in position order)."""
        need = self.blocks_for(ntokens)
        with self._lock:
            if seq_id in self._tables:
                raise ValueError(f"sequence {seq_id} already has a table")
            if len(self._free) < need:
                self.admission_rejects += 1
                g_serving_kv_admission_rejects.put(1)
                raise KVCacheFull(
                    f"need {need} blocks, {len(self._free)} free")
            table = [self._take_block_locked() for _ in range(need)]
            self._tables[seq_id] = table
            self._seq_len[seq_id] = ntokens
            self._audit_locked()
        g_serving_kv_block_allocs.put(need)
        return list(table)

    def extend_sequence(self, seq_id: int, new_len: int) -> List[int]:
        """Grow a block table so it covers ``new_len`` tokens (decode
        append); only fresh tail blocks are allocated."""
        with self._lock:
            table = self._tables.get(seq_id)
            if table is None:
                raise KeyError(f"unknown sequence {seq_id}")
            need = self.blocks_for(new_len)
            grew = 0
            while len(table) < need:
                table.append(self._take_block_locked())
                grew += 1
            self._seq_len[seq_id] = new_len
            self._quiesced.discard(seq_id)
            self._audit_locked()
        if grew:
            g_serving_kv_block_allocs.put(grew)
        return list(table)

    def truncate_sequence(self, seq_id: int, new_len: int) -> int:
        """Shrink a table back to ``new_len`` tokens: tail blocks past
        ``blocks_for(new_len)`` drop one ref and return to the free list
        at zero. Returns blocks freed."""
        freed = 0
        with self._lock:
            table = self._tables.get(seq_id)
            if table is None:
                raise KeyError(f"unknown sequence {seq_id}")
            keep = self.blocks_for(new_len)
            while len(table) > keep:
                freed += self._drop_block_locked(table.pop())
            self._seq_len[seq_id] = min(self._seq_len.get(seq_id, new_len),
                                        new_len)
            self._quiesced.discard(seq_id)
            self._audit_locked()
        if freed:
            g_serving_kv_block_frees.put(freed)
        return freed

    def fork_sequence(self, src_seq: int, dst_seq: int) -> List[int]:
        """Share ``src``'s blocks with a new sequence (refcount++); a
        write into a shared block must go through :meth:`cow_block`."""
        with self._lock:
            table = self._tables.get(src_seq)
            if table is None:
                raise KeyError(f"unknown sequence {src_seq}")
            if dst_seq in self._tables:
                raise ValueError(f"sequence {dst_seq} already has a table")
            for b in table:
                self._ref[b] += 1
            self._tables[dst_seq] = list(table)
            self._seq_len[dst_seq] = self._seq_len[src_seq]
            self._audit_locked()
            return list(table)

    def adopt_sequence(self, seq_id: int, blocks: List[int],
                       ntokens: int) -> List[int]:
        """Register a new sequence whose table IS an existing block chain
        (a prefix-cache hit): refcount++ on every chain block, zero
        allocations, zero copies. The chain must be live and must cover
        ``ntokens``."""
        bs = self.config.block_size
        if ntokens > len(blocks) * bs:
            raise ValueError(f"chain of {len(blocks)} blocks cannot cover "
                             f"{ntokens} tokens (block_size {bs})")
        with self._lock:
            if seq_id in self._tables:
                raise ValueError(f"sequence {seq_id} already has a table")
            for b in blocks:
                if b not in self._ref:
                    raise KeyError(f"block {b} is not live")
            for b in blocks:
                self._ref[b] += 1
            self._tables[seq_id] = list(blocks)
            self._seq_len[seq_id] = ntokens
            self._audit_locked()
        return list(blocks)

    def retain_block(self, block: int) -> None:
        """Take a prefix-cache hold on a live block (radix-tree commit):
        the block survives free_sequence until release_block drops the
        hold."""
        with self._lock:
            if block not in self._ref:
                raise KeyError(f"block {block} is not live")
            self._ref[block] += 1
            self._cache_ref[block] = self._cache_ref.get(block, 0) + 1
            self._audit_locked()

    def release_block(self, block: int) -> int:
        """Drop a prefix-cache hold (eviction, tree clear); the block
        returns to the free list at refcount zero. Returns blocks freed
        (0 or 1)."""
        with self._lock:
            held = self._cache_ref.get(block, 0)
            if held < 1:
                raise KeyError(f"block {block} has no cache hold")
            if held == 1:
                del self._cache_ref[block]
            else:
                self._cache_ref[block] = held - 1
            freed = self._drop_block_locked(block)
            self._audit_locked()
        if freed:
            g_serving_kv_block_frees.put(freed)
        return freed

    def block_ref(self, block: int) -> int:
        with self._lock:
            return self._ref.get(block, 0)

    def cache_held_blocks(self) -> int:
        """Distinct blocks currently pinned by prefix-cache holds."""
        with self._lock:
            return len(self._cache_ref)

    # -------------------------------------------------------- copy-on-write
    def cow_block(self, seq_id: int, block_index: int) -> int:
        """Copy-on-write split: make ``table[block_index]`` exclusively
        ``seq_id``'s before a write lands in it. An exclusive block
        (refcount 1) passes through; a shared one gets a fresh block, a
        device page copy and the table entry swapped."""
        with self._lock:
            table = self._tables.get(seq_id)
            if table is None:
                raise KeyError(f"unknown sequence {seq_id}")
            if not 0 <= block_index < len(table):
                raise IndexError(f"block index {block_index} outside "
                                 f"table of {len(table)}")
            src = table[block_index]
            self._quiesced.discard(seq_id)  # a write is coming
            if self._ref.get(src, 0) == 1:
                return src  # exclusive already: no split needed
            dst = self._take_block_locked()
        g_serving_kv_block_allocs.put(1)
        # the page copy runs OUTSIDE the ledger lock (it launches); the
        # source stays referenced by this sequence until the swap below
        (self._cow_copy_fn or self._cow_copy_block_device)(dst, src)
        with self._lock:
            table[block_index] = dst
            self._drop_block_locked(src)
            self.cow_splits += 1
            self._audit_locked()
        return dst

    def ensure_writable(self, seq_id: int, pos: int) -> int:
        """The engine's copy-on-write front door: split the block the
        write at token position ``pos`` lands in, if it is shared.
        Returns the (possibly fresh) physical block id."""
        return self.cow_block(seq_id, pos // self.config.block_size)

    def _cow_copy_block_device(self, dst: int, src: int) -> None:
        """One ``copy_`` of the block's ``block_size`` slots across every
        layer, for K and for V, on the pools' device."""
        bs = self.config.block_size
        d0, s0 = dst * bs, src * bs
        for pool in (self.k_pool, self.v_pool):
            pool[:, d0:d0 + bs].copy_(pool[:, s0:s0 + bs])
        self.pools_written()

    # ------------------------------------------------------------ migration
    def quiesce_sequence(self, seq_id: int) -> int:
        """Freeze a sequence for export: audit the ledger (even a disarmed
        one; exporting over refcounts that disagree with the tables ships
        corruption) and mark the chain quiesced. Returns the tokens the
        chain covers. The engine calls this only when no launch of the
        sequence is outstanding."""
        with self._lock:
            if seq_id not in self._tables:
                raise KeyError(f"unknown sequence {seq_id}")
            problems = self._invariant_problems_locked()
            if problems:
                raise AssertionError(
                    "refusing to quiesce over a broken ledger: " +
                    "; ".join(problems))
            self._quiesced.add(seq_id)
            return self._seq_len[seq_id]

    def export_chain(self, seq_id: int) -> Tuple[List[int], int]:
        """(block table, ntokens) of a quiesced sequence, for migration.
        The chain stays the source's until :meth:`release_exported`: the
        destination's ACK moves ownership, so the blocks never belong to
        nobody or to both sides."""
        with self._lock:
            if seq_id not in self._tables:
                raise KeyError(f"unknown sequence {seq_id}")
            if seq_id not in self._quiesced:
                raise AssertionError(
                    f"export of sequence {seq_id} without quiesce: call "
                    f"quiesce_sequence first (no in-flight writes may be "
                    f"outstanding when a chain leaves the pool)")
            return list(self._tables[seq_id]), self._seq_len[seq_id]

    def release_exported(self, seq_id: int) -> int:
        """Drop the source's ownership of a migrated chain once the
        destination ACKed adoption. Returns blocks freed."""
        with self._lock:
            self._quiesced.discard(seq_id)
        return self.free_sequence(seq_id)

    def unquiesce_sequence(self, seq_id: int) -> None:
        """Abort an export (the migration failed): the chain stays local
        and writable."""
        with self._lock:
            self._quiesced.discard(seq_id)

    def free_sequence(self, seq_id: int) -> int:
        """Drop a sequence's table; blocks return to the free list when
        their refcount hits zero. Returns blocks actually freed."""
        freed = 0
        with self._lock:
            table = self._tables.pop(seq_id, None)
            self._seq_len.pop(seq_id, None)
            self._quiesced.discard(seq_id)
            if table is None:
                return 0
            for b in table:
                freed += self._drop_block_locked(b)
            self._audit_locked()
        if freed:
            g_serving_kv_block_frees.put(freed)
        return freed

    def block_table(self, seq_id: int) -> Optional[List[int]]:
        with self._lock:
            t = self._tables.get(seq_id)
            return list(t) if t is not None else None

    def seq_len(self, seq_id: int) -> int:
        with self._lock:
            return self._seq_len.get(seq_id, 0)

    def live_sequences(self) -> List[int]:
        with self._lock:
            return sorted(self._tables)

    # ---------------------------------------------------------- write guard
    def assert_writable(self, table, start: int, stop: int) -> None:
        """Write guard (armed ledger only): every block the write range
        ``[start, stop)`` lands in must be exclusively owned (refcount 1),
        else a shared page would be silently clobbered."""
        if not self._check or stop <= start:
            return
        bs = self.config.block_size
        with self._lock:
            for bi in range(start // bs, (stop - 1) // bs + 1):
                b = table[bi]
                ref = self._ref.get(b, 0)
                if ref != 1:
                    raise AssertionError(
                        f"cow violation: write in [{start},{stop}) hits "
                        f"block {b} (table[{bi}]) with refcount {ref}; "
                        f"shared blocks must be cow-split before writing")

    def assert_writable_batch(self, tables, positions) -> None:
        """Per-row write guard for a decode batch: row i writes exactly at
        ``positions[i]`` in ``tables[i]``."""
        if not self._check:
            return
        for t, p in zip(tables, positions):
            self.assert_writable(t, int(p), int(p) + 1)

    # ------------------------------------------------------------ pool swap
    def update_pools(self, k_pool: torch.Tensor,
                     v_pool: torch.Tensor) -> None:
        """Install the post-step pools and re-point the store's handles at
        them, once per launch. The torch model updates the pools in place,
        so this mostly re-registers the same tensors; the call keeps the
        one place where the pools may change hands."""
        self.k_pool = k_pool
        self.v_pool = v_pool
        self.store.replace(self.k_handle, k_pool)
        self.store.replace(self.v_handle, v_pool)

    def pool_views(self, table) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (k, v) pools, ``(layers, slots, kv_dim)``, that ``table``'s
        slots index: here the one pair."""
        return self.k_pool, self.v_pool

    def read_chain(self, table) -> torch.Tensor:
        """``k ‖ v`` of exactly ``table``'s slots, one ``(2, layers,
        block_size, kv_dim)`` block per table entry in table (= position)
        order, ``(len(table), 2, layers, block_size, kv_dim)``: one
        gather per pool on the pools' device."""
        return _gather_slots(self.k_pool, self.v_pool,
                             chain_slots(table, self.block_size),
                             self.block_size)

    def write_chain(self, table, blocks: torch.Tensor) -> None:
        """Write ``blocks`` (:meth:`read_chain`'s layout) into exactly
        ``table``'s slots, one indexed write per pool. The caller proved
        the blocks writable first and notes the write after
        (``pools_written``)."""
        _scatter_slots(self.k_pool, self.v_pool,
                       chain_slots(table, self.block_size), blocks)

    def pools_written(self) -> None:
        """Note an in-place write of the pools (once per launch)."""
        # this re-registers the same tensors after a write; the writer (the
        # model's scatter, the cow copy) ran assert_writable/cow_block before
        # it launched
        self.update_pools(self.k_pool, self.v_pool)  # tpulint: disable=cow-before-write

    # ---------------------------------------------------------------- audit
    def _audit_locked(self) -> None:
        if not self._check:
            return
        problems = self._invariant_problems_locked()
        if problems:
            raise AssertionError("kv ledger violation: " +
                                 "; ".join(problems))

    def _invariant_problems_locked(self) -> List[str]:
        problems: List[str] = []
        held: Dict[int, int] = {}
        for table in self._tables.values():
            for b in table:
                held[b] = held.get(b, 0) + 1
        for b, n in self._cache_ref.items():
            held[b] = held.get(b, 0) + n
        if held != self._ref:
            problems.append(
                f"refcounts {self._ref} disagree with tables {held}")
        in_free = set(self._free)
        if len(in_free) != len(self._free):
            problems.append("duplicate block on the free list")
        overlap = in_free & set(held)
        if overlap:
            problems.append(f"blocks {sorted(overlap)} both free and held")
        if len(self._free) + len(self._ref) != self.config.num_blocks:
            problems.append(
                f"{len(self._free)} free + {len(self._ref)} held != "
                f"{self.config.num_blocks} capacity")
        return problems

    def assert_idle(self, context: str = "") -> None:
        """Teardown wholeness check: every block must be back on the free
        list with no refs held, tree holds included (the engine's stop()
        clears its tree first)."""
        with self._lock:
            problems = self._invariant_problems_locked()
            if self._tables:
                problems.append(
                    f"{len(self._tables)} sequence table(s) still live: "
                    f"{sorted(self._tables)}")
            if self._cache_ref:
                problems.append(
                    f"{len(self._cache_ref)} block hold(s) still owned by "
                    f"the prefix cache: {sorted(self._cache_ref)}")
            if len(self._free) != self.config.num_blocks:
                problems.append(
                    f"{self.config.num_blocks - len(self._free)} "
                    f"block(s) leaked")
        if problems:
            where = f" [{context}]" if context else ""
            raise AssertionError(f"kv pool not idle{where}: " +
                                 "; ".join(problems))

    def close(self) -> None:
        # a closed cache leaves the /vars pool totals now, not at its
        # garbage collection
        _caches.discard(self)
        self.store.free(self.k_handle)
        self.store.free(self.v_handle)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            used = self.config.num_blocks - len(self._free)
            return {
                "block_size": self.config.block_size,
                "blocks_total": self.config.num_blocks,
                "blocks_used": used,
                "blocks_free": len(self._free),
                "watermark": self.config.watermark,
                "used_ratio": used / float(self.config.num_blocks),
                "sequences": len(self._tables),
                "blocks_cached": len(self._cache_ref),
                "cow_splits": self.cow_splits,
                "admission_rejects": self.admission_rejects,
            }


class ShardTable(list):
    """A block table that knows which dp shard owns it: the (shard,
    block) naming of the sharded plane. It IS the plain block-id list
    everywhere the single-pool path expects one; the mesh model and the
    migration read ``.shard`` to find the sequence's pools."""

    def __init__(self, shard: int, blocks):
        super().__init__(blocks)
        self.shard = shard


_sharded: "weakref.WeakSet[ShardedKVCache]" = weakref.WeakSet()


def _fleet_skew() -> float:
    """Worst per-shard occupancy excess over its cache's mean: the
    quantity the serving_shard_skew watch rule fires on. 0 when balanced
    (or when no sharded cache is live)."""
    worst = 0.0
    for c in list(_sharded):
        ratios = [p.used_ratio() for p in c.pools]
        if ratios:
            worst = max(worst, max(ratios) - sum(ratios) / len(ratios))
    return worst


g_serving_kv_shard_skew = PassiveStatus(_fleet_skew) \
    .expose("g_serving_kv_shard_skew")
g_serving_kv_shard_skew.prometheus_type = "gauge"


class ShardedKVCache:
    """Per-shard block pools over the serving mesh's ``dp`` axis.

    One ledger-only :class:`PagedKVCache` per shard carries the block
    accounting (watermark, refcounts, audits: enforced PER POOL), while
    the K/V are ONE stacked ``(dp, layers, slots, kv_dim)`` pair on the
    mesh's device, adopted once in the DeviceStore. Over a mesh with a
    rank per position (``tpu/launch.py``) the ledgers stay here, on rank
    0, and each dp shard's ``(layers, slots, kv_dim)`` pair lives on the
    device of its own rank, the shard's first (sp 0, tp 0): the mesh
    model's programs write and read them there, a copy-on-write is a
    program on that rank, and :meth:`shard_pools` reads them back. A
    migrated chain's slots are read and written there too
    (:meth:`read_chain`, :meth:`write_chain`); such a mesh has no pool
    views (:meth:`pool_views` refuses). Sequences route to
    shards with the shard plane's splitmix64 ``shard_for`` (stable under
    reused ``version << 32`` ids); fork, extend and free touch only the
    owning shard's ledger."""

    def __init__(self, config: KVCacheConfig, layers: int, kv_dim: int,
                 mesh=None, store=None, dtype=torch.float32):
        from brpc_tpu_torch.shard.plane import shard_for
        from brpc_tpu_torch.tpu.mesh import serving_mesh

        if mesh is None:
            mesh = serving_mesh()
        if "dp" not in mesh.axis_names:
            raise ValueError(f"mesh {mesh.axis_names} has no dp axis")
        self.config = config
        self.layers = layers
        self.kv_dim = kv_dim
        self.mesh = mesh
        self.n_shards = int(mesh.shape["dp"])
        self.store = store if store is not None else global_store(
            mesh.device)
        if self.store.device != resolve_device(mesh.device):
            raise ValueError(f"store on {self.store.device}, mesh on "
                             f"{mesh.device}")
        self._route = shard_for
        self._lock = threading.Lock()
        self.pools = [PagedKVCache(config, layers, kv_dim,
                                   device_pools=False)
                      for _ in range(self.n_shards)]
        for i, p in enumerate(self.pools):
            # ledger-only shards copy-on-write through the stacked pools
            p._cow_copy_fn = (lambda dst, src, _s=i:
                              self._cow_copy_block_shard(_s, dst, src))
        self._shard_of: Dict[int, int] = {}
        self.admission_rejects = 0
        slots = (config.num_blocks + 1) * config.block_size
        self.ranked = mesh.ranked
        if self.ranked:
            self.key = f"kv-{next(_kv_keys)}"
            self.k_pools = self.v_pools = None
            mesh.run(_rank_kv_alloc, self.key, (layers, slots, kv_dim),
                     dtype)
        else:
            shape = (self.n_shards, layers, slots, kv_dim)
            self.k_pools = torch.zeros(shape, dtype=dtype,
                                       device=self.store.device)
            self.v_pools = torch.zeros_like(self.k_pools)
            self.k_handle, _ = self.store.adopt(self.k_pools)
            self.v_handle, _ = self.store.adopt(self.v_pools)
        _caches.add(self)   # fleet totals (/vars) see the aggregate
        _sharded.add(self)  # the skew gauge sees the per-shard spread

    # ------------------------------------------------------------- geometry
    @property
    def device(self) -> torch.device:
        return self.store.device

    @property
    def num_blocks(self) -> int:
        return self.config.num_blocks * self.n_shards

    @property
    def block_size(self) -> int:
        return self.config.block_size

    @property
    def used_blocks(self) -> int:
        return sum(p.used_blocks for p in self.pools)

    @property
    def free_blocks(self) -> int:
        return sum(p.free_blocks for p in self.pools)

    def used_ratio(self) -> float:
        return self.used_blocks / float(self.num_blocks)

    def blocks_for(self, ntokens: int) -> int:
        return self.pools[0].blocks_for(ntokens)

    # the armed-ledger switch (kv._check = True) fans out to every shard's
    # ledger: the audit contract is per pool
    @property
    def _check(self) -> bool:
        return any(p._check for p in self.pools)

    @_check.setter
    def _check(self, v: bool) -> None:
        for p in self.pools:
            p._check = v

    # -------------------------------------------------------------- routing
    def shard_of(self, seq_id: int) -> int:
        """The dp shard owning (or that would own) a sequence. Live
        sequences keep their pinned shard; new ones route by splitmix64,
        so a retry re-submitted with the same id lands on the same
        pool."""
        with self._lock:
            pinned = self._shard_of.get(seq_id)
        if pinned is not None:
            return pinned
        return self._route(seq_id, self.n_shards)

    def _pool_of(self, seq_id: int) -> Optional[Tuple[int, PagedKVCache]]:
        with self._lock:
            shard = self._shard_of.get(seq_id)
        if shard is None:
            return None
        return shard, self.pools[shard]

    def _owned(self, seq_id: int) -> Tuple[int, PagedKVCache]:
        got = self._pool_of(seq_id)
        if got is None:
            raise KeyError(f"unknown sequence {seq_id}")
        return got

    # ------------------------------------------------------------ admission
    def can_admit(self, ntokens: int, route_key: Optional[int] = None,
                  shard: Optional[int] = None) -> bool:
        """Watermark admission against the OWNING shard's pool when the
        placement is known (an explicit ``shard``, from prefix-hash
        routing, beats the ``route_key`` hash), against the fleet
        aggregate otherwise."""
        if shard is not None:
            return self.pools[shard].can_admit(ntokens)
        if route_key is not None:
            return self.pools[self.shard_of(route_key)].can_admit(ntokens)
        need = self.blocks_for(ntokens)
        limit = int(self.config.watermark * self.num_blocks)
        return self.used_blocks + need <= limit

    def note_rejected(self) -> None:
        with self._lock:
            self.admission_rejects += 1
        g_serving_kv_admission_rejects.put(1)

    # ----------------------------------------------------------- block ops
    def alloc_sequence(self, seq_id: int, ntokens: int,
                       shard: Optional[int] = None) -> ShardTable:
        if shard is None:
            shard = self.shard_of(seq_id)
        table = self.pools[shard].alloc_sequence(seq_id, ntokens)
        with self._lock:
            self._shard_of[seq_id] = shard
        return ShardTable(shard, table)

    def pin_shard(self, seq_id: int, shard: int) -> None:
        """Pin a sequence to a shard ahead of ledger registration: the
        prefix cache pins hits to the shard whose tree holds the chain,
        overriding the splitmix64 route."""
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} outside [0, {self.n_shards})")
        with self._lock:
            self._shard_of[seq_id] = shard

    def extend_sequence(self, seq_id: int, new_len: int) -> ShardTable:
        shard, pool = self._owned(seq_id)
        return ShardTable(shard, pool.extend_sequence(seq_id, new_len))

    def truncate_sequence(self, seq_id: int, new_len: int) -> int:
        return self._owned(seq_id)[1].truncate_sequence(seq_id, new_len)

    def fork_sequence(self, src_seq: int, dst_seq: int) -> ShardTable:
        """Shard-local fork: the child shares the parent's blocks, so it
        lives on the parent's shard, whatever its hash route says."""
        shard, pool = self._owned(src_seq)
        table = pool.fork_sequence(src_seq, dst_seq)
        with self._lock:
            self._shard_of[dst_seq] = shard
        return ShardTable(shard, table)

    def free_sequence(self, seq_id: int) -> int:
        with self._lock:
            shard = self._shard_of.pop(seq_id, None)
        if shard is None:
            return 0
        return self.pools[shard].free_sequence(seq_id)

    def adopt_sequence(self, seq_id: int, blocks, ntokens: int,
                       shard: Optional[int] = None) -> ShardTable:
        """Register a sequence over a live chain on ``shard`` (a prefix
        hit, a migration's staging adopt): refcount++ on every chain
        block, no allocation. Defaults to the chain's own shard when
        ``blocks`` is a :class:`ShardTable`."""
        if shard is None:
            shard = getattr(blocks, "shard", None)
        if shard is None:
            raise ValueError("adopt_sequence on a sharded pool needs the "
                             "owning shard (ShardTable or shard=)")
        table = self.pools[shard].adopt_sequence(seq_id, list(blocks),
                                                 ntokens)
        with self._lock:
            self._shard_of[seq_id] = shard
        return ShardTable(shard, table)

    # ------------------------------------------------------------ migration
    def quiesce_sequence(self, seq_id: int) -> int:
        return self._owned(seq_id)[1].quiesce_sequence(seq_id)

    def export_chain(self, seq_id: int) -> Tuple[ShardTable, int]:
        shard, pool = self._owned(seq_id)
        blocks, ntokens = pool.export_chain(seq_id)
        return ShardTable(shard, blocks), ntokens

    def release_exported(self, seq_id: int) -> int:
        with self._lock:
            shard = self._shard_of.pop(seq_id, None)
        if shard is None:
            return 0
        return self.pools[shard].release_exported(seq_id)

    def unquiesce_sequence(self, seq_id: int) -> None:
        got = self._pool_of(seq_id)
        if got is not None:
            got[1].unquiesce_sequence(seq_id)

    # -------------------------------------------------------- copy-on-write
    def cow_block(self, seq_id: int, block_index: int) -> int:
        return self._owned(seq_id)[1].cow_block(seq_id, block_index)

    def ensure_writable(self, seq_id: int, pos: int) -> int:
        return self.cow_block(seq_id, pos // self.config.block_size)

    def _cow_copy_block_shard(self, shard: int, dst: int, src: int) -> None:
        """The page copy of a ledger-only shard pool: one ``copy_`` of the
        block's slots across every layer, in the shard's slice of the
        stacked K and V."""
        bs = self.config.block_size
        d0, s0 = dst * bs, src * bs
        if self.ranked:
            self.mesh.run(_rank_kv_cow, self.key, shard, d0, s0, bs)
            return
        for pools in (self.k_pools, self.v_pools):
            pools[shard, :, d0:d0 + bs].copy_(pools[shard, :, s0:s0 + bs])
        self.pools_written()

    def assert_writable(self, table, start: int, stop: int) -> None:
        self.pools[getattr(table, "shard", 0)].assert_writable(
            table, start, stop)

    def assert_writable_batch(self, tables, positions) -> None:
        if not self._check:
            return
        for t, p in zip(tables, positions):
            self.assert_writable(t, int(p), int(p) + 1)

    def block_table(self, seq_id: int) -> Optional[ShardTable]:
        got = self._pool_of(seq_id)
        if got is None:
            return None
        shard, pool = got
        table = pool.block_table(seq_id)
        return ShardTable(shard, table) if table is not None else None

    def seq_len(self, seq_id: int) -> int:
        got = self._pool_of(seq_id)
        return got[1].seq_len(seq_id) if got else 0

    def live_sequences(self) -> List[int]:
        out: List[int] = []
        for p in self.pools:
            out.extend(p.live_sequences())
        return sorted(out)

    # ------------------------------------------------------------ pool swap
    def update_pools(self, k_pools: torch.Tensor,
                     v_pools: torch.Tensor) -> None:
        """Install the stacked pools and re-point the store's handles at
        them: one swap per launch for the WHOLE mesh, not per shard."""
        self.k_pools = k_pools
        self.v_pools = v_pools
        self.store.replace(self.k_handle, k_pools)
        self.store.replace(self.v_handle, v_pools)

    def pool_views(self, table) -> Tuple[torch.Tensor, torch.Tensor]:
        """The owning shard's ``(layers, slots, kv_dim)`` slices of the
        stacked pools (views: a write lands in the stack)."""
        if self.ranked:
            raise RuntimeError("the pools of a rank mesh live on their "
                               "ranks: read them with shard_pools")
        shard = getattr(table, "shard", 0)
        return self.k_pools[shard], self.v_pools[shard]

    def read_chain(self, table) -> torch.Tensor:
        """``k ‖ v`` of exactly a chain's slots on its shard, in
        :meth:`PagedKVCache.read_chain`'s layout. Over ranks one program
        gathers them on the shard's pool-holding rank, and only those
        slots come back to this process (on the host)."""
        shard = getattr(table, "shard", 0)
        slots = chain_slots(table, self.block_size)
        if not self.ranked:
            return _gather_slots(self.k_pools[shard], self.v_pools[shard],
                                 slots, self.block_size)
        got = self.mesh.run(_rank_kv_read_chain, self.key, shard, slots,
                            self.block_size)
        return next(g for g in got if g is not None)

    def write_chain(self, table, blocks: torch.Tensor) -> None:
        """Write ``blocks`` (:meth:`read_chain`'s layout) into exactly a
        chain's slots on its shard, one indexed write per pool. Over
        ranks the blocks go to the shard's pool-holding rank alone and
        are written there. The caller proved the blocks writable on this
        process's ledger first and notes the write after
        (``pools_written``)."""
        shard = getattr(table, "shard", 0)
        slots = chain_slots(table, self.block_size)
        if not self.ranked:
            _scatter_slots(self.k_pools[shard], self.v_pools[shard], slots,
                           blocks)
            return
        payload = (slots, blocks.detach().cpu())
        scatter = [payload if holds_shard(self.mesh, shard, r) else None
                   for r in range(self.mesh.devices.size)]
        self.mesh.run(_rank_kv_write_chain, self.key, scatter=scatter)

    def shard_pools(self, shard: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Copies of one shard's K and V pools, on this process (over
        ranks, read from the shard's rank)."""
        if not self.ranked:
            return self.k_pools[shard].clone(), self.v_pools[shard].clone()
        got = self.mesh.run(_rank_kv_read, self.key, shard)
        return next(g for g in got if g is not None)

    def pool_ranks(self) -> Dict[int, int]:
        """Over ranks: {shard: the rank whose device holds its pools}."""
        got = self.mesh.run(_rank_kv_where, self.key)
        return {shard: r for r, shard in enumerate(got) if shard is not None}

    def pools_written(self) -> None:
        """Note an in-place write of the stacked pools (once per
        launch)."""
        if not self.ranked:
            # re-registers the same stacked tensors after a write; the writer
            # (the mesh model's scatter, the shard's cow copy) proved
            # exclusivity first
            self.update_pools(self.k_pools, self.v_pools)  # tpulint: disable=cow-before-write

    # ---------------------------------------------------------------- audit
    def assert_idle(self, context: str = "") -> None:
        for i, p in enumerate(self.pools):
            where = f"shard {i}" + (f", {context}" if context else "")
            p.assert_idle(where)
        with self._lock:
            if self._shard_of:
                raise AssertionError(
                    f"sharded kv not idle [{context}]: routing entries "
                    f"for {sorted(self._shard_of)} still pinned")

    def close(self) -> None:
        _caches.discard(self)
        if not self.ranked:
            self.store.free(self.k_handle)
            self.store.free(self.v_handle)
        elif launch.active() is not None:
            self.mesh.run(_rank_kv_free, self.key)

    def snapshot(self) -> Dict[str, object]:
        used = self.used_blocks
        total = self.num_blocks
        dp = self.mesh.axis_names.index("dp")
        dev_rows = np.moveaxis(self.mesh.devices, dp, 0).reshape(
            self.n_shards, -1)
        shards = []
        for i, p in enumerate(self.pools):
            s = p.snapshot()
            s["shard"] = i
            s["devices"] = [str(d) for d in dev_rows[i]]
            shards.append(s)
        with self._lock:
            shard_map = dict(sorted(self._shard_of.items()))
            rejects = self.admission_rejects
        ratios = [s["used_ratio"] for s in shards]
        return {
            "block_size": self.config.block_size,
            "blocks_total": total,
            "blocks_used": used,
            "blocks_free": total - used,
            "watermark": self.config.watermark,
            "used_ratio": used / float(total),
            "sequences": sum(s["sequences"] for s in shards),
            "blocks_cached": sum(s["blocks_cached"] for s in shards),
            "cow_splits": sum(s["cow_splits"] for s in shards),
            "admission_rejects": rejects + sum(s["admission_rejects"]
                                               for s in shards),
            "n_shards": self.n_shards,
            "shard_skew": max(ratios) - sum(ratios) / len(ratios),
            "shards": shards,
            "shard_map": shard_map,
        }


# ------------------------------------------------------ a chain's slots
def chain_slots(table, block_size: int) -> torch.Tensor:
    """The pool slots of ``table``'s blocks, in table order (int64)."""
    blocks = torch.as_tensor(list(table), dtype=torch.int64)
    return (blocks[:, None] * block_size
            + torch.arange(block_size)).reshape(-1)


def _gather_slots(k: torch.Tensor, v: torch.Tensor, slots: torch.Tensor,
                  block_size: int) -> torch.Tensor:
    """The blocks at ``slots`` of the (k, v) ``(layers, slots, kv_dim)``
    pools, ``(n, 2, layers, block_size, kv_dim)``: a gather per pool and
    one copy into block order, on the pools' device."""
    layers, _, dim = k.shape
    idx = slots.to(k.device)
    both = torch.stack([k.index_select(1, idx), v.index_select(1, idx)])
    return both.view(2, layers, -1, block_size, dim).permute(
        2, 0, 1, 3, 4).contiguous()


def _scatter_slots(k: torch.Tensor, v: torch.Tensor, slots: torch.Tensor,
                   blocks: torch.Tensor) -> None:
    """Write ``blocks`` (:func:`_gather_slots`' layout) at ``slots``: one
    copy to the pools' device, one indexed write per pool."""
    layers, _, dim = k.shape
    idx = slots.to(k.device)
    blocks = blocks.to(k.device)
    for half, pool in enumerate((k, v)):
        pool.index_copy_(1, idx, blocks[:, half].transpose(0, 1).reshape(
            layers, idx.numel(), dim))


# ------------------------------------------ the pools over a rank mesh
_kv_keys = itertools.count()


def holds_pools(mesh, rank: int = None) -> bool:
    """Whether ``rank`` (default: this rank) holds its dp shard's pools:
    the shard's first rank (every other axis at 0)."""
    return all(i == 0 for a, i in mesh.coords(rank).items() if a != "dp")


def holds_shard(mesh, shard: int, rank: int = None) -> bool:
    """Whether ``rank`` (default: this rank) holds ``shard``'s pools."""
    return holds_pools(mesh, rank) and mesh.coords(rank)["dp"] == shard


def _rank_kv_alloc(mesh, key, shape, dtype):
    if holds_pools(mesh):
        k = torch.zeros(shape, dtype=dtype, device=mesh.device)
        launch.state()[key] = (k, torch.zeros_like(k))


def _rank_kv_cow(mesh, key, shard, d0, s0, bs):
    if holds_shard(mesh, shard):
        for pools in launch.state()[key]:
            pools[:, d0:d0 + bs].copy_(pools[:, s0:s0 + bs])


def _rank_kv_read(mesh, key, shard):
    if holds_shard(mesh, shard):
        return tuple(p.clone() for p in launch.state()[key])
    return None


def _rank_kv_read_chain(mesh, key, shard, slots, block_size):
    if holds_shard(mesh, shard):
        return _gather_slots(*launch.state()[key], slots, block_size)
    return None


def _rank_kv_write_chain(mesh, key, scattered):
    if scattered is not None:
        slots, blocks = scattered
        _scatter_slots(*launch.state()[key], slots, blocks)


def _rank_kv_where(mesh, key):
    return mesh.coord("dp") if key in launch.state() else None


def _rank_kv_free(mesh, key):
    launch.state().pop(key, None)
