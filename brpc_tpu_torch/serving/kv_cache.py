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
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

import torch

from brpc_tpu_torch.tpu.device_lane import global_store


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
    CPU store) is passed."""

    def __init__(self, config: KVCacheConfig, layers: int, kv_dim: int,
                 store=None, dtype=torch.float32, device=None):
        self.config = config
        self.layers = layers
        self.kv_dim = kv_dim
        self._lock = threading.Lock()
        self.store = store if store is not None else global_store(device)
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
                raise KVCacheFull(
                    f"need {need} blocks, {len(self._free)} free")
            table = [self._take_block_locked() for _ in range(need)]
            self._tables[seq_id] = table
            self._seq_len[seq_id] = ntokens
            self._audit_locked()
        return list(table)

    def extend_sequence(self, seq_id: int, new_len: int) -> List[int]:
        """Grow a block table so it covers ``new_len`` tokens (decode
        append); only fresh tail blocks are allocated."""
        with self._lock:
            table = self._tables.get(seq_id)
            if table is None:
                raise KeyError(f"unknown sequence {seq_id}")
            need = self.blocks_for(new_len)
            while len(table) < need:
                table.append(self._take_block_locked())
            self._seq_len[seq_id] = new_len
            self._quiesced.discard(seq_id)
            self._audit_locked()
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
        self.update_pools(self.k_pool, self.v_pool)

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
