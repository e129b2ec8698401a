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

With ``BRPC_TPU_CHECK=1`` in the environment (or ``_check = True``),
every alloc/extend/truncate/free re-audits the invariants, and
:meth:`PagedKVCache.assert_idle` proves at teardown that every block came
back.

Forking, copy-on-write, prefix-cache holds and migration export are not
ported yet; nothing on the engine's path calls them.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

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
        self.admission_rejects = 0
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

    def blocks_for(self, ntokens: int) -> int:
        bs = self.config.block_size
        return max(1, (ntokens + bs - 1) // bs)

    # ------------------------------------------------------------ admission
    def can_admit(self, ntokens: int) -> bool:
        """Watermark admission: the pool after this sequence's prefill
        blocks must stay at or under ``watermark`` of capacity."""
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
            self._audit_locked()
        return freed

    def free_sequence(self, seq_id: int) -> int:
        """Drop a sequence's table; blocks return to the free list when
        their refcount hits zero. Returns blocks actually freed."""
        freed = 0
        with self._lock:
            table = self._tables.pop(seq_id, None)
            self._seq_len.pop(seq_id, None)
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
        list with no refs held."""
        with self._lock:
            problems = self._invariant_problems_locked()
            if self._tables:
                problems.append(
                    f"{len(self._tables)} sequence table(s) still live: "
                    f"{sorted(self._tables)}")
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
                "admission_rejects": self.admission_rejects,
            }
