"""Shared-memory SPSC byte ring — the shard plane's doorbell channel.

One producer process, one consumer process, no locks across the boundary
and no pipes/pickles: records are length-prefixed byte strings in a shm
segment, and the head/tail cursors are 8-byte-aligned u64 cells in the
segment header. On x86-64 an aligned 8-byte store is a single atomic
memcpy and the architecture is TSO (stores are not reordered past
stores), so "write payload, then publish tail" is a correct
release/acquire pair without fences — the same reasoning the kernel's
own shm rings rely on. Within one process, multiple logical producers
serialize on a plain threading.Lock held by the owner (the ring itself
stays single-producer).

Record layout, 8-byte aligned:

    u32 length | u8 type | 3 pad | payload | pad to 8

A record never wraps the segment end: when the tail-to-end gap is too
small, an 8-byte WRAP marker record (length=0xFFFFFFFF) fills the gap
and the record starts at offset 0. Because capacity and every record
size are multiples of 8, the gap is always >= 8 when nonzero, so the
marker always fits.

Consumers poll: the parent's collector and the worker's cut loop both
sit in AdaptiveSpin-then-sleep loops (fiber/wakeup.py): the escalating
sleep floor keeps an idle 2-worker plane under 1% of a core while a busy
ring is picked up within the spin budget.
"""

from __future__ import annotations

import struct
from multiprocessing import shared_memory as _shm
from typing import List, Optional, Tuple

HDR_SIZE = 64          # u64 head @0 (consumer), u64 tail @8 (producer)
_REC_HDR = struct.Struct("<IB3x")   # length, type, pad -> 8 bytes
REC_OVERHEAD = _REC_HDR.size
_WRAP = 0xFFFFFFFF
_U64 = struct.Struct("<Q")

DEFAULT_RING_BYTES = 4 * 1024 * 1024


def _untrack(name: str) -> None:
    """Detach this process's resource_tracker claim on an attached segment
    so interpreter exit does not unlink shm another process still owns
    (same idiom as tpu/transport's pool attach)."""
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister("/" + name, "shared_memory")
    except Exception:
        pass


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class ShardRing:
    """One direction of a parent<->worker doorbell pair."""

    def __init__(self, shm: _shm.SharedMemory, owner: bool):
        self._shm = shm
        self._owner = owner
        self.name = shm.name
        self.capacity = (len(shm.buf) - HDR_SIZE) & ~7
        self._buf = shm.buf
        # local cursor caches: the producer owns tail, the consumer owns
        # head — each re-reads only the cell the OTHER side publishes
        self._head_cache = self._load(0)
        self._tail_cache = self._load(8)
        # lifetime tallies (process-local, for /tpu + W_STATS)
        self.pushed = 0
        self.push_full = 0
        self.popped = 0

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def create(cls, name: str, size: int = DEFAULT_RING_BYTES) -> "ShardRing":
        size = _pad8(max(size, 64 * 1024)) + HDR_SIZE
        shm = _shm.SharedMemory(name=name, create=True, size=size)
        shm.buf[:HDR_SIZE] = bytes(HDR_SIZE)
        return cls(shm, owner=True)

    @classmethod
    def attach(cls, name: str) -> "ShardRing":
        shm = _shm.SharedMemory(name=name)
        _untrack(name)
        return cls(shm, owner=False)

    def close(self) -> None:
        try:
            self._buf = None
            self._shm.close()
        except Exception:
            pass
        if self._owner:
            try:
                self._shm.unlink()
            except Exception:
                pass

    # ------------------------------------------------------------- cursors
    def _load(self, off: int) -> int:
        return _U64.unpack_from(self._shm.buf, off)[0]

    def _store(self, off: int, val: int) -> None:
        _U64.pack_into(self._shm.buf, off, val)

    # ------------------------------------------------------------ producer
    def push(self, rtype: int, payload: bytes) -> bool:
        """Append one record; False when the ring lacks space (caller
        falls back — in-process dispatch on the parent side, retry on the
        worker side). Never blocks."""
        buf = self._buf
        if buf is None:
            return False
        need = REC_OVERHEAD + _pad8(len(payload))
        if need > self.capacity:
            return False
        head = self._load(0)
        tail = self._tail_cache
        free = self.capacity - (tail - head)
        off = tail % self.capacity
        gap = self.capacity - off
        if need > gap:
            # wrap: burn the gap with a marker record, restart at 0
            if free < gap + need:
                self.push_full += 1
                return False
            _REC_HDR.pack_into(buf, HDR_SIZE + off, _WRAP, 0)
            tail += gap
            off = 0
        elif free < need:
            self.push_full += 1
            return False
        _REC_HDR.pack_into(buf, HDR_SIZE + off, len(payload), rtype)
        buf[HDR_SIZE + off + REC_OVERHEAD:
            HDR_SIZE + off + REC_OVERHEAD + len(payload)] = payload
        # publish AFTER the payload bytes land (x86 TSO store order)
        tail += need
        self._tail_cache = tail
        self._store(8, tail)
        self.pushed += 1
        return True

    @property
    def tail(self) -> int:
        """The producer's cursor: past the last record pushed (read it on
        the producer's side)."""
        return self._tail_cache

    @property
    def head(self) -> int:
        """The cursor the consumer has published: past every record it
        has taken off the ring."""
        return self._load(0)

    def free_bytes(self) -> int:
        return self.capacity - (self._tail_cache - self._load(0))

    # ------------------------------------------------------------ consumer
    @property
    def empty(self) -> bool:
        return self._head_cache == self._load(8)

    def pop(self, max_records: int = 64) -> List[Tuple[int, bytes]]:
        """Drain up to max_records; returns [] when the ring is empty.
        Payload bytes are copied out (the slot is reusable the moment the
        head cursor publishes past it)."""
        buf = self._buf
        if buf is None:
            return []
        head = self._head_cache
        tail = self._load(8)
        out: List[Tuple[int, bytes]] = []
        while head < tail and len(out) < max_records:
            off = head % self.capacity
            ln, typ = _REC_HDR.unpack_from(buf, HDR_SIZE + off)
            if ln == _WRAP:
                head += self.capacity - off
                continue
            start = HDR_SIZE + off + REC_OVERHEAD
            out.append((typ, bytes(buf[start:start + ln])))
            head += REC_OVERHEAD + _pad8(ln)
        if out:
            self._head_cache = head
            self._store(0, head)
            self.popped += len(out)
        return out
