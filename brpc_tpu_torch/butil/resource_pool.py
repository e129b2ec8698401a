"""Versioned resource pool — the addressing scheme behind SocketId/CallId.

Rebuild of the reference's ``butil/resource_pool.h`` + the 64-bit versioned-id
pattern of ``brpc/versioned_ref_with_id.h:54-64``: an id is
``(version << 32) | slot``; a slot is recycled with its version bumped by 2 so
stale ids can never address a reincarnated object ("weak-reference" semantics
without per-lookup locks). Lookup is O(1) into a slot table; a mismatched
version means the object the caller knew is gone.

In the reference this is lock-free slab allocation; here slot reuse is guarded
by one lock (allocation is off the hot path — lookups, the hot operation, are
lock-free thanks to the GIL's atomic list reads).
"""

from __future__ import annotations

import threading
from typing import Generic, List, Optional, TypeVar

T = TypeVar("T")

VERSION_SHIFT = 32
SLOT_MASK = (1 << 32) - 1


def make_id(version: int, slot: int) -> int:
    return (version << VERSION_SHIFT) | slot


def id_version(vid: int) -> int:
    return vid >> VERSION_SHIFT


def id_slot(vid: int) -> int:
    return vid & SLOT_MASK


class _Slot(Generic[T]):
    __slots__ = ("version", "obj")

    def __init__(self):
        # Even version == free, odd == live (mirrors the reference's
        # versioned-ref convention where an in-use ref has odd parity).
        self.version = 0
        self.obj: Optional[T] = None


class VersionedPool(Generic[T]):
    """Slot pool handing out 64-bit versioned ids."""

    def __init__(self):
        self._slots: List[_Slot[T]] = []
        self._free: List[int] = []
        self._lock = threading.Lock()

    def insert(self, obj: T) -> int:
        with self._lock:
            if self._free:
                slot_idx = self._free.pop()
            else:
                slot_idx = len(self._slots)
                self._slots.append(_Slot())
            slot = self._slots[slot_idx]
            slot.version += 1  # even -> odd: live
            slot.obj = obj
            return make_id(slot.version, slot_idx)

    def address(self, vid: int) -> Optional[T]:
        """Resolve id -> object; None if recycled (stale id)."""
        slot_idx = id_slot(vid)
        slots = self._slots
        if slot_idx >= len(slots):
            return None
        slot = slots[slot_idx]
        # Read obj BEFORE version: if a concurrent remove+insert reincarnates
        # the slot between the two reads, the version check fails and we
        # return None instead of handing a stale id the new object.
        obj = slot.obj
        if slot.version != id_version(vid):
            return None
        return obj

    def remove(self, vid: int) -> Optional[T]:
        """Free the slot; returns the object if the id was still live."""
        slot_idx = id_slot(vid)
        with self._lock:
            if slot_idx >= len(self._slots):
                return None
            slot = self._slots[slot_idx]
            if slot.version != id_version(vid):
                return None
            obj, slot.obj = slot.obj, None
            slot.version += 1  # odd -> even: free
            self._free.append(slot_idx)
            return obj

    def __len__(self) -> int:
        return len(self._slots) - len(self._free)

    def live_objects(self) -> List[T]:
        out = []
        for slot in self._slots:
            obj = slot.obj
            if obj is not None and (slot.version & 1):
                out.append(obj)
        return out

    def live_ids(self) -> List[int]:
        out = []
        for idx, slot in enumerate(self._slots):
            if slot.obj is not None and (slot.version & 1):
                out.append(make_id(slot.version, idx))
        return out


class ObjectPool(Generic[T]):
    """Free-list object pool (reference ``butil/object_pool.h``)."""

    def __init__(self, factory, reset=None, max_free: int = 1024):
        self._factory = factory
        self._reset = reset
        self._free: List[T] = []
        self._lock = threading.Lock()
        self._max_free = max_free

    def get(self) -> T:
        with self._lock:
            if self._free:
                return self._free.pop()
        return self._factory()

    def put(self, obj: T) -> None:
        if self._reset is not None:
            self._reset(obj)
        with self._lock:
            if len(self._free) < self._max_free:
                self._free.append(obj)
