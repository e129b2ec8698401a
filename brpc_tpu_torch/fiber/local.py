"""Fiber-local storage — keytables (reference bthread/key.cpp:
bthread_key_create/delete, bthread_setspecific/getspecific).

Semantics carried over:
  - a key is created process-wide with an optional destructor;
  - values are scoped to the RUNNING FIBER TASK (each FiberTask gets a
    lazily-created keytable); code running on a plain thread falls back to
    a thread-local keytable, exactly like bthread_getspecific called from
    a pthread;
  - destructors run when the task finishes (reference keytable teardown at
    task end) or when the key is deleted;
  - a deleted key's slot never resolves again (version check — reference
    key.cpp versioned KeyInfo), so stale keys can't read another key's
    value after slot reuse.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Tuple

_registry_lock = threading.Lock()
_destructors: Dict[int, Tuple[int, Optional[Callable[[Any], None]]]] = {}
_next_slot = [0]
_thread_tables = threading.local()

# set by the fiber runtime around task execution
_current = threading.local()


def _table_for_current() -> Dict[int, Any]:
    task = getattr(_current, "task", None)
    if task is not None:
        table = getattr(task, "keytable", None)
        if table is None:
            table = task.keytable = {}
        return table
    table = getattr(_thread_tables, "table", None)
    if table is None:
        table = _thread_tables.table = {}
    return table


def key_create(destructor: Optional[Callable[[Any], None]] = None) -> int:
    """Returns a new key (slot | version<<32, like bthread_key_t)."""
    with _registry_lock:
        slot = _next_slot[0]
        _next_slot[0] += 1
        version = 1
        _destructors[slot] = (version, destructor)
        return slot | (version << 32)


def key_delete(key: int) -> None:
    """Invalidate the key; existing values are abandoned (their destructors
    run only via explicit table teardown, matching the reference's
    'destructor may still run after delete returns' caveat)."""
    slot = key & 0xFFFFFFFF
    with _registry_lock:
        cur = _destructors.get(slot)
        if cur is not None and cur[0] == key >> 32:
            _destructors[slot] = (cur[0] + 1, None)


def _key_valid(key: int) -> bool:
    slot, version = key & 0xFFFFFFFF, key >> 32
    with _registry_lock:
        cur = _destructors.get(slot)
        return cur is not None and cur[0] == version


def set_specific(key: int, value: Any) -> bool:
    if not _key_valid(key):
        return False
    _table_for_current()[key] = value
    return True


def get_specific(key: int, default: Any = None) -> Any:
    if not _key_valid(key):
        return default
    return _table_for_current().get(key, default)


def _run_destructors(table: Dict[int, Any]) -> None:
    """Called by the fiber runtime when a task with a keytable ends."""
    for key, value in list(table.items()):
        slot, version = key & 0xFFFFFFFF, key >> 32
        with _registry_lock:
            cur = _destructors.get(slot)
            dtor = cur[1] if cur is not None and cur[0] == version else None
        if dtor is not None and value is not None:
            try:
                dtor(value)
            except Exception:
                pass
    table.clear()


def _enter_task(task) -> None:
    _current.task = task


def _exit_task(task) -> None:
    _current.task = None
    table = getattr(task, "keytable", None)
    if table:
        _run_destructors(table)


def current_task():
    """The FiberTask running on this thread, or None (pthread context)."""
    return getattr(_current, "task", None)
