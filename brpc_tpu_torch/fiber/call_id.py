"""CallId — versioned correlation id with built-in lock + error channel.

Rebuild of ``bthread/id.h:28-48`` / ``id.cpp``: one CallId per RPC. It is
simultaneously (a) a weak reference (stale ids never resolve after destroy —
VersionedPool), (b) a mutex serializing everything that touches the RPC's
state (response processing, timeout, socket failure), and (c) an error
channel: ``id_error`` delivers a code to the owner's on_error under the lock,
deferred if the lock is held. Retries bump an in-id call version
(``id.cpp:396,405`` ranged versions) so responses to an abandoned attempt
fail verification and are dropped — the stale-response race the reference
guards at controller.cpp:1059-1066.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

from brpc_tpu_torch.butil.resource_pool import VersionedPool


class IdGone(Exception):
    """The id was destroyed (RPC completed) — stale reference."""


class _Id:
    __slots__ = (
        "data",
        "on_error",
        "cond",
        "locked",
        "destroyed",
        "pending_errors",
        "call_version",
        "join_event",
    )

    def __init__(self, data, on_error):
        self.data = data
        self.on_error: Optional[Callable] = on_error
        self.cond = threading.Condition()
        self.locked = False
        self.destroyed = False
        self.pending_errors: List[int] = []
        self.call_version = 1
        self.join_event = threading.Event()


_pool: VersionedPool = VersionedPool()


def id_create(data=None, on_error: Optional[Callable] = None) -> int:
    """New call id. on_error(data, call_id, error_code) runs under the lock."""
    return _pool.insert(_Id(data, on_error))


def _resolve(call_id: int) -> _Id:
    ident = _pool.address(call_id)
    if ident is None:
        raise IdGone(f"call id {call_id:#x} destroyed")
    return ident


def id_lock(call_id: int, timeout: Optional[float] = None):
    """Acquire the id's lock; returns data. Raises IdGone if destroyed."""
    ident = _resolve(call_id)
    with ident.cond:
        ok = ident.cond.wait_for(
            lambda: not ident.locked or ident.destroyed, timeout=timeout
        )
        if not ok:
            raise TimeoutError("id_lock timeout")
        if ident.destroyed:
            raise IdGone(f"call id {call_id:#x} destroyed")
        ident.locked = True
        return ident.data


def id_lock_verify(call_id: int, call_version: int):
    """Lock only if the in-id call version matches (stale-response guard)."""
    data = id_lock(call_id)
    ident = _resolve(call_id)
    if ident.call_version != call_version:
        id_unlock(call_id)
        raise IdGone(
            f"call id {call_id:#x} at version {ident.call_version}, "
            f"response for stale version {call_version}"
        )
    return data


def id_version(call_id: int) -> int:
    return _resolve(call_id).call_version


def id_bump_version(call_id: int) -> int:
    """Caller must hold the lock; invalidates in-flight responses (retry)."""
    ident = _resolve(call_id)
    ident.call_version += 1
    return ident.call_version


def id_unlock(call_id: int) -> None:
    try:
        ident = _resolve(call_id)
    except IdGone:
        return
    # Deliver deferred errors one at a time while keeping the lock; the
    # handler must finish with id_unlock or id_unlock_and_destroy, so loop
    # until the queue drains or the handler destroys the id.
    while True:
        with ident.cond:
            if ident.destroyed:
                ident.cond.notify_all()
                return
            if not ident.pending_errors:
                ident.locked = False
                ident.cond.notify()
                return
            code = ident.pending_errors.pop(0)
            handler = ident.on_error
            data = ident.data
        if handler is None:
            continue
        handler(data, call_id, code)
        # handler unlocked (or destroyed) the id; re-acquire for next error
        try:
            with ident.cond:
                if ident.destroyed:
                    return
                if ident.locked:
                    # handler kept it locked — its responsibility now
                    return
                if ident.pending_errors:
                    ident.locked = True
                    continue
                return
        except IdGone:
            return


def id_unlock_and_destroy(call_id: int) -> None:
    ident = _pool.address(call_id)
    if ident is None:
        return
    with ident.cond:
        ident.destroyed = True
        ident.locked = False
        ident.pending_errors.clear()
        ident.cond.notify_all()
        ident.join_event.set()
    _pool.remove(call_id)


def id_join(call_id: int, timeout: Optional[float] = None) -> bool:
    """Block until the id is destroyed (RPC fully finished)."""
    ident = _pool.address(call_id)
    if ident is None:
        return True  # already gone
    return ident.join_event.wait(timeout)


def id_error(call_id: int, error_code: int) -> bool:
    """Deliver an error to the id's owner.

    If the id is unlocked: lock it and run on_error on this thread.
    If locked: queue the error; the current holder delivers it at unlock.
    Returns False if the id is already destroyed.
    """
    try:
        ident = _resolve(call_id)
    except IdGone:
        return False
    with ident.cond:
        if ident.destroyed:
            return False
        if ident.locked:
            ident.pending_errors.append(error_code)
            return True
        ident.locked = True
        handler = ident.on_error
        data = ident.data
    if handler is not None:
        handler(data, call_id, error_code)
    else:
        id_unlock_and_destroy(call_id)
    return True


def id_about_to_destroy(call_id: int) -> None:
    """Reject future errors early (reference bthread_id_about_to_destroy)."""
    try:
        ident = _resolve(call_id)
    except IdGone:
        return
    with ident.cond:
        ident.on_error = None
        ident.pending_errors.clear()
