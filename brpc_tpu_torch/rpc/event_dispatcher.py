"""EventDispatcher — the IO event loops feeding the fiber runtime.

Rebuild of ``event_dispatcher_epoll.cpp:196-206``: one or more dedicated
threads blocked in epoll; events never read data themselves — they fire the
consumer's callback (``AddConsumer``, event_dispatcher.h:122). Registration
changes from other threads are applied through a self-pipe wakeup so the
loop never holds stale interest sets.

Like the reference (``event_dispatcher.cpp:32,59-78`` —
``event_dispatcher_num`` loops), a pool of dispatchers shares the fd space:
each new socket is assigned round-robin via :func:`pick_dispatcher`, so one
connection's burst can't monopolize every socket's event delivery. A socket
whose read buffer grows past the inline-cut budget gets its read interest
suspended while a fiber worker drains and parses it off-loop
(InputMessenger._cut_offloaded), then resumed — the analog of the
reference's ProcessEvent handoff at the first atomic (socket.cpp:2256).
"""

from __future__ import annotations

import logging
import os
import selectors
import threading
from typing import Callable, Dict, List, Optional, Set, Tuple

from brpc_tpu_torch.fiber import wakeup as _wakeup
from brpc_tpu_torch.metrics.reducer import Adder

log = logging.getLogger("brpc_tpu_torch.event_dispatcher")


class EventDispatcher:
    def __init__(self, name: str = "event-dispatcher"):
        self._selector = selectors.DefaultSelector()
        self._lock = threading.Lock()
        self._handlers: Dict[int, Tuple[Optional[Callable], Optional[Callable]]] = {}
        self._read_suspended: Set[int] = set()
        self._wake_r, self._wake_w = os.pipe()
        os.set_blocking(self._wake_r, False)
        self._selector.register(self._wake_r, selectors.EVENT_READ, None)
        self._stopped = False
        # one per dispatcher at startup, not per request
        self.events_dispatched = Adder()  # tpulint: disable=metric-churn
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        # run-to-completion executes framework completions on this thread;
        # user callbacks reaching a completion path here must be offloaded
        # (controller._finish_locked checks this mark)
        self._thread.brpc_no_user_code = True
        self._thread.start()

    # ------------------------------------------------------------------- api
    def add_consumer(self, fd: int, on_readable: Optional[Callable] = None,
                     on_writable: Optional[Callable] = None) -> None:
        events = 0
        if on_readable:
            events |= selectors.EVENT_READ
        if on_writable:
            events |= selectors.EVENT_WRITE
        with self._lock:
            self._handlers[fd] = (on_readable, on_writable)
            self._read_suspended.discard(fd)
            try:
                self._selector.modify(fd, events, fd)
            except KeyError:
                self._selector.register(fd, events, fd)
        self._wakeup()

    def _events_for_locked(self, fd: int) -> int:
        r, w = self._handlers.get(fd, (None, None))
        events = 0
        if r and fd not in self._read_suspended:
            events |= selectors.EVENT_READ
        if w:
            events |= selectors.EVENT_WRITE
        return events

    def _apply_locked(self, fd: int) -> None:
        events = self._events_for_locked(fd)
        if not events:
            try:
                self._selector.unregister(fd)
            except KeyError:
                pass
            return
        try:
            self._selector.modify(fd, events, fd)
        except KeyError:
            try:
                self._selector.register(fd, events, fd)
            except (ValueError, OSError):
                pass

    def enable_write(self, fd: int, on_writable: Callable) -> None:
        with self._lock:
            r, _ = self._handlers.get(fd, (None, None))
            self._handlers[fd] = (r, on_writable)
            self._apply_locked(fd)
        self._wakeup()

    def disable_write(self, fd: int) -> None:
        with self._lock:
            if fd not in self._handlers:
                return
            r, w = self._handlers[fd]
            if w is None:
                return  # write interest never armed: nothing to change
                # (this is the COMMON case — every inline-drained write
                # used to pay a wakeup-pipe round trip here, ~2ms each)
            self._handlers[fd] = (r, None)
            if r is None:
                self._remove_locked(fd)
            else:
                self._apply_locked(fd)
        self._wakeup()

    def suspend_read(self, fd: int) -> None:
        """Stop delivering read events while an off-loop cutter owns the
        socket's read side; write interest is preserved."""
        with self._lock:
            if fd not in self._handlers:
                return
            self._read_suspended.add(fd)
            self._apply_locked(fd)
        self._wakeup()

    def resume_read(self, fd: int) -> None:
        with self._lock:
            if fd not in self._handlers:
                return
            self._read_suspended.discard(fd)
            self._apply_locked(fd)
        self._wakeup()

    def remove_consumer(self, fd: int) -> None:
        with self._lock:
            self._remove_locked(fd)
        self._wakeup()

    def _remove_locked(self, fd: int) -> None:
        self._handlers.pop(fd, None)
        self._read_suspended.discard(fd)
        try:
            self._selector.unregister(fd)
        except KeyError:
            pass

    def stop(self) -> None:
        self._stopped = True
        self._wakeup()

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)

    # ------------------------------------------------------------------ loop
    def _wakeup(self) -> None:
        try:
            os.write(self._wake_w, b"\x00")
        except OSError:
            pass

    def _run(self) -> None:
        # Load-adaptive select timeout: after a quantum that delivered real
        # events, the next frame of the conversation is usually already in
        # flight — burn a few zero-timeout selects (each one a syscall, so
        # the GIL is released per probe) before decaying back to the 1s
        # park. The spin budget adapts: probes that see events grow it,
        # dry probe runs shrink it toward the floor, so an idle loop (or a
        # single-core box where the peer needs this CPU) spends its life
        # parked exactly as before.
        # small ceiling: each probe is a syscall, and a dry decay from the
        # cap must stay well under the 1ms scale the spin is trying to win
        from brpc_tpu_torch.profiling import registry as _prof

        _prof.register_current_thread(_prof.ROLE_POLLER)
        spin = _wakeup.get_spin(f"dispatcher:{self._thread.name}",
                                initial=8, floor=1, ceiling=64)
        spin_left = 0
        while not self._stopped:
            spinning = spin_left > 0
            try:
                events = self._selector.select(
                    timeout=0.0 if spinning else 1.0)
            except OSError:
                continue
            if spinning:
                spin_left -= 1
                _wakeup.g_wakeup_spins.put(1)
            if events:
                if spinning:
                    spin.note_win()
                spin_left = spin.budget
            elif spinning and spin_left == 0:
                spin.note_loss()
            for key, mask in events:
                if key.fd == self._wake_r:
                    try:
                        while os.read(self._wake_r, 4096):
                            pass
                    except BlockingIOError:
                        pass
                    continue
                with self._lock:
                    on_r, on_w = self._handlers.get(key.fd, (None, None))
                    if key.fd in self._read_suspended:
                        on_r = None
                self.events_dispatched.put(1)
                if mask & selectors.EVENT_READ and on_r:
                    try:
                        on_r()
                    except Exception:
                        log.exception("read handler failed (fd=%d)", key.fd)
                if mask & selectors.EVENT_WRITE and on_w:
                    try:
                        on_w()
                    except Exception:
                        log.exception("write handler failed (fd=%d)", key.fd)
        try:
            self._selector.close()
        except OSError:
            pass


# --------------------------------------------------------------------- pool
_pool: List[EventDispatcher] = []
_pool_lock = threading.Lock()
_pick_counter = 0


def _dispatcher_count() -> int:
    from brpc_tpu_torch import flags

    try:
        return max(1, int(flags.get("event_dispatcher_num")))
    except Exception:
        return 1


def _ensure_pool() -> List[EventDispatcher]:
    global _pool
    with _pool_lock:
        want = _dispatcher_count()
        while len(_pool) < want:
            _pool.append(
                EventDispatcher(name=f"event-dispatcher-{len(_pool)}"))
        return _pool


def pick_dispatcher() -> EventDispatcher:
    """Round-robin assignment of new sockets across the dispatcher pool
    (reference: fd-hash over event_dispatcher_num loops)."""
    global _pick_counter
    pool = _ensure_pool()
    with _pool_lock:
        _pick_counter += 1
        return pool[_pick_counter % len(pool)]


def all_dispatchers() -> List[EventDispatcher]:
    return _ensure_pool()


def global_dispatcher() -> EventDispatcher:
    """The pool's first loop — kept for callers that need a stable
    dispatcher (listeners, bootstrap sockets)."""
    return _ensure_pool()[0]
