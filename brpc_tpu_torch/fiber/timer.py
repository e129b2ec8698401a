"""TimerThread — schedule/unschedule callbacks at an absolute time.

Rebuild of ``bthread/timer_thread.h:53-82``: backs every RPC timeout and
backup-request timer. One daemon thread sleeps on a heap of deadlines;
``unschedule`` marks the entry dead (O(1)) instead of re-heapifying, matching
the reference's lazy-deletion design.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, Optional


class _Entry:
    __slots__ = ("deadline", "seq", "fn", "args", "cancelled")

    def __init__(self, deadline: float, seq: int, fn, args):
        self.deadline = deadline
        self.seq = seq
        self.fn = fn
        self.args = args
        self.cancelled = False

    def __lt__(self, other: "_Entry") -> bool:
        return (self.deadline, self.seq) < (other.deadline, other.seq)


class TimerThread:
    def __init__(self, name: str = "fiber-timer"):
        self._heap: list = []
        self._entries = {}
        self._cond = threading.Condition()
        self._seq = itertools.count()
        self._stopped = False
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._started = False

    def _ensure_started(self) -> None:
        if not self._started:
            self._started = True
            self._thread.start()

    # ------------------------------------------------------------------- api
    def schedule(self, fn: Callable, delay_s: float, *args) -> int:
        """Run fn(*args) after delay_s seconds; returns a timer id."""
        return self.schedule_abs(fn, time.monotonic() + delay_s, *args)

    def schedule_abs(self, fn: Callable, abstime: float, *args) -> int:
        entry = _Entry(abstime, next(self._seq), fn, args)
        with self._cond:
            self._ensure_started()
            # wake the sleeper only when this deadline becomes the new
            # head: an RPC-timeout timer landing behind the current head
            # (the overwhelmingly common case) must not cost a thread
            # wakeup per call — the sleeper's timed wait already covers it
            wake = not self._heap or abstime < self._heap[0].deadline
            heapq.heappush(self._heap, entry)
            self._entries[entry.seq] = entry
            if wake:
                self._cond.notify()
        return entry.seq

    def unschedule(self, timer_id: int) -> bool:
        """Cancel; True if the timer had not fired yet."""
        with self._cond:
            entry = self._entries.pop(timer_id, None)
            if entry is None or entry.cancelled:
                return False
            entry.cancelled = True
            return True

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify()

    # ------------------------------------------------------------------ loop
    def _run(self) -> None:
        from brpc_tpu_torch.profiling import registry as _prof

        _prof.register_current_thread(_prof.ROLE_TIMER)
        while True:
            with self._cond:
                while not self._stopped:
                    if not self._heap:
                        self._cond.wait()
                        continue
                    now = time.monotonic()
                    head = self._heap[0]
                    if head.cancelled:
                        heapq.heappop(self._heap)
                        continue
                    if head.deadline <= now:
                        entry = heapq.heappop(self._heap)
                        self._entries.pop(entry.seq, None)
                        break
                    self._cond.wait(timeout=head.deadline - now)
                else:
                    return
            # fire outside the lock
            try:
                entry.fn(*entry.args)
            except Exception:
                pass


_global_timer: Optional[TimerThread] = None
_global_timer_lock = threading.Lock()


def global_timer() -> TimerThread:
    global _global_timer
    with _global_timer_lock:
        if _global_timer is None:
            _global_timer = TimerThread()
        return _global_timer


def timer_add(fn: Callable, delay_s: float, *args) -> int:
    return global_timer().schedule(fn, delay_s, *args)


def timer_del(timer_id: int) -> bool:
    return global_timer().unschedule(timer_id)
