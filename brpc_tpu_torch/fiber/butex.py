"""Butex — wait/wake on a 32-bit word (reference bthread/butex.h:41-84).

The foundation of every blocking primitive in the reference: a fiber waits
until the word's value differs from an expected value; wakers change the word
and wake sleepers. Our adaptation keeps the compare-and-sleep contract (it is
what Stream flow control and call-id join are written against) on top of a
condition variable; on the TPU datapath the "waker" is a PJRT completion
callback (SURVEY §5.8: butex signaled from PJRT callback).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from brpc_tpu_torch.fiber import wakeup as _wakeup

# shared spin budget for every butex wait (per-site granularity lives in
# the contention table; the spin policy adapts to the process-wide mix)
_spin = _wakeup.get_spin("butex")

# contention bookkeeping (reference bthread/mutex.cpp:63-80 contention
# profiler): per-site wait counts + total wait time, sampled cheaply —
# only waits that actually blocked are recorded
_contention: Dict[str, List[int]] = {}
_contention_lock = threading.Lock()


def record_contention(site: str, wait_ns: int) -> None:
    with _contention_lock:
        ent = _contention.get(site)
        if ent is None:
            if len(_contention) >= 1024:  # bounded table
                return
            _contention[site] = [1, wait_ns]
        else:
            ent[0] += 1
            ent[1] += wait_ns
    _maybe_capture_stack(site, wait_ns)


def contention_stats() -> List[Tuple[str, int, int]]:
    """[(site, waits, total_wait_ns)] sorted by wait time desc."""
    with _contention_lock:
        rows = [(site, ent[0], ent[1]) for site, ent in _contention.items()]
    return sorted(rows, key=lambda r: -r[2])


# sampled waiter STACKS per site (reference contention profiler records
# where waiters came from, not just the wait word's label): site ->
# collapsed stack -> [waits, total_wait_ns]. Collector-budget-gated so the
# capture cost scales with the observability budget, not the wait rate.
_contention_stacks: Dict[str, Dict[Tuple[str, ...], List[int]]] = {}
_MAX_STACK_SITES = 256
_MAX_STACKS_PER_SITE = 8
_collector = None


def _maybe_capture_stack(site: str, wait_ns: int) -> None:
    global _collector
    if _collector is None:
        from brpc_tpu_torch.metrics.collector import global_collector

        _collector = global_collector()
    if (time.monotonic() < _collector._deny_until
            or not _collector.ask_to_be_sampled()):
        return
    import sys

    from brpc_tpu_torch.profiling.sampler import collapse

    # _getframe(2): the caller of record_contention — the wait site itself
    # (Butex.wait, TrackedLock.acquire, ...)
    try:
        frame = sys._getframe(2)
    except ValueError:
        frame = sys._getframe()
    stack = collapse(frame)
    with _contention_lock:
        stacks = _contention_stacks.get(site)
        if stacks is None:
            if len(_contention_stacks) >= _MAX_STACK_SITES:
                return
            stacks = _contention_stacks[site] = {}
        ent = stacks.get(stack)
        if ent is None:
            if len(stacks) >= _MAX_STACKS_PER_SITE:
                return
            stacks[stack] = [1, wait_ns]
        else:
            ent[0] += 1
            ent[1] += wait_ns


def contention_stacks() -> Dict[str, List[Tuple[str, int, int]]]:
    """site -> [(folded_stack, waits, total_wait_ns)] sorted by wait time
    desc within each site."""
    with _contention_lock:
        out = {}
        for site, stacks in _contention_stacks.items():
            rows = [(";".join(st), ent[0], ent[1])
                    for st, ent in stacks.items()]
            out[site] = sorted(rows, key=lambda r: -r[2])
    return out


def reset_contention_for_test() -> None:
    with _contention_lock:
        _contention.clear()
        _contention_stacks.clear()


class Butex:
    __slots__ = ("_value", "_cond", "_site")

    def __init__(self, value: int = 0, site: str = ""):
        self._value = value
        self._cond = threading.Condition()
        self._site = site

    @property
    def value(self) -> int:
        return self._value

    def set_value(self, value: int) -> None:
        with self._cond:
            self._value = value

    def wait(self, expected: int, timeout: Optional[float] = None) -> bool:
        """Block while value == expected. True if woken, False on timeout.

        Returns immediately if the value already differs (the lost-wakeup
        guard that makes the butex protocol race-free).
        """
        # spin-then-park: probe the word lock-free before paying for the
        # condition variable (racy read is safe — the locked re-check below
        # is still the authority; a spin "win" only short-circuits a park)
        if self._value != expected:
            return True
        if (timeout is None or timeout > 0) and _spin.spin(
                lambda: self._value != expected):
            return True
        with self._cond:
            if self._value != expected:
                return True
            t0 = time.monotonic_ns()
            woken = self._cond.wait_for(
                lambda: self._value != expected, timeout=timeout
            )
            if self._site:
                record_contention(self._site, time.monotonic_ns() - t0)
            return woken

    def wake(self, value: Optional[int] = None, n: Optional[int] = None) -> None:
        """Optionally store a new value, then wake sleepers (all by default)."""
        with self._cond:
            if value is not None:
                self._value = value
            if n is None:
                self._cond.notify_all()
            else:
                self._cond.notify(n)

    def add_and_wake(self, delta: int = 1) -> int:
        with self._cond:
            self._value += delta
            self._cond.notify_all()
            return self._value
