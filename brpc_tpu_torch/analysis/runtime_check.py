"""Opt-in runtime invariant checker (``BRPC_TPU_CHECK=1``).

Static analysis proves the *lexical* shape of the invariants; this module
validates the two properties only execution can show:

* **Lock order** — every lock acquisition is recorded on a thread-local
  stack; each new (held -> acquired) pair becomes an edge in a global
  order graph, and an edge that closes a cycle is a potential deadlock
  recorded at the moment the second order is first exhibited (long before
  the schedules actually collide).
* **Credit/refcount ledger** — every tunnel window credit and every
  borrowed (exported) block is tracked from acquire to release. Overdraw,
  double-release, and leaks are recorded as violations; at socket
  teardown the window must be whole, and at test exit
  :func:`assert_balanced` fails loudly if anything is still outstanding.

Everything here is dormant unless ``BRPC_TPU_CHECK=1`` is set at import
(or :func:`activate` is called): instrumented objects created while the
checker is inactive carry no token and every ledger call on them is a
no-op, so late activation mid-process is safe and the default-path cost
is one module-global boolean test.
"""

from __future__ import annotations

import gc
import itertools
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

ACTIVE = os.environ.get("BRPC_TPU_CHECK", "") == "1"

_TOKEN = "_rc_token"
_counter = itertools.count(1)


def _token(obj) -> Optional[int]:
    return getattr(obj, _TOKEN, None)


def _tag(obj) -> int:
    tok = next(_counter)
    try:
        setattr(obj, _TOKEN, tok)
    except AttributeError:  # __slots__ without _rc_token
        return -1
    return tok


# --------------------------------------------------------------- lock order
class LockOrderRecorder:
    """Thread-local acquisition stacks feeding a global order graph."""

    def __init__(self):
        self._tls = threading.local()
        self._mu = threading.Lock()
        # (held, acquired) -> thread name that first exhibited the order
        self._edges: Dict[Tuple[str, str], str] = {}
        self.violations: List[str] = []

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self.violations = []

    def _stack(self) -> List[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def on_acquire(self, name: str) -> None:
        st = self._stack()
        if name in st:  # reentrant (RLock) — no new ordering information
            st.append(name)
            return
        with self._mu:
            for held in st:
                edge = (held, name)
                if edge in self._edges:
                    continue
                self._edges[edge] = threading.current_thread().name
                cycle = self._path(name, held)
                if cycle is not None:
                    self.violations.append(
                        "lock-order cycle: "
                        + " -> ".join([held] + cycle)
                        + f" (edge {held} -> {name} first taken on thread "
                        f"{self._edges[edge]!r})")
        st.append(name)

    def on_release(self, name: str) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] == name:
                del st[i]
                return

    def _path(self, src: str, dst: str) -> Optional[List[str]]:
        """A path src ->* dst in the order graph (caller holds _mu)."""
        adj: Dict[str, List[str]] = {}
        for a, b in self._edges:
            adj.setdefault(a, []).append(b)
        seen = {src}
        stack = [(src, [src])]
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in adj.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None


class TrackedLock:
    """A Lock/RLock proxy that reports acquisitions to the recorder."""

    __slots__ = ("_name", "_lock")

    def __init__(self, name: str, lock):
        self._name = name
        self._lock = lock

    def acquire(self, *args, **kwargs) -> bool:
        # uncontended path stays a single extra branch; a blocked acquire
        # feeds the contention profiler (waits + sampled waiter stacks on
        # /hotspots/contention, site "lock:<name>")
        got = self._lock.acquire(False) if not args and not kwargs else False
        if not got:
            t0 = time.monotonic_ns()
            got = self._lock.acquire(*args, **kwargs)
            if got:
                from brpc_tpu_torch.fiber.butex import record_contention

                record_contention(f"lock:{self._name}",
                                  time.monotonic_ns() - t0)
        if got:
            lock_order.on_acquire(self._name)
        return got

    def release(self) -> None:
        lock_order.on_release(self._name)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self) -> str:
        return f"TrackedLock({self._name!r}, {self._lock!r})"


def tracked_lock(name: str, lock=None):
    """Wrap ``lock`` (default: a fresh Lock) for order recording when the
    checker is active; hand back the raw lock otherwise so the production
    path pays nothing."""
    if lock is None:
        lock = threading.Lock()
    if not ACTIVE:
        return lock
    return TrackedLock(name, lock)


# ------------------------------------------------------------ credit ledger
class CreditLedger:
    """Tracks tunnel window credits and borrowed block exports."""

    def __init__(self):
        self._mu = threading.Lock()
        # token -> [label, owner, capacity, outstanding]
        self._windows: Dict[int, list] = {}
        # token -> [label, owner, borrowed-view count]
        self._pools: Dict[int, list] = {}
        self.violations: List[str] = []

    def reset(self) -> None:
        with self._mu:
            self._windows.clear()
            self._pools.clear()
            self.violations = []

    # -- registration (call sites guard with `if ACTIVE:`) ------------------
    def track_window(self, win, capacity: int, label: str = "window",
                     owner: str = "") -> None:
        tok = _tag(win)
        if tok < 0:
            return
        with self._mu:
            self._windows[tok] = [label, owner, capacity, 0]

    def track_pool(self, pool, label: str = "pool", owner: str = "") -> None:
        tok = _tag(pool)
        if tok < 0:
            return
        with self._mu:
            self._pools[tok] = [label, owner, 0]

    # -- window credits -----------------------------------------------------
    def window_acquired(self, win, n: int) -> None:
        tok = _token(win)
        if tok is None:
            return
        with self._mu:
            rec = self._windows.get(tok)
            if rec is None:
                return
            rec[3] += n
            if rec[3] > rec[2]:
                self.violations.append(
                    f"window overdraw on {rec[0]} ({rec[1]}): "
                    f"{rec[3]} credits outstanding > capacity {rec[2]}")

    def window_released(self, win, n: int) -> None:
        tok = _token(win)
        if tok is None:
            return
        with self._mu:
            rec = self._windows.get(tok)
            if rec is None:
                return
            rec[3] -= n
            if rec[3] < 0:
                self.violations.append(
                    f"window double-release on {rec[0]} ({rec[1]}): "
                    f"outstanding went negative ({rec[3]})")
                rec[3] = 0

    def window_closed(self, win) -> None:
        """The window's shm mapping is going away. A window closed by
        tunnel failure legitimately carries in-flight credits the peer
        will never ACK (they die with the generation), so closing only
        *untracks* — graceful shutdown asserts wholeness first via
        :meth:`window_teardown`, and live windows are asserted whole at
        :meth:`assert_balanced`."""
        tok = _token(win)
        if tok is None:
            return
        with self._mu:
            self._windows.pop(tok, None)

    # -- borrowed blocks ----------------------------------------------------
    def export_added(self, pool) -> None:
        tok = _token(pool)
        if tok is None:
            return
        with self._mu:
            rec = self._pools.get(tok)
            if rec is not None:
                rec[2] += 1

    def export_dropped(self, pool) -> None:
        tok = _token(pool)
        if tok is None:
            return
        with self._mu:
            rec = self._pools.get(tok)
            if rec is None:
                return
            rec[2] -= 1
            if rec[2] < 0:
                self.violations.append(
                    f"block double-return on {rec[0]} ({rec[1]}): more "
                    f"drop_export() calls than borrows")
                rec[2] = 0

    # -- checkpoints ---------------------------------------------------------
    def window_teardown(self, win, wait: float = 0.0) -> None:
        """Graceful-close assertion: the window must be whole (every
        acquired credit released) before its endpoint shuts down. ACKs for
        the tail of the last message may still be in flight on the ctrl
        socket, so ``wait`` bounds a poll for quiescence before the
        verdict."""
        tok = _token(win)
        if tok is None:
            return
        deadline = time.monotonic() + wait
        while True:
            with self._mu:
                rec = self._windows.get(tok)
                if rec is None or rec[3] == 0:
                    return
                if time.monotonic() >= deadline:
                    self.violations.append(
                        f"graceful teardown of window {rec[0]} ({rec[1]}) "
                        f"with {rec[3]} credit(s) still outstanding — "
                        f"leaked on some send path")
                    return
            time.sleep(0.005)

    def snapshot(self) -> Dict[str, object]:
        with self._mu:
            return {
                "windows": {f"{r[0]}({r[1]})": r[3]
                            for r in self._windows.values()},
                "borrowed": {f"{r[0]}({r[1]})": r[2]
                             for r in self._pools.values() if r[2]},
                "violations": list(self.violations),
            }

    def assert_balanced(self, drain: Optional[Callable[[], None]] = None) -> None:
        """Fail if any violation was recorded or anything is outstanding.

        ``drain`` runs first (e.g. the transport's deferred-pool sweep);
        then a gc pass collects dropped zero-copy views so their release
        hooks return borrows before the balance check.
        """
        if drain is not None:
            drain()
        gc.collect()
        problems: List[str] = []
        with self._mu:
            problems.extend(self.violations)
            for rec in self._windows.values():
                if rec[3] != 0:
                    problems.append(
                        f"window {rec[0]} ({rec[1]}) still holds {rec[3]} "
                        f"credit(s)")
            for rec in self._pools.values():
                if rec[2]:
                    problems.append(
                        f"pool {rec[0]} ({rec[1]}) still has {rec[2]} "
                        f"borrowed view(s) alive")
        problems.extend(lock_order.violations)
        if problems:
            raise AssertionError(
                "BRPC_TPU_CHECK ledger not balanced:\n  "
                + "\n  ".join(problems))


lock_order = LockOrderRecorder()
ledger = CreditLedger()


def activate() -> None:
    """Turn the checker on mid-process (tests). Objects created before
    activation stay untracked — only new windows/pools/locks participate."""
    global ACTIVE
    lock_order.reset()
    ledger.reset()
    ACTIVE = True


def deactivate() -> None:
    global ACTIVE
    ACTIVE = False
    lock_order.reset()
    ledger.reset()
