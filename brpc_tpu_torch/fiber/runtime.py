"""Fiber runtime — the M:N task scheduler (reference bthread TaskControl/
TaskGroup, task_control.cpp:213/task_group.cpp:470).

Semantics carried over, not code: ``start_background`` enqueues a task for
any worker; ``start_urgent`` runs it at the head of the queue (the
reference's start_foreground makes the *caller* yield — meaningless under
the GIL, so urgency maps to queue position); workers own a local deque and
steal from siblings when idle (Chase-Lev in the reference,
work_stealing_queue.h:32); tagged worker groups isolate pools
(task_control.cpp:291). Python threads are the "pthread workers"; tasks are
plain callables — IO-bound RPC work is where M:N pays off under the GIL,
and device-bound work is dispatched to XLA asynchronously anyway.

Wakeup design (reference ParkingLot, parking_lot.h / task_control.cpp:565):
every submit bumps a per-group signal word and wakes exactly one parked
worker; a worker about to park re-checks the word it read before its last
(futile) scan, so a submit that raced the scan is never missed.  No polling
loops — dispatch latency at idle is one condvar notify.
"""

from __future__ import annotations

import random
import threading
from collections import deque
from typing import Callable, Dict, List, Optional

from brpc_tpu_torch.fiber.butex import contention_stats  # noqa: F401  (re-export for /hotspots/contention)
from brpc_tpu_torch.metrics.reducer import Adder

DEFAULT_TAG = 0


class FiberTask:
    __slots__ = ("fn", "args", "done", "error", "_event", "keytable")

    def __init__(self, fn, args):
        self.fn = fn
        self.args = args
        self.done = False
        self.error: Optional[BaseException] = None
        self._event = threading.Event()
        self.keytable = None  # fiber-local storage (fiber/local.py)

    def run(self) -> None:
        from brpc_tpu_torch.fiber import local as _local

        _local._enter_task(self)
        try:
            self.fn(*self.args)
        except BaseException as e:  # noqa: BLE001 - task errors are captured
            self.error = e
        finally:
            _local._exit_task(self)
            self.done = True
            self._event.set()

    def join(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)


class ParkingLot:
    """Futex-style sleep/wake for idle workers (reference parking_lot.h).

    ``state()`` returns the current signal word; ``wait(expected)`` parks
    only if the word is still ``expected`` (i.e. no signal arrived since the
    caller last looked for work); ``signal()`` bumps the word and wakes one
    parked worker.  The value-compare closes the scan→park race without any
    polling interval.  Deliberately NOT built on fiber.butex.Butex: the
    reference likewise keeps ParkingLot separate from butex
    (parking_lot.h vs butex.cpp) — butex carries contention accounting the
    scheduler idle path must not pay, and a spurious wakeup here is harmless
    (the worker just rescans for work).
    """

    __slots__ = ("_cond", "_signal", "_parked")

    def __init__(self):
        self._cond = threading.Condition()
        self._signal = 0
        self._parked = 0

    def state(self) -> int:
        with self._cond:
            return self._signal

    def signal(self, all_workers: bool = False) -> None:
        with self._cond:
            self._signal += 1
            if all_workers:
                self._cond.notify_all()
            elif self._parked:
                self._cond.notify()

    def wait(self, expected: int, timeout: Optional[float] = None) -> None:
        with self._cond:
            if self._signal != expected:
                return
            self._parked += 1
            try:
                self._cond.wait(timeout)
            finally:
                self._parked -= 1


class _Worker(threading.Thread):
    def __init__(self, control: "TaskControl", index: int, tag: int):
        super().__init__(name=f"fiber-worker-{tag}-{index}", daemon=True)
        self.control = control
        self.index = index
        self.tag = tag
        self.local: deque = deque()
        self.lock = threading.Lock()
        self.current: Optional[FiberTask] = None  # /fibers task visibility

    def run(self) -> None:
        from brpc_tpu_torch.profiling import registry as _prof

        _prof.register_current_thread(_prof.ROLE_WORKER)
        control = self.control
        lot = control._lot(self.tag)
        while not control._stopped:
            expected = lot.state()
            task = self._next_task()
            if task is None:
                # Park until a submit bumps the signal word. A submit that
                # landed after our scan already changed the word, so wait()
                # returns immediately (reference TaskGroup::wait_task,
                # task_group.cpp:162).
                lot.wait(expected, timeout=1.0)
                continue
            control.tasks_executed.put(1)
            self.current = task
            try:
                task.run()
            finally:
                self.current = None

    def _next_task(self) -> Optional[FiberTask]:
        with self.lock:
            if self.local:
                return self.local.popleft()
        return self.control._steal(self)

    def push(self, task: FiberTask, urgent: bool) -> None:
        with self.lock:
            if urgent:
                self.local.appendleft(task)
            else:
                self.local.append(task)

    def depth(self) -> int:
        return len(self.local)  # racy read is fine — used as a heuristic


class TaskControl:
    """Global scheduler: owns workers per tag group, submits to the
    shallowest queue, wakes a parked worker on every submit, and lets idle
    workers steal from siblings."""

    def __init__(self, concurrency: int = 8):
        self._workers: Dict[int, List[_Worker]] = {}
        self._lots: Dict[int, ParkingLot] = {}
        self._stopped = False
        self._lock = threading.Lock()
        self._default_concurrency = concurrency
        self.tasks_executed = Adder()

    def _lot_locked(self, tag: int) -> ParkingLot:
        # caller holds self._lock
        lot = self._lots.get(tag)
        if lot is None:
            lot = self._lots[tag] = ParkingLot()
        return lot

    def _lot(self, tag: int) -> ParkingLot:
        # lock-free fast path: lots are created once and never removed
        lot = self._lots.get(tag)
        if lot is not None:
            return lot
        with self._lock:
            return self._lot_locked(tag)

    def _group(self, tag: int) -> List[_Worker]:
        group = self._workers.get(tag)
        if group is not None:
            return group
        with self._lock:
            group = self._workers.get(tag)
            if group is None:
                self._lot_locked(tag)
                group = [
                    _Worker(self, i, tag)
                    for i in range(self._default_concurrency)
                ]
                self._workers[tag] = group
                for w in group:
                    w.start()
            return group

    def add_workers(self, n: int, tag: int = DEFAULT_TAG) -> None:
        with self._lock:
            self._lot_locked(tag)
            group = self._workers.setdefault(tag, [])
            base = len(group)
            new = [_Worker(self, base + i, tag) for i in range(n)]
            group.extend(new)
        for w in new:
            w.start()

    def concurrency(self, tag: int = DEFAULT_TAG) -> int:
        with self._lock:
            return len(self._workers.get(tag, ())) or self._default_concurrency

    # ------------------------------------------------------------ submission
    def submit(self, fn: Callable, args=(), urgent: bool = False,
               tag: int = DEFAULT_TAG) -> FiberTask:
        task = FiberTask(fn, args)
        group = self._group(tag)
        # Power-of-two-choices on queue depth: cheaper than a full scan at
        # large concurrency, and avoids the blind round-robin pile-up the
        # reference solves with per-group signalling (task_control.cpp:565).
        n = len(group)
        if n == 1:
            worker = group[0]
        else:
            a = group[random.randrange(n)]
            b = group[random.randrange(n)]
            worker = a if a.depth() <= b.depth() else b
        worker.push(task, urgent)
        self._lot(tag).signal()
        return task

    # -------------------------------------------------------------- stealing
    def _steal(self, thief: _Worker) -> Optional[FiberTask]:
        group = self._workers.get(thief.tag, ())
        n = len(group)
        if n <= 1:
            return None
        start = random.randrange(n)
        for i in range(n):
            victim = group[(start + i) % n]
            if victim is thief:
                continue
            with victim.lock:
                if victim.local:
                    return victim.local.pop()  # steal from the tail
        return None

    def stop(self) -> None:
        self._stopped = True
        with self._lock:
            lots = list(self._lots.values())
        for lot in lots:
            lot.signal(all_workers=True)


_global_control: Optional[TaskControl] = None
_global_lock = threading.Lock()


def global_control() -> TaskControl:
    global _global_control
    with _global_lock:
        if _global_control is None:
            _global_control = TaskControl()
        return _global_control


def start_background(fn: Callable, *args, tag: int = DEFAULT_TAG) -> FiberTask:
    """Queue a task for any worker (bthread_start_background)."""
    return global_control().submit(fn, args, urgent=False, tag=tag)


def start_urgent(fn: Callable, *args, tag: int = DEFAULT_TAG) -> FiberTask:
    """Queue a task at the head — processed before background work
    (bthread_start_urgent semantics, minus the caller-yield)."""
    return global_control().submit(fn, args, urgent=True, tag=tag)
