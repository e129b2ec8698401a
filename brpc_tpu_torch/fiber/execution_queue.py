"""ExecutionQueue — ordered async execution with an on-demand consumer.

Rebuild of ``bthread/execution_queue.h:30-35``: producers from any thread
push items wait-free; a single consumer task is started only when the queue
transitions empty->non-empty and drains everything in order, then parks.
Guarantees strict ordering without a dedicated thread per queue — the
mechanism Streaming RPC uses for in-order message delivery (stream.cpp).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, List, Optional

from brpc_tpu_torch.fiber import runtime


class ExecutionQueue:
    """execute(item) enqueues; consumer_fn(items: list) handles batches in
    submission order. stop() + join() for graceful shutdown (a None batch is
    delivered last, like the reference's iterated-stop signal)."""

    def __init__(self, consumer_fn: Callable[[Optional[List]], None],
                 control: Optional[runtime.TaskControl] = None,
                 batch_max: int = 64):
        self._consumer_fn = consumer_fn
        self._control = control
        self._queue: deque = deque()
        self._lock = threading.Lock()
        self._running = False
        self._stopped = False
        self._drained = threading.Event()
        self._drained.set()
        self._batch_max = batch_max

    def execute(self, item) -> bool:
        """Returns False if the queue is stopped."""
        with self._lock:
            if self._stopped:
                return False
            self._queue.append(item)
            if self._running:
                return True
            # empty -> non-empty: this producer starts the consumer
            self._running = True
            self._drained.clear()
        self._spawn_consumer()
        return True

    def _spawn_consumer(self) -> None:
        if self._control is not None:
            self._control.submit(self._consume)
        else:
            runtime.start_background(self._consume)

    def _consume(self) -> None:
        while True:
            with self._lock:
                if not self._queue:
                    self._running = False
                    stopped = self._stopped
                    self._drained.set()
                    break
                batch = []
                while self._queue and len(batch) < self._batch_max:
                    batch.append(self._queue.popleft())
            try:
                self._consumer_fn(batch)
            except Exception:
                pass
        if stopped:
            try:
                self._consumer_fn(None)  # stop signal, delivered once drained
            except Exception:
                pass

    def stop(self) -> None:
        notify_now = False
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            if not self._running and not self._queue:
                notify_now = True
        if notify_now:
            try:
                self._consumer_fn(None)
            except Exception:
                pass

    def join(self, timeout: Optional[float] = None) -> bool:
        return self._drained.wait(timeout)

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)
