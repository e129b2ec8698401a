"""BatchQueue — per-(service, method) admission queue with three flush
triggers: size (queue reached max_batch_size), deadline (oldest item aged
max_delay_us, via the fiber timer), and poll-batch boundary (the
dispatcher finished cutting a read batch — brpc_tpu_torch.batch.runtime installs
the hook).

Admission happens on whatever thread runs the service callback (fiber
worker on the generic path, the poller itself under usercode_inline);
flushed batches always run on a fresh fiber so a long vectorized call
never blocks the dispatcher or the timer thread.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Optional

from brpc_tpu_torch.batch import metrics as bmetrics
from brpc_tpu_torch.batch.policy import BatchPolicy
from brpc_tpu_torch.fiber import runtime as _runtime
from brpc_tpu_torch.fiber.timer import timer_add, timer_del
from brpc_tpu_torch.policy.limiters import create_limiter
from brpc_tpu_torch.rpc import errors

log = logging.getLogger("brpc_tpu_torch.batch")


def _now_us() -> int:
    return time.monotonic_ns() // 1000


class BatchItem:
    """One admitted request parked until its batch flushes."""

    __slots__ = ("cntl", "request", "done", "enqueue_us", "settled")

    def __init__(self, cntl, request, done):
        self.cntl = cntl
        self.request = request
        self.done = done
        self.enqueue_us = _now_us()
        self.settled = False


class BatchQueue:
    """Admission + flush machinery for one batched method.

    ``runner(queue, items, reason)`` is invoked on a fiber per flushed
    chunk (brpc_tpu_torch.batch.runtime.run_batch pads, calls the vectorized
    handler, scatters responses).
    """

    def __init__(self, name: str, policy: BatchPolicy,
                 runner: Callable[["BatchQueue", List[BatchItem], str], None]):
        self.name = name
        self.policy = policy
        self.runner = runner
        self.limiter = create_limiter(policy.limiter)
        self.vector_fn = None            # set by the runtime wrapper
        self._lock = threading.Lock()
        self._items: List[BatchItem] = []
        self._outstanding = 0            # admitted, not yet settled
        self._timer_id: Optional[int] = None
        self._pending_flag = False       # on the poll-boundary flush list
        # lifetime counters (rendered by /vars status + tests)
        self.admitted = 0
        self.rejected = 0
        self.flushes = 0

    # ------------------------------------------------------------ admission
    def admit(self, item: BatchItem) -> int:
        """Queue one request; returns 0 or an error code (ELIMIT)."""
        if self.limiter is not None and not self.limiter.on_request():
            self.rejected += 1
            bmetrics.g_batch_elimit.put(1)
            return errors.ELIMIT
        full_chunk = None
        with self._lock:
            # the cap counts OUTSTANDING work (queued + batches still
            # executing), not just parked items — a slow vectorized handler
            # must push back on admission, not let fibers pile up behind it
            if self._outstanding >= self.policy.max_queue:
                self.rejected += 1
                bmetrics.g_batch_elimit.put(1)
                if self.limiter is not None:
                    # hand back the slot the probe above took
                    self.limiter.on_response(0.0, errors.ELIMIT)
                return errors.ELIMIT
            self._items.append(item)
            self._outstanding += 1
            self.admitted += 1
            n = len(self._items)
            if n >= self.policy.max_batch_size:
                full_chunk = self._take_locked(self.policy.max_batch_size)
            elif n == 1 and self.policy.max_delay_us > 0 \
                    and self._timer_id is None:
                self._timer_id = timer_add(self._on_deadline,
                                           self.policy.max_delay_us / 1e6)
        if full_chunk is not None:
            self._dispatch(full_chunk, "size")
        elif self.policy.flush_on_poll_batch:
            from brpc_tpu_torch.batch import runtime as brt

            brt.note_pending(self)
        return 0

    # -------------------------------------------------------------- flushing
    def flush(self, reason: str = "manual") -> int:
        """Drain everything queued, in max_batch_size chunks; returns the
        number of items dispatched."""
        dispatched = 0
        while True:
            with self._lock:
                if not self._items:
                    return dispatched
                chunk = self._take_locked(self.policy.max_batch_size)
            dispatched += len(chunk)
            self._dispatch(chunk, reason)

    def depth(self) -> int:
        with self._lock:
            return len(self._items)

    def _take_locked(self, k: int) -> List[BatchItem]:
        chunk, self._items = self._items[:k], self._items[k:]
        if not self._items and self._timer_id is not None:
            timer_del(self._timer_id)
            self._timer_id = None
        return chunk

    def _on_deadline(self):
        with self._lock:
            self._timer_id = None
            if not self._items:
                return
        self.flush("deadline")

    def _dispatch(self, items: List[BatchItem], reason: str) -> None:
        self.flushes += 1
        bmetrics.note_flush(reason, len(items))
        now = _now_us()
        for it in items:
            bmetrics.note_queue_delay(now - it.enqueue_us)
        _runtime.start_background(self._run_safe, items, reason)

    def _run_safe(self, items: List[BatchItem], reason: str) -> None:
        try:
            self.runner(self, items, reason)
        except Exception:
            # the runner already isolates handler errors; reaching here
            # means the scatter machinery itself broke — fail the items so
            # no caller hangs until timeout
            log.exception("batch runner failed (queue=%s)", self.name)
            for it in items:
                try:
                    it.cntl.set_failed(errors.EINTERNAL,
                                       "batch runner failed")
                    it.done(None)
                except Exception:
                    pass
                finally:
                    self.settle(it, errors.EINTERNAL)

    # ------------------------------------------------------------ settlement
    def settle(self, item: BatchItem, error_code: int) -> None:
        """Per-item completion: releases the outstanding slot and the
        limiter slot taken at admission. Idempotent per item (the error
        fallback path may race a partial scatter)."""
        with self._lock:
            if item.settled:
                return
            item.settled = True
            self._outstanding -= 1
        if self.limiter is not None:
            self.limiter.on_response(_now_us() - item.enqueue_us, error_code)
