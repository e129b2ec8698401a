"""Batch runtime — the wrapper between the dispatch path and a vectorized
handler.

Integration contract (rpc/server_processing.py, both dispatch paths): a
service method that returns None without invoking ``done`` has gone async;
the wrapper produced by :func:`batched_method` / :func:`make_batched`
enqueues the request and returns None, so batched methods ride the normal
and fast dispatch paths with no dispatcher changes. Rejections use the
other half of the contract: ``cntl.set_failed(ELIMIT); return None`` makes
the dispatcher send the error itself.

Flush-on-poll-boundary: queues that admitted items register here; the
InputMessenger calls :func:`flush_poll_batch` after cutting each read
batch (and the native poll loop after each event batch), so a burst parsed
together is batched together.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Sequence

from brpc_tpu_torch.batch import metrics as bmetrics
from brpc_tpu_torch.batch.policy import BatchPolicy
from brpc_tpu_torch.batch.queue import BatchItem, BatchQueue
from brpc_tpu_torch.profiling import registry as _prof
from brpc_tpu_torch.rpc import errors

log = logging.getLogger("brpc_tpu_torch.batch")


# --------------------------------------------------------------------------
#  BatchContext — what a vectorized handler receives
# --------------------------------------------------------------------------
class BatchContext:
    """One flushed batch: the live items plus stack/pad helpers.

    ``size`` is the number of real requests, ``bucket`` the padded batch
    the handler should compute at (a declared bucket_shape, so the set of shapes
    it sees stays bounded). Rows ``size..bucket-1`` are padding; the runtime
    discards their outputs at scatter time.
    """

    def __init__(self, items: List[BatchItem], bucket: int, reason: str):
        self.items = items
        self.size = len(items)
        self.bucket = bucket
        self.reason = reason
        self._errors: Dict[int, tuple] = {}

    @property
    def requests(self) -> list:
        return [it.request for it in self.items]

    @property
    def controllers(self) -> list:
        return [it.cntl for it in self.items]

    def fail(self, index: int, error_code: int, text: str = "") -> None:
        """Fail one item without touching the rest of the batch."""
        self._errors[index] = (error_code, text)

    def failed(self, index: int) -> bool:
        return index in self._errors

    def stack(self, rows: Sequence, dtype=None, pad_value=0):
        """Stack per-item rows into a (bucket, ...) array, padding the tail.

        A row that cannot be coerced to the leading row's shape/dtype fails
        alone (EREQUEST) and its slot is left as padding — one malformed
        tensor must not poison the batch.
        """
        import numpy as np

        first = None
        for i, r in enumerate(rows):
            try:
                first = np.asarray(r, dtype=dtype)
                break
            except Exception as e:
                self.fail(i, errors.EREQUEST, f"bad request tensor: {e}")
        if first is None:
            raise ValueError("every row in the batch was malformed")
        out = np.full((self.bucket,) + first.shape, pad_value,
                      dtype=first.dtype)
        for i, r in enumerate(rows):
            if i in self._errors:
                continue
            try:
                out[i] = np.asarray(r, dtype=first.dtype)
            except Exception as e:
                self.fail(i, errors.EREQUEST, f"bad request tensor: {e}")
        return out

    def device_arrays(self, handles: Sequence[int], store=None,
                      device=None) -> list:
        """Resolve DeviceStore handles to device-resident tensors (the
        store of ``device``, the card by default); an unknown handle
        fails its item alone and yields None in its slot."""
        if store is None:
            from brpc_tpu_torch.tpu.device_lane import global_store

            store = global_store(device)
        out = []
        for i, h in enumerate(handles):
            arr = store.lookup(h)
            if arr is None:
                self.fail(i, errors.EREQUEST, f"unknown device handle {h}")
            out.append(arr)
        return out


# --------------------------------------------------------------------------
#  Batch execution: pad -> one vectorized call -> scatter
# --------------------------------------------------------------------------
def _finish(queue: BatchQueue, item: BatchItem, response,
            error_code: int, text: str) -> None:
    try:
        if error_code:
            item.cntl.set_failed(error_code, text)
        item.done(response)
    except Exception:
        # a dead connection must not take down the rest of the scatter
        log.exception("batch done callback failed (queue=%s)", queue.name)
    finally:
        queue.settle(item, error_code)


def run_batch(queue: BatchQueue, items: List[BatchItem], reason: str) -> None:
    """Runner installed on every BatchQueue: build the context, invoke the
    vectorized handler once, scatter per-item responses/errors."""
    bucket = queue.policy.bucket_for(len(items))
    bmetrics.note_pad_waste(bucket, len(items))
    ctx = BatchContext(items, bucket, reason)
    now_us = time.monotonic_ns() // 1000
    note = (f"batch: size={ctx.size} bucket={bucket} reason={reason} "
            f"queue={queue.name}")
    spans = []
    for it in items:
        span = getattr(it.cntl, "span", None)
        if span is not None:
            span.annotate(f"{note} queue_delay={now_us - it.enqueue_us}us")
            # phase marks ride the full Span API only (controllers under
            # test may carry duck-typed spans with just annotate())
            if hasattr(span, "add_phase"):
                span.add_phase("batch_wait_us",
                               max(0, now_us - it.enqueue_us))
                span.event("batch", size=ctx.size, bucket=bucket,
                           pad=bucket - ctx.size, reason=reason,
                           queue=queue.name)
                spans.append(span)
    t_exec = time.monotonic_ns()
    prev_ph = _prof.set_phase("execute")
    try:
        responses = queue.vector_fn(ctx)
    except Exception as e:
        _prof.set_phase(prev_ph)
        if len(items) == 1:
            _finish(queue, items[0], None, errors.EINTERNAL,
                    f"batched handler raised: {e!r}")
            bmetrics.g_batch_item_errors.put(1)
            return
        # isolation: the handler died on the batch — re-run every item as
        # its own singleton so one poisoned request fails alone
        bmetrics.g_batch_isolations.put(1)
        log.warning("batched handler raised on %d items (queue=%s): %r — "
                    "isolating", len(items), queue.name, e)
        for it in items:
            run_batch(queue, [it], "isolate")
        return
    _prof.set_phase(prev_ph)
    # the vectorized call's wall time is every rider's device time: each
    # item waited for the whole call, so each span carries the full mark
    exec_us = (time.monotonic_ns() - t_exec) / 1000.0
    for span in spans:
        span.add_phase("execute_us", exec_us)
    n_resp = len(responses) if responses is not None else 0
    for i, it in enumerate(items):
        err = ctx._errors.get(i)
        if err is not None:
            bmetrics.g_batch_item_errors.put(1)
            _finish(queue, it, None, err[0],
                    err[1] or errors.error_text(err[0]))
        elif i < n_resp and responses[i] is not None:
            _finish(queue, it, responses[i], 0, "")
        else:
            bmetrics.g_batch_item_errors.put(1)
            _finish(queue, it, None, errors.EINTERNAL,
                    "batched handler produced no response for item")


# --------------------------------------------------------------------------
#  Poll-batch-boundary flushing
# --------------------------------------------------------------------------
_pending_lock = threading.Lock()
_pending: List[BatchQueue] = []
_hooks_installed = False


def note_pending(queue: BatchQueue) -> None:
    """Mark a queue for flushing at the next poll-batch boundary."""
    install = False
    with _pending_lock:
        if not queue._pending_flag:
            queue._pending_flag = True
            _pending.append(queue)
        global _hooks_installed
        if not _hooks_installed:
            _hooks_installed = True
            install = True
    if install:
        _install_hooks()


def flush_poll_batch() -> None:
    """Poll-batch boundary: drain every queue that admitted since the last
    boundary. Called by InputMessenger.cut_messages and the native poll
    loop; cheap no-op when nothing is pending."""
    if not _pending:
        return
    with _pending_lock:
        queues = _pending[:]
        _pending.clear()
        for q in queues:
            q._pending_flag = False
    for q in queues:
        q.flush("poll")


def _install_hooks() -> None:
    from brpc_tpu_torch.rpc import input_messenger

    input_messenger.poll_batch_hook = flush_poll_batch
    from brpc_tpu_torch.rpc import native_transport

    native_transport.poll_batch_hook = flush_poll_batch


def _reset_hooks_for_test() -> None:
    global _hooks_installed
    with _pending_lock:
        for q in _pending:
            q._pending_flag = False
        _pending.clear()
        _hooks_installed = False


# --------------------------------------------------------------------------
#  The user-facing wrappers
# --------------------------------------------------------------------------
class _BoundBatchedMethod:
    """The callable the dispatcher sees: (cntl, request, done) -> None.

    Enqueues into its BatchQueue and returns None (async per the dispatch
    contract); on rejection marks the controller ELIMIT so the dispatcher
    sends the error."""

    __slots__ = ("queue", "__name__")

    def __init__(self, name: str, vector_fn, policy: BatchPolicy):
        self.queue = BatchQueue(name, policy, run_batch)
        self.queue.vector_fn = vector_fn
        self.__name__ = name

    def __call__(self, cntl, request, done):
        # server-side deadline: don't enqueue work whose client budget is
        # already spent — it would occupy a batch slot only to have its
        # response dropped by the caller
        dl = getattr(cntl, "deadline_mono", 0.0)
        if dl and time.monotonic() >= dl:
            from brpc_tpu_torch.rpc.server_processing import \
                g_server_deadline_expired

            g_server_deadline_expired.put(1)
            cntl.set_failed(errors.ERPCTIMEDOUT,
                            "request deadline already spent before batch "
                            "enqueue")
            return None
        rc = self.queue.admit(BatchItem(cntl, request, done))
        if rc != 0:
            cntl.set_failed(rc, f"batch queue {self.queue.name} over "
                                f"capacity")
        elif getattr(getattr(cntl, "_srv_socket", None),
                     "priority_lane", False):
            # latency-sensitive lane: a request arriving on the tpu
            # tunnel's priority sub-stream is exempt from batch_wait —
            # flush whatever this admission formed immediately
            self.queue.flush("priority")
        return None


def make_batched(name: str, vector_fn, **policy_knobs) -> _BoundBatchedMethod:
    """Wrap a vectorized callable ``fn(BatchContext) -> [responses]`` for
    manual ``Service.add_method(name, make_batched(...), req, resp)``."""
    return _BoundBatchedMethod(name, vector_fn, BatchPolicy(**policy_knobs))


class _BatchedMethodDescriptor:
    """What @batched_method leaves on the class: binding an instance builds
    that instance's _BoundBatchedMethod (one BatchQueue per service object,
    named <service>.<method>) and caches it in the instance dict — so
    Service.__init__'s getattr() wires the wrapper straight into the
    MethodEntry."""

    def __init__(self, fn, policy: BatchPolicy):
        self._fn = fn
        self._policy = policy
        self._name = fn.__name__
        self.__doc__ = fn.__doc__

    def __set_name__(self, owner, name):
        self._name = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        service = getattr(obj, "service_name", type(obj).__name__)
        bound = _BoundBatchedMethod(f"{service}.{self._name}",
                                    self._fn.__get__(obj), self._policy)
        obj.__dict__[self._name] = bound
        return bound


def batched_method(fn=None, *, max_batch_size: int = 32,
                   max_delay_us: int = 2000, max_queue: int = 1024,
                   bucket_shapes: Sequence[int] = (),
                   flush_on_poll_batch: bool = True,
                   limiter=None):
    """Declare a vectorized service method.

    The decorated function takes ``(self, batch: BatchContext)`` and
    returns a list of >= batch.size responses (index-aligned; slots the
    handler ``batch.fail()``-ed may hold None). Example::

        class Inference(Service):
            @batched_method(bucket_shapes=(1, 4, 16, 64), max_delay_us=1000)
            def Infer(self, batch):
                x = batch.stack([parse(r) for r in batch.requests])
                y = self.model(x)              # ONE device call
                return [make_resp(y[i]) for i in range(batch.size)]
    """
    policy = BatchPolicy(max_batch_size=max_batch_size,
                         max_delay_us=max_delay_us, max_queue=max_queue,
                         bucket_shapes=tuple(bucket_shapes),
                         flush_on_poll_batch=flush_on_poll_batch,
                         limiter=limiter)

    def wrap(f):
        return _BatchedMethodDescriptor(f, policy)

    if fn is not None:  # bare @batched_method
        return wrap(fn)
    return wrap
