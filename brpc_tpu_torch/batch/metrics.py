"""Batching observability — the /vars view of the coalescing machinery.

Global (all queues) recorders; per-queue numbers live on the queue object
and are rendered by its own exposed status variable. ``g_batch_size`` and
``g_batch_queue_delay_us`` are the two counters the bench sweep and CI
smoke assert on.
"""

from __future__ import annotations

import threading
from typing import Dict

from brpc_tpu_torch.metrics import Adder, IntRecorder, Variable


class AvgVariable(Variable):
    """Running average of an IntRecorder as `avg (count=N)` — whole-run, not
    windowed, so a post-hoc /vars fetch still sees the bench's traffic."""

    def __init__(self, recorder: IntRecorder):
        super().__init__()
        self._recorder = recorder

    def get_value(self):
        return self._recorder.average()

    def describe(self) -> str:
        s, c = self._recorder.get_value()
        return f"{(s / c if c else 0.0):.1f} (count={c})"


# batch size at flush time (items per vectorized call)
batch_size_recorder = IntRecorder()
# per-item time from admission to flush dispatch
queue_delay_recorder = IntRecorder()

g_batch_size = AvgVariable(batch_size_recorder).expose("g_batch_size")
g_batch_queue_delay_us = AvgVariable(queue_delay_recorder).expose(
    "g_batch_queue_delay_us")

g_batch_items = Adder("g_batch_items")                # items batched, total
g_batch_flush_size = Adder("g_batch_flush_size")      # flushes by trigger
g_batch_flush_deadline = Adder("g_batch_flush_deadline")
g_batch_flush_poll = Adder("g_batch_flush_poll")
g_batch_elimit = Adder("g_batch_elimit")              # admissions rejected
g_batch_item_errors = Adder("g_batch_item_errors")    # items failed alone
g_batch_isolations = Adder("g_batch_isolations")      # batches re-run 1-by-1

_FLUSH_ADDERS = {
    "size": g_batch_flush_size,
    "deadline": g_batch_flush_deadline,
    "poll": g_batch_flush_poll,
}


def note_flush(reason: str, size: int) -> None:
    batch_size_recorder.record(size)
    g_batch_items.put(size)
    adder = _FLUSH_ADDERS.get(reason)
    if adder is not None:
        adder.put(1)


def note_queue_delay(delay_us: float) -> None:
    queue_delay_recorder.record(delay_us)


# ---------------------------------------------------------------------------
# per-bucket pad waste: a flush padded to bucket B with S live items
# wasted B-S padded rows of compute. One recorder per bucket size, exposed
# lazily as g_batch_pad_waste_<bucket> ("avg wasted rows (count=flushes)"),
# so /vars shows exactly which bucket boundaries burn padding — the signal
# for retuning BatchPolicy.buckets.
_pad_waste_lock = threading.Lock()
_pad_waste_recorders: Dict[int, IntRecorder] = {}
_pad_waste_vars: Dict[int, AvgVariable] = {}  # keep exposed vars alive


def note_pad_waste(bucket: int, size: int) -> None:
    waste = bucket - size
    if waste < 0:  # unbucketed policy (bucket_for returned size)
        return
    rec = _pad_waste_recorders.get(bucket)
    if rec is None:
        with _pad_waste_lock:
            rec = _pad_waste_recorders.get(bucket)
            if rec is None:
                rec = IntRecorder()
                _pad_waste_vars[bucket] = AvgVariable(rec).expose(
                    f"g_batch_pad_waste_{bucket}")
                _pad_waste_recorders[bucket] = rec
    rec.record(waste)


def pad_waste_buckets() -> Dict[int, IntRecorder]:
    """Snapshot of the per-bucket recorders (tests, dashboards)."""
    with _pad_waste_lock:
        return dict(_pad_waste_recorders)
