"""Batch policy — the knobs of one BatchQueue.

Batch sizes are padded up to a small set of buckets, so a handler sees a
bounded set of shapes (one CUDA graph or one tuned launch per bucket)
whatever sizes traffic produces.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple, Union

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def _pow2_buckets(max_batch_size: int) -> Tuple[int, ...]:
    out = []
    k = 1
    while k < max_batch_size:
        out.append(k)
        k <<= 1
    out.append(max_batch_size)
    return tuple(out)


@dataclass
class BatchPolicy:
    """Flush triggers, padding buckets, and backpressure for one queue.

    max_batch_size  — hard cap per flushed batch (largest bucket).
    max_delay_us    — oldest queued item waits at most this long before a
                      deadline flush; 0 disables the timer (size/poll only).
    max_queue       — admission cap: queued items beyond this are rejected
                      with ELIMIT instead of queueing unboundedly.
    bucket_shapes   — padded batch sizes (the shapes a handler sees); defaults to
                      powers of two up to max_batch_size.
    flush_on_poll_batch — also flush at poll-batch boundaries (the
                      cut-batch hook), trading batch size for latency when
                      the wire goes quiet.
    limiter         — optional policy/limiters.py spec (int | 'auto' |
                      'constant:N' | 'timeout[:ms]') consulted at admission
                      and settled per item at completion.
    """

    max_batch_size: int = 32
    max_delay_us: int = 2000
    max_queue: int = 1024
    bucket_shapes: Tuple[int, ...] = field(default_factory=tuple)
    flush_on_poll_batch: bool = True
    limiter: Union[int, str, None] = None

    def __post_init__(self):
        if self.max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if self.max_queue < self.max_batch_size:
            self.max_queue = self.max_batch_size
        if not self.bucket_shapes:
            self.bucket_shapes = _pow2_buckets(self.max_batch_size)
        buckets = sorted(set(int(b) for b in self.bucket_shapes if b >= 1))
        if not buckets:
            raise ValueError("bucket_shapes must name at least one size >= 1")
        # the largest bucket must be able to carry a full batch, else a
        # size-triggered flush could never be padded to a known shape
        if buckets[-1] < self.max_batch_size:
            buckets.append(self.max_batch_size)
        self.bucket_shapes = tuple(buckets)

    def bucket_for(self, n: int) -> int:
        """Smallest declared bucket >= n (n is capped at max_batch_size)."""
        for b in self.bucket_shapes:
            if b >= n:
                return b
        return self.bucket_shapes[-1]
