"""batch — adaptive request batching: N concurrent RPCs, one device call.

The port of ``brpc_tpu/batch/``: host code only. The handler a flush
runs is the service's own; on the card it makes one device call for the
whole padded batch (``examples/batched_inference``,
``bench/batch_lane.py``).

The missing layer between bRPC's per-message dispatch and a device model:
InputMessenger already parses a poll batch at a time, but every parsed
request still reaches the service callback alone, so a device-backed service
pays one interpreter round-trip and one tiny device dispatch per RPC.
This package coalesces concurrent calls to the same (service, method) into
one padded, vectorized invocation:

  - :class:`BatchPolicy` — the knobs (max_batch_size, max_delay_us,
    size-bucketed padding, queue cap, limiter spec).
  - :class:`BatchQueue` — per-(service, method) admission queue; flushes on
    size, deadline, or poll-batch boundary.
  - :func:`batched_method` — decorator declaring a vectorized handler on a
    Service; the runtime stacks/pads request tensors, invokes the handler
    once per batch, and scatters per-item responses/errors.
  - :func:`make_batched` — the same wrapping as a plain callable, for
    manual ``Service.add_method`` registration.

Closest reference analog: bthread/execution_queue.h (serialize work onto a
consumer that drains opportunistically large batches).
"""

from brpc_tpu_torch.batch.policy import BatchPolicy, DEFAULT_BUCKETS
from brpc_tpu_torch.batch.queue import BatchItem, BatchQueue
from brpc_tpu_torch.batch.runtime import (
    BatchContext,
    batched_method,
    flush_poll_batch,
    make_batched,
)

__all__ = [
    "BatchPolicy",
    "DEFAULT_BUCKETS",
    "BatchItem",
    "BatchQueue",
    "BatchContext",
    "batched_method",
    "make_batched",
    "flush_poll_batch",
]
