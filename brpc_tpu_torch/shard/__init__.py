"""Sharded dispatch plane — the Python lane spread over N worker processes.

CPython runs one interpreter thread at a time per process, so the CPU-heavy
middle of the Python lane (TRPC frame parse, method dispatch, response
pack) is spread over OS processes: a parent keeps owning the tunnel's
control plane (handshake, epochs, credit window, healer) while workers
parse, dispatch and pack.

The contract that makes this cheap is **handles cross the process
boundary, never bytes that own anything**:

- workers map the SAME shm block pools the tunnel already registered,
  *by name* (the pool name went over the HELLO wire for exactly this
  reason) — a bulk response is memcpy'd once, by the worker, directly
  into client-visible registered memory;
- the parent leases each worker a **credit sub-window** — block indices
  acquired from its PeerWindow — so workers never talk to the credit
  machinery, and a dead worker's lease is reclaimed wholesale;
- requests/responses cross on shm SPSC byte rings as raw wire frames +
  integer handles (see wire.py); the ``cross-process-ownership`` tpulint
  rule enforces that no ``IOBuf``/``Block``/socket object is ever
  pickled across.

Responses fan back in through the parent's existing coalesced-doorbell
write (``TpuEndpoint.fan_in_flush``): one collector thread drains every
worker's ring and posts a poll batch of worker responses as ONE ctrl
write. Worker death rides the healer philosophy: a ``worker.crash``
fault point for chaos tests, parent-side respawn with a generation
bump, and a dead worker's calls run at most once unless the caller asks
for retries. The parent first sends every answer the worker left in its
out ring. Of the calls still unanswered, one whose request the worker
never took off its in ring never ran, and the parent's own dispatch runs
it. One the worker took may have run, so it gets the reference's
retriable EFAILEDSOCKET. The port's Channel retries that code as it does
a failed socket, within the caller's ``max_retry``: at 0 the caller sees
the error and the handler ran at most once. The reference's Channel does
not retry an error that arrives in a response.

``tpu_shard_workers=0`` (the default) is a strict no-op: no process is
spawned, no lane hook installed, the fast path runs unchanged.

The port's copy of the JAX package's ``shard/``: :func:`plane.shard_for`
is also the route the sharded KV cache and its prefix trees place
sequences with, bit for bit the reference's. Workers are dispatch-only
and are spawned off the card (``plane.py``).
"""

from __future__ import annotations

from brpc_tpu_torch import fault as _fault

# chaos hook: SIGKILL worker <match_worker> (or any worker when unmatched)
# from the plane's monitor loop — the shard analog of tpu.tunnel.kill.
# Needs the fault_injection_enabled master gate like every fault point.
_fault.register(
    "worker.crash",
    "SIGKILL a shard dispatch worker from the plane monitor "
    "(match_worker=<index> targets one); exercises lease reclaim, "
    "retriable fan-out to in-flight cids, and generation-bump respawn")
