"""The shard plane's routing: ``shard_for``, the port of
``brpc_tpu/shard/plane.py:64-81``.

The rest of the plane (workers, rings, fan-in, respawn) waits for ROADMAP
Queue 1 item 2(b)9; the sharded KV cache and the sharded prefix cache
need only the route, and it must be the reference's, bit for bit: a
sequence id lands on the same shard in both packages.
"""

from __future__ import annotations


def shard_for(cid: int, n: int) -> int:
    """cid -> worker index, stable across processes and runs: a retry
    re-issued with the same cid lands on the same worker.

    Full splitmix64 avalanche, not a bare multiplicative hash: real cids
    from a low-concurrency channel are ``version << 32`` (only the high
    bits advance), so any scheme that reads a fixed bit range of
    ``cid * K`` sees a constant and pins every request to worker 0."""
    h = cid & 0xFFFFFFFFFFFFFFFF
    h ^= h >> 30
    h = (h * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    h ^= h >> 27
    h = (h * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    h ^= h >> 31
    return h % n
