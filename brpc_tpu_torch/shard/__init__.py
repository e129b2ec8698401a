"""shard — the sharded dispatch plane's routing, on the port.

Only :func:`~brpc_tpu_torch.shard.plane.shard_for` is ported: the
splitmix64 route that the sharded KV cache and its prefix trees place
sequences with. The worker processes, shared-memory rings and fan-in of
``brpc_tpu/shard/`` wait for ROADMAP Queue 1 item 2(b)9.
"""

__all__ = ["plane"]
