"""The redis example: ``server`` (``python -m
brpc_tpu_torch.examples.redis_kv.server``)."""
