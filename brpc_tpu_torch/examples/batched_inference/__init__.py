"""The batched-inference example: ``server`` and ``client`` (``python -m
brpc_tpu_torch.examples.batched_inference.server``)."""
