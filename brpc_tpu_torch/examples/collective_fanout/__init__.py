"""The collective fan-out example: ``client`` (``python -m
brpc_tpu_torch.examples.collective_fanout.client [--cpu]``)."""
