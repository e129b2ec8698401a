"""The HTTP example: ``server`` (``python -m
brpc_tpu_torch.examples.http.server``)."""
