"""The streaming echo example: ``server`` and ``client`` (``python -m
brpc_tpu_torch.examples.streaming_echo.server``)."""
