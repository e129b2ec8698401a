"""The SelectiveChannel example: ``client`` (``python -m
brpc_tpu_torch.examples.selective_echo.client``)."""
