"""The multi-threaded echo client: ``client`` (``python -m
brpc_tpu_torch.examples.multi_threaded_echo.client``)."""
