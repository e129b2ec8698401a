"""The gRPC example: ``server`` and ``client`` (``python -m
brpc_tpu_torch.examples.grpc_echo.server``)."""
