"""The echo example: ``server`` and ``client`` (``python -m
brpc_tpu_torch.examples.echo.server``)."""
