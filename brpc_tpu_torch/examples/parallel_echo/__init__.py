"""The ParallelChannel fan-out example: ``client`` (``python -m
brpc_tpu_torch.examples.parallel_echo.client``)."""
