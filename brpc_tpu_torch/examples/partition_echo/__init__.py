"""The PartitionChannel example: ``client`` (``python -m
brpc_tpu_torch.examples.partition_echo.client``)."""
