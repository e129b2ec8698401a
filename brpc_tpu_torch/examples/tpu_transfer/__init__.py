"""The tpu:// transfer sweep: ``client`` (``python -m
brpc_tpu_torch.examples.tpu_transfer.client``)."""
