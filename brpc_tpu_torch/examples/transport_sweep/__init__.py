"""The transport sweep example: ``client`` (``python -m
brpc_tpu_torch.examples.transport_sweep.client``)."""
