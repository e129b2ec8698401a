"""The RTMP live relay example: ``client`` (``python -m
brpc_tpu_torch.examples.rtmp_live.client``)."""
