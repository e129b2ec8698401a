"""The mongo example: ``client`` (``python -m
brpc_tpu_torch.examples.mongo_kv.client``)."""
