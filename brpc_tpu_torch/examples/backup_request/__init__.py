"""The backup-request example: ``client`` (``python -m
brpc_tpu_torch.examples.backup_request.client``)."""
