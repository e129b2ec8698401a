"""The streaming-into-device-memory example: ``server`` and ``client``
(``python -m brpc_tpu_torch.examples.device_stream.server``)."""
