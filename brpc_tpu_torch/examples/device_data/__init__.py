"""The device-resident payload example: ``server`` and ``client``
(``python -m brpc_tpu_torch.examples.device_data.server``)."""
