"""The LLM serving example: ``server`` and ``client`` (``python -m
brpc_tpu_torch.examples.llm_server.server``)."""
