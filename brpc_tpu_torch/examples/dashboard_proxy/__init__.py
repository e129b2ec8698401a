"""The dashboard proxy example: ``client`` (``python -m
brpc_tpu_torch.examples.dashboard_proxy.client``) and the proxy it runs
(``proxy.serve``)."""
