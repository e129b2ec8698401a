"""The traffic tools of the port: each keeps the JAX package's
``tools/<name>.py`` name, flags, output lines and exit codes, on the
port's RPC stack and message runtime (no JAX, no protobuf).

- :mod:`~brpc_tpu_torch.tools.rpc_press` — a load generator (any method:
  echo, a raw body, or one read from a ``.proto`` or a descriptor set).
- :mod:`~brpc_tpu_torch.tools.rpc_replay` — open-loop replay of rpc_dump
  traffic, with trace tagging and per-tenant results.
- :mod:`~brpc_tpu_torch.tools.rpc_view` — a server's builtin pages over
  the binary protocol, as a proxy, and the dump renderer.
- :mod:`~brpc_tpu_torch.tools.bench_server` — the bench server child
  (echo, native, device, batch, serving and sharded modes).
- :mod:`~brpc_tpu_torch.tools.record_serving_corpus` and its ``_overload``
  and ``_spec`` twins — regenerate ``tests/data/serving_corpus*``.

Run each as ``python -m brpc_tpu_torch.tools.<name>`` or as a file. The
tools that run an engine or touch a device run on ``cuda`` unless
``--torch-device cpu`` is given, and raise with no card.
"""
