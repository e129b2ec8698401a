"""The tools of the port: each keeps the JAX package's
``tools/<name>.py`` name, flags, output lines and exit codes, on the
port's RPC stack, message runtime and kernels (no JAX, no protobuf).

The traffic tools:

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

The kernel tools, which need a card (without one each prints why and
returns 1), their rates against the H100's 989 TFLOP/s and 3.35 TB/s:

- :mod:`~brpc_tpu_torch.tools.kernel_bench` — attention forward and
  backward, the ring path, RMSNorm against the copy ceiling, and the
  flagship's training step (kernels on, plain, at scale).
- :mod:`~brpc_tpu_torch.tools.causal_sweep` and
  :mod:`~brpc_tpu_torch.tools.qgrid_sweep` — the forward over the
  reference's block configs.

The operator tools, over a server's builtin pages or files they wrote:

- :mod:`~brpc_tpu_torch.tools.trace_view` (``/rpcz`` as waterfalls),
  :mod:`~brpc_tpu_torch.tools.vars_view` (``/vars`` series as sparklines,
  merged across members), :mod:`~brpc_tpu_torch.tools.flame_view` (folded
  stacks as an SVG), :mod:`~brpc_tpu_torch.tools.prof_diff` and
  :mod:`~brpc_tpu_torch.tools.trace_diff` (which frame, which phase
  moved), :mod:`~brpc_tpu_torch.tools.chaos_run` (scenarios over
  ``/fault``) and :mod:`~brpc_tpu_torch.tools.tpulint` (the linter's
  CLI).

The last tools, host code that needs no card:

- :mod:`~brpc_tpu_torch.tools.fuzz` — the mutational fuzzer over the
  port's wire parsers and its C++ engine's h2 parser.
- :mod:`~brpc_tpu_torch.tools.subinterp_probe` — the cost of a dispatch
  through a subinterpreter against an inline call.
- :mod:`~brpc_tpu_torch.tools.gen_hpack_tables`,
  :mod:`~brpc_tpu_torch.tools.gen_press_echo_desc`,
  :mod:`~brpc_tpu_torch.tools.gen_rpc_meta_proto` and
  :mod:`~brpc_tpu_torch.tools.gen_serving_proto` — regenerate the
  engine's HPACK header, the vendored descriptor set and the two
  ``*_pb2`` modules from the port's own tables (the three descriptor
  generators share ``_proto_schema``'s writer), without protobuf.

Run each as ``python -m brpc_tpu_torch.tools.<name>`` or as a file. The
traffic tools that run an engine or touch a device run on ``cuda`` unless
``--torch-device cpu`` is given, and raise with no card.
"""
