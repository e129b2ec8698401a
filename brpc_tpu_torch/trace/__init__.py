"""trace — per-RPC span tracing (rpcz), request sampling (rpc_dump),
phase-timeline diffing, and OTLP export.

Counterpart of the reference's ``src/brpc/span.*`` + ``rpc_dump.*``
(SURVEY §5.1): client and server spans with annotations, sampled into an
in-memory SpanDB browsable at ``/rpcz``; trace ids propagate through
RpcMeta so multi-hop calls stitch into one trace. rpc_dump samples inbound
requests to v2 records (wire bytes + arrival timestamp + the server span's
settled phase timeline) that ``tools/rpc_replay`` re-issues at N× rate and
``trace/diff.py`` compares against the recording to localize a regression
to a phase. ``trace/export.py`` streams finished spans as OTLP JSON lines
behind the ``span_export_path`` flag.
"""

from brpc_tpu_torch.trace.span import (
    Span,
    PHASE_NAMES,
    start_client_span,
    start_server_span,
    recent_spans,
    spans_of_trace,
    trace_to_dict,
    build_span_tree,
    merge_trace_docs,
    reset_for_test,
)
from brpc_tpu_torch.trace.rpc_dump import (
    RpcDumper,
    RpcDumpLoader,
    DumpRecord,
)

__all__ = [
    "Span",
    "PHASE_NAMES",
    "start_client_span",
    "start_server_span",
    "recent_spans",
    "spans_of_trace",
    "trace_to_dict",
    "build_span_tree",
    "merge_trace_docs",
    "reset_for_test",
    "RpcDumper",
    "RpcDumpLoader",
    "DumpRecord",
]
