#!/usr/bin/env python
"""Regenerate brpc_tpu_torch/proto/rpc_meta_pb2.py without protobuf.

The trpc_std / trpc_stream wire metadata as one schema list (``FILE``).
:func:`build` serializes it into the ``FileDescriptorProto`` the JAX
package's generator assembles from protobuf's primitives (its file name
``brpc_tpu/proto/rpc_meta.proto``, no json names); :func:`main` writes the
port's form of the module from it: ``Message`` classes with ``FIELDS``
tables and a ``FileDescriptor`` named ``rpc_meta.proto``.
``brpc_tpu_torch/proto/rpc_meta.proto`` is the human-readable source of
truth; keep the two in sync when editing.

    python -m brpc_tpu_torch.tools.gen_rpc_meta_proto [OUT]
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from brpc_tpu_torch.proto._message import (BOOL, INT32, INT64,  # noqa: E402
                                           MESSAGE, STRING, UINT32)
from brpc_tpu_torch.tools._proto_schema import (  # noqa: E402
    ProtoField, ProtoFile, file_proto, module_source, write)

FILE = ProtoFile(
    "brpc_tpu/proto/rpc_meta.proto", "brpc_tpu", [
        ("RequestMeta", [
            ProtoField("service_name", 1, STRING),
            ProtoField("method_name", 2, STRING),
            ProtoField("log_id", 3, INT64),
            ProtoField("trace_id", 4, INT64),
            ProtoField("span_id", 5, INT64),
            ProtoField("parent_span_id", 6, INT64),
            ProtoField("timeout_ms", 7, INT32),
            # multi-tenant QoS identity: rides like log_id/trace_id
            ProtoField("tenant_id", 8, STRING),
            ProtoField("priority", 9, INT32),
        ]),
        ("ResponseMeta", [
            ProtoField("error_code", 1, INT32),
            ProtoField("error_text", 2, STRING),
        ]),
        ("StreamSettings", [
            ProtoField("stream_id", 1, INT64),
            ProtoField("need_feedback", 2, BOOL),
            ProtoField("window_bytes", 3, INT64),
        ]),
        ("StreamFrameMeta", [
            ProtoField("stream_id", 1, INT64),
            ProtoField("source_stream_id", 2, INT64),
            ProtoField("frame_type", 3, INT32),
            ProtoField("seq", 4, INT64),
            ProtoField("consumed_bytes", 5, INT64),
            ProtoField("has_continuation", 6, BOOL),
        ]),
        ("RpcMeta", [
            ProtoField("request", 1, MESSAGE, message="RequestMeta"),
            ProtoField("response", 2, MESSAGE, message="ResponseMeta"),
            ProtoField("correlation_id", 3, INT64),
            ProtoField("attempt_version", 4, INT32),
            ProtoField("compress_type", 5, INT32),
            ProtoField("attachment_size", 6, INT64),
            ProtoField("checksum", 7, UINT32),
            ProtoField("stream_settings", 8, MESSAGE,
                       message="StreamSettings"),
            ProtoField("auth_token", 9, STRING),
        ]),
    ], json_names=False)

DOC = ("trpc_std / trpc_stream wire metadata (``rpc_meta.proto``), as\n"
       "tables of the port's message runtime\n"
       "(:mod:`brpc_tpu_torch.proto._message`).")
OUT = os.path.join(ROOT, "brpc_tpu_torch", "proto", "rpc_meta_pb2.py")


def build() -> bytes:
    """The serialized ``FileDescriptorProto`` of :data:`FILE`."""
    return file_proto(FILE)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    write(argv[0] if argv else OUT, module_source(
        FILE, DOC, "brpc_tpu_torch/tools/gen_rpc_meta_proto.py"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
