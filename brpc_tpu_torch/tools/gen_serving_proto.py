#!/usr/bin/env python
"""Regenerate brpc_tpu_torch/proto/serving_pb2.py without protobuf.

The serving plane's wire messages and the ``LlmService`` methods as one
schema list (``FILE``). :func:`build` serializes it into the
``FileDescriptorProto`` the JAX package's generator assembles from
protobuf's primitives (json names included); :func:`main` writes the
port's form of the module from it: ``Message`` classes with ``FIELDS``
tables and a ``FileDescriptor`` with the service. The port's runtime
writes no json names, so the module's ``serialized_pb`` is the file
without them. ``brpc_tpu_torch/proto/serving.proto`` is the
human-readable source of truth; keep the two in sync when editing.

    python -m brpc_tpu_torch.tools.gen_serving_proto [OUT]
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from brpc_tpu_torch.proto._message import (BOOL, INT32,  # noqa: E402
                                           INT64, STRING)
from brpc_tpu_torch.tools._proto_schema import (  # noqa: E402
    ProtoField, ProtoFile, file_proto, module_source, write)

FILE = ProtoFile(
    "serving.proto", "brpc_tpu.serving", [
        ("GenerateRequest", [
            ProtoField("prompt_tokens", 1, INT32, repeated=True),
            ProtoField("max_new_tokens", 2, INT32),
            # when prompt_tokens is empty the server synthesizes a
            # deterministic prompt of this length: bench and replay
            # requests stay tiny on the wire
            ProtoField("prompt_len", 3, INT32),
            ProtoField("stop_token", 4, INT32),
            # two-stage disaggregated dispatch: attach to a migrated
            # sequence on the decode shard the stage-1 reply names
            ProtoField("resume_seq_id", 5, INT64),
            ProtoField("resume_shard", 6, INT32),
        ]),
        ("GenerateResponse", [
            ProtoField("tokens", 1, INT32, repeated=True),
            ProtoField("seq_id", 2, INT64),
            ProtoField("prompt_len", 3, INT32),
            ProtoField("steps", 4, INT32),
            ProtoField("ttft_us", 5, INT64),
            ProtoField("finish_reason", 6, STRING),
            # handoff meta: valid when finish_reason == "handoff"
            ProtoField("handoff_shard", 7, INT32),
        ]),
        ("TokenDelta", [
            ProtoField("seq_id", 1, INT64),
            ProtoField("tokens", 2, INT32, repeated=True),
            ProtoField("step", 3, INT32),
            ProtoField("done", 4, BOOL),
            ProtoField("accepted", 5, INT32),
        ]),
        ("ServingStatsRequest", []),
        ("ServingStats", [
            ProtoField("seqs_running", 1, INT64),
            ProtoField("seqs_waiting", 2, INT64),
            ProtoField("kv_blocks_total", 3, INT64),
            ProtoField("kv_blocks_used", 4, INT64),
            ProtoField("steps", 5, INT64),
            ProtoField("tokens_generated", 6, INT64),
        ]),
        # KV migration manifest: block bytes stream over the record
        # lane, one (handle, nbytes) record per block, not over this RPC
        ("MigrateRequest", [
            ProtoField("seq_id", 1, INT64),
            ProtoField("prompt_tokens", 2, INT32, repeated=True),
            ProtoField("out_tokens", 3, INT32, repeated=True),
            ProtoField("max_new_tokens", 4, INT32),
            ProtoField("stop_token", 5, INT32),
            ProtoField("ntokens", 6, INT32),
            ProtoField("n_blocks", 7, INT32),
            ProtoField("block_size", 8, INT32),
            ProtoField("layers", 9, INT32),
            ProtoField("kv_dim", 10, INT32),
            ProtoField("block_bytes", 11, INT64),
            ProtoField("recovery", 12, BOOL),
        ]),
        ("MigrateAck", [
            ProtoField("accepted", 1, BOOL),
            ProtoField("dest_seq_id", 2, INT64),
            ProtoField("blocks", 3, INT32),
            ProtoField("message", 4, STRING),
        ]),
        ("MigrateCommitRequest", [
            ProtoField("seq_id", 1, INT64),
        ]),
    ],
    services=[("LlmService", [
        ("Generate", "GenerateRequest", "GenerateResponse"),
        ("Stats", "ServingStatsRequest", "ServingStats"),
        ("MigrateOpen", "MigrateRequest", "MigrateAck"),
        ("MigrateCommit", "MigrateCommitRequest", "MigrateAck"),
    ])])

DOC = ("Serving-plane wire messages and the ``LlmService`` descriptor\n"
       "(``serving.proto``), as tables of the port's message runtime\n"
       "(:mod:`brpc_tpu_torch.proto._message`).")
OUT = os.path.join(ROOT, "brpc_tpu_torch", "proto", "serving_pb2.py")


def build() -> bytes:
    """The serialized ``FileDescriptorProto`` of :data:`FILE`."""
    return file_proto(FILE)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    write(argv[0] if argv else OUT, module_source(
        FILE, DOC, "brpc_tpu_torch/tools/gen_serving_proto.py"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
