"""Serving-plane wire messages and the ``LlmService`` descriptor
(``serving.proto``), as tables of the port's message runtime
(:mod:`brpc_tpu_torch.proto._message`). Each class names the ``.proto``
lines it comes from; the bytes are protobuf's.
"""

from brpc_tpu_torch.proto._message import (BOOL, INT32, INT64, STRING,
                                           Field, FileDescriptor, Message)


class GenerateRequest(Message):  # serving.proto:7-19
    FIELDS = (
        Field(1, "prompt_tokens", INT32, repeated=True),
        Field(2, "max_new_tokens", INT32),
        Field(3, "prompt_len", INT32),
        Field(4, "stop_token", INT32),
        Field(5, "resume_seq_id", INT64),
        Field(6, "resume_shard", INT32),
    )


class GenerateResponse(Message):  # serving.proto:21-33
    FIELDS = (
        Field(1, "tokens", INT32, repeated=True),
        Field(2, "seq_id", INT64),
        Field(3, "prompt_len", INT32),
        Field(4, "steps", INT32),
        Field(5, "ttft_us", INT64),
        Field(6, "finish_reason", STRING),
        Field(7, "handoff_shard", INT32),
    )


class TokenDelta(Message):  # serving.proto:36-45
    FIELDS = (
        Field(1, "seq_id", INT64),
        Field(2, "tokens", INT32, repeated=True),
        Field(3, "step", INT32),
        Field(4, "done", BOOL),
        Field(5, "accepted", INT32),
    )


class ServingStatsRequest(Message):  # serving.proto:47
    FIELDS = ()


class ServingStats(Message):  # serving.proto:49-56
    FIELDS = (
        Field(1, "seqs_running", INT64),
        Field(2, "seqs_waiting", INT64),
        Field(3, "kv_blocks_total", INT64),
        Field(4, "kv_blocks_used", INT64),
        Field(5, "steps", INT64),
        Field(6, "tokens_generated", INT64),
    )


class MigrateRequest(Message):  # serving.proto:62-75
    FIELDS = (
        Field(1, "seq_id", INT64),
        Field(2, "prompt_tokens", INT32, repeated=True),
        Field(3, "out_tokens", INT32, repeated=True),
        Field(4, "max_new_tokens", INT32),
        Field(5, "stop_token", INT32),
        Field(6, "ntokens", INT32),
        Field(7, "n_blocks", INT32),
        Field(8, "block_size", INT32),
        Field(9, "layers", INT32),
        Field(10, "kv_dim", INT32),
        Field(11, "block_bytes", INT64),
        Field(12, "recovery", BOOL),
    )


class MigrateAck(Message):  # serving.proto:77-82
    FIELDS = (
        Field(1, "accepted", BOOL),
        Field(2, "dest_seq_id", INT64),
        Field(3, "blocks", INT32),
        Field(4, "message", STRING),
    )


class MigrateCommitRequest(Message):  # serving.proto:84-86
    FIELDS = (
        Field(1, "seq_id", INT64),
    )


DESCRIPTOR = FileDescriptor(
    "serving.proto", "brpc_tpu.serving",
    [GenerateRequest, GenerateResponse, TokenDelta, ServingStatsRequest,
     ServingStats, MigrateRequest, MigrateAck, MigrateCommitRequest],
    services={"LlmService": [  # serving.proto:88-97
        ("Generate", GenerateRequest, GenerateResponse),
        ("Stats", ServingStatsRequest, ServingStats),
        ("MigrateOpen", MigrateRequest, MigrateAck),
        ("MigrateCommit", MigrateCommitRequest, MigrateAck),
    ]})
