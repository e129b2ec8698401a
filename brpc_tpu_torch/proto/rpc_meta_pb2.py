"""trpc_std / trpc_stream wire metadata (``rpc_meta.proto``), as tables of
the port's message runtime (:mod:`brpc_tpu_torch.proto._message`). Each
class names the ``.proto`` lines it comes from; the bytes are protobuf's.
"""

from brpc_tpu_torch.proto._message import (BOOL, INT32, INT64, MESSAGE,
                                           STRING, UINT32, Field,
                                           FileDescriptor, Message)


class RequestMeta(Message):  # rpc_meta.proto:8-27
    FIELDS = (
        Field(1, "service_name", STRING),
        Field(2, "method_name", STRING),
        Field(3, "log_id", INT64),
        Field(4, "trace_id", INT64),
        Field(5, "span_id", INT64),
        Field(6, "parent_span_id", INT64),
        Field(7, "timeout_ms", INT32),
        Field(8, "tenant_id", STRING),
        Field(9, "priority", INT32),
    )


class ResponseMeta(Message):  # rpc_meta.proto:29-32
    FIELDS = (
        Field(1, "error_code", INT32),
        Field(2, "error_text", STRING),
    )


class StreamSettings(Message):  # rpc_meta.proto:34-39
    FIELDS = (
        Field(1, "stream_id", INT64),
        Field(2, "need_feedback", BOOL),
        Field(3, "window_bytes", INT64),
    )


class StreamFrameMeta(Message):  # rpc_meta.proto:44-51
    FIELDS = (
        Field(1, "stream_id", INT64),
        Field(2, "source_stream_id", INT64),
        Field(3, "frame_type", INT32),
        Field(4, "seq", INT64),
        Field(5, "consumed_bytes", INT64),
        Field(6, "has_continuation", BOOL),
    )


class RpcMeta(Message):  # rpc_meta.proto:53-65
    FIELDS = (
        Field(1, "request", MESSAGE, message_class=RequestMeta),
        Field(2, "response", MESSAGE, message_class=ResponseMeta),
        Field(3, "correlation_id", INT64),
        Field(4, "attempt_version", INT32),
        Field(5, "compress_type", INT32),
        Field(6, "attachment_size", INT64),
        Field(7, "checksum", UINT32),
        Field(8, "stream_settings", MESSAGE, message_class=StreamSettings),
        Field(9, "auth_token", STRING),
    )


DESCRIPTOR = FileDescriptor(
    "rpc_meta.proto", "brpc_tpu",
    [RequestMeta, ResponseMeta, StreamSettings, StreamFrameMeta, RpcMeta])
