"""The builtin pages over the binary protocol (``builtin_view.proto``),
as tables of the port's message runtime
(:mod:`brpc_tpu_torch.proto._message`). Each class names the ``.proto``
lines it comes from; the bytes are protobuf's.
"""

from brpc_tpu_torch.proto._message import (BYTES, INT32, STRING, Field,
                                           FileDescriptor, Message)


class ViewRequest(Message):  # builtin_view.proto:9-12
    FIELDS = (
        Field(1, "path", STRING),
        Field(2, "accept", STRING),
    )


class ViewResponse(Message):  # builtin_view.proto:14-18
    FIELDS = (
        Field(1, "status", INT32),
        Field(2, "content_type", STRING),
        Field(3, "body", BYTES),
    )


DESCRIPTOR = FileDescriptor(
    "builtin_view.proto", "brpc_tpu", [ViewRequest, ViewResponse],
    services={"BuiltinViewService": [  # builtin_view.proto:20-22
        ("Get", ViewRequest, ViewResponse),
    ]})
