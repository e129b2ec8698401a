"""The json2pb bridge's proto2 test schema (``jsonpb_test2.proto``), as
tables of the port's message runtime (:mod:`brpc_tpu_torch.proto._message`):
optional scalars with real has-bits, a declared default, a required
field and an unpacked repeated field. The bytes are protobuf's.
"""

from brpc_tpu_torch.proto._message import (INT32, STRING, Field,
                                           FileDescriptor, Message)


class Proto2Scratch(Message):  # jsonpb_test2.proto:8-13
    SYNTAX = "proto2"
    FIELDS = (
        Field(1, "opt_i32", INT32),
        Field(2, "opt_text", STRING, default="dflt"),
        Field(3, "must", INT32, required=True),
        Field(4, "many", INT32, repeated=True),
    )


DESCRIPTOR = FileDescriptor(
    "jsonpb_test2.proto", "brpc_tpu.test2", [Proto2Scratch],
    syntax="proto2")
