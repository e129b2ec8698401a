"""The json2pb bridge's proto3 test schema (``jsonpb_test.proto``), as
tables of the port's message runtime (:mod:`brpc_tpu_torch.proto._message`):
every kind the bridge converts (maps, enums, oneof, bytes, nested and
repeated messages, 64-bit ints, floats, an explicit-presence scalar).
Each class names the ``.proto`` lines it comes from; the bytes are
protobuf's.
"""

from brpc_tpu_torch.proto._message import (BOOL, BYTES, DOUBLE, ENUM, FLOAT,
                                           INT32, INT64, MESSAGE, STRING,
                                           UINT64, EnumType, Field,
                                           FileDescriptor, Message)

Color = EnumType("Color", [  # jsonpb_test.proto:7-11
    ("COLOR_UNSET", 0), ("RED", 1), ("BLUE", 2)])
COLOR_UNSET, RED, BLUE = 0, 1, 2


class Inner(Message):  # jsonpb_test.proto:13-16
    FIELDS = (
        Field(1, "name", STRING),
        Field(2, "nums", INT32, repeated=True),
    )


class JsonScratch(Message):  # jsonpb_test.proto:18-38
    FIELDS = (
        Field(1, "i32", INT32),
        Field(2, "i64", INT64),
        Field(3, "u64", UINT64),
        Field(4, "d", DOUBLE),
        Field(5, "f", FLOAT),
        Field(6, "flag", BOOL),
        Field(7, "text", STRING),
        Field(8, "blob", BYTES),
        Field(9, "color", ENUM, enum_type=Color),
        Field(10, "inner", MESSAGE, message_class=Inner),
        Field(11, "items", MESSAGE, repeated=True, message_class=Inner),
        Field(12, "counts", INT32, map_key=STRING),
        Field(13, "registry", MESSAGE, message_class=Inner,
              map_key=INT64),
        Field(14, "choice_a", STRING, oneof="choice"),
        Field(15, "choice_b", INT32, oneof="choice"),
        Field(16, "colors", ENUM, repeated=True, enum_type=Color),
        Field(17, "maybe_i32", INT32, optional=True),
    )


DESCRIPTOR = FileDescriptor(
    "jsonpb_test.proto", "brpc_tpu.test", [Inner, JsonScratch],
    enums=[Color])
