"""The collective fan-out's tensor envelope (``collective.proto``), as
tables of the port's message runtime (:mod:`brpc_tpu_torch.proto._message`).
Each class names the ``.proto`` lines it comes from; the bytes, and the
file's ``serialized_pb``, are protobuf's.
"""

from brpc_tpu_torch.proto._message import (BYTES, STRING, UINT32, Field,
                                           FileDescriptor, Message)


class TensorRequest(Message):  # collective.proto:9-14
    FIELDS = (
        Field(1, "fn", STRING),
        Field(2, "dtype", STRING),
        Field(3, "shape", UINT32, repeated=True),
        Field(4, "data", BYTES),
    )


class TensorResponse(Message):  # collective.proto:16-20
    FIELDS = (
        Field(1, "dtype", STRING),
        Field(2, "shape", UINT32, repeated=True),
        Field(3, "data", BYTES),
    )


DESCRIPTOR = FileDescriptor(
    "collective.proto", "brpc_tpu", [TensorRequest, TensorResponse],
    services={"CollectiveService": [  # collective.proto:22-24
        ("Apply", TensorRequest, TensorResponse),
    ]})
