"""The echo service's messages and descriptor (``echo.proto``), as tables
of the port's message runtime (:mod:`brpc_tpu_torch.proto._message`). Each
class names the ``.proto`` lines it comes from; the bytes are protobuf's.
"""

from brpc_tpu_torch.proto._message import (BYTES, INT32, STRING, Field,
                                           FileDescriptor, Message)


class EchoRequest(Message):  # echo.proto:8-12
    FIELDS = (
        Field(1, "message", STRING),
        Field(2, "payload", BYTES),
        Field(3, "sleep_us", INT32),
    )


class EchoResponse(Message):  # echo.proto:14-17
    FIELDS = (
        Field(1, "message", STRING),
        Field(2, "payload", BYTES),
    )


DESCRIPTOR = FileDescriptor(
    "echo.proto", "brpc_tpu.test", [EchoRequest, EchoResponse],
    services={"EchoService": [  # echo.proto:19-21
        ("Echo", EchoRequest, EchoResponse),
    ]})
