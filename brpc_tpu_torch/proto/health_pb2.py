"""The gRPC health checking protocol's messages and descriptor
(``health.proto``), as tables of the port's message runtime
(:mod:`brpc_tpu_torch.proto._message`). Each class names the ``.proto``
lines it comes from; the bytes are protobuf's.
"""

from brpc_tpu_torch.proto._message import (ENUM, STRING, EnumType, Field,
                                           FileDescriptor, Message)


class HealthCheckRequest(Message):  # health.proto:6-8
    FIELDS = (
        Field(1, "service", STRING),
    )


class HealthCheckResponse(Message):  # health.proto:10-18
    ServingStatus = EnumType("ServingStatus", [
        ("UNKNOWN", 0), ("SERVING", 1), ("NOT_SERVING", 2),
        ("SERVICE_UNKNOWN", 3)])
    ENUMS = (ServingStatus,)
    UNKNOWN, SERVING, NOT_SERVING, SERVICE_UNKNOWN = 0, 1, 2, 3
    FIELDS = (
        Field(1, "status", ENUM, enum_type=ServingStatus),
    )


DESCRIPTOR = FileDescriptor(
    "health.proto", "grpc.health.v1",
    [HealthCheckRequest, HealthCheckResponse],
    services={"Health": [  # health.proto:20-22
        ("Check", HealthCheckRequest, HealthCheckResponse),
    ]})
