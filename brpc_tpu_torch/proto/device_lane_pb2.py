"""The device data plane's messages and descriptor (``device_lane.proto``),
as tables of the port's message runtime
(:mod:`brpc_tpu_torch.proto._message`). Each class names the ``.proto``
lines it comes from; the bytes, and the file's ``serialized_pb``, are
protobuf's.
"""

from brpc_tpu_torch.proto._message import (BOOL, INT32, INT64, Field,
                                           FileDescriptor, Message)


class DeviceHandle(Message):  # device_lane.proto:10-13
    FIELDS = (
        Field(1, "handle", INT64),
        Field(2, "nbytes", INT64),
    )


class DeviceStatsRequest(Message):  # device_lane.proto:15-17
    FIELDS = (
        Field(1, "fence", BOOL),
    )


class PumpRequest(Message):  # device_lane.proto:19-22
    FIELDS = (
        Field(1, "handle", INT64),
        Field(2, "rounds", INT32),
    )


class PumpResult(Message):  # device_lane.proto:24-27
    FIELDS = (
        Field(1, "checksum", INT64),
        Field(2, "moved_bytes", INT64),
    )


class DeviceStats(Message):  # device_lane.proto:29-33
    FIELDS = (
        Field(1, "handles", INT64),
        Field(2, "resident_bytes", INT64),
        Field(3, "moved_bytes", INT64),
    )


DESCRIPTOR = FileDescriptor(
    "device_lane.proto", "brpc_tpu.device",
    [DeviceHandle, DeviceStatsRequest, PumpRequest, PumpResult, DeviceStats],
    services={"DeviceDataService": [  # device_lane.proto:35-42
        ("Put", DeviceHandle, DeviceHandle),
        ("Copy", DeviceHandle, DeviceHandle),
        ("Pump", PumpRequest, PumpResult),
        ("Get", DeviceHandle, DeviceHandle),
        ("Free", DeviceHandle, DeviceHandle),
        ("Stats", DeviceStatsRequest, DeviceStats),
    ]})
