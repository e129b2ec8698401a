"""Wire messages of the port.

``rpc_meta_pb2``, ``serving_pb2``, ``echo_pb2`` and ``device_lane_pb2``
are tables of the port's own proto3 message runtime
(:mod:`brpc_tpu_torch.proto._message`, no protobuf); each class names the
lines of the ``.proto`` file beside it that it comes from, and writes the
bytes protobuf writes. Each module's ``DESCRIPTOR.serialized_pb`` is the
file descriptor protoc writes for that file.
"""
