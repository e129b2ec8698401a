"""Generated protobuf modules (protoc --python_out from the .proto sources).

``device_lane_pb2`` is a verbatim copy of ``brpc_tpu/proto``'s: the same
serialized descriptor, so both copies can be loaded in one process and
their messages serialize to the same bytes. Nothing in the port imports
it at module load; ``tpu.device_lane.DeviceDataService`` imports it when
a service is built.
"""
