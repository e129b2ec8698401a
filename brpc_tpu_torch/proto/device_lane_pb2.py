# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: device_lane.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x11\x64\x65vice_lane.proto\x12\x0f\x62rpc_tpu.device\".\n\x0c\x44\x65viceHandle\x12\x0e\n\x06handle\x18\x01 \x01(\x03\x12\x0e\n\x06nbytes\x18\x02 \x01(\x03\"#\n\x12\x44\x65viceStatsRequest\x12\r\n\x05\x66\x65nce\x18\x01 \x01(\x08\"-\n\x0bPumpRequest\x12\x0e\n\x06handle\x18\x01 \x01(\x03\x12\x0e\n\x06rounds\x18\x02 \x01(\x05\"3\n\nPumpResult\x12\x10\n\x08\x63hecksum\x18\x01 \x01(\x03\x12\x13\n\x0bmoved_bytes\x18\x02 \x01(\x03\"K\n\x0b\x44\x65viceStats\x12\x0f\n\x07handles\x18\x01 \x01(\x03\x12\x16\n\x0eresident_bytes\x18\x02 \x01(\x03\x12\x13\n\x0bmoved_bytes\x18\x03 \x01(\x03\x32\xb8\x03\n\x11\x44\x65viceDataService\x12\x43\n\x03Put\x12\x1d.brpc_tpu.device.DeviceHandle\x1a\x1d.brpc_tpu.device.DeviceHandle\x12\x44\n\x04\x43opy\x12\x1d.brpc_tpu.device.DeviceHandle\x1a\x1d.brpc_tpu.device.DeviceHandle\x12\x41\n\x04Pump\x12\x1c.brpc_tpu.device.PumpRequest\x1a\x1b.brpc_tpu.device.PumpResult\x12\x43\n\x03Get\x12\x1d.brpc_tpu.device.DeviceHandle\x1a\x1d.brpc_tpu.device.DeviceHandle\x12\x44\n\x04\x46ree\x12\x1d.brpc_tpu.device.DeviceHandle\x1a\x1d.brpc_tpu.device.DeviceHandle\x12J\n\x05Stats\x12#.brpc_tpu.device.DeviceStatsRequest\x1a\x1c.brpc_tpu.device.DeviceStatsb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'device_lane_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _DEVICEHANDLE._serialized_start=38
  _DEVICEHANDLE._serialized_end=84
  _DEVICESTATSREQUEST._serialized_start=86
  _DEVICESTATSREQUEST._serialized_end=121
  _PUMPREQUEST._serialized_start=123
  _PUMPREQUEST._serialized_end=168
  _PUMPRESULT._serialized_start=170
  _PUMPRESULT._serialized_end=221
  _DEVICESTATS._serialized_start=223
  _DEVICESTATS._serialized_end=298
  _DEVICEDATASERVICE._serialized_start=301
  _DEVICEDATASERVICE._serialized_end=741
# @@protoc_insertion_point(module_scope)
