#!/usr/bin/env python
"""Regenerate tests/data/press_echo.desc, the vendored descriptor set
rpc_press reads on hosts without a protoc binary, without protobuf.

The set is equivalent to compiling:

    syntax = "proto3";
    package press.test;
    message Req  { string message = 1; bytes payload = 2; int32 sleep_us = 3; }
    message Resp { string message = 1; bytes payload = 2; }
    service EchoService { rpc Echo(Req) returns (Resp); }

written here from one schema list (``FILE``, json names included) by the
port's descriptor writer, byte for byte what protobuf serializes for the
same ``FileDescriptorSet``.

    python -m brpc_tpu_torch.tools.gen_press_echo_desc [OUT]
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from brpc_tpu_torch.proto._message import BYTES, INT32, STRING  # noqa: E402
from brpc_tpu_torch.tools._proto_schema import (  # noqa: E402
    ProtoField, ProtoFile, file_proto, file_set, write)

FILE = ProtoFile(
    "press_echo.proto", "press.test", [
        ("Req", [
            ProtoField("message", 1, STRING),
            ProtoField("payload", 2, BYTES),
            ProtoField("sleep_us", 3, INT32),
        ]),
        ("Resp", [
            ProtoField("message", 1, STRING),
            ProtoField("payload", 2, BYTES),
        ]),
    ],
    services=[("EchoService", [("Echo", "Req", "Resp")])])
OUT = os.path.join(ROOT, "tests", "data", "press_echo.desc")


def build() -> bytes:
    """The serialized ``FileDescriptorSet`` of :data:`FILE`."""
    return file_set(file_proto(FILE))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    write(argv[0] if argv else OUT, build())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
