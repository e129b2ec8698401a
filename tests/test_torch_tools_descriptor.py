"""The port's descriptor-set reader (``proto/_message.read_descriptor_set``)
against protobuf: every port ``*_pb2`` module's ``serialized_pb``, the
vendored ``tests/data/press_echo.desc`` and a protoc-compiled pair of
files (nested messages and enums, maps, oneofs, proto3 ``optional``, a
proto2 file with defaults and a required field, two packages, an import)
become classes whose bytes equal protobuf's on numpy-seeded messages.
Maps are compared by parsing (protobuf's Python runtime writes map
entries in an order of its own)."""

import os
import shutil
import subprocess

import numpy as np
import pytest
from google.protobuf import descriptor_pb2, descriptor_pool, message_factory
from google.protobuf.descriptor import FieldDescriptor as FD

from brpc_tpu_torch.proto import (_message, builtin_view_pb2, collective_pb2,
                                  device_lane_pb2, echo_pb2, health_pb2,
                                  jsonpb_test2_pb2, jsonpb_test_pb2,
                                  rpc_meta_pb2, serving_pb2)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
PORT_MODULES = [echo_pb2, serving_pb2, rpc_meta_pb2, jsonpb_test_pb2,
                jsonpb_test2_pb2, device_lane_pb2, builtin_view_pb2,
                health_pb2, collective_pb2]
SAMPLES = 25  # seeded messages per message type


def _repeated(f):
    return f.is_repeated


def _is_map(f):
    return (f.type == FD.TYPE_MESSAGE
            and f.message_type.GetOptions().map_entry)


def _scalar(f, rng):
    t = f.type
    if t == FD.TYPE_ENUM:
        return int(rng.choice([v.number for v in f.enum_type.values]))
    if t == FD.TYPE_INT32:
        return int(rng.integers(-2**31, 2**31))
    if t == FD.TYPE_INT64:
        return int(rng.integers(-2**63, 2**63, dtype=np.int64))
    if t == FD.TYPE_UINT32:
        return int(rng.integers(0, 2**32))
    if t == FD.TYPE_UINT64:
        return int(rng.integers(0, 2**64, dtype=np.uint64))
    if t == FD.TYPE_BOOL:
        return bool(rng.integers(0, 2))
    if t == FD.TYPE_DOUBLE:
        return float(rng.standard_normal() * 1e3)
    if t == FD.TYPE_FLOAT:
        return float(np.float32(rng.standard_normal()))
    if t == FD.TYPE_STRING:
        return "".join(chr(int(c)) for c in rng.integers(32, 0x2FF,
                                                         rng.integers(0, 6)))
    if t == FD.TYPE_BYTES:
        return rng.integers(0, 256, rng.integers(0, 8)).astype(
            np.uint8).tobytes()
    raise AssertionError(f"no generator for {f.full_name}")


def _fill(msg, rng, depth=0):
    """Random values in ``msg`` (protobuf): each oneof gets at most one
    member, a required field always a value."""
    desc = msg.DESCRIPTOR
    chosen = {o.name: rng.integers(-1, len(o.fields))
              for o in desc.oneofs}
    for f in desc.fields:
        o = f.containing_oneof
        if o is not None and (chosen[o.name] < 0
                              or o.fields[chosen[o.name]] is not f):
            continue
        required = f.is_required
        if not required and o is None and rng.random() < 0.3:
            continue
        if _is_map(f):
            kf, vf = f.message_type.fields_by_name["key"], \
                f.message_type.fields_by_name["value"]
            target = getattr(msg, f.name)
            for _ in range(rng.integers(0, 4)):
                key = _scalar(kf, rng)
                if vf.type == FD.TYPE_MESSAGE:
                    if depth < 2:
                        _fill(target[key], rng, depth + 1)
                else:
                    target[key] = _scalar(vf, rng)
        elif _repeated(f):
            target = getattr(msg, f.name)
            for _ in range(rng.integers(0, 4)):
                if f.type == FD.TYPE_MESSAGE:
                    if depth < 2:
                        _fill(target.add(), rng, depth + 1)
                else:
                    target.append(_scalar(f, rng))
        elif f.type == FD.TYPE_MESSAGE:
            if depth < 2 or required:
                getattr(msg, f.name).SetInParent()
                if depth < 2:
                    _fill(getattr(msg, f.name), rng, depth + 1)
        else:
            setattr(msg, f.name, _scalar(f, rng))


def _has_map(desc, seen=None):
    seen = seen if seen is not None else set()
    if desc.full_name in seen:
        return False
    seen.add(desc.full_name)
    return any(_is_map(f) or (f.type == FD.TYPE_MESSAGE
                              and _has_map(f.message_type, seen))
               for f in desc.fields)


def _pools(set_bytes):
    """protobuf's pool and the port's reader over the same set."""
    fds = descriptor_pb2.FileDescriptorSet.FromString(set_bytes)
    pool = descriptor_pool.DescriptorPool()
    for fd in fds.file:
        pool.Add(fd)
    files = _message.read_descriptor_set(set_bytes)
    return pool, files, fds


def _port_classes(files):
    out = {}

    def walk(cls):
        out[cls.DESCRIPTOR.full_name] = cls
        for nested in cls.NESTED:
            walk(nested)
    for fd in files:
        for d in fd.message_types_by_name.values():
            walk(d._concrete_class)
    return out


def _check_bytes(pool, port, full, seed):
    pb_cls = message_factory.GetMessageClass(
        pool.FindMessageTypeByName(full))
    cls = port[full]
    rng = np.random.default_rng(seed)
    for _ in range(SAMPLES):
        m = pb_cls()
        _fill(m, rng)
        data = m.SerializeToString()
        ours = cls.FromString(data)
        back = ours.SerializeToString()
        if _has_map(pb_cls.DESCRIPTOR):
            assert pb_cls.FromString(back) == m, full
        else:
            assert back == data, full
        assert cls.FromString(back) == ours


def _set_of(*serialized_pbs):
    out = bytearray()
    for pb in serialized_pbs:
        _message._put_bytes(out, 1, pb)
    return bytes(out)


@pytest.mark.parametrize("mod", PORT_MODULES, ids=lambda m: m.__name__)
def test_a_port_file_reads_back_to_its_own_descriptor(mod):
    """The reader is the inverse of what the runtime writes: the
    FileDescriptor read from a module's ``serialized_pb`` writes the same
    bytes, with the same services and methods."""
    (fd,) = _message.read_descriptor_set(_set_of(
        mod.DESCRIPTOR.serialized_pb))
    assert fd.serialized_pb == mod.DESCRIPTOR.serialized_pb
    assert sorted(fd.services_by_name) == sorted(
        mod.DESCRIPTOR.services_by_name)
    for name, svc in fd.services_by_name.items():
        want = mod.DESCRIPTOR.services_by_name[name]
        assert [(m.name, m.input_type.full_name, m.output_type.full_name)
                for m in svc.methods] == [
            (m.name, m.input_type.full_name, m.output_type.full_name)
            for m in want.methods]


@pytest.mark.parametrize("mod", PORT_MODULES, ids=lambda m: m.__name__)
def test_a_port_files_classes_match_protobufs_bytes(mod):
    pool, files, fds = _pools(_set_of(mod.DESCRIPTOR.serialized_pb))
    port = _port_classes(files)
    for i, full in enumerate(sorted(port)):
        if full.endswith("Entry"):
            continue
        _check_bytes(pool, port, full, seed=1000 + i)


def test_the_vendored_press_descriptor_set():
    with open(os.path.join(DATA, "press_echo.desc"), "rb") as f:
        data = f.read()
    pool, files, _ = _pools(data)
    md = _message.find_method(files, "press.test.EchoService.Echo")
    assert (md.containing_service.name, md.input_type.full_name,
            md.output_type.full_name) == ("EchoService", "press.test.Req",
                                          "press.test.Resp")
    port = _port_classes(files)
    for i, full in enumerate(("press.test.Req", "press.test.Resp")):
        _check_bytes(pool, port, full, seed=i)
    with pytest.raises(KeyError):
        _message.find_method(files, "press.test.EchoService.Nope")


DEP_PROTO = """
syntax = "proto2";
package dep;
message Other {
  enum Color { RED = 0; GREEN = 1; }
  optional int32 x = 1 [default = 7];
  required string name = 2;
  repeated int32 r = 3;
  optional string t = 4 [default = "hi"];
  optional bytes bb = 5 [default = "a\\001b"];
  optional Color c = 6 [default = GREEN];
  optional float fl = 7 [default = -1.5];
  optional bool on = 8 [default = true];
  optional uint64 big = 9 [default = 18446744073709551615];
}
"""

TOP_PROTO = """
syntax = "proto3";
package tools.test;
import "dep.proto";
enum Top { TOP_ZERO = 0; TOP_ONE = 1; TOP_NEG = -3; }
message Outer {
  message Inner {
    enum Kind { K0 = 0; K1 = 1; }
    string s = 1;
    repeated int64 v = 2;
    Kind kind = 3;
    repeated Inner children = 4;
  }
  Inner inner = 1;
  repeated Inner inners = 2;
  map<string, Inner> by_name = 3;
  map<int32, Top> tops = 4;
  oneof pick { string a = 5; Inner b = 6; uint32 c = 7; }
  optional double d = 8;
  dep.Other other = 9;
  float f = 10;
  bool flag = 11;
  bytes blob = 12;
  uint64 u = 13;
  repeated Top top_list = 14;
  map<uint64, bytes> raw = 15;
}
service Svc { rpc Call(Outer) returns (dep.Other); }
"""


@pytest.fixture
def compiled_pair(tmp_path):
    if shutil.which("protoc") is None:
        pytest.skip("needs protoc")
    (tmp_path / "dep.proto").write_text(DEP_PROTO)
    (tmp_path / "top.proto").write_text(TOP_PROTO)
    out = tmp_path / "set.desc"
    subprocess.run(["protoc", "-I", str(tmp_path), "--include_imports",
                    f"--descriptor_set_out={out}", str(tmp_path / "top.proto")],
                   check=True)
    return out.read_bytes()


def test_a_protoc_set_with_nesting_maps_oneofs_and_an_import(compiled_pair):
    pool, files, _ = _pools(compiled_pair)
    port = _port_classes(files)
    assert {"tools.test.Outer", "tools.test.Outer.Inner",
            "dep.Other"} <= set(port)
    for i, full in enumerate(("tools.test.Outer", "tools.test.Outer.Inner",
                              "dep.Other")):
        _check_bytes(pool, port, full, seed=50 + i)
    md = _message.find_method(files, "tools.test.Svc.Call")
    assert md.input_type._concrete_class is port["tools.test.Outer"]
    assert md.output_type._concrete_class is port["dep.Other"]
    outer = port["tools.test.Outer"]
    inner = port["tools.test.Outer.Inner"]
    assert outer.Inner is inner and outer.NESTED == (inner,)
    assert inner.K1 == 1 and inner.ENUMS[0].full_name == \
        "tools.test.Outer.Inner.Kind"
    m = outer(a="x")
    m.inner.s = "y"
    assert m.WhichOneof("pick") == "a"
    m.c = 5
    assert m.WhichOneof("pick") == "c" and not m.HasField("d")
    m.d = 0.0
    assert m.HasField("d")


def test_proto2_defaults_and_required(compiled_pair):
    pool, files, _ = _pools(compiled_pair)
    other = _port_classes(files)["dep.Other"]
    pb_other = message_factory.GetMessageClass(
        pool.FindMessageTypeByName("dep.Other"))
    ours, theirs = other(), pb_other()
    for name in ("x", "t", "bb", "c", "fl", "on", "big"):
        assert getattr(ours, name) == getattr(theirs, name), name
        assert not ours.HasField(name)
    with pytest.raises(_message.EncodeError):
        ours.SerializeToString()
    ours.name = "n"
    theirs.name = "n"
    ours.x = 7  # set at its default: written, as protobuf writes it
    theirs.x = 7
    assert ours.SerializeToString() == theirs.SerializeToString()


def test_a_kind_the_runtime_lacks_is_refused(tmp_path):
    fdp = descriptor_pb2.FileDescriptorProto(name="z.proto", package="z",
                                             syntax="proto3")
    msg = fdp.message_type.add(name="Z")
    msg.field.add(name="s", number=1, type=FD.TYPE_SINT32,
                  label=FD.LABEL_OPTIONAL)
    with pytest.raises(NotImplementedError, match="sint32"):
        _message.read_descriptor_set(_set_of(fdp.SerializeToString()))
