"""The port's message runtime (brpc_tpu_torch.proto._message) against
protobuf: for every message of the port's tables (rpc_meta, serving,
echo, device_lane, collective), the same field values give the same bytes as the JAX package's
generated ``*_pb2`` classes, byte for byte, and each side parses the
other's bytes to equal fields. Values come from a numpy seed (with the
edges: negative int32/int64, int64 at ±(2^63 − 1), uint32 at 2^32 − 1,
empty and non-ASCII strings, empty and 1000-element repeated fields,
present-but-empty sub-messages) and from hypothesis. Each table module's
file descriptor is the one protoc wrote for the reference's ``.proto``.
Tolerance: exact.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from brpc_tpu.proto import collective_pb2 as jax_collective
from brpc_tpu.proto import device_lane_pb2 as jax_device
from brpc_tpu.proto import echo_pb2 as jax_echo
from brpc_tpu.proto import rpc_meta_pb2 as jax_meta
from brpc_tpu.proto import serving_pb2 as jax_serving
from brpc_tpu_torch.proto import _message as rt
from brpc_tpu_torch.proto import (collective_pb2, device_lane_pb2,
                                  echo_pb2, rpc_meta_pb2, serving_pb2)

FILES = [(rpc_meta_pb2, jax_meta), (serving_pb2, jax_serving),
         (echo_pb2, jax_echo), (device_lane_pb2, jax_device),
         (collective_pb2, jax_collective)]
PAIRS = [(mod, jmod, name) for mod, jmod in FILES
         for name in mod.DESCRIPTOR.message_types_by_name]
IDS = [name for _, _, name in PAIRS]

EDGES = {
    rt.INT32: [0, 1, -1, -(1 << 31), (1 << 31) - 1, 300, -300],
    rt.INT64: [0, 1, -1, (1 << 63) - 1, -(1 << 63) + 1, -(1 << 63),
               1 << 40],
    rt.UINT32: [0, 1, (1 << 32) - 1, 1 << 31],
    rt.BOOL: [False, True],
    rt.STRING: ["", "a", "héllo ✓ 世界", "\x00nul"],
    rt.BYTES: [b"", b"\x00\xff", bytes(range(256))],
}
UNICODE = "aé✓世\U0001f600"


def test_every_message_of_the_reference_protos_is_in_the_tables():
    for mod, jmod in FILES:
        assert set(mod.DESCRIPTOR.message_types_by_name) == \
            set(jmod.DESCRIPTOR.message_types_by_name)
        for name, desc in mod.DESCRIPTOR.message_types_by_name.items():
            jfields = jmod.DESCRIPTOR.message_types_by_name[name].fields
            assert [(f.number, f.name) for f in desc.fields] == \
                sorted((f.number, f.name) for f in jfields)
        for sname, sdesc in mod.DESCRIPTOR.services_by_name.items():
            jsdesc = jmod.DESCRIPTOR.services_by_name[sname]
            assert sdesc.full_name == jsdesc.full_name
            assert [(m.name, m.input_type.full_name, m.output_type.full_name)
                    for m in sdesc.methods] == \
                [(m.name, m.input_type.full_name, m.output_type.full_name)
                 for m in jsdesc.methods]


@pytest.mark.parametrize("mod,jmod", FILES,
                         ids=[m.DESCRIPTOR.name for m, _ in FILES])
def test_file_descriptor_is_the_one_protoc_wrote(mod, jmod):
    """``serialized_pb``, encoded from the tables, equals the reference
    module's FileDescriptorProto: the same messages, fields (name, number,
    label, type, type name) in declaration order, services and methods.
    What the reference's protoc wrote around the schema is set aside: the
    file's path, and the json names it wrote into serving.proto's."""
    from google.protobuf import descriptor_pb2

    ref = descriptor_pb2.FileDescriptorProto.FromString(
        jmod.DESCRIPTOR.serialized_pb)
    ref.name = mod.DESCRIPTOR.name
    for msg in ref.message_type:
        for f in msg.field:
            f.ClearField("json_name")
    assert mod.DESCRIPTOR.serialized_pb == ref.SerializeToString()


# ------------------------------------------------------------------ values
def _spec_from_rng(cls, rng, depth=0):
    """{field: value | nested spec | None (present, empty)} for cls."""
    spec = {}
    for f in cls.FIELDS:
        if f.kind == rt.MESSAGE:
            r = rng.integers(3)
            if r == 1:
                spec[f.name] = None
            elif r == 2 and depth < 2:
                spec[f.name] = _spec_from_rng(f.message_class, rng, depth + 1)
        elif f.repeated:
            n = [0, 1, 7, 1000][rng.integers(4)]
            lo, hi = {rt.INT32: (-(1 << 31), (1 << 31) - 1),
                      rt.UINT32: (0, (1 << 32) - 1)}.get(
                          f.kind, (0, (1 << 31) - 1))
            spec[f.name] = [int(x) for x in rng.integers(lo, hi, size=n,
                                                         endpoint=True)]
        elif rng.integers(3):
            edges = EDGES[f.kind]
            if f.kind == rt.STRING and rng.integers(2):
                spec[f.name] = "".join(rng.choice(list(UNICODE),
                                                  size=rng.integers(20)))
            elif f.kind == rt.BYTES and rng.integers(2):
                spec[f.name] = rng.bytes(int(rng.integers(64)))
            else:
                spec[f.name] = edges[rng.integers(len(edges))]
    return spec


def _apply(msg, spec):
    for name, value in spec.items():
        if value is None:
            getattr(msg, name).SetInParent()
        elif isinstance(value, dict):
            sub = getattr(msg, name)
            sub.SetInParent()
            _apply(sub, value)
        elif isinstance(value, list):
            getattr(msg, name).extend(value)
        else:
            setattr(msg, name, value)
    return msg


def _fields(msg, cls):
    """Field values of a port or protobuf message, by the port's table."""
    out = {}
    for f in cls.FIELDS:
        if f.kind == rt.MESSAGE:
            out[f.name] = (_fields(getattr(msg, f.name), f.message_class)
                           if msg.HasField(f.name) else "unset")
        elif f.repeated:
            out[f.name] = list(getattr(msg, f.name))
        else:
            out[f.name] = getattr(msg, f.name)
    return out


def _check(mod, jmod, name, spec):
    cls, jcls = getattr(mod, name), getattr(jmod, name)
    port = _apply(cls(), spec)
    ref = _apply(jcls(), spec)
    pb = port.SerializeToString()
    assert pb == ref.SerializeToString(), spec
    assert port.ByteSize() == ref.ByteSize()
    # each side parses the other's bytes to equal fields
    assert _fields(jcls.FromString(pb), cls) == _fields(port, cls)
    back = cls.FromString(ref.SerializeToString())
    assert _fields(back, cls) == _fields(ref, cls)
    assert back == port
    copy = cls()
    copy.CopyFrom(port)
    assert copy == port and copy.SerializeToString() == pb


@pytest.mark.parametrize("mod,jmod,name", PAIRS, ids=IDS)
def test_seeded_values_serialize_as_protobuf(mod, jmod, name):
    rng = np.random.default_rng(sum(map(ord, name)))
    for _ in range(40):
        _check(mod, jmod, name, _spec_from_rng(getattr(mod, name), rng))


@pytest.mark.parametrize("mod,jmod,name", PAIRS, ids=IDS)
def test_every_edge_value_of_every_field(mod, jmod, name):
    cls = getattr(mod, name)
    for f in cls.FIELDS:
        if f.kind == rt.MESSAGE:
            cases = [None, {}]
        elif f.repeated and f.kind == rt.UINT32:
            cases = [[], [0], [1, (1 << 31), (1 << 32) - 1],
                     list(range(1000))]
        elif f.repeated:
            cases = [[], [0], [-1, (1 << 31) - 1, -(1 << 31)],
                     list(range(-500, 500))]
        else:
            cases = EDGES[f.kind]
        for value in cases:
            _check(mod, jmod, name, {f.name: value})


def _strategy(cls, depth=0):
    fields = {}
    for f in cls.FIELDS:
        if f.kind == rt.MESSAGE:
            inner = (st.none() if depth >= 2
                     else st.none() | _strategy(f.message_class, depth + 1))
            fields[f.name] = inner
        elif f.repeated:
            lo, hi = rt._RANGES[f.kind]
            fields[f.name] = st.lists(st.integers(max(lo, -(1 << 31)), hi),
                                      max_size=50)
        elif f.kind in (rt.INT32, rt.INT64, rt.UINT32):
            lo, hi = rt._RANGES[f.kind]
            fields[f.name] = st.integers(lo, hi)
        elif f.kind == rt.BOOL:
            fields[f.name] = st.booleans()
        elif f.kind == rt.STRING:
            fields[f.name] = st.text(max_size=40)
        else:
            fields[f.name] = st.binary(max_size=40)
    return st.fixed_dictionaries({}, optional=fields)


@pytest.mark.parametrize("mod,jmod,name", PAIRS, ids=IDS)
@settings(max_examples=60, deadline=None)
@given(data=st.data())
def test_hypothesis_values_serialize_as_protobuf(mod, jmod, name, data):
    spec = data.draw(_strategy(getattr(mod, name)))
    _check(mod, jmod, name, spec)


# ------------------------------------------------------- parsing edge cases
def _varint(v):
    out = bytearray()
    rt._put_varint(out, v)
    return bytes(out)


def test_unknown_fields_are_skipped():
    ref = jax_serving.GenerateRequest(prompt_tokens=[3, -4, 5],
                                      max_new_tokens=7, resume_seq_id=-9)
    extra = (_varint((15 << 3) | 0) + _varint(12345)          # varint
             + _varint((16 << 3) | 2) + _varint(3) + b"abc"   # length
             + _varint((17 << 3) | 5) + b"\x01\x02\x03\x04"   # fixed32
             + _varint((18 << 3) | 1) + bytes(8))              # fixed64
    data = ref.SerializeToString() + extra
    got = serving_pb2.GenerateRequest.FromString(data)
    assert got == serving_pb2.GenerateRequest.FromString(
        ref.SerializeToString())
    assert _fields(got, serving_pb2.GenerateRequest) == _fields(
        jax_serving.GenerateRequest.FromString(data),
        serving_pb2.GenerateRequest)
    # a known number with a wire type its kind never has: unknown too
    odd = _varint((6 << 3) | 0) + _varint(1) + _varint((2 << 3) | 2) + \
        _varint(1) + b"\x01"
    assert _fields(serving_pb2.GenerateResponse.FromString(odd),
                   serving_pb2.GenerateResponse) == _fields(
        jax_serving.GenerateResponse.FromString(odd),
        serving_pb2.GenerateResponse)


def test_unpacked_and_split_repeated_fields_parse():
    vals = [0, 1, -1, (1 << 31) - 1, -(1 << 31), 300]
    unpacked = b"".join(_varint(1 << 3) + _varint(v) for v in vals)
    packed = jax_serving.GenerateRequest(prompt_tokens=vals[:3]) \
        .SerializeToString()
    for data in (unpacked, packed + unpacked, unpacked + packed):
        got = serving_pb2.GenerateRequest.FromString(data)
        want = jax_serving.GenerateRequest.FromString(data)
        assert list(got.prompt_tokens) == list(want.prompt_tokens)
        assert got.SerializeToString() == want.SerializeToString()


def test_sub_message_twice_merges_as_protobuf():
    a = jax_meta.RpcMeta()
    a.request.service_name = "svc"
    b = jax_meta.RpcMeta()
    b.request.log_id = -3
    data = a.SerializeToString() + b.SerializeToString()
    got = rpc_meta_pb2.RpcMeta.FromString(data)
    assert got.SerializeToString() == \
        jax_meta.RpcMeta.FromString(data).SerializeToString()
    assert (got.request.service_name, got.request.log_id) == ("svc", -3)


@pytest.mark.parametrize("data", [
    b"\xff", b"\x0a\x05ab", b"\x0b", b"\x00", b"\x0f", b"\x0e",
    b"\x08" + b"\x80" * 10 + b"\x01", b"\x32\x02\xff\xfe", b"\x0a\x02\x08"])
def test_malformed_bytes_fail_on_both_sides(data):
    with pytest.raises(Exception):
        jax_serving.GenerateResponse.FromString(data)
    with pytest.raises(rt.DecodeError):
        serving_pb2.GenerateResponse.FromString(data)


def test_reading_an_unset_sub_message_leaves_it_unset():
    meta = rpc_meta_pb2.RpcMeta()
    assert meta.stream_settings.stream_id == 0
    assert not meta.HasField("stream_settings")
    assert meta.SerializeToString() == b""
    meta.stream_settings.stream_id = 0  # an assignment marks it present
    assert meta.HasField("stream_settings")
    ref = jax_meta.RpcMeta()
    ref.stream_settings.stream_id = 0
    assert meta.SerializeToString() == ref.SerializeToString() == b"\x42\x00"


def test_setters_check_types_and_ranges():
    msg = rpc_meta_pb2.RpcMeta()
    with pytest.raises(ValueError):
        msg.attempt_version = 1 << 31
    with pytest.raises(ValueError):
        msg.checksum = -1
    with pytest.raises(TypeError):
        msg.correlation_id = 1.5
    with pytest.raises(TypeError):
        msg.auth_token = 3
    with pytest.raises(AttributeError):
        msg.request = rpc_meta_pb2.RequestMeta()
    with pytest.raises(AttributeError):
        msg.no_such_field = 1
    with pytest.raises(ValueError):
        msg.HasField("correlation_id")
    msg.correlation_id = np.int64(7)  # numpy ints take __index__
    assert msg.correlation_id == 7 and type(msg.correlation_id) is int


def test_descriptors_name_their_classes():
    svc = serving_pb2.DESCRIPTOR.services_by_name["LlmService"]
    assert (svc.name, svc.full_name) == ("LlmService",
                                         "brpc_tpu.serving.LlmService")
    gen = svc.methods_by_name["Generate"]
    assert gen.containing_service is svc
    assert gen.full_name == "brpc_tpu.serving.LlmService.Generate"
    assert rt.get_message_class(gen.input_type) is serving_pb2.GenerateRequest
    assert rt.get_message_class(gen.output_type) is \
        serving_pb2.GenerateResponse
    assert [m.name for m in svc.methods] == [
        "Generate", "Stats", "MigrateOpen", "MigrateCommit"]
