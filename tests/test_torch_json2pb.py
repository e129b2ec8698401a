"""The port's json2pb bridge (brpc_tpu_torch/json2pb.py over the port's
message runtime) held against the JAX package's (brpc_tpu/json2pb.py over
protobuf): every case of ``tests/test_json2pb.py`` on the port's tables
(reference src/json2pb pb_to_json.cpp / json_to_pb.cpp conversion
rules), then, on the same field values, the port's JSON text equal to the
reference's under every option, each side's JSON parsed by the other to
equal messages, and the wire kinds the bridge's schemas add (uint64,
double, float, enums, maps, oneof, proto3 ``optional``, repeated
messages, proto2 has-bits, defaults and unpacked repeats) byte-equal to
protobuf's, from a numpy seed. Each new table module's file descriptor is
the one protoc wrote. Tolerance: exact."""

import json
import math

import pytest

from brpc_tpu_torch.json2pb import (
    Json2PbError,
    Json2PbOptions,
    Pb2JsonOptions,
    json_to_pb,
    pb_to_json,
)
from brpc_tpu_torch.proto import jsonpb_test_pb2 as tp


def full_msg():
    m = tp.JsonScratch(
        i32=-7, i64=-(1 << 40), u64=1 << 50, d=2.5, f=0.5, flag=True,
        text="héllo", blob=b"\x00\xffbin", color=tp.BLUE,
        inner=tp.Inner(name="n", nums=[1, 2, 3]),
        colors=[tp.RED, tp.BLUE],
    )
    m.items.add(name="a", nums=[4])
    m.items.add(name="b")
    m.counts["x"] = 1
    m.counts["y"] = 2
    m.registry[9].name = "nine"
    m.choice_a = "picked"
    return m


class TestRoundTrip:
    def test_full_roundtrip(self):
        m = full_msg()
        back = json_to_pb(pb_to_json(m), tp.JsonScratch)
        assert back == m

    def test_oneof(self):
        m = tp.JsonScratch()
        m.choice_b = 0  # default-valued but SET oneof must survive
        back = json_to_pb(pb_to_json(m), tp.JsonScratch)
        assert back.WhichOneof("choice") == "choice_b"

    def test_nan_inf(self):
        m = tp.JsonScratch(d=math.nan, f=math.inf)
        back = json_to_pb(pb_to_json(m), tp.JsonScratch)
        assert math.isnan(back.d) and math.isinf(back.f)

    def test_map_int_keys(self):
        m = tp.JsonScratch()
        m.registry[-3].name = "neg"
        d = json.loads(pb_to_json(m))
        assert d["registry"]["-3"]["name"] == "neg"
        back = json_to_pb(pb_to_json(m), tp.JsonScratch)
        assert back.registry[-3].name == "neg"


class TestPbToJsonOptions:
    def test_enum_as_number(self):
        m = tp.JsonScratch(color=tp.BLUE)
        d = json.loads(pb_to_json(m, options=Pb2JsonOptions(
            enum_as_name=False)))
        assert d["color"] == 2

    def test_int64_as_string(self):
        m = tp.JsonScratch(i64=1 << 40)
        d = json.loads(pb_to_json(m, options=Pb2JsonOptions(
            int64_as_string=True)))
        assert d["i64"] == str(1 << 40)

    def test_bytes_raw_passthrough(self):
        m = tp.JsonScratch(blob=b"\x01\x02raw")
        opts = Pb2JsonOptions(bytes_to_base64=False)
        d = json.loads(pb_to_json(m, options=opts))
        assert d["blob"] == "\x01\x02raw"
        back = json_to_pb(json.dumps(d), tp.JsonScratch,
                          options=Json2PbOptions(base64_to_bytes=False))
        assert back.blob == b"\x01\x02raw"

    def test_jsonify_empty_array(self):
        d = json.loads(pb_to_json(tp.JsonScratch(), options=Pb2JsonOptions(
            jsonify_empty_array=True)))
        assert d["items"] == [] and d["counts"] == {}

    def test_always_print_primitives(self):
        d = json.loads(pb_to_json(tp.JsonScratch(), options=Pb2JsonOptions(
            always_print_primitive_fields=True)))
        assert d["i32"] == 0 and d["flag"] is False and d["text"] == ""


class TestJsonToPbOptions:
    def test_unknown_field_tolerance(self):
        m = json_to_pb('{"nope": 1, "i32": 5}', tp.JsonScratch)
        assert m.i32 == 5
        with pytest.raises(Json2PbError):
            json_to_pb('{"nope": 1}', tp.JsonScratch,
                       ignore_unknown_fields=False)

    def test_unknown_enum(self):
        with pytest.raises(Json2PbError):
            json_to_pb('{"color": "MAGENTA"}', tp.JsonScratch)
        m = json_to_pb('{"color": "MAGENTA", "i32": 1}', tp.JsonScratch,
                       options=Json2PbOptions(allow_unknown_enum=True))
        assert m.i32 == 1 and m.color == tp.COLOR_UNSET

    def test_camel_case_json_names(self):
        m = json_to_pb('{"choiceA": "via-camel"}', tp.JsonScratch)
        assert m.choice_a == "via-camel"

    def test_type_errors_are_reported_with_path(self):
        with pytest.raises(Json2PbError) as ei:
            json_to_pb('{"inner": {"nums": ["NaN-ish"]}}', tp.JsonScratch)
        assert "inner.nums[0]" in str(ei.value)

    def test_int64_string_accepted(self):
        m = json_to_pb('{"i64": "-1099511627776"}', tp.JsonScratch)
        assert m.i64 == -(1 << 40)

    def test_malformed_json(self):
        with pytest.raises(Json2PbError):
            json_to_pb("{nope", tp.JsonScratch)

    def test_empty_body_default_message(self):
        assert json_to_pb("", tp.JsonScratch) == tp.JsonScratch()


class TestExplicitPresence:
    """Explicit-presence scalars follow the has-bit, not the value
    (reference pb_to_json.cpp checks has-bits)."""

    def test_proto2_optional_set_to_default_is_emitted(self):
        from brpc_tpu_torch.proto import jsonpb_test2_pb2 as tp2
        m = tp2.Proto2Scratch(must=5)
        m.opt_i32 = 0
        d = json.loads(pb_to_json(m))
        assert d["opt_i32"] == 0 and "opt_text" not in d

    def test_proto2_roundtrip_preserves_presence(self):
        from brpc_tpu_torch.proto import jsonpb_test2_pb2 as tp2
        m = tp2.Proto2Scratch(must=5)
        m.opt_i32 = 0
        back = json_to_pb(pb_to_json(m), tp2.Proto2Scratch)
        assert back.HasField("opt_i32")
        assert not back.HasField("opt_text")

    def test_set_to_default_is_emitted(self):
        m = tp.JsonScratch()
        m.maybe_i32 = 0
        assert json.loads(pb_to_json(m))["maybe_i32"] == 0

    def test_unset_is_omitted(self):
        assert "maybe_i32" not in json.loads(pb_to_json(tp.JsonScratch()))

    def test_roundtrip_preserves_presence(self):
        m = tp.JsonScratch()
        m.maybe_i32 = 0
        back = json_to_pb(pb_to_json(m), tp.JsonScratch)
        assert back.HasField("maybe_i32")
        back2 = json_to_pb(pb_to_json(tp.JsonScratch()), tp.JsonScratch)
        assert not back2.HasField("maybe_i32")


# ------------------------------------------------ parity with the reference
from brpc_tpu import json2pb as jax_json2pb  # noqa: E402
from brpc_tpu.proto import builtin_view_pb2 as jax_view  # noqa: E402
from brpc_tpu.proto import health_pb2 as jax_health  # noqa: E402
from brpc_tpu.proto import jsonpb_test2_pb2 as jax_tp2  # noqa: E402
from brpc_tpu.proto import jsonpb_test_pb2 as jax_tp  # noqa: E402
from brpc_tpu_torch.proto import builtin_view_pb2, health_pb2  # noqa: E402
from brpc_tpu_torch.proto import jsonpb_test2_pb2 as tp2  # noqa: E402

OPTIONS = [
    {},
    {"enum_as_name": False},
    {"bytes_to_base64": False},
    {"int64_as_string": False},
    {"jsonify_empty_array": True},
    {"always_print_primitive_fields": True},
    {"pretty": True},
]


def _seeded(mod, rng, entries=3):
    """A JsonScratch of ``mod`` (the port's tables or protobuf's classes)
    with values drawn from ``rng``, each map holding fewer than
    ``entries`` entries; the same draws give the same values on either
    side."""
    m = mod.JsonScratch()
    if rng.integers(2):
        m.i32 = int(rng.integers(-(1 << 31), 1 << 31))
    if rng.integers(2):
        m.i64 = int(rng.integers(-(1 << 63), (1 << 63) - 1))
    if rng.integers(2):
        m.u64 = int(rng.integers(0, 1 << 63)) * 2 + int(rng.integers(2))
    if rng.integers(2):
        m.d = float(rng.choice([0.0, -0.5, 1e300, float(rng.normal()),
                                float("inf"), float("-inf")]))
    if rng.integers(2):
        m.f = float(rng.normal())
    if rng.integers(2):
        m.flag = bool(rng.integers(2))
    if rng.integers(2):
        m.text = "".join(rng.choice(list("aé✓世\U0001f600 \"\\"),
                                    size=int(rng.integers(12))))
    if rng.integers(2):
        m.blob = rng.bytes(int(rng.integers(20)))
    if rng.integers(2):
        m.color = int(rng.integers(0, 4))  # 3 has no name: an open enum
    if rng.integers(2):
        m.inner.name = "in"
        m.inner.nums.extend(int(x) for x in rng.integers(-9, 9, size=3))
    for _ in range(int(rng.integers(3))):
        it = m.items.add()
        it.name = str(int(rng.integers(100)))
    for _ in range(int(rng.integers(entries))):
        m.counts[str(int(rng.integers(50)))] = int(rng.integers(-5, 5))
    for _ in range(int(rng.integers(entries))):
        m.registry[int(rng.integers(-(1 << 40), 1 << 40))].name = "r"
    choice = int(rng.integers(3))
    if choice == 1:
        m.choice_a = "a" * int(rng.integers(3))
    elif choice == 2:
        m.choice_b = int(rng.integers(-3, 3))
    m.colors.extend(int(x) for x in rng.integers(0, 3,
                                                 size=int(rng.integers(3))))
    if rng.integers(2):
        m.maybe_i32 = int(rng.integers(-2, 2))
    return m


@pytest.mark.parametrize("opts", OPTIONS, ids=lambda o: ",".join(o) or
                         "defaults")
def test_json_text_equals_the_reference(opts):
    """The same values give the same text under each option, and each
    side parses that text to the same message."""
    import numpy as np

    rng = np.random.default_rng(sum(map(ord, ",".join(opts))) + 16)
    back_opts = {"base64_to_bytes": opts.get("bytes_to_base64", True)}
    for i in range(60):
        seed = int(rng.integers(1 << 30))
        port = _seeded(tp, np.random.default_rng(seed))
        ref = _seeded(jax_tp, np.random.default_rng(seed))
        text = pb_to_json(port, options=Pb2JsonOptions(**opts))
        assert text == jax_json2pb.pb_to_json(
            ref, options=jax_json2pb.Pb2JsonOptions(**opts)), (i, opts)
        got = json_to_pb(text, tp.JsonScratch,
                         options=Json2PbOptions(**back_opts))
        want = jax_json2pb.json_to_pb(
            text, jax_tp.JsonScratch,
            options=jax_json2pb.Json2PbOptions(**back_opts))
        assert got == tp.JsonScratch.FromString(want.SerializeToString())


@pytest.mark.parametrize("seed", range(4))
def test_new_wire_kinds_are_byte_equal_to_protobuf(seed):
    """Byte equality where protobuf's bytes are defined: its Python
    runtime writes a map of several entries in an order of its own, even
    with ``deterministic=True``, so those messages are held by parsing
    each side's bytes on the other instead (the port writes entries in
    key order)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for _ in range(50):
        s = int(rng.integers(1 << 30))
        port = _seeded(tp, np.random.default_rng(s), entries=2)
        ref = _seeded(jax_tp, np.random.default_rng(s), entries=2)
        data = port.SerializeToString()
        assert data == ref.SerializeToString()
        assert port.ByteSize() == ref.ByteSize()
        back = tp.JsonScratch.FromString(data)
        assert back == port
        assert jax_tp.JsonScratch.FromString(data) == ref
        assert back.WhichOneof("choice") == ref.WhichOneof("choice")
        assert back.HasField("maybe_i32") == ref.HasField("maybe_i32")
        port = _seeded(tp, np.random.default_rng(s), entries=5)
        ref = _seeded(jax_tp, np.random.default_rng(s), entries=5)
        assert tp.JsonScratch.FromString(ref.SerializeToString()) == port
        assert jax_tp.JsonScratch.FromString(
            port.SerializeToString()) == ref
        assert port.ByteSize() == ref.ByteSize()


def test_proto2_has_bits_defaults_and_unpacked_repeats_match_protobuf():
    for kw, opt in [({"must": 0}, None), ({"must": -3, "many": [1, -2]}, 0),
                    ({"must": 7, "opt_text": "dflt"}, 5)]:
        port, ref = tp2.Proto2Scratch(**kw), jax_tp2.Proto2Scratch(**kw)
        if opt is not None:
            port.opt_i32 = ref.opt_i32 = opt
        data = port.SerializeToString()
        assert data == ref.SerializeToString()
        back = tp2.Proto2Scratch.FromString(data)
        assert back == port
        for name in ("opt_i32", "opt_text", "must"):
            assert back.HasField(name) == ref.HasField(name)
            assert getattr(back, name) == getattr(ref, name)
        assert pb_to_json(port) == jax_json2pb.pb_to_json(ref)
    with pytest.raises(ValueError, match="missing required fields: must"):
        tp2.Proto2Scratch().SerializeToString()


@pytest.mark.parametrize("mod,jmod", [
    (tp, jax_tp), (tp2, jax_tp2), (health_pb2, jax_health),
    (builtin_view_pb2, jax_view)], ids=lambda m: m.DESCRIPTOR.name)
def test_file_descriptor_is_the_one_protoc_wrote(mod, jmod):
    """``serialized_pb`` of each new table module: nested map entries
    with their ``map_entry`` option, enums top-level and nested, oneofs
    with proto3 ``optional``'s synthetic one, proto2's labels and
    default, all as protoc wrote them (the file's path set aside)."""
    from google.protobuf import descriptor_pb2

    ref = descriptor_pb2.FileDescriptorProto.FromString(
        jmod.DESCRIPTOR.serialized_pb)
    ref.name = mod.DESCRIPTOR.name
    assert mod.DESCRIPTOR.serialized_pb == ref.SerializeToString()


def test_health_and_view_messages_equal_protobufs():
    for status in range(4):
        assert health_pb2.HealthCheckResponse(status=status) \
            .SerializeToString() == jax_health.HealthCheckResponse(
                status=status).SerializeToString()
    assert health_pb2.HealthCheckResponse.ServingStatus.Name(2) == \
        jax_health.HealthCheckResponse.ServingStatus.Name(2)
    kw = dict(status=404, content_type="text/plain", body=b"\x00no")
    assert builtin_view_pb2.ViewResponse(**kw).SerializeToString() == \
        jax_view.ViewResponse(**kw).SerializeToString()
    resp = health_pb2.HealthCheckResponse(status=1)
    assert pb_to_json(resp) == jax_json2pb.pb_to_json(
        jax_health.HealthCheckResponse(status=1)) == '{"status": "SERVING"}'
