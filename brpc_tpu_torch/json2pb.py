"""json2pb — bidirectional JSON <-> message bridge with conversion options.

Counterpart of the reference's ``src/json2pb`` (``pb_to_json.cpp`` /
``json_to_pb.cpp`` and their Pb2JsonOptions / Json2PbOptions): the HTTP
protocol family serves message services to JSON clients, and proxies need
control over the conversion rules, not a fixed mapping.

The port's copy of the JAX package's ``json2pb.py``, which walks
protobuf's descriptors; this one walks the port's field tables
(:mod:`brpc_tpu_torch.proto._message`) and, given the same field values,
writes the same text:

  - maps (string/int/bool keys), nested + repeated messages, oneof
  - enums by name or number (``enum_as_name``), unknown enum tolerance
  - bytes as base64 (or latin-1 passthrough when ``bytes_to_base64=False``
    — the reference's raw-bytes escape hatch)
  - 64-bit ints as JSON strings (``int64_as_string``) for JS safety
  - NaN/Infinity round-tripping for float/double
  - ``always_print_primitive_fields`` / ``jsonify_empty_array`` dump shaping
  - unknown-field tolerance on parse (``ignore_unknown_fields``),
    camelCase json_name acceptance

Limitation: well-known types (Timestamp/Duration/Struct/wrappers) have no
tables here, and none of the port's schemas uses them.
"""

from __future__ import annotations

import base64
import json
import math
from dataclasses import dataclass
from typing import Optional, Type

from brpc_tpu_torch.proto import _message as _m

_INT_KINDS = {_m.INT32, _m.INT64, _m.UINT32, _m.UINT64}
_WIDE_KINDS = {_m.INT64, _m.UINT64}
_FLOAT_KINDS = {_m.FLOAT, _m.DOUBLE}


class Json2PbError(ValueError):
    pass


@dataclass
class Pb2JsonOptions:
    """reference pb_to_json.h Pb2JsonOptions (subset, renamed pythonic)."""

    enum_as_name: bool = True
    bytes_to_base64: bool = True
    int64_as_string: bool = True
    jsonify_empty_array: bool = False
    always_print_primitive_fields: bool = False
    pretty: bool = False


@dataclass
class Json2PbOptions:
    """reference json_to_pb.h Json2PbOptions (subset)."""

    base64_to_bytes: bool = True
    ignore_unknown_fields: bool = True
    allow_unknown_enum: bool = False  # drop unknown enum names vs error


# ------------------------------------------------------------------ pb->json
def _value_to_json(field, value, opts: Pb2JsonOptions):
    kind = field.kind
    if kind == _m.MESSAGE:
        return _message_to_dict(value, opts)
    if kind == _m.ENUM:
        if opts.enum_as_name:
            return field.enum_type.values_by_number.get(value, value)
        return value
    if kind == _m.BOOL:
        return bool(value)
    if kind in _FLOAT_KINDS:
        if math.isnan(value):
            return "NaN"
        if math.isinf(value):
            return "Infinity" if value > 0 else "-Infinity"
        return value
    if kind in _WIDE_KINDS and opts.int64_as_string:
        return str(value)
    if kind == _m.BYTES:
        if opts.bytes_to_base64:
            return base64.b64encode(value).decode("ascii")
        return value.decode("latin-1")
    return value


def _message_to_dict(msg, opts: Pb2JsonOptions) -> dict:
    out = {}
    for field in type(msg).FIELDS:  # declaration order, as protobuf's
        name = field.name
        if field.is_map:
            mapping = getattr(msg, name)
            if not mapping and not opts.jsonify_empty_array:
                continue
            out[name] = {str(k).lower() if isinstance(k, bool) else str(k):
                         _value_to_json(field, v, opts)
                         for k, v in sorted(mapping.items(),
                                            key=lambda kv: str(kv[0]))}
            continue
        if field.repeated:
            items = getattr(msg, name)
            if not items and not opts.jsonify_empty_array:
                continue
            out[name] = [_value_to_json(field, v, opts) for v in items]
            continue
        if field.kind == _m.MESSAGE:
            if msg.HasField(name):
                out[name] = _message_to_dict(getattr(msg, name), opts)
            continue
        if field.has_presence:
            # explicit presence (oneof member, proto3 `optional`, proto2
            # optional scalar): emission follows the has-bit, so a field
            # explicitly set to its default survives the round trip
            # (reference pb_to_json.cpp checks has-bits, not values)
            if msg.HasField(name):
                out[name] = _value_to_json(field, getattr(msg, name), opts)
            continue
        value = getattr(msg, name)
        if value == field.default \
                and not opts.always_print_primitive_fields:
            continue
        out[name] = _value_to_json(field, value, opts)
    return out


def pb_to_json(message, pretty: bool = False,
               always_print_fields_with_no_presence: bool = False,
               options: Optional[Pb2JsonOptions] = None) -> str:
    opts = options or Pb2JsonOptions(
        pretty=pretty,
        always_print_primitive_fields=always_print_fields_with_no_presence)
    try:
        d = _message_to_dict(message, opts)
        return json.dumps(d, indent=2 if opts.pretty else None,
                          sort_keys=False)
    except Json2PbError:
        raise
    except Exception as e:
        raise Json2PbError(str(e)) from None


# ------------------------------------------------------------------ json->pb
def _json_to_value(field, value, opts: Json2PbOptions, where: str):
    kind = field.kind
    if kind == _m.ENUM:
        if isinstance(value, str):
            number = field.enum_type.values_by_name.get(value)
            if number is None:
                if opts.allow_unknown_enum:
                    return None
                raise Json2PbError(f"{where}: unknown enum name {value!r}")
            return number
        if isinstance(value, bool) or not isinstance(value, int):
            raise Json2PbError(f"{where}: bad enum value {value!r}")
        return value
    if kind == _m.BOOL:
        if isinstance(value, bool):
            return value
        raise Json2PbError(f"{where}: expected bool, got {value!r}")
    if kind in _INT_KINDS:
        if isinstance(value, bool) or not isinstance(value, (int, str)):
            raise Json2PbError(f"{where}: expected int, got {value!r}")
        try:
            return int(value)
        except ValueError:
            raise Json2PbError(f"{where}: bad int {value!r}") from None
    if kind in _FLOAT_KINDS:
        if isinstance(value, str):
            if value == "NaN":
                return math.nan
            if value == "Infinity":
                return math.inf
            if value == "-Infinity":
                return -math.inf
            try:
                return float(value)
            except ValueError:
                raise Json2PbError(f"{where}: bad float {value!r}") from None
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            return float(value)
        raise Json2PbError(f"{where}: expected number, got {value!r}")
    if kind == _m.BYTES:
        if not isinstance(value, str):
            raise Json2PbError(f"{where}: expected string for bytes")
        if opts.base64_to_bytes:
            try:
                return base64.b64decode(value, validate=True)
            except Exception:
                raise Json2PbError(f"{where}: invalid base64") from None
        return value.encode("latin-1")
    if kind == _m.STRING:
        if not isinstance(value, str):
            raise Json2PbError(f"{where}: expected string, got {value!r}")
        return value
    raise Json2PbError(f"{where}: unhandled field type")


def _map_key_from_json(kind: str, key: str, where: str):
    if kind == _m.BOOL:
        if key in ("true", "false"):
            return key == "true"
        raise Json2PbError(f"{where}: bad bool map key {key!r}")
    if kind in _INT_KINDS:
        try:
            return int(key)
        except ValueError:
            raise Json2PbError(f"{where}: bad int map key {key!r}") from None
    return key


def _dict_to_message(d: dict, msg, opts: Json2PbOptions, where: str) -> None:
    if not isinstance(d, dict):
        raise Json2PbError(f"{where}: expected object, got {d!r}")
    cls = type(msg)
    fields = cls._by_name
    for key, value in d.items():
        field = fields.get(key)
        if field is None:
            # also accept camelCase against snake_case schemas
            field = next((f for f in cls.FIELDS if f.json_name == key),
                         None)
        if field is None:
            if opts.ignore_unknown_fields:
                continue
            raise Json2PbError(f"{where}: unknown field {key!r}")
        fwhere = f"{where}.{field.name}"
        if value is None:
            continue  # JSON null = leave default (proto3 json mapping)
        if field.is_map:
            if not isinstance(value, dict):
                raise Json2PbError(f"{fwhere}: expected object for map")
            target = getattr(msg, field.name)
            for k, v in value.items():
                pk = _map_key_from_json(field.key_kind, k, fwhere)
                if field.kind == _m.MESSAGE:
                    _dict_to_message(v, target[pk], opts, f"{fwhere}[{k}]")
                else:
                    converted = _json_to_value(field, v, opts,
                                               f"{fwhere}[{k}]")
                    if converted is not None:
                        target[pk] = converted
            continue
        if field.repeated:
            if not isinstance(value, list):
                raise Json2PbError(f"{fwhere}: expected array")
            target = getattr(msg, field.name)
            for i, item in enumerate(value):
                iw = f"{fwhere}[{i}]"
                if field.kind == _m.MESSAGE:
                    _dict_to_message(item, target.add(), opts, iw)
                else:
                    converted = _json_to_value(field, item, opts, iw)
                    if converted is not None:
                        target.append(_m._check_scalar(field, converted))
            continue
        if field.kind == _m.MESSAGE:
            _dict_to_message(value, getattr(msg, field.name), opts, fwhere)
            continue
        converted = _json_to_value(field, value, opts, fwhere)
        if converted is not None:
            setattr(msg, field.name, converted)


def json_to_pb(data, message_class: Type,
               ignore_unknown_fields: bool = True,
               options: Optional[Json2PbOptions] = None):
    """Parse a JSON document (str/bytes) into a new message instance."""
    opts = options or Json2PbOptions(
        ignore_unknown_fields=ignore_unknown_fields)
    if isinstance(data, (bytes, bytearray, memoryview)):
        try:
            data = bytes(data).decode("utf-8")
        except UnicodeDecodeError as e:
            raise Json2PbError(str(e)) from None
    msg = message_class()
    if data.strip() == "":
        return msg  # empty body = default message (GET-style calls)
    try:
        parsed = json.loads(data)
    except json.JSONDecodeError as e:
        raise Json2PbError(str(e)) from None
    try:
        _dict_to_message(parsed, msg, opts, message_class.DESCRIPTOR.name)
    except Json2PbError:
        raise
    except (ValueError, TypeError) as e:
        # the setters' range and type checks (int32 overflow, negative
        # uint...)
        raise Json2PbError(str(e)) from None
    return msg
