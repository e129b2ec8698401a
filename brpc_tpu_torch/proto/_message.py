"""A message runtime with no protobuf: proto3 wire messages from field tables.

The port's wire messages (``rpc_meta.proto``, ``serving.proto``,
``echo.proto``, ``device_lane.proto`` beside this file) are declared as :class:`Message`
subclasses with a ``FIELDS`` table: one :class:`Field` per ``.proto``
field, giving its number, name, kind, whether it repeats, and the class of
a sub-message. The runtime writes and reads the same bytes as protobuf's
proto3 encoding of those fields:

- fields are written in field-number order; a scalar at its default
  (0, false, "", b"") is not written; an empty repeated field is not
  written;
- varints: a negative int32 or int64 is its 64-bit two's complement (a
  10-byte varint); uint32 is masked to 32 bits;
- ``repeated int32`` is written packed; parsing takes packed and unpacked
  forms;
- a sub-message that is present is written even when empty (length 0);
  a sub-message is present once any of its fields was assigned (reading
  an unset one returns an empty message and leaves it unset);
- strings are UTF-8; unknown fields, and known numbers with a wire type
  their kind never has, are skipped when parsing (protobuf keeps them as
  unknown fields; this runtime drops them).

The API is the subset of protobuf's Python API the RPC core uses:
``SerializeToString``, ``ParseFromString``, ``FromString``, ``HasField``
(message fields), ``CopyFrom``, ``MergeFrom``, ``ByteSize``, ``Clear``,
``__eq__`` and keyword construction. Each module of tables builds a
:class:`FileDescriptor` whose ``services_by_name`` gives
:class:`ServiceDescriptor` / :class:`MethodDescriptor` objects with the
fields ``rpc.server.Service`` and ``rpc.channel.Stub`` read, and the
file's ``serialized_pb`` as protoc writes it;
:func:`get_message_class` takes the place of protobuf's
``message_factory.GetMessageClass``.
"""

from __future__ import annotations

import operator
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

INT32 = "int32"
INT64 = "int64"
UINT32 = "uint32"
BOOL = "bool"
STRING = "string"
BYTES = "bytes"
MESSAGE = "message"

_VARINT_KINDS = (INT32, INT64, UINT32, BOOL)
_WT_VARINT, _WT_I64, _WT_LEN, _WT_I32 = 0, 1, 2, 5
_U64 = (1 << 64) - 1
_RANGES = {INT32: (-(1 << 31), (1 << 31) - 1),
           INT64: (-(1 << 63), (1 << 63) - 1),
           UINT32: (0, (1 << 32) - 1)}
_DEFAULTS = {INT32: 0, INT64: 0, UINT32: 0, BOOL: False, STRING: "",
             BYTES: b""}


class DecodeError(ValueError):
    """Bytes that are not a valid encoding of the message."""


class Field:
    __slots__ = ("number", "name", "kind", "repeated", "message_class")

    def __init__(self, number: int, name: str, kind: str,
                 repeated: bool = False, message_class=None):
        if kind == MESSAGE and message_class is None:
            raise ValueError(f"field {name!r}: a message field needs a class")
        if repeated and kind not in _VARINT_KINDS:
            raise ValueError(f"field {name!r}: only repeated varint fields "
                             f"are supported")
        self.number = number
        self.name = name
        self.kind = kind
        self.repeated = repeated
        self.message_class = message_class


# ------------------------------------------------------------------ varints
def _put_varint(out: bytearray, v: int) -> None:
    v &= _U64
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _get_varint(data, pos: int) -> Tuple[int, int]:
    result = shift = 0
    end = len(data)
    while True:
        if pos >= end:
            raise DecodeError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & _U64, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than 10 bytes")


def _signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _from_varint(kind: str, v: int):
    if kind == INT32:
        return _signed(v, 32)
    if kind == INT64:
        return _signed(v, 64)
    if kind == UINT32:
        return v & 0xFFFFFFFF
    return v != 0


def _check_scalar(f: Field, value):
    """Coerce and range-check one scalar as protobuf's setters do."""
    kind = f.kind
    if kind == BOOL:
        if not isinstance(value, (bool, int)) or isinstance(value, float):
            raise TypeError(f"{f.name}: expected bool, got "
                            f"{type(value).__name__}")
        return bool(value)
    if kind in _RANGES:
        if isinstance(value, float):
            raise TypeError(f"{f.name}: expected int, got float")
        v = operator.index(value)
        lo, hi = _RANGES[kind]
        if not lo <= v <= hi:
            raise ValueError(f"{f.name}: value {v} out of range for {kind}")
        return v
    if kind == STRING:
        if isinstance(value, bytes):
            value = value.decode("utf-8")
        if not isinstance(value, str):
            raise TypeError(f"{f.name}: expected str, got "
                            f"{type(value).__name__}")
        return value
    if not isinstance(value, (bytes, bytearray, memoryview)):
        raise TypeError(f"{f.name}: expected bytes, got "
                        f"{type(value).__name__}")
    return bytes(value)


def _skip(data, pos: int, wire_type: int) -> int:
    if wire_type == _WT_VARINT:
        return _get_varint(data, pos)[1]
    if wire_type == _WT_I64:
        pos += 8
    elif wire_type == _WT_I32:
        pos += 4
    elif wire_type == _WT_LEN:
        n, pos = _get_varint(data, pos)
        pos += n
    else:
        raise DecodeError(f"unsupported wire type {wire_type}")
    if pos > len(data):
        raise DecodeError("truncated field")
    return pos


# ------------------------------------------------------------------ message
class Message:
    """Base of every table-built message. Subclasses set ``FIELDS``."""

    FIELDS: Tuple[Field, ...] = ()
    DESCRIPTOR: "Descriptor" = None
    # class-level tables, built by __init_subclass__
    _by_name: Dict[str, Field] = {}
    _by_number: Dict[int, Field] = {}
    _ordered: Tuple[Field, ...] = ()

    __slots__ = ("_values", "_present", "_parent")

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls._ordered = tuple(sorted(cls.FIELDS, key=lambda f: f.number))
        cls._by_name = {f.name: f for f in cls._ordered}
        cls._by_number = {f.number: f for f in cls._ordered}
        if len(cls._by_name) != len(cls.FIELDS) or \
                len(cls._by_number) != len(cls.FIELDS):
            raise ValueError(f"{cls.__name__}: duplicate field name or "
                             f"number")

    def __init__(self, **kwargs):
        object.__setattr__(self, "_values", {})
        object.__setattr__(self, "_present", set())
        object.__setattr__(self, "_parent", None)
        for name, value in kwargs.items():
            f = self._by_name.get(name)
            if f is None:
                raise ValueError(f"{type(self).__name__} has no field "
                                 f"{name!r}")
            if f.kind == MESSAGE:
                getattr(self, name).CopyFrom(value)
                self._mark(name)
            else:
                setattr(self, name, value)

    # ---------------------------------------------------------- attributes
    def __getattr__(self, name):
        f = type(self)._by_name.get(name)
        if f is None:
            raise AttributeError(f"{type(self).__name__} has no field "
                                 f"{name!r}")
        values = self._values
        v = values.get(name)
        if v is not None:
            return v
        if f.repeated:
            v = values[name] = []
        elif f.kind == MESSAGE:
            # unset: an empty child that marks this field present the
            # first time one of its own fields is assigned
            v = values[name] = f.message_class()
            object.__setattr__(v, "_parent", (self, name))
        else:
            v = _DEFAULTS[f.kind]
        return v

    def __setattr__(self, name, value):
        f = type(self)._by_name.get(name)
        if f is None:
            raise AttributeError(f"{type(self).__name__} has no field "
                                 f"{name!r}")
        if f.kind == MESSAGE:
            raise AttributeError(f"assignment to message field {name!r}: "
                                 f"set its fields or use CopyFrom")
        if f.repeated:
            self._values[name] = [_check_scalar(f, v) for v in value]
        else:
            self._values[name] = _check_scalar(f, value)
        self._touch()

    def _touch(self) -> None:
        parent = self._parent
        if parent is not None:
            parent[0]._mark(parent[1])

    def _mark(self, name: str) -> None:
        if name not in self._present:
            self._present.add(name)
            self._touch()

    def HasField(self, name: str) -> bool:
        f = type(self)._by_name.get(name)
        if f is None or f.kind != MESSAGE:
            raise ValueError(f"{type(self).__name__}: HasField is for "
                             f"message fields, not {name!r}")
        return name in self._present

    def SetInParent(self) -> None:
        """Mark this (empty) sub-message present in its parent."""
        self._touch()

    def Clear(self) -> None:
        self._values.clear()
        self._present.clear()

    # --------------------------------------------------------------- copies
    def MergeFrom(self, other: "Message") -> None:
        if type(other) is not type(self):
            raise TypeError(f"MergeFrom: {type(other).__name__} is not "
                            f"{type(self).__name__}")
        for f in self._ordered:
            name = f.name
            if f.repeated:
                vals = other._values.get(name)
                if vals:
                    getattr(self, name).extend(vals)
                    self._touch()
            elif f.kind == MESSAGE:
                if name in other._present:
                    getattr(self, name).MergeFrom(other._values[name])
                    self._mark(name)
            else:
                v = other._values.get(name, _DEFAULTS[f.kind])
                if v != _DEFAULTS[f.kind]:
                    self._values[name] = v
                    self._touch()

    def CopyFrom(self, other: "Message") -> None:
        if other is self:
            return
        self.Clear()
        self.MergeFrom(other)

    # ----------------------------------------------------------------- wire
    def _encode(self, out: bytearray) -> None:
        values = self._values
        for f in self._ordered:
            name = f.name
            if f.kind == MESSAGE:
                if name not in self._present:
                    continue
                body = values[name].SerializeToString()
                _put_varint(out, (f.number << 3) | _WT_LEN)
                _put_varint(out, len(body))
                out += body
                continue
            v = values.get(name)
            if not v:
                continue  # default scalar or empty repeated
            if f.repeated:
                packed = bytearray()
                mask32 = f.kind == UINT32
                for x in v:
                    x = int(x)
                    _put_varint(packed, x & 0xFFFFFFFF if mask32 else x)
                _put_varint(out, (f.number << 3) | _WT_LEN)
                _put_varint(out, len(packed))
                out += packed
            elif f.kind in _VARINT_KINDS:
                _put_varint(out, f.number << 3)
                _put_varint(out, v & 0xFFFFFFFF if f.kind == UINT32
                            else int(v))
            else:
                raw = v.encode("utf-8") if f.kind == STRING else v
                _put_varint(out, (f.number << 3) | _WT_LEN)
                _put_varint(out, len(raw))
                out += raw

    def SerializeToString(self) -> bytes:
        out = bytearray()
        self._encode(out)
        return bytes(out)

    def ByteSize(self) -> int:
        return len(self.SerializeToString())

    def _merge_bytes(self, data, pos: int, end: int) -> None:
        by_number = self._by_number
        values = self._values
        while pos < end:
            key, pos = _get_varint(data, pos)
            number, wt = key >> 3, key & 7
            if number == 0:
                raise DecodeError("field number 0")
            f = by_number.get(number)
            if f is None or wt != (_WT_VARINT if f.kind in _VARINT_KINDS
                                   and not (f.repeated and wt == _WT_LEN)
                                   else _WT_LEN):
                # unknown field, or a known number with a wire type its
                # kind never has: protobuf keeps both as unknown fields
                pos = _skip(data, pos, wt)
                if pos > end:
                    raise DecodeError("truncated field")
                continue
            if f.kind in _VARINT_KINDS:
                if wt == _WT_VARINT:
                    v, pos = _get_varint(data, pos)
                    v = _from_varint(f.kind, v)
                    if f.repeated:
                        getattr(self, f.name).append(v)
                    else:
                        values[f.name] = v
                elif wt == _WT_LEN and f.repeated:
                    n, pos = _get_varint(data, pos)
                    stop = pos + n
                    if stop > end:
                        raise DecodeError("truncated packed field")
                    lst = getattr(self, f.name)
                    while pos < stop:
                        v, pos = _get_varint(data, pos)
                        lst.append(_from_varint(f.kind, v))
                    if pos != stop:
                        raise DecodeError("packed field overruns its length")
            else:
                n, pos = _get_varint(data, pos)
                stop = pos + n
                if stop > end:
                    raise DecodeError(f"field {f.name}: truncated")
                if f.kind == MESSAGE:
                    child = getattr(self, f.name)
                    child._merge_bytes(data, pos, stop)
                    self._present.add(f.name)
                elif f.kind == STRING:
                    try:
                        values[f.name] = bytes(data[pos:stop]).decode("utf-8")
                    except UnicodeDecodeError as e:
                        raise DecodeError(f"field {f.name}: {e}") from None
                else:
                    values[f.name] = bytes(data[pos:stop])
                pos = stop
        if pos != end:
            raise DecodeError("message overruns its length")

    def MergeFromString(self, data) -> int:
        view = memoryview(data).cast("B") if not isinstance(
            data, (bytes, bytearray)) else data
        self._merge_bytes(view, 0, len(view))
        self._touch()
        return len(view)

    def ParseFromString(self, data) -> int:
        self.Clear()
        return self.MergeFromString(data)

    @classmethod
    def FromString(cls, data) -> "Message":
        msg = cls()
        msg.MergeFromString(data)
        return msg

    # ------------------------------------------------------------ equality
    def _fields_tuple(self):
        out = []
        for f in self._ordered:
            name = f.name
            if f.kind == MESSAGE:
                out.append(self._values[name]._fields_tuple()
                           if name in self._present else None)
            elif f.repeated:
                out.append(tuple(self._values.get(name, ())))
            else:
                out.append(self._values.get(name, _DEFAULTS[f.kind]))
        return tuple(out)

    def __eq__(self, other):
        if type(other) is not type(self):
            return NotImplemented
        return self._fields_tuple() == other._fields_tuple()

    __hash__ = None

    def __repr__(self) -> str:
        parts = []
        for f in self._ordered:
            name = f.name
            if f.kind == MESSAGE:
                if name in self._present:
                    parts.append(f"{name}={self._values[name]!r}")
            else:
                v = self._values.get(name)
                if v:
                    parts.append(f"{name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"


# --------------------------------------------------------------- descriptors
class Descriptor:
    """A message type: its names and its concrete class."""

    def __init__(self, cls, package: str):
        self.name = cls.__name__
        self.full_name = f"{package}.{cls.__name__}" if package \
            else cls.__name__
        self.fields = cls._ordered
        self._concrete_class = cls


class MethodDescriptor:
    def __init__(self, name: str, input_type: Descriptor,
                 output_type: Descriptor, service: "ServiceDescriptor"):
        self.name = name
        self.full_name = f"{service.full_name}.{name}"
        self.input_type = input_type
        self.output_type = output_type
        self.containing_service = service


class ServiceDescriptor:
    def __init__(self, name: str, package: str,
                 methods: Sequence[Tuple[str, type, type]]):
        self.name = name
        self.full_name = f"{package}.{name}" if package else name
        self.methods: List[MethodDescriptor] = [
            MethodDescriptor(m, req.DESCRIPTOR, resp.DESCRIPTOR, self)
            for m, req, resp in methods]
        self.methods_by_name = {m.name: m for m in self.methods}


class FileDescriptor:
    """One ``.proto`` file's tables: sets each class's DESCRIPTOR and
    builds the services, ``services`` maps a service name to its
    ``(method, request class, response class)`` list. ``serialized_pb``
    is the ``FileDescriptorProto`` protoc writes for such a file (no
    json names), encoded from the tables: messages and services in the
    order given, fields in ``FIELDS`` order."""

    def __init__(self, name: str, package: str,
                 messages: Iterable[type],
                 services: Optional[Dict[str, Sequence[Tuple[str, type,
                                                             type]]]] = None):
        self.name = name
        self.package = package
        self.message_types_by_name = {}
        for cls in messages:
            cls.DESCRIPTOR = Descriptor(cls, package)
            self.message_types_by_name[cls.__name__] = cls.DESCRIPTOR
        self.services_by_name = {
            sname: ServiceDescriptor(sname, package, methods)
            for sname, methods in (services or {}).items()}
        self.serialized_pb = self._file_proto()

    def _file_proto(self) -> bytes:
        # descriptor.proto: FileDescriptorProto name 1, package 2,
        # message_type 4, service 6, syntax 12; DescriptorProto name 1,
        # field 2; FieldDescriptorProto name 1, number 3, label 4, type 5,
        # type_name 6; ServiceDescriptorProto name 1, method 2;
        # MethodDescriptorProto name 1, input_type 2, output_type 3
        out = bytearray()
        _put_text(out, 1, self.name)
        if self.package:
            _put_text(out, 2, self.package)
        for desc in self.message_types_by_name.values():
            msg = bytearray()
            _put_text(msg, 1, desc.name)
            for f in desc._concrete_class.FIELDS:
                field = bytearray()
                _put_text(field, 1, f.name)
                _put_number(field, 3, f.number)
                _put_number(field, 4, _LABEL_REPEATED if f.repeated
                            else _LABEL_OPTIONAL)
                _put_number(field, 5, _TYPE_CODES[f.kind])
                if f.kind == MESSAGE:
                    _put_text(field, 6,
                              "." + f.message_class.DESCRIPTOR.full_name)
                _put_bytes(msg, 2, field)
            _put_bytes(out, 4, msg)
        for svc in self.services_by_name.values():
            sb = bytearray()
            _put_text(sb, 1, svc.name)
            for m in svc.methods:
                mb = bytearray()
                _put_text(mb, 1, m.name)
                _put_text(mb, 2, "." + m.input_type.full_name)
                _put_text(mb, 3, "." + m.output_type.full_name)
                _put_bytes(sb, 2, mb)
            _put_bytes(out, 6, sb)
        _put_text(out, 12, "proto3")
        return bytes(out)


# FieldDescriptorProto's Label and Type values (descriptor.proto)
_LABEL_OPTIONAL, _LABEL_REPEATED = 1, 3
_TYPE_CODES = {INT64: 3, INT32: 5, BOOL: 8, STRING: 9, MESSAGE: 11,
               BYTES: 12, UINT32: 13}


def _put_number(out: bytearray, number: int, v: int) -> None:
    _put_varint(out, number << 3 | _WT_VARINT)
    _put_varint(out, v)


def _put_bytes(out: bytearray, number: int, data) -> None:
    _put_varint(out, number << 3 | _WT_LEN)
    _put_varint(out, len(data))
    out += data


def _put_text(out: bytearray, number: int, text: str) -> None:
    _put_bytes(out, number, text.encode("utf-8"))


def get_message_class(desc: Descriptor) -> type:
    """The concrete class of a message descriptor."""
    return desc._concrete_class
