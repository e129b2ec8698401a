"""A message runtime with no protobuf: wire messages from field tables.

The port's wire messages (the ``.proto`` files beside this file) are
declared as :class:`Message` subclasses with a ``FIELDS`` table: one
:class:`Field` per ``.proto`` field, giving its number, name, kind,
whether it repeats, the class of a sub-message or the :class:`EnumType`
of an enum, and for the kinds that have one its oneof, presence, map key
and value. The runtime writes and reads the same bytes as protobuf's
encoding of those fields:

- fields are written in field-number order; a scalar without presence at
  its default (0, 0.0, false, "", b"") is not written; an empty repeated
  field is not written;
- a scalar with presence (a oneof member, proto3 ``optional``, any proto2
  singular scalar) is written once set, even at its default; setting a
  oneof member clears the others;
- varints: a negative int32, int64 or enum is its 64-bit two's complement
  (a 10-byte varint); uint32 is masked to 32 bits; double and float are
  little-endian fixed64 / fixed32 (a float stores its float32 value);
- repeated scalars are written packed in proto3 and unpacked in proto2;
  parsing takes both forms;
- a map is a repeated entry message (key 1, value 2), each entry with
  both its key and its value, written in key order (protobuf's Python
  runtime writes a map of several entries in an order of its own, even
  when asked to be deterministic; each side parses the other's bytes);
- a sub-message that is present is written even when empty (length 0);
  a sub-message is present once any of its fields was assigned (reading
  an unset one returns an empty message and leaves it unset);
- strings are UTF-8; unknown fields, and known numbers with a wire type
  their kind never has, are skipped when parsing (protobuf keeps them as
  unknown fields; this runtime drops them); a proto2 message missing a
  required field refuses to serialize.

The API is the subset of protobuf's Python API the port uses:
``SerializeToString``, ``ParseFromString``, ``FromString``, ``HasField``,
``WhichOneof``, ``CopyFrom``, ``MergeFrom``, ``ByteSize``, ``Clear``,
``__eq__``, keyword construction, ``add()`` on repeated messages and
item access on maps. Each module of tables builds a
:class:`FileDescriptor` whose ``services_by_name`` gives
:class:`ServiceDescriptor` / :class:`MethodDescriptor` objects with the
fields ``rpc.server.Service`` and ``rpc.channel.Stub`` read, and the
file's ``serialized_pb`` as protoc writes it;
:func:`get_message_class` takes the place of protobuf's
``message_factory.GetMessageClass``.
"""

from __future__ import annotations

import math
import operator
import struct
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

INT32 = "int32"
INT64 = "int64"
UINT32 = "uint32"
UINT64 = "uint64"
BOOL = "bool"
ENUM = "enum"
DOUBLE = "double"
FLOAT = "float"
STRING = "string"
BYTES = "bytes"
MESSAGE = "message"

_VARINT_KINDS = (INT32, INT64, UINT32, UINT64, BOOL, ENUM)
_WT_VARINT, _WT_I64, _WT_LEN, _WT_I32 = 0, 1, 2, 5
_WIRE = {DOUBLE: _WT_I64, FLOAT: _WT_I32}
_U64 = (1 << 64) - 1
_RANGES = {INT32: (-(1 << 31), (1 << 31) - 1),
           INT64: (-(1 << 63), (1 << 63) - 1),
           UINT32: (0, (1 << 32) - 1),
           UINT64: (0, (1 << 64) - 1),
           ENUM: (-(1 << 31), (1 << 31) - 1)}
_DEFAULTS = {INT32: 0, INT64: 0, UINT32: 0, UINT64: 0, BOOL: False,
             ENUM: 0, DOUBLE: 0.0, FLOAT: 0.0, STRING: "", BYTES: b""}


class DecodeError(ValueError):
    """Bytes that are not a valid encoding of the message."""


class EncodeError(ValueError):
    """A message that cannot be serialized (a proto2 required field is
    missing)."""


class EnumType:
    """An enum of a ``.proto`` file: its values by name and by number.
    :class:`FileDescriptor` sets ``full_name``."""

    def __init__(self, name: str, values: Sequence[Tuple[str, int]]):
        self.name = name
        self.full_name = name
        self.values = tuple(values)
        self.values_by_name = dict(self.values)
        self.values_by_number = {}
        for vname, number in self.values:
            self.values_by_number.setdefault(number, vname)

    def Name(self, number: int) -> str:
        return self.values_by_number[number]


def _wire_type(kind: str) -> int:
    if kind in _VARINT_KINDS:
        return _WT_VARINT
    return _WIRE.get(kind, _WT_LEN)


def _varint_bytes(v: int) -> bytes:
    out = bytearray()
    _put_varint(out, v)
    return bytes(out)


class Field:
    __slots__ = ("number", "name", "kind", "repeated", "message_class",
                 "enum_type", "oneof", "optional", "required", "default",
                 "key_kind", "is_map", "json_name", "has_presence",
                 "packed", "wire", "tag", "len_tag", "_entry")

    def __init__(self, number: int, name: str, kind: str,
                 repeated: bool = False, message_class=None, *,
                 enum_type: Optional[EnumType] = None,
                 oneof: Optional[str] = None, optional: bool = False,
                 required: bool = False, default=None,
                 map_key: Optional[str] = None):
        if kind == MESSAGE and message_class is None:
            raise ValueError(f"field {name!r}: a message field needs a class")
        if kind == ENUM and enum_type is None:
            raise ValueError(f"field {name!r}: an enum field needs its type")
        if map_key is not None and (repeated or oneof or optional):
            raise ValueError(f"field {name!r}: a map is neither repeated, "
                             f"a oneof member nor optional")
        self.number = number
        self.name = name
        self.kind = kind
        self.repeated = repeated or map_key is not None
        self.message_class = message_class
        self.enum_type = enum_type
        self.oneof = oneof
        self.optional = optional
        self.required = required
        self.default = _DEFAULTS.get(kind) if default is None else default
        self.key_kind = map_key
        self.is_map = map_key is not None
        # the key bytes of one value of this kind, and of a
        # length-delimited record (a message, an entry, a packed run)
        self.wire = _wire_type(kind)
        self.tag = _varint_bytes(number << 3 | self.wire)
        self.len_tag = _varint_bytes(number << 3 | _WT_LEN)
        # protobuf's ToJsonName: drop each '_', upper-case what follows
        parts = name.split("_")
        self.json_name = parts[0] + "".join(p[:1].upper() + p[1:]
                                            for p in parts[1:])
        # set by the message class: proto2 singular scalars have presence
        self.has_presence = oneof is not None or optional or required
        self.packed = True
        self._entry = None


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
    if kind in (INT32, ENUM):
        return _signed(v, 32)
    if kind == INT64:
        return _signed(v, 64)
    if kind == UINT32:
        return v & 0xFFFFFFFF
    if kind == UINT64:
        return v
    return v != 0


def _f32(v: float) -> float:
    return struct.unpack("<f", struct.pack("<f", v))[0]


def _check_scalar(f: Field, value, kind: Optional[str] = None):
    """Coerce and range-check one scalar as protobuf's setters do."""
    kind = kind or f.kind
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
    if kind in (DOUBLE, FLOAT):
        if isinstance(value, (str, bytes)) or value is None:
            raise TypeError(f"{f.name}: expected float, got "
                            f"{type(value).__name__}")
        v = float(value)
        return _f32(v) if kind == FLOAT else v
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


def _put_scalar(out: bytearray, kind: str, v) -> None:
    """One scalar's value bytes, no key."""
    if kind == DOUBLE:
        out += struct.pack("<d", v)
    elif kind == FLOAT:
        out += struct.pack("<f", v)
    elif kind in (STRING, BYTES):
        raw = v.encode("utf-8") if kind == STRING else v
        _put_varint(out, len(raw))
        out += raw
    elif kind == UINT32:
        _put_varint(out, v & 0xFFFFFFFF)
    else:
        _put_varint(out, int(v))


def _get_scalar(data, pos: int, end: int, kind: str, name: str):
    """One scalar's value at ``pos`` (its key already read)."""
    if kind in _VARINT_KINDS:
        v, pos = _get_varint(data, pos)
        return _from_varint(kind, v), pos
    if kind in _WIRE:
        width = 8 if kind == DOUBLE else 4
        if pos + width > end:
            raise DecodeError(f"field {name}: truncated")
        (v,) = struct.unpack_from("<d" if kind == DOUBLE else "<f",
                                  bytes(data[pos:pos + width]))
        return v, pos + width
    n, pos = _get_varint(data, pos)
    stop = pos + n
    if stop > end:
        raise DecodeError(f"field {name}: truncated")
    raw = bytes(data[pos:stop])
    if kind == STRING:
        try:
            return raw.decode("utf-8"), stop
        except UnicodeDecodeError as e:
            raise DecodeError(f"field {name}: {e}") from None
    return raw, stop


# --------------------------------------------------------------- containers
class _RepeatedMessages(list):
    """A repeated message field: ``add(**fields)`` appends a new element."""

    __slots__ = ("_owner", "_cls")

    def __init__(self, owner: "Message", cls):
        super().__init__()
        self._owner = owner
        self._cls = cls

    def add(self, **kwargs) -> "Message":
        msg = self._cls(**kwargs)
        super().append(msg)
        self._owner._touch()
        return msg

    def append(self, msg) -> None:
        self.add().CopyFrom(msg)

    def extend(self, msgs) -> None:
        for m in msgs:
            self.append(m)


class _Map(dict):
    """A map field. Scalar values are checked on assignment; a message
    value is created on first access, as protobuf's message maps do."""

    __slots__ = ("_owner", "_field")

    def __init__(self, owner: "Message", field: Field):
        super().__init__()
        self._owner = owner
        self._field = field

    def __setitem__(self, key, value):
        f = self._field
        if f.kind == MESSAGE:
            raise ValueError(f"{f.name}: assign to a message map's fields, "
                             f"not to its entries")
        super().__setitem__(_check_scalar(f, key, f.key_kind),
                            _check_scalar(f, value))
        self._owner._touch()

    def __getitem__(self, key):
        f = self._field
        key = _check_scalar(f, key, f.key_kind)
        if key not in self:
            if f.kind != MESSAGE:
                return f.default
            super().__setitem__(key, f.message_class())
            self._owner._touch()
        return super().__getitem__(key)

    def update(self, other=(), **kw):
        for k, v in dict(other, **kw).items():
            if self._field.kind == MESSAGE:
                self[k].CopyFrom(v)
            else:
                self[k] = v


# ------------------------------------------------------------------ message
class Message:
    """Base of every table-built message. Subclasses set ``FIELDS``;
    ``SYNTAX = "proto2"`` gives every singular scalar presence and writes
    repeated scalars unpacked. Nested enums are class attributes listed in
    ``ENUMS``, with their values as class constants."""

    FIELDS: Tuple[Field, ...] = ()
    SYNTAX = "proto3"
    ENUMS: Tuple[EnumType, ...] = ()
    NESTED: Tuple[type, ...] = ()  # nested message types (not map entries)
    DESCRIPTOR: "Descriptor" = None
    # class-level tables, built by __init_subclass__
    _by_name: Dict[str, Field] = {}
    _by_number: Dict[int, Field] = {}
    _ordered: Tuple[Field, ...] = ()
    _oneofs: Dict[str, Tuple[str, ...]] = {}
    _required: Tuple[str, ...] = ()

    __slots__ = ("_values", "_present", "_parent")

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls._build_tables()

    @classmethod
    def _build_tables(cls) -> None:
        """The class's lookup tables from ``FIELDS``; run again after
        ``FIELDS`` is set on a class made before the classes its fields
        name (a message that holds itself, or one read from a descriptor
        set)."""
        cls._ordered = tuple(sorted(cls.FIELDS, key=lambda f: f.number))
        cls._by_name = {f.name: f for f in cls._ordered}
        cls._by_number = {f.number: f for f in cls._ordered}
        if len(cls._by_name) != len(cls.FIELDS) or \
                len(cls._by_number) != len(cls.FIELDS):
            raise ValueError(f"{cls.__name__}: duplicate field name or "
                             f"number")
        oneofs: Dict[str, List[str]] = {}
        for f in cls.FIELDS:
            if f.oneof is not None:
                oneofs.setdefault(f.oneof, []).append(f.name)
            if cls.SYNTAX == "proto2":
                f.packed = False
                if not f.repeated and f.kind != MESSAGE:
                    f.has_presence = True
            if f.is_map:
                f._entry = _map_entry(f)
        cls._oneofs = {k: tuple(v) for k, v in oneofs.items()}
        cls._required = tuple(f.name for f in cls.FIELDS if f.required)

    def __init__(self, **kwargs):
        object.__setattr__(self, "_values", {})
        object.__setattr__(self, "_present", set())
        object.__setattr__(self, "_parent", None)
        for name, value in kwargs.items():
            f = self._by_name.get(name)
            if f is None:
                raise ValueError(f"{type(self).__name__} has no field "
                                 f"{name!r}")
            if f.is_map:
                getattr(self, name).update(value)
            elif f.kind == MESSAGE and f.repeated:
                getattr(self, name).extend(value)
            elif f.kind == MESSAGE:
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
        if f.is_map:
            v = values[name] = _Map(self, f)
        elif f.repeated and f.kind == MESSAGE:
            v = values[name] = _RepeatedMessages(self, f.message_class)
        elif f.repeated:
            v = values[name] = []
        elif f.kind == MESSAGE:
            # unset: an empty child that marks this field present the
            # first time one of its own fields is assigned
            v = values[name] = f.message_class()
            object.__setattr__(v, "_parent", (self, name))
        else:
            v = f.default
        return v

    def __setattr__(self, name, value):
        f = type(self)._by_name.get(name)
        if f is None:
            raise AttributeError(f"{type(self).__name__} has no field "
                                 f"{name!r}")
        if f.kind == MESSAGE or f.is_map:
            raise AttributeError(f"assignment to {f.kind} field {name!r}: "
                                 f"set its fields or use CopyFrom")
        if f.repeated:
            self._values[name] = [_check_scalar(f, v) for v in value]
        else:
            self._values[name] = _check_scalar(f, value)
            if f.has_presence:
                self._set_present(f)
        self._touch()

    def _set_present(self, f: Field) -> None:
        if f.oneof is not None:
            for other in self._oneofs[f.oneof]:
                if other != f.name:
                    self._values.pop(other, None)
                    self._present.discard(other)
        self._present.add(f.name)

    def _touch(self) -> None:
        parent = self._parent
        if parent is not None:
            parent[0]._mark(parent[1])

    def _mark(self, name: str) -> None:
        if name not in self._present:
            self._set_present(self._by_name[name])
            self._touch()

    def HasField(self, name: str) -> bool:
        if name in self._oneofs:
            return self.WhichOneof(name) is not None
        f = type(self)._by_name.get(name)
        if f is None or f.repeated or not (f.kind == MESSAGE
                                           or f.has_presence):
            raise ValueError(f"{type(self).__name__}: field {name!r} has "
                             f"no presence")
        return name in self._present

    def WhichOneof(self, oneof: str) -> Optional[str]:
        members = self._oneofs.get(oneof)
        if members is None:
            raise ValueError(f"{type(self).__name__} has no oneof "
                             f"{oneof!r}")
        return next((m for m in members if m in self._present), None)

    def SetInParent(self) -> None:
        """Mark this (empty) sub-message present in its parent."""
        self._touch()

    def Clear(self) -> None:
        self._values.clear()
        self._present.clear()

    def _missing(self) -> List[str]:
        return [n for n in self._required if n not in self._present]

    # --------------------------------------------------------------- copies
    def MergeFrom(self, other: "Message") -> None:
        if type(other) is not type(self):
            raise TypeError(f"MergeFrom: {type(other).__name__} is not "
                            f"{type(self).__name__}")
        for f in self._ordered:
            name = f.name
            vals = other._values.get(name)
            if f.is_map:
                if vals:
                    getattr(self, name).update(vals)
            elif f.repeated:
                if vals:
                    getattr(self, name).extend(vals)
                    self._touch()
            elif f.kind == MESSAGE:
                if name in other._present:
                    getattr(self, name).MergeFrom(vals)
                    self._mark(name)
            elif f.has_presence:
                if name in other._present:
                    setattr(self, name, vals if vals is not None
                            else f.default)
            elif vals is not None and vals != f.default:
                self._values[name] = vals
                self._touch()

    def CopyFrom(self, other: "Message") -> None:
        if other is self:
            return
        self.Clear()
        self.MergeFrom(other)

    # ----------------------------------------------------------------- wire
    def _encode(self, out: bytearray) -> None:
        if self._required:
            missing = self._missing()
            if missing:
                raise EncodeError(f"Message {self.DESCRIPTOR.full_name} is "
                                  f"missing required fields: "
                                  f"{','.join(missing)}")
        values = self._values
        present = self._present
        for f in self._ordered:
            v = values.get(f.name)
            if v is None:
                continue  # never set: nothing to write
            kind = f.kind
            if f.repeated:
                if not v:
                    continue
                if f.is_map:
                    for key, value in sorted(v.items()):
                        entry = bytearray()
                        _put_varint(entry, 1 << 3 | _wire_type(f.key_kind))
                        _put_scalar(entry, f.key_kind, key)
                        if kind == MESSAGE:
                            _put_bytes(entry, 2, value.SerializeToString())
                        else:
                            _put_varint(entry, 2 << 3 | f.wire)
                            _put_scalar(entry, kind, value)
                        out += f.len_tag
                        _put_varint(out, len(entry))
                        out += entry
                elif kind == MESSAGE:
                    for m in v:
                        body = m.SerializeToString()
                        out += f.len_tag
                        _put_varint(out, len(body))
                        out += body
                elif f.packed and kind not in (STRING, BYTES):
                    packed = bytearray()
                    for x in v:
                        _put_scalar(packed, kind, x)
                    out += f.len_tag
                    _put_varint(out, len(packed))
                    out += packed
                else:
                    for x in v:
                        out += f.tag
                        _put_scalar(out, kind, x)
                continue
            if kind == MESSAGE:
                if f.name in present:
                    body = v.SerializeToString()
                    out += f.len_tag
                    _put_varint(out, len(body))
                    out += body
                continue
            if not v:
                # a default scalar is written only with presence (and
                # proto3 writes -0.0)
                if f.has_presence:
                    if f.name not in present:
                        continue
                elif kind not in _WIRE or math.copysign(1.0, v) > 0:
                    continue
            out += f.tag
            _put_scalar(out, kind, v)

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
            if f is None or not (wt == f.wire and not f.is_map
                                 or wt == _WT_LEN and (f.repeated
                                                       or f.kind == MESSAGE)):
                # unknown field, or a known number with a wire type its
                # kind never has: protobuf keeps both as unknown fields
                pos = _skip(data, pos, wt)
                if pos > end:
                    raise DecodeError("truncated field")
                continue
            if f.kind == MESSAGE or f.is_map:
                n, pos = _get_varint(data, pos)
                stop = pos + n
                if stop > end:
                    raise DecodeError(f"field {f.name}: truncated")
                if f.is_map:
                    entry = f._entry()
                    entry._merge_bytes(data, pos, stop)
                    target = getattr(self, f.name)
                    if f.kind == MESSAGE:
                        target[entry.key].CopyFrom(entry.value)
                    else:
                        target[entry.key] = entry.value
                elif f.repeated:
                    getattr(self, f.name).add()._merge_bytes(data, pos, stop)
                else:
                    getattr(self, f.name)._merge_bytes(data, pos, stop)
                    self._set_present(f)
                pos = stop
            elif f.repeated and wt == _WT_LEN and f.kind not in (STRING,
                                                                 BYTES):
                n, pos = _get_varint(data, pos)
                stop = pos + n
                if stop > end:
                    raise DecodeError("truncated packed field")
                lst = getattr(self, f.name)
                while pos < stop:
                    v, pos = _get_scalar(data, pos, stop, f.kind, f.name)
                    lst.append(v)
                if pos != stop:
                    raise DecodeError("packed field overruns its length")
            else:
                v, pos = _get_scalar(data, pos, end, f.kind, f.name)
                if f.repeated:
                    getattr(self, f.name).append(v)
                else:
                    values[f.name] = v
                    if f.has_presence:
                        self._set_present(f)
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
            v = self._values.get(name)
            if f.is_map:
                items = sorted((v or {}).items())
                out.append(tuple(
                    (k, x._fields_tuple() if f.kind == MESSAGE else x)
                    for k, x in items))
            elif f.repeated and f.kind == MESSAGE:
                out.append(tuple(m._fields_tuple() for m in v or ()))
            elif f.kind == MESSAGE:
                out.append(v._fields_tuple()
                           if name in self._present else None)
            elif f.repeated:
                out.append(tuple(v or ()))
            elif f.has_presence:
                out.append((name in self._present,
                            f.default if v is None else v))
            else:
                out.append(f.default if v is None else v)
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
            if f.kind == MESSAGE and not f.repeated:
                if name in self._present:
                    parts.append(f"{name}={self._values[name]!r}")
            else:
                v = self._values.get(name)
                if v or name in self._present:
                    parts.append(f"{name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"


def _map_entry(f: Field) -> type:
    """The entry message of a map field, ``<Name>Entry`` (key 1, value
    2), as protoc nests it."""
    name = "".join(p[:1].upper() + p[1:] for p in f.name.split("_"))
    value = Field(2, "value", f.kind, message_class=f.message_class,
                  enum_type=f.enum_type)
    return type(f"{name}Entry", (Message,), {
        "FIELDS": (Field(1, "key", f.key_kind), value),
        "__slots__": ()})


# --------------------------------------------------------------- descriptors
class Descriptor:
    """A message type: its names and its concrete class."""

    def __init__(self, cls, prefix: str):
        self.name = cls.__name__
        self.full_name = f"{prefix}.{cls.__name__}" if prefix \
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
    """One ``.proto`` file's tables: sets each class's DESCRIPTOR and each
    enum's full name, and builds the services; ``services`` maps a
    service name to its ``(method, request class, response class)`` list.
    ``serialized_pb`` is the ``FileDescriptorProto`` protoc writes for
    such a file (no json names), encoded from the tables: messages, enums
    and services in the order given, fields in ``FIELDS`` order, each
    map's entry type and each message's enums nested in it."""

    def __init__(self, name: str, package: str,
                 messages: Iterable[type],
                 services: Optional[Dict[str, Sequence[Tuple[str, type,
                                                             type]]]] = None,
                 enums: Sequence[EnumType] = (), syntax: str = "proto3"):
        self.name = name
        self.package = package
        self.syntax = syntax
        self.message_types_by_name = {}
        self.enum_types_by_name = {}
        for enum in enums:
            enum.full_name = f"{package}.{enum.name}" if package \
                else enum.name
            self.enum_types_by_name[enum.name] = enum
        for cls in messages:
            self.message_types_by_name[cls.__name__] = _describe(cls,
                                                                 package)
        self.services_by_name = {
            sname: ServiceDescriptor(sname, package, methods)
            for sname, methods in (services or {}).items()}
        self.serialized_pb = self._file_proto()

    def _file_proto(self) -> bytes:
        # descriptor.proto: FileDescriptorProto name 1, package 2,
        # message_type 4, enum_type 5, service 6, syntax 12 (proto3 only)
        out = bytearray()
        _put_text(out, 1, self.name)
        if self.package:
            _put_text(out, 2, self.package)
        for desc in self.message_types_by_name.values():
            _put_bytes(out, 4, _message_proto(desc._concrete_class))
        for enum in self.enum_types_by_name.values():
            _put_bytes(out, 5, _enum_proto(enum))
        for svc in self.services_by_name.values():
            # ServiceDescriptorProto name 1, method 2; MethodDescriptorProto
            # name 1, input_type 2, output_type 3
            sb = bytearray()
            _put_text(sb, 1, svc.name)
            for m in svc.methods:
                mb = bytearray()
                _put_text(mb, 1, m.name)
                _put_text(mb, 2, "." + m.input_type.full_name)
                _put_text(mb, 3, "." + m.output_type.full_name)
                _put_bytes(sb, 2, mb)
            _put_bytes(out, 6, sb)
        if self.syntax == "proto3":
            _put_text(out, 12, "proto3")
        return bytes(out)


def _describe(cls, prefix: str) -> Descriptor:
    """Set the DESCRIPTOR of ``cls``, of its map entries and nested types,
    and the full names of its enums."""
    cls.DESCRIPTOR = Descriptor(cls, prefix)
    full = cls.DESCRIPTOR.full_name
    for enum in cls.ENUMS:
        enum.full_name = f"{full}.{enum.name}"
    for f in cls.FIELDS:
        if f.is_map:
            f._entry.DESCRIPTOR = Descriptor(f._entry, full)
    for nested in cls.NESTED:
        _describe(nested, full)
    return cls.DESCRIPTOR


# FieldDescriptorProto's Label and Type values (descriptor.proto)
_LABEL_OPTIONAL, _LABEL_REQUIRED, _LABEL_REPEATED = 1, 2, 3
_TYPE_CODES = {DOUBLE: 1, FLOAT: 2, INT64: 3, UINT64: 4, INT32: 5, BOOL: 8,
               STRING: 9, MESSAGE: 11, BYTES: 12, UINT32: 13, ENUM: 14}


def _message_proto(cls) -> bytearray:
    # DescriptorProto name 1, field 2, nested_type 3, enum_type 4,
    # options 7 (MessageOptions map_entry 7), oneof_decl 8 (name 1);
    # FieldDescriptorProto name 1, number 3, label 4, type 5, type_name 6,
    # default_value 7, oneof_index 9, proto3_optional 17
    msg = bytearray()
    _put_text(msg, 1, cls.__name__)
    full = cls.DESCRIPTOR.full_name
    # a proto3 ``optional`` field sits in a synthetic oneof named
    # _<field>, declared after the real ones
    decls = list(cls._oneofs) + [f"_{f.name}" for f in cls.FIELDS
                                 if f.optional]
    for f in cls.FIELDS:
        field = bytearray()
        _put_text(field, 1, f.name)
        _put_number(field, 3, f.number)
        _put_number(field, 4, _LABEL_REPEATED if f.repeated
                    else _LABEL_REQUIRED if f.required else _LABEL_OPTIONAL)
        if f.is_map:
            _put_number(field, 5, _TYPE_CODES[MESSAGE])
            _put_text(field, 6, f".{full}.{f._entry.__name__}")
        else:
            _put_number(field, 5, _TYPE_CODES[f.kind])
            if f.kind == MESSAGE:
                _put_text(field, 6,
                          "." + f.message_class.DESCRIPTOR.full_name)
            elif f.kind == ENUM:
                _put_text(field, 6, "." + f.enum_type.full_name)
        if cls.SYNTAX == "proto2" and f.default != _DEFAULTS.get(f.kind):
            _put_text(field, 7, str(f.default))
        if f.oneof is not None or f.optional:
            _put_number(field, 9, decls.index(f.oneof if f.oneof is not None
                                              else f"_{f.name}"))
        if f.optional:
            _put_number(field, 17, 1)
        _put_bytes(msg, 2, field)
    for f in cls.FIELDS:
        if f.is_map:
            entry = _message_proto_of_entry(f._entry, full)
            _put_bytes(msg, 3, entry)
    for nested in cls.NESTED:
        _put_bytes(msg, 3, _message_proto(nested))
    for enum in cls.ENUMS:
        _put_bytes(msg, 4, _enum_proto(enum))
    for decl in decls:
        ob = bytearray()
        _put_text(ob, 1, decl)
        _put_bytes(msg, 8, ob)
    return msg


def _message_proto_of_entry(entry, parent: str) -> bytearray:
    msg = bytearray()
    _put_text(msg, 1, entry.__name__)
    for f in entry.FIELDS:
        field = bytearray()
        _put_text(field, 1, f.name)
        _put_number(field, 3, f.number)
        _put_number(field, 4, _LABEL_OPTIONAL)
        _put_number(field, 5, _TYPE_CODES[f.kind])
        if f.kind == MESSAGE:
            _put_text(field, 6, "." + f.message_class.DESCRIPTOR.full_name)
        elif f.kind == ENUM:
            _put_text(field, 6, "." + f.enum_type.full_name)
        _put_bytes(msg, 2, field)
    options = bytearray()
    _put_number(options, 7, 1)
    _put_bytes(msg, 7, options)
    return msg


def _enum_proto(enum: EnumType) -> bytearray:
    # EnumDescriptorProto name 1, value 2; EnumValueDescriptorProto
    # name 1, number 2
    eb = bytearray()
    _put_text(eb, 1, enum.name)
    for vname, number in enum.values:
        vb = bytearray()
        _put_text(vb, 1, vname)
        _put_number(vb, 2, number)
        _put_bytes(eb, 2, vb)
    return eb


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


# ----------------------------------------------------------- descriptor sets
# descriptor.proto's messages, as far as the reader below needs them (proto2,
# so every singular scalar has presence: ``oneof_index`` 0 is told from
# unset); the fields not listed (options but map_entry, json names,
# source info) are skipped when parsing
class _EnumValueProto(Message):
    SYNTAX = "proto2"
    FIELDS = (Field(1, "name", STRING), Field(2, "number", INT32))


class _EnumProto(Message):
    SYNTAX = "proto2"
    FIELDS = (Field(1, "name", STRING),
              Field(2, "value", MESSAGE, True, _EnumValueProto))


class _FieldProto(Message):
    SYNTAX = "proto2"
    FIELDS = (Field(1, "name", STRING), Field(3, "number", INT32),
              Field(4, "label", INT32), Field(5, "type", INT32),
              Field(6, "type_name", STRING),
              Field(7, "default_value", STRING),
              Field(9, "oneof_index", INT32),
              Field(17, "proto3_optional", BOOL))


class _MessageOptionsProto(Message):
    SYNTAX = "proto2"
    FIELDS = (Field(7, "map_entry", BOOL),)


class _OneofProto(Message):
    SYNTAX = "proto2"
    FIELDS = (Field(1, "name", STRING),)


class _MessageProto(Message):
    SYNTAX = "proto2"


_MessageProto.FIELDS = (
    Field(1, "name", STRING), Field(2, "field", MESSAGE, True, _FieldProto),
    Field(3, "nested_type", MESSAGE, True, _MessageProto),
    Field(4, "enum_type", MESSAGE, True, _EnumProto),
    Field(7, "options", MESSAGE, message_class=_MessageOptionsProto),
    Field(8, "oneof_decl", MESSAGE, True, _OneofProto))
_MessageProto._build_tables()


class _MethodProto(Message):
    SYNTAX = "proto2"
    FIELDS = (Field(1, "name", STRING), Field(2, "input_type", STRING),
              Field(3, "output_type", STRING))


class _ServiceProto(Message):
    SYNTAX = "proto2"
    FIELDS = (Field(1, "name", STRING),
              Field(2, "method", MESSAGE, True, _MethodProto))


class _FileProto(Message):
    SYNTAX = "proto2"
    FIELDS = (Field(1, "name", STRING), Field(2, "package", STRING),
              Field(3, "dependency", STRING, True),
              Field(4, "message_type", MESSAGE, True, _MessageProto),
              Field(5, "enum_type", MESSAGE, True, _EnumProto),
              Field(6, "service", MESSAGE, True, _ServiceProto),
              Field(12, "syntax", STRING))


class _FileSetProto(Message):
    SYNTAX = "proto2"
    FIELDS = (Field(1, "file", MESSAGE, True, _FileProto),)


_KINDS = {code: kind for kind, code in _TYPE_CODES.items()}
_UNSUPPORTED = {6: "fixed64", 7: "fixed32", 10: "group", 15: "sfixed32",
                16: "sfixed64", 17: "sint32", 18: "sint64"}


def _parse_default(kind: str, text: str, enum_type: Optional[EnumType]):
    """A proto2 ``default_value`` (descriptor.proto's text form) as the
    field's Python value."""
    if kind == STRING:
        return text
    if kind == BYTES:
        import codecs

        return codecs.escape_decode(text.encode("latin-1"))[0]
    if kind == BOOL:
        return text == "true"
    if kind in (DOUBLE, FLOAT):
        return float(text)
    if kind == ENUM:
        return enum_type.values_by_name[text]
    return int(text, 0)


class _SetReader:
    """Turns the ``FileDescriptorProto``s of one set into classes: every
    message class is made first (empty), so that fields can name any
    message of any file of the set, itself included."""

    def __init__(self, files: Sequence[_FileProto]):
        self.files = files
        self.classes: Dict[str, type] = {}     # ".pkg.Outer.Inner" -> class
        self.enums: Dict[str, EnumType] = {}
        self.protos: Dict[str, Tuple[_MessageProto, str]] = {}
        for fp in files:
            prefix = f".{fp.package}" if fp.package else ""
            syntax = fp.syntax or "proto2"
            for ep in fp.enum_type:
                self._enum(ep, prefix)
            for mp in fp.message_type:
                self._declare(mp, prefix, syntax)
        for full, (mp, syntax) in self.protos.items():
            self._fill(self.classes[full], mp, full)

    def _enum(self, ep: _EnumProto, prefix: str) -> EnumType:
        enum = EnumType(ep.name, [(v.name, v.number) for v in ep.value])
        self.enums[f"{prefix}.{ep.name}"] = enum
        return enum

    def _declare(self, mp: _MessageProto, prefix: str, syntax: str) -> type:
        full = f"{prefix}.{mp.name}"
        cls = type(mp.name, (Message,), {"SYNTAX": syntax})
        cls.ENUMS = tuple(self._enum(ep, full) for ep in mp.enum_type)
        for enum in cls.ENUMS:
            for vname, number in enum.values:
                setattr(cls, vname, number)
        nested = [self._declare(np_, full, syntax) for np_ in mp.nested_type]
        cls.NESTED = tuple(c for c, np_ in zip(nested, mp.nested_type)
                           if not np_.options.map_entry)
        for c in cls.NESTED:
            setattr(cls, c.__name__, c)  # Outer.Inner, as protobuf names it
        self.classes[full] = cls
        self.protos[full] = (mp, syntax)
        return cls

    def _fill(self, cls: type, mp: _MessageProto, full: str) -> None:
        if mp.options.map_entry:
            return  # an entry is a map field's, made by the runtime
        fields = []
        for fp in mp.field:
            code = fp.type
            if code in _UNSUPPORTED:
                raise NotImplementedError(
                    f"{full[1:]}.{fp.name}: the message runtime has no "
                    f"{_UNSUPPORTED[code]} fields")
            kind = _KINDS[code]
            kw: Dict[str, object] = {}
            if kind == MESSAGE:
                target = self.protos.get(fp.type_name)
                if target is not None and target[0].options.map_entry:
                    key, value = target[0].field[0], target[0].field[1]
                    fields.append(self._map_field(fp, key, value))
                    continue
                kw["message_class"] = self.classes[fp.type_name]
            elif kind == ENUM:
                kw["enum_type"] = self.enums[fp.type_name]
            if fp.proto3_optional:
                kw["optional"] = True
            elif fp.HasField("oneof_index"):
                kw["oneof"] = mp.oneof_decl[fp.oneof_index].name
            if fp.label == _LABEL_REQUIRED:
                kw["required"] = True
            if fp.HasField("default_value"):
                kw["default"] = _parse_default(kind, fp.default_value,
                                               kw.get("enum_type"))
            fields.append(Field(fp.number, fp.name, kind,
                                fp.label == _LABEL_REPEATED, **kw))
        cls.FIELDS = tuple(fields)
        cls._build_tables()

    def _map_field(self, fp: _FieldProto, key: _FieldProto,
                   value: _FieldProto) -> Field:
        kind = _KINDS[value.type]
        kw: Dict[str, object] = {}
        if kind == MESSAGE:
            kw["message_class"] = self.classes[value.type_name]
        elif kind == ENUM:
            kw["enum_type"] = self.enums[value.type_name]
        return Field(fp.number, fp.name, kind, map_key=_KINDS[key.type],
                     **kw)

    def file_descriptors(self) -> List[FileDescriptor]:
        out = []
        for fp in self.files:
            prefix = f".{fp.package}" if fp.package else ""
            messages = [self.classes[f"{prefix}.{mp.name}"]
                        for mp in fp.message_type]
            enums = [self.enums[f"{prefix}.{ep.name}"] for ep in fp.enum_type]
            services = {sp.name: [(m.name, self.classes[m.input_type],
                                   self.classes[m.output_type])
                                  for m in sp.method]
                        for sp in fp.service}
            out.append(FileDescriptor(fp.name, fp.package, messages,
                                      services, enums,
                                      syntax=fp.syntax or "proto2"))
        return out


def read_descriptor_set(data) -> List[FileDescriptor]:
    """The files of a ``FileDescriptorSet`` (``protoc
    --descriptor_set_out``, ``--include_imports`` when a file imports
    another) as :class:`FileDescriptor` objects over new message classes:
    messages and nested messages, enums, maps, oneofs, proto3
    ``optional``, proto2 presence, defaults and ``required``, packages. A
    type a field names must be in the set. The inverse of
    ``FileDescriptor.serialized_pb`` for the files this runtime writes."""
    return _SetReader(list(_FileSetProto.FromString(data).file)) \
        .file_descriptors()


def find_method(files: Iterable[FileDescriptor],
                full_method: str) -> MethodDescriptor:
    """``pkg.Service.Method`` among ``files``' services."""
    svc_full, _, name = full_method.rpartition(".")
    for fd in files:
        for svc in fd.services_by_name.values():
            if svc.full_name == svc_full and name in svc.methods_by_name:
                return svc.methods_by_name[name]
    raise KeyError(f"no method {full_method} in the descriptor set")
