"""bson — minimal BSON codec for the mongo wire protocol.

Counterpart of the reference's vendored bson slice under
``policy/mongo_protocol.cpp`` usage. Covers the types mongo commands and
replies actually use; everything is plain Python values:

  float <-> double (0x01)        str <-> string (0x02)
  dict <-> document (0x03)       list <-> array (0x04)
  bytes <-> binary/generic(0x05) ObjectId <-> ObjectId (0x07)
  bool <-> boolean (0x08)        datetime <-> UTC datetime (0x09)
  None <-> null (0x0A)           int <-> int32/int64 (0x10/0x12)

Unknown element types raise BsonError on decode (a malformed reply must
not be silently mis-read).

The port's copy of the JAX package's ``policy/bson.py``: the same bytes for
the same values.
"""

from __future__ import annotations

import datetime as _dt
import os
import struct
import threading
import time


class BsonError(ValueError):
    pass


class ObjectId:
    """12-byte mongo object id (4B time + 5B random + 3B counter)."""

    _counter = int.from_bytes(os.urandom(3), "big")
    _rand = os.urandom(5)
    _lock = threading.Lock()

    __slots__ = ("binary",)

    def __init__(self, binary: bytes = b""):
        if binary:
            if len(binary) != 12:
                raise BsonError("ObjectId needs 12 bytes")
            self.binary = bytes(binary)
        else:
            with ObjectId._lock:
                ObjectId._counter = (ObjectId._counter + 1) & 0xFFFFFF
                cnt = ObjectId._counter
            self.binary = (struct.pack(">I", int(time.time()))
                           + ObjectId._rand + cnt.to_bytes(3, "big"))

    def __repr__(self):
        return f"ObjectId({self.binary.hex()})"

    def __eq__(self, other):
        return isinstance(other, ObjectId) and other.binary == self.binary

    def __hash__(self):
        return hash(self.binary)


_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)


def _encode_value(key: str, value, out: bytearray) -> None:
    kb = key.encode("utf-8") + b"\x00"
    if isinstance(value, bool):  # before int (bool is an int subclass)
        out += b"\x08" + kb + (b"\x01" if value else b"\x00")
    elif isinstance(value, float):
        out += b"\x01" + kb + struct.pack("<d", value)
    elif isinstance(value, int):
        if -(1 << 31) <= value < (1 << 31):
            out += b"\x10" + kb + struct.pack("<i", value)
        elif -(1 << 63) <= value < (1 << 63):
            out += b"\x12" + kb + struct.pack("<q", value)
        else:
            raise BsonError(f"int out of int64 range: {value}")
    elif isinstance(value, str):
        vb = value.encode("utf-8") + b"\x00"
        out += b"\x02" + kb + struct.pack("<i", len(vb)) + vb
    elif isinstance(value, dict):
        out += b"\x03" + kb + encode(value)
    elif isinstance(value, (list, tuple)):
        out += b"\x04" + kb + encode(
            {str(i): v for i, v in enumerate(value)})
    elif isinstance(value, (bytes, bytearray, memoryview)):
        vb = bytes(value)
        out += b"\x05" + kb + struct.pack("<i", len(vb)) + b"\x00" + vb
    elif isinstance(value, ObjectId):
        out += b"\x07" + kb + value.binary
    elif isinstance(value, _dt.datetime):
        if value.tzinfo is None:  # the common naive idiom means UTC
            value = value.replace(tzinfo=_dt.timezone.utc)
        ms = int((value - _EPOCH).total_seconds() * 1000)
        out += b"\x09" + kb + struct.pack("<q", ms)
    elif value is None:
        out += b"\x0a" + kb
    else:
        raise BsonError(f"cannot BSON-encode {type(value).__name__}")


def encode(doc: dict) -> bytes:
    out = bytearray()
    for key, value in doc.items():
        _encode_value(str(key), value, out)
    return struct.pack("<i", len(out) + 5) + bytes(out) + b"\x00"


def _decode_cstring(data: bytes, pos: int) -> tuple:
    end = data.find(b"\x00", pos)
    if end < 0:
        raise BsonError("unterminated cstring")
    try:
        return data[pos:end].decode("utf-8"), end + 1
    except UnicodeDecodeError as e:
        raise BsonError(f"invalid utf-8 in key: {e}") from None


def _decode_value(etype: int, data: bytes, pos: int,
                  depth: int = 0) -> tuple:
    if etype == 0x01:
        if pos + 8 > len(data):
            raise BsonError("truncated double")
        return struct.unpack_from("<d", data, pos)[0], pos + 8
    if etype == 0x02:
        if pos + 4 > len(data):
            raise BsonError("truncated string length")
        (n,) = struct.unpack_from("<i", data, pos)
        pos += 4
        if n < 1 or pos + n > len(data):
            raise BsonError("bad string length")
        try:
            return data[pos:pos + n - 1].decode("utf-8"), pos + n
        except UnicodeDecodeError as e:
            raise BsonError(f"invalid utf-8 in string: {e}") from None
    if etype in (0x03, 0x04):
        doc, pos = _decode_doc(data, pos, depth + 1)
        if etype == 0x04:
            try:
                keys = sorted(doc, key=int)
            except ValueError:
                raise BsonError("array with non-numeric index keys") \
                    from None
            return [doc[k] for k in keys], pos
        return doc, pos
    if etype == 0x05:
        if pos + 5 > len(data):
            raise BsonError("truncated binary")
        (n,) = struct.unpack_from("<i", data, pos)
        pos += 5  # length + subtype byte
        if n < 0 or pos + n > len(data):
            raise BsonError("bad binary length")
        return bytes(data[pos:pos + n]), pos + n
    if etype == 0x07:
        if pos + 12 > len(data):
            raise BsonError("truncated ObjectId")
        return ObjectId(data[pos:pos + 12]), pos + 12
    if etype == 0x08:
        if pos >= len(data):
            raise BsonError("truncated bool")
        return data[pos] != 0, pos + 1
    if etype == 0x09:
        if pos + 8 > len(data):
            raise BsonError("truncated datetime")
        (ms,) = struct.unpack_from("<q", data, pos)
        try:
            return _EPOCH + _dt.timedelta(milliseconds=ms), pos + 8
        except (OverflowError, OSError):
            raise BsonError("datetime out of range") from None
    if etype == 0x0A:
        return None, pos
    if etype == 0x10:
        if pos + 4 > len(data):
            raise BsonError("truncated int32")
        return struct.unpack_from("<i", data, pos)[0], pos + 4
    if etype == 0x12:
        if pos + 8 > len(data):
            raise BsonError("truncated int64")
        return struct.unpack_from("<q", data, pos)[0], pos + 8
    raise BsonError(f"unsupported BSON type 0x{etype:02x}")


MAX_DEPTH = 100  # mongo's own nesting limit


def _decode_doc(data: bytes, pos: int, depth: int = 0) -> tuple:
    if depth > MAX_DEPTH:
        raise BsonError("document nesting exceeds limit")
    if pos + 4 > len(data):
        raise BsonError("truncated document length")
    (total,) = struct.unpack_from("<i", data, pos)
    if total < 5 or pos + total > len(data):
        raise BsonError("bad document length")
    end = pos + total
    if data[end - 1] != 0:
        raise BsonError("document missing terminator")
    pos += 4
    doc = {}
    while pos < end - 1:
        etype = data[pos]
        pos += 1
        key, pos = _decode_cstring(data, pos)
        value, pos = _decode_value(etype, data, pos, depth)
        doc[key] = value
    if pos != end - 1:
        raise BsonError("document element overrun")
    return doc, end


def decode(data: bytes, pos: int = 0) -> dict:
    doc, end = _decode_doc(bytes(data), pos)
    return doc
