"""amf0 — Action Message Format 0 codec (the RTMP command/data encoding).

Counterpart of the reference's ``policy/amf.cpp`` (AMF0 subset used by the
RTMP control plane). Python mapping:

  float/int <-> Number (0x00)     bool <-> Boolean (0x01)
  str <-> String/LongString       dict <-> Object (0x03) / ECMA (0x08)
  None <-> Null (0x05)            Undefined (0x06) -> None
  list <-> Strict Array (0x0A)

Decode raises Amf0Error on malformed bytes (fuzz-facing contract).

The port's copy of the JAX package's ``policy/amf0.py``: the same bytes for
the same values.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple


class Amf0Error(ValueError):
    pass


T_NUMBER = 0x00
T_BOOL = 0x01
T_STRING = 0x02
T_OBJECT = 0x03
T_NULL = 0x05
T_UNDEFINED = 0x06
T_ECMA = 0x08
T_OBJECT_END = 0x09
T_STRICT_ARRAY = 0x0A
T_LONG_STRING = 0x0C


def _enc_str_body(s: str) -> bytes:
    b = s.encode("utf-8")
    if len(b) > 0xFFFF:
        return struct.pack(">BI", T_LONG_STRING, len(b)) + b
    return struct.pack(">BH", T_STRING, len(b)) + b


def encode_value(v: Any) -> bytes:
    if isinstance(v, bool):
        return struct.pack(">BB", T_BOOL, 1 if v else 0)
    if isinstance(v, (int, float)):
        return struct.pack(">Bd", T_NUMBER, float(v))
    if isinstance(v, str):
        return _enc_str_body(v)
    if v is None:
        return bytes([T_NULL])
    if isinstance(v, dict):
        out = bytes([T_OBJECT])
        for k, val in v.items():
            kb = str(k).encode("utf-8")
            out += struct.pack(">H", len(kb)) + kb + encode_value(val)
        return out + b"\x00\x00" + bytes([T_OBJECT_END])
    if isinstance(v, (list, tuple)):
        out = struct.pack(">BI", T_STRICT_ARRAY, len(v))
        for item in v:
            out += encode_value(item)
        return out
    raise Amf0Error(f"cannot AMF0-encode {type(v).__name__}")


def encode(*values: Any) -> bytes:
    return b"".join(encode_value(v) for v in values)


def _need(data: bytes, pos: int, n: int) -> None:
    if pos + n > len(data):
        raise Amf0Error("truncated AMF0 value")


def _dec_key(data: bytes, pos: int) -> Tuple[str, int]:
    _need(data, pos, 2)
    (n,) = struct.unpack_from(">H", data, pos)
    pos += 2
    _need(data, pos, n)
    try:
        return data[pos:pos + n].decode("utf-8"), pos + n
    except UnicodeDecodeError as e:
        raise Amf0Error(f"bad utf-8 key: {e}") from None


def decode_value(data: bytes, pos: int, depth: int = 0) -> Tuple[Any, int]:
    if depth > 32:
        raise Amf0Error("AMF0 nesting too deep")
    _need(data, pos, 1)
    t = data[pos]
    pos += 1
    if t == T_NUMBER:
        _need(data, pos, 8)
        return struct.unpack_from(">d", data, pos)[0], pos + 8
    if t == T_BOOL:
        _need(data, pos, 1)
        return data[pos] != 0, pos + 1
    if t == T_STRING:
        _need(data, pos, 2)
        (n,) = struct.unpack_from(">H", data, pos)
        pos += 2
        _need(data, pos, n)
        try:
            return data[pos:pos + n].decode("utf-8"), pos + n
        except UnicodeDecodeError as e:
            raise Amf0Error(f"bad utf-8 string: {e}") from None
    if t == T_LONG_STRING:
        _need(data, pos, 4)
        (n,) = struct.unpack_from(">I", data, pos)
        pos += 4
        _need(data, pos, n)
        try:
            return data[pos:pos + n].decode("utf-8"), pos + n
        except UnicodeDecodeError as e:
            raise Amf0Error(f"bad utf-8 string: {e}") from None
    if t in (T_OBJECT, T_ECMA):
        if t == T_ECMA:
            _need(data, pos, 4)
            pos += 4  # associative count: advisory, ignore
        obj = {}
        while True:
            key, pos = _dec_key(data, pos)
            _need(data, pos, 1)
            if key == "" and data[pos] == T_OBJECT_END:
                return obj, pos + 1
            obj[key], pos = decode_value(data, pos, depth + 1)
    if t == T_NULL or t == T_UNDEFINED:
        return None, pos
    if t == T_STRICT_ARRAY:
        _need(data, pos, 4)
        (n,) = struct.unpack_from(">I", data, pos)
        pos += 4
        if n > 1 << 20:
            raise Amf0Error("array too large")
        out: List[Any] = []
        for _ in range(n):
            v, pos = decode_value(data, pos, depth + 1)
            out.append(v)
        return out, pos
    raise Amf0Error(f"unsupported AMF0 type 0x{t:02x}")


def decode_all(data: bytes) -> List[Any]:
    out, pos = [], 0
    while pos < len(data):
        v, pos = decode_value(data, pos)
        out.append(v)
    return out
