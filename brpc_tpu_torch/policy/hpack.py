"""HPACK (RFC 7541) — header compression for HTTP/2 and gRPC.

Counterpart of the reference's ``details/hpack.cpp`` (used by
``policy/http2_rpc_protocol.cpp``). Full implementation: static table,
per-connection dynamic table with size eviction, integer/string literals,
and the complete Huffman code. Tables below are the public RFC 7541
Appendix A/B data, not reference code.

The port's copy of the JAX package's ``policy/hpack.py``: the same bytes
for the same values.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# --------------------------------------------------------------- static table
# RFC 7541 Appendix A (1-indexed).
STATIC_TABLE: List[Tuple[str, str]] = [
    (":authority", ""),
    (":method", "GET"),
    (":method", "POST"),
    (":path", "/"),
    (":path", "/index.html"),
    (":scheme", "http"),
    (":scheme", "https"),
    (":status", "200"),
    (":status", "204"),
    (":status", "206"),
    (":status", "304"),
    (":status", "400"),
    (":status", "404"),
    (":status", "500"),
    ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"),
    ("accept-language", ""),
    ("accept-ranges", ""),
    ("accept", ""),
    ("access-control-allow-origin", ""),
    ("age", ""),
    ("allow", ""),
    ("authorization", ""),
    ("cache-control", ""),
    ("content-disposition", ""),
    ("content-encoding", ""),
    ("content-language", ""),
    ("content-length", ""),
    ("content-location", ""),
    ("content-range", ""),
    ("content-type", ""),
    ("cookie", ""),
    ("date", ""),
    ("etag", ""),
    ("expect", ""),
    ("expires", ""),
    ("from", ""),
    ("host", ""),
    ("if-match", ""),
    ("if-modified-since", ""),
    ("if-none-match", ""),
    ("if-range", ""),
    ("if-unmodified-since", ""),
    ("last-modified", ""),
    ("link", ""),
    ("location", ""),
    ("max-forwards", ""),
    ("proxy-authenticate", ""),
    ("proxy-authorization", ""),
    ("range", ""),
    ("referer", ""),
    ("refresh", ""),
    ("retry-after", ""),
    ("server", ""),
    ("set-cookie", ""),
    ("strict-transport-security", ""),
    ("transfer-encoding", ""),
    ("user-agent", ""),
    ("vary", ""),
    ("via", ""),
    ("www-authenticate", ""),
]
STATIC_COUNT = len(STATIC_TABLE)  # 61

# index lookups for encoding: full (name,value) match, then name-only
_STATIC_FULL: Dict[Tuple[str, str], int] = {}
_STATIC_NAME: Dict[str, int] = {}
for _i, (_n, _v) in enumerate(STATIC_TABLE):
    _STATIC_FULL.setdefault((_n, _v), _i + 1)
    _STATIC_NAME.setdefault(_n, _i + 1)

# -------------------------------------------------------------- Huffman table
# RFC 7541 Appendix B: (code, bit-length) for symbols 0..255 + EOS(256).
HUFFMAN_CODES: List[Tuple[int, int]] = [
    (0x1FF8, 13), (0x7FFFD8, 23), (0xFFFFFE2, 28), (0xFFFFFE3, 28),
    (0xFFFFFE4, 28), (0xFFFFFE5, 28), (0xFFFFFE6, 28), (0xFFFFFE7, 28),
    (0xFFFFFE8, 28), (0xFFFFEA, 24), (0x3FFFFFFC, 30), (0xFFFFFE9, 28),
    (0xFFFFFEA, 28), (0x3FFFFFFD, 30), (0xFFFFFEB, 28), (0xFFFFFEC, 28),
    (0xFFFFFED, 28), (0xFFFFFEE, 28), (0xFFFFFEF, 28), (0xFFFFFF0, 28),
    (0xFFFFFF1, 28), (0xFFFFFF2, 28), (0x3FFFFFFE, 30), (0xFFFFFF3, 28),
    (0xFFFFFF4, 28), (0xFFFFFF5, 28), (0xFFFFFF6, 28), (0xFFFFFF7, 28),
    (0xFFFFFF8, 28), (0xFFFFFF9, 28), (0xFFFFFFA, 28), (0xFFFFFFB, 28),
    (0x14, 6), (0x3F8, 10), (0x3F9, 10), (0xFFA, 12),
    (0x1FF9, 13), (0x15, 6), (0xF8, 8), (0x7FA, 11),
    (0x3FA, 10), (0x3FB, 10), (0xF9, 8), (0x7FB, 11),
    (0xFA, 8), (0x16, 6), (0x17, 6), (0x18, 6),
    (0x0, 5), (0x1, 5), (0x2, 5), (0x19, 6),
    (0x1A, 6), (0x1B, 6), (0x1C, 6), (0x1D, 6),
    (0x1E, 6), (0x1F, 6), (0x5C, 7), (0xFB, 8),
    (0x7FFC, 15), (0x20, 6), (0xFFB, 12), (0x3FC, 10),
    (0x1FFA, 13), (0x21, 6), (0x5D, 7), (0x5E, 7),
    (0x5F, 7), (0x60, 7), (0x61, 7), (0x62, 7),
    (0x63, 7), (0x64, 7), (0x65, 7), (0x66, 7),
    (0x67, 7), (0x68, 7), (0x69, 7), (0x6A, 7),
    (0x6B, 7), (0x6C, 7), (0x6D, 7), (0x6E, 7),
    (0x6F, 7), (0x70, 7), (0x71, 7), (0x72, 7),
    (0xFC, 8), (0x73, 7), (0xFD, 8), (0x1FFB, 13),
    (0x7FFF0, 19), (0x1FFC, 13), (0x3FFC, 14), (0x22, 6),
    (0x7FFD, 15), (0x3, 5), (0x23, 6), (0x4, 5),
    (0x24, 6), (0x5, 5), (0x25, 6), (0x26, 6),
    (0x27, 6), (0x6, 5), (0x74, 7), (0x75, 7),
    (0x28, 6), (0x29, 6), (0x2A, 6), (0x7, 5),
    (0x2B, 6), (0x76, 7), (0x2C, 6), (0x8, 5),
    (0x9, 5), (0x2D, 6), (0x77, 7), (0x78, 7),
    (0x79, 7), (0x7A, 7), (0x7B, 7), (0x7FFE, 15),
    (0x7FC, 11), (0x3FFD, 14), (0x1FFD, 13), (0xFFFFFFC, 28),
    (0xFFFE6, 20), (0x3FFFD2, 22), (0xFFFE7, 20), (0xFFFE8, 20),
    (0x3FFFD3, 22), (0x3FFFD4, 22), (0x3FFFD5, 22), (0x7FFFD9, 23),
    (0x3FFFD6, 22), (0x7FFFDA, 23), (0x7FFFDB, 23), (0x7FFFDC, 23),
    (0x7FFFDD, 23), (0x7FFFDE, 23), (0xFFFFEB, 24), (0x7FFFDF, 23),
    (0xFFFFEC, 24), (0xFFFFED, 24), (0x3FFFD7, 22), (0x7FFFE0, 23),
    (0xFFFFEE, 24), (0x7FFFE1, 23), (0x7FFFE2, 23), (0x7FFFE3, 23),
    (0x7FFFE4, 23), (0x1FFFDC, 21), (0x3FFFD8, 22), (0x7FFFE5, 23),
    (0x3FFFD9, 22), (0x7FFFE6, 23), (0x7FFFE7, 23), (0xFFFFEF, 24),
    (0x3FFFDA, 22), (0x1FFFDD, 21), (0xFFFE9, 20), (0x3FFFDB, 22),
    (0x3FFFDC, 22), (0x7FFFE8, 23), (0x7FFFE9, 23), (0x1FFFDE, 21),
    (0x7FFFEA, 23), (0x3FFFDD, 22), (0x3FFFDE, 22), (0xFFFFF0, 24),
    (0x1FFFDF, 21), (0x3FFFDF, 22), (0x7FFFEB, 23), (0x7FFFEC, 23),
    (0x1FFFE0, 21), (0x1FFFE1, 21), (0x3FFFE0, 22), (0x1FFFE2, 21),
    (0x7FFFED, 23), (0x3FFFE1, 22), (0x7FFFEE, 23), (0x7FFFEF, 23),
    (0xFFFEA, 20), (0x3FFFE2, 22), (0x3FFFE3, 22), (0x3FFFE4, 22),
    (0x7FFFF0, 23), (0x3FFFE5, 22), (0x3FFFE6, 22), (0x7FFFF1, 23),
    (0x3FFFFE0, 26), (0x3FFFFE1, 26), (0xFFFEB, 20), (0x7FFF1, 19),
    (0x3FFFE7, 22), (0x7FFFF2, 23), (0x3FFFE8, 22), (0x1FFFFEC, 25),
    (0x3FFFFE2, 26), (0x3FFFFE3, 26), (0x3FFFFE4, 26), (0x7FFFFDE, 27),
    (0x7FFFFDF, 27), (0x3FFFFE5, 26), (0xFFFFF1, 24), (0x1FFFFED, 25),
    (0x7FFF2, 19), (0x1FFFE3, 21), (0x3FFFFE6, 26), (0x7FFFFE0, 27),
    (0x7FFFFE1, 27), (0x3FFFFE7, 26), (0x7FFFFE2, 27), (0xFFFFF2, 24),
    (0x1FFFE4, 21), (0x1FFFE5, 21), (0x3FFFFE8, 26), (0x3FFFFE9, 26),
    (0xFFFFFFD, 28), (0x7FFFFE3, 27), (0x7FFFFE4, 27), (0x7FFFFE5, 27),
    (0xFFFEC, 20), (0xFFFFF3, 24), (0xFFFED, 20), (0x1FFFE6, 21),
    (0x3FFFE9, 22), (0x1FFFE7, 21), (0x1FFFE8, 21), (0x7FFFF3, 23),
    (0x3FFFEA, 22), (0x3FFFEB, 22), (0x1FFFFEE, 25), (0x1FFFFEF, 25),
    (0xFFFFF4, 24), (0xFFFFF5, 24), (0x3FFFFEA, 26), (0x7FFFF4, 23),
    (0x3FFFFEB, 26), (0x7FFFFE6, 27), (0x3FFFFEC, 26), (0x3FFFFED, 26),
    (0x7FFFFE7, 27), (0x7FFFFE8, 27), (0x7FFFFE9, 27), (0x7FFFFEA, 27),
    (0x7FFFFEB, 27), (0xFFFFFFE, 28), (0x7FFFFEC, 27), (0x7FFFFED, 27),
    (0x7FFFFEE, 27), (0x7FFFFEF, 27), (0x7FFFFF0, 27), (0x3FFFFEE, 26),
    (0x3FFFFFFF, 30),
]

# decode dict: (bit-length, code) -> symbol; max code length is 30 bits so
# decoding probes at most 26 lengths per symbol (shortest code is 5 bits)
_HUFF_DECODE: Dict[Tuple[int, int], int] = {
    (bits, code): sym for sym, (code, bits) in enumerate(HUFFMAN_CODES)
}
_MIN_BITS = min(b for _, b in HUFFMAN_CODES)  # 5


class HpackError(Exception):
    pass


def huffman_encode(data: bytes) -> bytes:
    acc = 0
    nbits = 0
    out = bytearray()
    for b in data:
        code, blen = HUFFMAN_CODES[b]
        acc = (acc << blen) | code
        nbits += blen
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
    if nbits:
        # pad with EOS prefix (all-ones)
        out.append(((acc << (8 - nbits)) | ((1 << (8 - nbits)) - 1)) & 0xFF)
    return bytes(out)


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    cur = 0
    curlen = 0
    decode = _HUFF_DECODE
    for byte in data:
        for i in range(7, -1, -1):
            cur = (cur << 1) | ((byte >> i) & 1)
            curlen += 1
            if curlen < _MIN_BITS:
                continue
            sym = decode.get((curlen, cur))
            if sym is not None:
                if sym == 256:
                    raise HpackError("EOS symbol in huffman data")
                out.append(sym)
                cur = 0
                curlen = 0
            elif curlen > 30:
                raise HpackError("invalid huffman code")
    # remaining bits must be a prefix of EOS (all ones), < 8 bits
    if curlen >= 8 or cur != (1 << curlen) - 1:
        raise HpackError("invalid huffman padding")
    return bytes(out)


# ------------------------------------------------------------ integer coding
def encode_int(value: int, prefix_bits: int, flags: int = 0) -> bytearray:
    """RFC 7541 §5.1 — N-bit prefix integer, high bits carry flags."""
    limit = (1 << prefix_bits) - 1
    out = bytearray()
    if value < limit:
        out.append(flags | value)
        return out
    out.append(flags | limit)
    value -= limit
    while value >= 128:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return out


def decode_int(data: bytes, pos: int, prefix_bits: int) -> Tuple[int, int]:
    if pos >= len(data):
        raise HpackError("truncated integer")
    limit = (1 << prefix_bits) - 1
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HpackError("truncated integer continuation")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos
        if shift > 35:
            raise HpackError("integer overflow")


def _encode_string(s: str, huffman: bool = True) -> bytes:
    raw = s.encode("utf-8") if isinstance(s, str) else s
    if huffman:
        enc = huffman_encode(raw)
        if len(enc) < len(raw):
            return bytes(encode_int(len(enc), 7, 0x80)) + enc
    return bytes(encode_int(len(raw), 7, 0x00)) + raw


def _decode_string(data: bytes, pos: int) -> Tuple[str, int]:
    if pos >= len(data):
        raise HpackError("truncated string")
    huff = bool(data[pos] & 0x80)
    length, pos = decode_int(data, pos, 7)
    if pos + length > len(data):
        raise HpackError("truncated string payload")
    raw = data[pos:pos + length]
    pos += length
    if huff:
        raw = huffman_decode(raw)
    return raw.decode("utf-8", "replace"), pos


# ------------------------------------------------------------- dynamic table
class _DynamicTable:
    """FIFO of (name, value); size-bounded per RFC 7541 §4 (32-byte overhead
    per entry). Index 1 = most recently inserted."""

    def __init__(self, max_size: int = 4096):
        self.entries: List[Tuple[str, str]] = []
        self.size = 0
        self.max_size = max_size

    @staticmethod
    def entry_size(name: str, value: str) -> int:
        return len(name.encode()) + len(value.encode()) + 32

    def add(self, name: str, value: str) -> None:
        need = self.entry_size(name, value)
        self._evict_to(self.max_size - need)
        if need <= self.max_size:
            self.entries.insert(0, (name, value))
            self.size += need
        # an entry larger than the table empties it (already evicted)

    def resize(self, new_max: int) -> None:
        self.max_size = new_max
        self._evict_to(new_max)

    def _evict_to(self, budget: int) -> None:
        while self.entries and self.size > max(budget, 0):
            n, v = self.entries.pop()
            self.size -= self.entry_size(n, v)

    def get(self, index: int) -> Tuple[str, str]:
        """index is 1-based within the dynamic table."""
        if 1 <= index <= len(self.entries):
            return self.entries[index - 1]
        raise HpackError(f"dynamic table index {index} out of range")

    def find(self, name: str, value: str) -> Tuple[int, int]:
        """-> (full_match_index, name_match_index) 1-based, 0 = none."""
        full = name_only = 0
        for i, (n, v) in enumerate(self.entries):
            if n == name:
                if v == value and not full:
                    full = i + 1
                if not name_only:
                    name_only = i + 1
            if full:
                break
        return full, name_only


class HpackEncoder:
    def __init__(self, max_table_size: int = 4096):
        self.table = _DynamicTable(max_table_size)

    def encode(self, headers: List[Tuple[str, str]]) -> bytes:
        out = bytearray()
        for name, value in headers:
            name = name.lower()
            out += self._encode_one(name, value)
        return bytes(out)

    def _encode_one(self, name: str, value: str) -> bytearray:
        static_full = _STATIC_FULL.get((name, value), 0)
        if static_full:
            return encode_int(static_full, 7, 0x80)  # indexed
        dyn_full, dyn_name = self.table.find(name, value)
        if dyn_full:
            return encode_int(STATIC_COUNT + dyn_full, 7, 0x80)
        # literal with incremental indexing (0x40), name indexed if possible
        name_idx = _STATIC_NAME.get(name, 0) or (
            STATIC_COUNT + dyn_name if dyn_name else 0)
        out = encode_int(name_idx, 6, 0x40)
        if not name_idx:
            out += _encode_string(name)
        out += _encode_string(value)
        self.table.add(name, value)
        return out


class HpackDecoder:
    def __init__(self, max_table_size: int = 4096):
        self.table = _DynamicTable(max_table_size)
        # RFC 7541 §4.2: the peer may shrink/restore the table but never
        # grow it past the size we advertised (our default: 4096) — an
        # uncapped resize lets one connection grow memory without bound
        self._advertised_max = max_table_size

    def _lookup(self, index: int) -> Tuple[str, str]:
        if index == 0:
            raise HpackError("index 0")
        if index <= STATIC_COUNT:
            return STATIC_TABLE[index - 1]
        return self.table.get(index - STATIC_COUNT)

    def decode(self, data: bytes) -> List[Tuple[str, str]]:
        headers: List[Tuple[str, str]] = []
        pos = 0
        while pos < len(data):
            b = data[pos]
            if b & 0x80:  # indexed field
                index, pos = decode_int(data, pos, 7)
                headers.append(self._lookup(index))
            elif b & 0x40:  # literal, incremental indexing
                index, pos = decode_int(data, pos, 6)
                name = self._lookup(index)[0] if index else None
                if name is None:
                    name, pos = _decode_string(data, pos)
                value, pos = _decode_string(data, pos)
                self.table.add(name, value)
                headers.append((name, value))
            elif b & 0x20:  # dynamic table size update
                new_size, pos = decode_int(data, pos, 5)
                if new_size > self._advertised_max:
                    raise HpackError(
                        f"table size update {new_size} exceeds advertised "
                        f"maximum {self._advertised_max}")
                self.table.resize(new_size)
            else:  # literal without indexing (0x00) / never indexed (0x10)
                index, pos = decode_int(data, pos, 4)
                name = self._lookup(index)[0] if index else None
                if name is None:
                    name, pos = _decode_string(data, pos)
                value, pos = _decode_string(data, pos)
                headers.append((name, value))
        return headers
