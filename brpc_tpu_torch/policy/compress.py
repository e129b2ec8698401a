"""Compression handlers (reference global.cpp:395-404 gzip/zlib/snappy).

snappy has no stdlib codec and deps are frozen, so the registry carries
gzip/zlib (stdlib) and is open for registration like the reference's.
"""

from __future__ import annotations

import gzip as _gzip
import zlib as _zlib
from typing import Callable, Dict, Tuple

COMPRESS_NONE = 0
COMPRESS_GZIP = 1
COMPRESS_ZLIB = 2

_handlers: Dict[int, Tuple[Callable[[bytes], bytes], Callable[[bytes], bytes]]] = {
    COMPRESS_GZIP: (_gzip.compress, _gzip.decompress),
    COMPRESS_ZLIB: (_zlib.compress, _zlib.decompress),
}


def register_compression(ctype: int, compress_fn, decompress_fn) -> None:
    _handlers[ctype] = (compress_fn, decompress_fn)


def compress(data: bytes, ctype: int) -> bytes:
    if ctype == COMPRESS_NONE:
        return data
    try:
        return _handlers[ctype][0](data)
    except KeyError:
        raise ValueError(f"unknown compress type {ctype}")


def decompress(data: bytes, ctype: int) -> bytes:
    if ctype == COMPRESS_NONE:
        return data
    try:
        return _handlers[ctype][1](data)
    except KeyError:
        raise ValueError(f"unknown compress type {ctype}")
