"""Small perf utilities: crc32c, fast_rand, monotonic time helpers.

Counterparts of the reference's ``butil/crc32c.cc`` (HW-accelerated CRC32-C
used as the attachment checksum), ``butil/fast_rand.cpp`` and
``butil/time.h`` (cpuwide_time_us). The CRC32-C here is the Castagnoli
polynomial via a 256-entry table: the port has no C++ core, so this is
the reference's own pure-Python branch (same values).
"""

from __future__ import annotations

import random
import time

# ----------------------------------------------------------------- crc32c
_CRC32C_POLY = 0x82F63B78
_TABLE = []


def _build_table():
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ _CRC32C_POLY if crc & 1 else crc >> 1
        _TABLE.append(crc)


_build_table()


def crc32c(data, value: int = 0) -> int:
    """CRC32-C (Castagnoli) of bytes-like; chainable via ``value``."""
    crc = value ^ 0xFFFFFFFF
    table = _TABLE
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# --------------------------------------------------------------- fast_rand
_rng = random.Random()


def fast_rand() -> int:
    return _rng.getrandbits(64)


def fast_rand_less_than(n: int) -> int:
    return _rng.randrange(n) if n > 0 else 0


# -------------------------------------------------------------------- time
def cpuwide_time_us() -> int:
    return time.perf_counter_ns() // 1000


def monotonic_time_ns() -> int:
    return time.monotonic_ns()


def gettimeofday_us() -> int:
    return time.time_ns() // 1000
