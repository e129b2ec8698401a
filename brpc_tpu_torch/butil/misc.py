"""Small perf utilities: crc32c, fast_rand, monotonic time helpers.

Counterparts of the reference's ``butil/crc32c.cc`` (HW-accelerated CRC32-C
used as the attachment checksum), ``butil/fast_rand.cpp`` and
``butil/time.h`` (cpuwide_time_us). The CRC32-C here is the Castagnoli
polynomial via a 256-entry table; the port's C++ core
(``brpc_tpu_torch/native``, installed by ``policy.ensure_registered``)
provides an SSE4.2/tabled version that is preferred once installed (same
values).
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

_native_crc32c = None  # installed by brpc_tpu_torch.native.install()


def crc32c(data, value: int = 0) -> int:
    """CRC32-C (Castagnoli) of bytes-like; chainable via ``value``."""
    if _native_crc32c is not None:
        return _native_crc32c(bytes(data), value)
    crc = value ^ 0xFFFFFFFF
    table = _TABLE
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# --------------------------------------------------------------- fast_rand
_rng = random.Random()
# hook pattern (same as _native_crc32c): callers `from`-import these
# functions, so the native core installs via indirection, not rebinding
_native_fast_rand = None
_native_fast_rand_less_than = None


def fast_rand() -> int:
    if _native_fast_rand is not None:
        return _native_fast_rand()
    return _rng.getrandbits(64)


def fast_rand_less_than(n: int) -> int:
    if _native_fast_rand_less_than is not None:
        return _native_fast_rand_less_than(n)
    return _rng.randrange(n) if n > 0 else 0


# -------------------------------------------------------------------- time
def cpuwide_time_us() -> int:
    return time.perf_counter_ns() // 1000


def monotonic_time_ns() -> int:
    return time.monotonic_ns()


def gettimeofday_us() -> int:
    return time.time_ns() // 1000
