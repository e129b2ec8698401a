"""butil — base library for the TPU-native bRPC rebuild (SURVEY §2.1)."""

from brpc_tpu_torch.butil.iobuf import IOBuf, IOBufAppender
from brpc_tpu_torch.butil.endpoint import EndPoint, EndPointError, str2endpoint
from brpc_tpu_torch.butil.resource_pool import (
    VersionedPool,
    ObjectPool,
    make_id,
    id_version,
    id_slot,
)
from brpc_tpu_torch.butil.doubly_buffered import DoublyBufferedData
from brpc_tpu_torch.butil.misc import (
    crc32c,
    fast_rand,
    fast_rand_less_than,
    cpuwide_time_us,
    gettimeofday_us,
)

__all__ = [
    "IOBuf",
    "IOBufAppender",
    "EndPoint",
    "EndPointError",
    "str2endpoint",
    "VersionedPool",
    "ObjectPool",
    "make_id",
    "id_version",
    "id_slot",
    "DoublyBufferedData",
    "crc32c",
    "fast_rand",
    "fast_rand_less_than",
    "cpuwide_time_us",
    "gettimeofday_us",
]
