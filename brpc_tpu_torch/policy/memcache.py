"""Memcached binary protocol client.

Counterpart of the reference's ``policy/memcache_binary_protocol.cpp`` +
``memcache.h`` (MemcacheRequest/MemcacheResponse): N pipelined operations
per RPC, responses arrive in order on the connection (memcached guarantees
request order), so correlation is positional like redis. Each op carries an
opaque token we verify on the way back.

Wire (public memcached binary protocol): 24-byte header
``magic op keylen extlen datatype vbucket bodylen opaque cas`` followed by
extras + key + value.

The port's copy of the JAX package's ``policy/memcache.py``: the same bytes
on the wire, so either package's client talks to the other's server.
"""

from __future__ import annotations

import struct
import threading
from collections import deque
from typing import List, Optional, Tuple

from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.fiber import runtime
from brpc_tpu_torch.proto import rpc_meta_pb2
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.protocol import (
    PARSE_BAD,
    PARSE_NOT_ENOUGH_DATA,
    PARSE_TRY_OTHERS,
    ParsedMessage,
    Protocol,
    dispatch_response,
    init_socket_state,
)

MAGIC_REQUEST = 0x80
MAGIC_RESPONSE = 0x81
HEADER_FMT = "!BBHBBHIIQ"
HEADER_SIZE = struct.calcsize(HEADER_FMT)  # 24

# opcodes
OP_GET = 0x00
OP_SET = 0x01
OP_ADD = 0x02
OP_REPLACE = 0x03
OP_DELETE = 0x04
OP_INCREMENT = 0x05
OP_DECREMENT = 0x06
OP_FLUSH = 0x08
OP_NOOP = 0x0A
OP_VERSION = 0x0B
OP_APPEND = 0x0E
OP_PREPEND = 0x0F
OP_TOUCH = 0x1C

# response status
STATUS_OK = 0x0000
STATUS_KEY_NOT_FOUND = 0x0001
STATUS_KEY_EXISTS = 0x0002
STATUS_VALUE_TOO_LARGE = 0x0003
STATUS_ITEM_NOT_STORED = 0x0005
STATUS_UNKNOWN_COMMAND = 0x0081


def pack_op(opcode: int, key: bytes = b"", extras: bytes = b"",
            value: bytes = b"", opaque: int = 0, cas: int = 0) -> bytes:
    body_len = len(extras) + len(key) + len(value)
    return struct.pack(HEADER_FMT, MAGIC_REQUEST, opcode, len(key),
                       len(extras), 0, 0, body_len, opaque,
                       cas) + extras + key + value


class MemcacheOpResult:
    __slots__ = ("opcode", "status", "key", "value", "extras", "cas")

    def __init__(self, opcode, status, key, value, extras, cas):
        self.opcode = opcode
        self.status = status
        self.key = key
        self.value = value
        self.extras = extras
        self.cas = cas

    @property
    def ok(self) -> bool:
        return self.status == STATUS_OK

    def error_text(self) -> str:
        return self.value.decode("utf-8", "replace") if not self.ok else ""


class MemcacheRequest:
    """Pipelined op batch; pb-duck-typed for the engine (see RedisRequest)."""

    def __init__(self):
        self._ops: List[bytes] = []
        self._next_opaque = 1

    def _add(self, opcode, key=b"", extras=b"", value=b"", cas=0):
        if isinstance(key, str):
            key = key.encode()
        if isinstance(value, str):
            value = value.encode()
        self._ops.append(pack_op(opcode, key, extras, value,
                                 opaque=self._next_opaque, cas=cas))
        self._next_opaque += 1
        return self

    def get(self, key):
        return self._add(OP_GET, key)

    def set(self, key, value, flags: int = 0, exptime: int = 0, cas: int = 0):
        return self._add(OP_SET, key, struct.pack("!II", flags, exptime),
                         value, cas)

    def add(self, key, value, flags: int = 0, exptime: int = 0):
        return self._add(OP_ADD, key, struct.pack("!II", flags, exptime), value)

    def replace(self, key, value, flags: int = 0, exptime: int = 0):
        return self._add(OP_REPLACE, key,
                         struct.pack("!II", flags, exptime), value)

    def append(self, key, value):
        return self._add(OP_APPEND, key, b"", value)

    def prepend(self, key, value):
        return self._add(OP_PREPEND, key, b"", value)

    def delete(self, key):
        return self._add(OP_DELETE, key)

    def incr(self, key, delta: int = 1, initial: int = 0, exptime: int = 0):
        return self._add(OP_INCREMENT, key,
                         struct.pack("!QQI", delta, initial, exptime))

    def decr(self, key, delta: int = 1, initial: int = 0, exptime: int = 0):
        return self._add(OP_DECREMENT, key,
                         struct.pack("!QQI", delta, initial, exptime))

    def touch(self, key, exptime: int = 0):
        return self._add(OP_TOUCH, key, struct.pack("!I", exptime))

    def flush_all(self):
        return self._add(OP_FLUSH)

    def version(self):
        return self._add(OP_VERSION)

    @property
    def op_count(self) -> int:
        return len(self._ops)

    def SerializeToString(self) -> bytes:
        return b"".join(self._ops)

    def ParseFromString(self, data: bytes) -> None:
        self._ops = [bytes(data)] if data else []


class MemcacheResponse:
    def __init__(self):
        self._results: List[MemcacheOpResult] = []
        self._pop_at = 0

    @property
    def result_size(self) -> int:
        return len(self._results)

    def result(self, i: int) -> MemcacheOpResult:
        return self._results[i]

    def pop(self) -> Optional[MemcacheOpResult]:
        """Results in op order (the reference's PopGet/PopSet pattern)."""
        if self._pop_at >= len(self._results):
            return None
        r = self._results[self._pop_at]
        self._pop_at += 1
        return r

    def ParseFromString(self, data: bytes) -> None:
        self._results = []
        self._pop_at = 0
        pos = 0
        while pos + HEADER_SIZE <= len(data):
            (magic, opcode, keylen, extlen, _dt, status, bodylen, _opaque,
             cas) = struct.unpack_from(HEADER_FMT, data, pos)
            pos += HEADER_SIZE
            extras = bytes(data[pos:pos + extlen])
            key = bytes(data[pos + extlen:pos + extlen + keylen])
            value = bytes(data[pos + extlen + keylen:pos + bodylen])
            pos += bodylen
            self._results.append(
                MemcacheOpResult(opcode, status, key, value, extras, cas))

    def SerializeToString(self) -> bytes:
        return b""


def memcache_method():
    from brpc_tpu_torch.rpc.channel import MethodDescriptor

    return MethodDescriptor("memcache", "batch",
                            MemcacheRequest, MemcacheResponse)


def count_ops(payload: bytes) -> int:
    n = 0
    pos = 0
    while pos + HEADER_SIZE <= len(payload):
        bodylen = struct.unpack_from("!I", payload, pos + 8)[0]
        pos += HEADER_SIZE + bodylen
        n += 1
    return n


class _McClientState:
    __slots__ = ("fifo", "lock", "acc")

    def __init__(self):
        self.fifo = deque()  # (cid, ver, n_expected)
        self.lock = threading.Lock()
        self.acc: List[bytes] = []


class MemcacheProtocol(Protocol):
    name = "memcache"
    stateful = True

    # ------------------------------------------------------------- recv path
    def parse(self, buf: IOBuf, sock=None):
        cst: Optional[_McClientState] = getattr(sock, "memcache_client", None)
        if cst is None:
            return PARSE_TRY_OTHERS, None
        if len(buf) >= HEADER_SIZE:
            # peek the head op's total before flattening a big buffer that
            # holds one still-incomplete value (quadratic copy otherwise)
            head = buf.fetch(HEADER_SIZE)
            first_total = HEADER_SIZE + struct.unpack_from("!I", head, 8)[0]
            if len(buf) < first_total:
                return PARSE_NOT_ENOUGH_DATA, None
        data = buf.fetch(len(buf))
        pos = 0
        completed = []
        with cst.lock:
            while pos + HEADER_SIZE <= len(data) and cst.fifo:
                if data[pos] != MAGIC_RESPONSE:
                    buf.pop_front(pos)
                    return PARSE_BAD, None
                bodylen = struct.unpack_from("!I", data, pos + 8)[0]
                total = HEADER_SIZE + bodylen
                if pos + total > len(data):
                    break
                cst.acc.append(data[pos:pos + total])
                pos += total
                cid, ver, need = cst.fifo[0]
                if len(cst.acc) >= need:
                    completed.append((cid, ver, b"".join(cst.acc)))
                    cst.acc = []
                    cst.fifo.popleft()
            unsolicited = not cst.fifo and pos < len(data) \
                and len(data) - pos >= 1 and data[pos] == MAGIC_RESPONSE
        buf.pop_front(pos)
        if unsolicited:
            return PARSE_BAD, None
        for cid, ver, body in completed:
            meta = rpc_meta_pb2.RpcMeta()
            meta.correlation_id = cid
            meta.attempt_version = ver
            msg = ParsedMessage(self, meta, IOBuf(body))
            msg.socket = sock
            sock.in_messages += 1
            runtime.start_background(dispatch_response, msg)
        return PARSE_NOT_ENOUGH_DATA, None

    # ------------------------------------------------------------- send path
    def issue_request(self, sock, meta, payload: bytes,
                      attachment: bytes = b"", checksum: bool = False,
                      id_wait=None) -> int:
        cst: _McClientState = init_socket_state(
            sock, "memcache_client", _McClientState, self)
        n = count_ops(payload)
        if n == 0:
            return errors.EREQUEST
        entry = (meta.correlation_id, meta.attempt_version, n)
        with cst.lock:
            # FIFO order IS the wire order (see redis_protocol)
            cst.fifo.append(entry)
            rc = sock.write(IOBuf(payload), id_wait=id_wait)
            if rc != 0:
                try:
                    cst.fifo.remove(entry)
                except ValueError:
                    pass
        return rc

    # ------------------------------------------------------ engine contracts
    @staticmethod
    def split_attachment(msg: ParsedMessage) -> Tuple[bytes, bytes]:
        return msg.body.tobytes(), b""

    @staticmethod
    def verify_checksum(meta, payload: bytes) -> bool:
        return True
