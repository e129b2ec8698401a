"""nshead protocol — the UB legacy family's framing (client + server).

Counterpart of the reference's ``policy/nshead_protocol.cpp`` +
``nshead_service.h`` + ``nshead_message.h``: a 36-byte little-endian header
(id, version, log_id, provider[16], magic 0xfb709394, reserved, body_len)
followed by an opaque body. The ubrpc/mcpack/compack protocols of the
reference are all nshead-framed payload dialects; here the body is opaque
bytes and payload dialects layer on top (mcpack2pb provides one).

No correlation id on the wire -> positional FIFO correlation per
connection, like redis/memcache. Server side: ``ServerOptions.
nshead_service`` gets (controller-ish peer info, NsheadMessage) and returns
an NsheadMessage.

The port's copy of the JAX package's ``policy/nshead.py``: the same bytes
on the wire, so either package's client talks to the other's server.
"""

from __future__ import annotations

import struct
import threading
from collections import deque
from typing import Optional, Tuple

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

NSHEAD_MAGIC = 0xFB709394
HEADER_FMT = "<HHI16sIII"
HEADER_SIZE = struct.calcsize(HEADER_FMT)  # 36
MAX_BODY = 64 << 20


class NsheadMessage:
    """head fields + opaque body; pb-duck-typed for the engine."""

    def __init__(self, body: bytes = b"", id: int = 0, version: int = 0,
                 log_id: int = 0, provider: bytes = b"brpc-tpu"):
        self.id = id
        self.version = version
        self.log_id = log_id
        self.provider = provider
        self.body = body if isinstance(body, bytes) else body.encode()

    def SerializeToString(self) -> bytes:
        return struct.pack(HEADER_FMT, self.id, self.version, self.log_id,
                           self.provider[:16].ljust(16, b"\x00"),
                           NSHEAD_MAGIC, 0, len(self.body)) + self.body

    def ParseFromString(self, data: bytes) -> None:
        (self.id, self.version, self.log_id, provider, magic, _res,
         body_len) = struct.unpack_from(HEADER_FMT, data, 0)
        if magic != NSHEAD_MAGIC:
            raise ValueError("bad nshead magic")
        self.provider = provider.rstrip(b"\x00")
        self.body = bytes(data[HEADER_SIZE:HEADER_SIZE + body_len])


def nshead_method():
    from brpc_tpu_torch.rpc.channel import MethodDescriptor

    return MethodDescriptor("nshead", "call", NsheadMessage, NsheadMessage)


class NsheadService:
    """Subclass and override process(). Runs in a fiber per request; the
    response is written back in arrival order per connection."""

    def process(self, peer, request: NsheadMessage) -> NsheadMessage:
        raise NotImplementedError


class _NsClientState:
    __slots__ = ("fifo", "lock")

    def __init__(self):
        self.fifo = deque()  # (cid, ver)
        self.lock = threading.Lock()


class _NsServerState:
    __slots__ = ("queue",)

    def __init__(self, sock, service):
        def consume(items):
            if items is None:
                return
            out = IOBuf()
            for req in items:
                try:
                    resp = service.process(sock.remote, req)
                except Exception:
                    resp = NsheadMessage(b"", id=req.id, log_id=req.log_id)
                out.append(resp.SerializeToString())
            sock.write(out)

        from brpc_tpu_torch.fiber.execution_queue import ExecutionQueue

        self.queue = ExecutionQueue(consume)


class NsheadProtocol(Protocol):
    name = "nshead"
    stateful = True

    # ------------------------------------------------------------- recv path
    def parse(self, buf: IOBuf, sock=None):
        cst = getattr(sock, "nshead_client", None)
        srv = sock.owner_server
        service = getattr(srv.options, "nshead_service", None) if srv else None
        if cst is None and service is None:
            return PARSE_TRY_OTHERS, None
        first = True
        while True:
            if len(buf) < HEADER_SIZE:
                if first and len(buf) >= 28:
                    # the magic (offset 24) is already visible: only reject
                    # when it genuinely isn't nshead
                    head = buf.fetch(28)
                    magic, = struct.unpack_from("<I", head, 24)
                    if magic != NSHEAD_MAGIC:
                        return PARSE_TRY_OTHERS, None
                return PARSE_NOT_ENOUGH_DATA, None
            head = buf.fetch(HEADER_SIZE)
            magic, = struct.unpack_from("<I", head, 24)
            body_len, = struct.unpack_from("<I", head, 32)
            if magic != NSHEAD_MAGIC or body_len > MAX_BODY:
                return (PARSE_TRY_OTHERS if first else PARSE_BAD), None
            if len(buf) < HEADER_SIZE + body_len:
                return PARSE_NOT_ENOUGH_DATA, None
            sock.preferred_protocol = self
            raw = buf.cutn(HEADER_SIZE + body_len).tobytes()
            msg_obj = NsheadMessage()
            msg_obj.ParseFromString(raw)
            sock.in_messages += 1
            first = False
            if service is not None and cst is None:
                sst = getattr(sock, "nshead_server", None)
                if sst is None:
                    sst = _NsServerState(sock, service)
                    sock.nshead_server = sst
                sst.queue.execute(msg_obj)
                continue
            with cst.lock:
                ctx = cst.fifo.popleft() if cst.fifo else None
            if ctx is None:
                return PARSE_BAD, None  # unsolicited response
            meta = rpc_meta_pb2.RpcMeta()
            meta.correlation_id, meta.attempt_version = ctx
            msg = ParsedMessage(self, meta, IOBuf(raw))
            msg.socket = sock
            runtime.start_background(dispatch_response, msg)

    # ------------------------------------------------------------- send path
    def issue_request(self, sock, meta, payload: bytes,
                      attachment: bytes = b"", checksum: bool = False,
                      id_wait=None) -> int:
        cst: _NsClientState = init_socket_state(
            sock, "nshead_client", _NsClientState, self)
        entry = (meta.correlation_id, meta.attempt_version)
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
