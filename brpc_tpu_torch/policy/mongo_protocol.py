"""mongo — MongoDB wire protocol (OP_MSG), client + server side.

Counterpart of the reference's ``policy/mongo_protocol.cpp``. Modern wire
format only (OP_MSG, opcode 2013, mongo >= 3.6): 16-byte little-endian
header (messageLength, requestID, responseTo, opCode) + uint32 flagBits +
one kind-0 section carrying a single BSON command/reply document.

Correlation is native to the wire: each request gets a fresh requestID and
the reply's responseTo names it — so unlike RESP there is no positional
FIFO; out-of-order replies (mongo exhaust/parallel cursors) correlate
correctly.

Client:   ch = Channel(ChannelOptions(protocol="mongo")).init(addr)
          resp = ch.call_method(mongo_method(),
                                MongoRequest({"ping": 1, "$db": "admin"}))
          resp.document -> {"ok": 1.0, ...}
Server:   ServerOptions(mongo_service=MongoService()) with
          add_command_handler("find", fn(doc) -> reply_doc) — the fake-
          mongod test substrate (the reference tests the same way).

The port's copy of the JAX package's ``policy/mongo_protocol.py``: the same
bytes on the wire, so either package's client talks to the other's server.
"""

from __future__ import annotations

import struct
import threading
from typing import Callable, Dict, Optional, Tuple

from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.fiber import runtime
from brpc_tpu_torch.policy import bson
from brpc_tpu_torch.proto import rpc_meta_pb2
from brpc_tpu_torch.rpc.protocol import (
    PARSE_BAD,
    PARSE_NOT_ENOUGH_DATA,
    PARSE_TRY_OTHERS,
    ParsedMessage,
    Protocol,
)

OP_MSG = 2013
HEADER = "<iiii"
HEADER_SIZE = 16
MAX_MESSAGE = 48 << 20  # mongo's own maxMessageSizeBytes

_next_request_id = [1]
_rid_lock = threading.Lock()


def _fresh_request_id() -> int:
    with _rid_lock:
        rid = _next_request_id[0]
        _next_request_id[0] = (rid + 1) & 0x7FFFFFFF or 1
        return rid


def pack_msg(request_id: int, response_to: int, doc: dict) -> bytes:
    body = struct.pack("<I", 0) + b"\x00" + bson.encode(doc)
    return struct.pack(HEADER, HEADER_SIZE + len(body), request_id,
                       response_to, OP_MSG) + body


def unpack_msg_body(body: bytes) -> dict:
    if len(body) < 5:
        raise bson.BsonError("OP_MSG body too short")
    # flagBits(4) + section kind byte; only kind 0 (single document) is
    # accepted — and nothing may FOLLOW it (silently dropping a kind-1
    # document sequence would lose payload, e.g. a driver's insert docs)
    if body[4] != 0:
        raise bson.BsonError(f"unsupported OP_MSG section kind {body[4]}")
    doc, end = bson._decode_doc(bytes(body), 5)
    if end != len(body):
        raise bson.BsonError("unsupported extra OP_MSG sections")
    return doc


class MongoRequest:
    """One command document (SerializeToString carries flags+section; the
    header with its fresh requestID is added at issue time)."""

    def __init__(self, document: Optional[dict] = None):
        self.document = dict(document or {})

    def SerializeToString(self) -> bytes:
        return struct.pack("<I", 0) + b"\x00" + bson.encode(self.document)

    def ParseFromString(self, data: bytes) -> None:  # for rpc_replay
        self.document = unpack_msg_body(bytes(data))


class MongoResponse:
    def __init__(self):
        self.document: dict = {}

    @property
    def ok(self) -> bool:
        return float(self.document.get("ok", 0)) == 1.0

    def ParseFromString(self, data: bytes) -> None:
        self.document = unpack_msg_body(bytes(data))

    def SerializeToString(self) -> bytes:
        return struct.pack("<I", 0) + b"\x00" + bson.encode(self.document)


def mongo_method():
    from brpc_tpu_torch.rpc.channel import MethodDescriptor

    return MethodDescriptor("mongo", "command", MongoRequest, MongoResponse)


class MongoService:
    """Server-side command registry (the fake-mongod test substrate)."""

    def __init__(self):
        self._handlers: Dict[str, Callable[[dict], dict]] = {}
        self.add_command_handler("ping", lambda doc: {"ok": 1.0})
        self.add_command_handler(
            "hello", lambda doc: {"ok": 1.0, "isWritablePrimary": True,
                                  "maxWireVersion": 17})

    def add_command_handler(self, name: str,
                            handler: Callable[[dict], dict]) -> "MongoService":
        self._handlers[name.lower()] = handler
        return self

    def handle(self, doc: dict) -> dict:
        if not doc:
            return {"ok": 0.0, "errmsg": "empty command", "code": 22}
        cmd = next(iter(doc)).lower()
        handler = self._handlers.get(cmd)
        if handler is None:
            return {"ok": 0.0, "errmsg": f"no such command: '{cmd}'",
                    "code": 59}
        try:
            return handler(doc)
        except Exception as e:
            return {"ok": 0.0, "errmsg": str(e), "code": 8}


class _MongoClientState:
    __slots__ = ("inflight", "lock")

    def __init__(self):
        self.inflight: Dict[int, Tuple[int, int]] = {}  # rid -> (cid, ver)
        self.lock = threading.Lock()


class MongoProtocol(Protocol):
    name = "mongo"
    stateful = True

    # ------------------------------------------------------------- recv path
    def parse(self, buf: IOBuf, sock=None):
        # consume EVERY complete message in the buffer: dispatch is a side
        # effect here (wire-native correlation), so returning early would
        # strand pipelined messages until bytes that may never come
        first = True
        while True:
            if len(buf) < HEADER_SIZE:
                if first:
                    return self._probe_short(buf, sock)
                return PARSE_NOT_ENOUGH_DATA, None
            head = buf.fetch(HEADER_SIZE)
            length, request_id, response_to, opcode = struct.unpack(HEADER,
                                                                    head)
            if opcode != OP_MSG:
                return (PARSE_TRY_OTHERS if first else PARSE_BAD), None
            if not HEADER_SIZE + 5 <= length <= MAX_MESSAGE:
                return PARSE_BAD, None
            if not self._ours(sock):
                return PARSE_TRY_OTHERS, None
            if len(buf) < length:
                return PARSE_NOT_ENOUGH_DATA, None
            buf.pop_front(HEADER_SIZE)
            body = buf.cutn(length - HEADER_SIZE).tobytes()
            cst: Optional[_MongoClientState] = getattr(sock, "mongo_client",
                                                       None)
            if cst is not None:
                rc = self._client_reply(sock, cst, response_to, body)
            else:
                rc = self._server_request(sock, request_id, body)
            if rc[0] == PARSE_BAD:
                return rc
            first = False

    def _probe_short(self, buf: IOBuf, sock) -> tuple:
        # not enough for a header: ours if the socket already speaks mongo,
        # otherwise let other protocols probe
        if getattr(sock, "mongo_client", None) is not None or \
                getattr(sock, "mongo_server", False):
            return PARSE_NOT_ENOUGH_DATA, None
        return PARSE_TRY_OTHERS, None

    def _ours(self, sock) -> bool:
        if sock is None:
            return False
        if getattr(sock, "mongo_client", None) is not None or \
                getattr(sock, "mongo_server", False):
            return True
        srv = sock.owner_server
        service = getattr(srv.options, "mongo_service", None) if srv else None
        if service is not None:
            sock.mongo_server = True
            sock.preferred_protocol = self
            return True
        return False

    def _client_reply(self, sock, cst: _MongoClientState, response_to: int,
                      body: bytes):
        with cst.lock:
            entry = cst.inflight.pop(response_to, None)
        if entry is None:
            return PARSE_NOT_ENOUGH_DATA, None  # late reply of a dead call
        cid, ver = entry
        meta = rpc_meta_pb2.RpcMeta()
        meta.correlation_id = cid
        meta.attempt_version = ver
        msg = ParsedMessage(self, meta, IOBuf(body))
        msg.socket = sock
        sock.in_messages += 1
        from brpc_tpu_torch.rpc.protocol import dispatch_response

        runtime.start_background(dispatch_response, msg)
        return PARSE_NOT_ENOUGH_DATA, None

    def _server_request(self, sock, request_id: int, body: bytes):
        srv = sock.owner_server
        service = getattr(srv.options, "mongo_service", None) if srv else None
        if service is None:
            return PARSE_BAD, None
        sock.in_messages += 1

        def work():
            try:
                doc = unpack_msg_body(body)
                reply = service.handle(doc)
            except bson.BsonError as e:
                reply = {"ok": 0.0, "errmsg": f"bad BSON: {e}", "code": 22}
            try:
                packet = pack_msg(_fresh_request_id(), request_id, reply)
            except Exception as e:
                # a handler returning something unencodable must still get
                # SOME reply out — a swallowed exception hangs the client
                packet = pack_msg(_fresh_request_id(), request_id,
                                  {"ok": 0.0, "code": 8,
                                   "errmsg": f"unencodable reply: {e}"})
            sock.write(IOBuf(packet))

        runtime.start_background(work)
        return PARSE_NOT_ENOUGH_DATA, None

    # ------------------------------------------------------------- send path
    def issue_request(self, sock, meta, payload: bytes,
                      attachment: bytes = b"", checksum: bool = False,
                      id_wait=None) -> int:
        from brpc_tpu_torch.rpc.protocol import init_socket_state

        cst: _MongoClientState = init_socket_state(
            sock, "mongo_client", _MongoClientState, self)
        rid = _fresh_request_id()
        packet = struct.pack(HEADER, HEADER_SIZE + len(payload), rid, 0,
                             OP_MSG) + payload
        with cst.lock:
            cst.inflight[rid] = (meta.correlation_id, meta.attempt_version)
            if len(cst.inflight) > 4096:
                # timed-out calls never get a reply to clear their entry;
                # shed oldest first (stale late replies are rejected by the
                # call-id version check anyway)
                cst.inflight.pop(next(iter(cst.inflight)))
        rc = sock.write(IOBuf(packet), id_wait=id_wait)
        if rc != 0:
            with cst.lock:
                cst.inflight.pop(rid, None)
        return rc

    # ------------------------------------------------------ engine contracts
    @staticmethod
    def split_attachment(msg: ParsedMessage) -> Tuple[bytes, bytes]:
        return msg.body.tobytes(), b""

    @staticmethod
    def verify_checksum(meta, payload: bytes) -> bool:
        return True
