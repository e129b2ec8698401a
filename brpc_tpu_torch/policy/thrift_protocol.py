"""Thrift framed-transport protocol (TBinaryProtocol, strict).

Counterpart of the reference's ``policy/thrift_protocol.cpp`` +
``thrift_service.h``: clients call thrift servers (framed binary), and a
Server can answer thrift clients through ``ServerOptions.thrift_service``.

Wire: u32 frame length, then a TBinary message — strict header
``0x8001_00_0t`` (t = message type), method name, i32 seqid, then the
args/result struct. Correlation is the seqid: a per-socket map seqid ->
(call id, attempt version); thrift servers may reply out of order.

Payloads are raw struct bytes (``ThriftRawMessage``) — bring serialized
structs from any generator — plus a small TBinary writer/reader for
building/parsing structs without generated code.

The port's copy of the JAX package's ``policy/thrift_protocol.py``: the
same bytes on the wire, so either package's client talks to the other's
server.
"""

from __future__ import annotations

import struct
import threading
from typing import Dict, Optional, Tuple

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

VERSION_MASK = 0xFFFF0000
VERSION_1 = 0x80010000

# message types
MT_CALL = 1
MT_REPLY = 2
MT_EXCEPTION = 3
MT_ONEWAY = 4

# field types
T_STOP = 0
T_BOOL = 2
T_BYTE = 3
T_DOUBLE = 4
T_I16 = 6
T_I32 = 8
T_I64 = 10
T_STRING = 11
T_STRUCT = 12
T_MAP = 13
T_SET = 14
T_LIST = 15

MAX_FRAME = 64 << 20


# ------------------------------------------------------------ binary codec
class ThriftBinaryWriter:
    """Minimal TBinaryProtocol writer (struct body only)."""

    def __init__(self):
        self._out = bytearray()

    def bytes(self) -> bytes:
        return bytes(self._out)

    def field_stop(self) -> "ThriftBinaryWriter":
        self._out.append(T_STOP)
        return self

    def _field(self, ftype: int, fid: int) -> None:
        self._out += struct.pack("!bh", ftype, fid)

    def write_bool(self, fid: int, v: bool):
        self._field(T_BOOL, fid)
        self._out.append(1 if v else 0)
        return self

    def write_byte(self, fid: int, v: int):
        self._field(T_BYTE, fid)
        self._out += struct.pack("!b", v)
        return self

    def write_i16(self, fid: int, v: int):
        self._field(T_I16, fid)
        self._out += struct.pack("!h", v)
        return self

    def write_i32(self, fid: int, v: int):
        self._field(T_I32, fid)
        self._out += struct.pack("!i", v)
        return self

    def write_i64(self, fid: int, v: int):
        self._field(T_I64, fid)
        self._out += struct.pack("!q", v)
        return self

    def write_double(self, fid: int, v: float):
        self._field(T_DOUBLE, fid)
        self._out += struct.pack("!d", v)
        return self

    def write_string(self, fid: int, v):
        if isinstance(v, str):
            v = v.encode("utf-8")
        self._field(T_STRING, fid)
        self._out += struct.pack("!i", len(v)) + v
        return self

    def write_struct(self, fid: int, body: bytes):
        """body must already end with T_STOP."""
        self._field(T_STRUCT, fid)
        self._out += body
        return self


class ThriftBinaryReader:
    """Reads a flat struct into {field_id: (type, value)}; nested structs
    come back as raw bytes for a second reader pass."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def _take(self, fmt: str):
        v = struct.unpack_from(fmt, self.data, self.pos)[0]
        self.pos += struct.calcsize(fmt)
        return v

    def read_struct(self) -> Dict[int, Tuple[int, object]]:
        fields: Dict[int, Tuple[int, object]] = {}
        while True:
            ftype = self._take("!b")
            if ftype == T_STOP:
                return fields
            fid = self._take("!h")
            fields[fid] = (ftype, self._read_value(ftype))

    def _read_value(self, ftype: int):
        if ftype == T_BOOL:
            return bool(self._take("!b"))
        if ftype == T_BYTE:
            return self._take("!b")
        if ftype == T_I16:
            return self._take("!h")
        if ftype == T_I32:
            return self._take("!i")
        if ftype == T_I64:
            return self._take("!q")
        if ftype == T_DOUBLE:
            return self._take("!d")
        if ftype == T_STRING:
            n = self._take("!i")
            v = self.data[self.pos:self.pos + n]
            self.pos += n
            return bytes(v)
        if ftype == T_STRUCT:
            start = self.pos
            self.read_struct()  # skip over it
            return bytes(self.data[start:self.pos])
        if ftype in (T_LIST, T_SET):
            etype = self._take("!b")
            n = self._take("!i")
            return [self._read_value(etype) for _ in range(n)]
        if ftype == T_MAP:
            ktype = self._take("!b")
            vtype = self._take("!b")
            n = self._take("!i")
            return {self._read_value(ktype): self._read_value(vtype)
                    for _ in range(n)}
        raise ValueError(f"unsupported thrift type {ftype}")


def pack_message(mtype: int, method: str, seqid: int, body: bytes) -> bytes:
    name = method.encode("utf-8")
    msg = (struct.pack("!I", VERSION_1 | mtype)
           + struct.pack("!i", len(name)) + name
           + struct.pack("!i", seqid) + body)
    return struct.pack("!I", len(msg)) + msg


def unpack_message(frame: bytes) -> Tuple[int, str, int, bytes]:
    """frame = one message without the length prefix."""
    ver = struct.unpack_from("!I", frame, 0)[0]
    if ver & VERSION_MASK != VERSION_1:
        raise ValueError("not a strict TBinary message")
    mtype = ver & 0xFF
    nlen = struct.unpack_from("!i", frame, 4)[0]
    name = frame[8:8 + nlen].decode("utf-8", "replace")
    seqid = struct.unpack_from("!i", frame, 8 + nlen)[0]
    return mtype, name, seqid, bytes(frame[12 + nlen:])


# TApplicationException (what servers throw for unknown methods etc.)
AE_UNKNOWN_METHOD = 1
AE_INTERNAL_ERROR = 6


def pack_application_exception(method: str, seqid: int, code: int,
                               message: str) -> bytes:
    body = (ThriftBinaryWriter()
            .write_string(1, message)
            .write_i32(2, code)
            .field_stop().bytes())
    return pack_message(MT_EXCEPTION, method, seqid, body)


# --------------------------------------------------------- message classes
class ThriftRawMessage:
    """method + raw TBinary struct body, pb-message duck-typed. The method
    name rides the wire in the thrift header, set from the RPC's
    method_name (use ``thrift_method(name)``)."""

    def __init__(self, body: bytes = b"\x00"):
        self.body = body  # b"\x00" = empty struct (just T_STOP)

    def SerializeToString(self) -> bytes:
        return self.body

    def ParseFromString(self, data: bytes) -> None:
        self.body = bytes(data)


def thrift_method(name: str):
    from brpc_tpu_torch.rpc.channel import MethodDescriptor

    return MethodDescriptor("thrift", name, ThriftRawMessage, ThriftRawMessage)


class ThriftService:
    """Server half: method name -> handler(args_body: bytes) -> bytes
    (result struct body). Raise to return a TApplicationException."""

    def __init__(self):
        self._methods: Dict[str, object] = {}

    def add_method(self, name: str, handler) -> "ThriftService":
        self._methods[name] = handler
        return self

    def find(self, name: str):
        return self._methods.get(name)


# ------------------------------------------------------------ client state
class _ThriftClientState:
    __slots__ = ("lock", "next_seqid", "calls")

    def __init__(self):
        self.lock = threading.Lock()
        self.next_seqid = 1
        self.calls: Dict[int, Tuple[int, int]] = {}  # seqid -> (cid, ver)


class ThriftProtocol(Protocol):
    name = "thrift"
    stateful = True

    # ------------------------------------------------------------- recv path
    def parse(self, buf: IOBuf, sock=None):
        """Consumes EVERY complete frame in buf (returning
        PARSE_NOT_ENOUGH_DATA stops the messenger's cut loop, so leaving a
        complete frame buffered would strand it until the next read event)."""
        cst = getattr(sock, "thrift_client", None)
        srv = sock.owner_server
        service = getattr(srv.options, "thrift_service", None) if srv else None
        if cst is None and service is None:
            return PARSE_TRY_OTHERS, None
        first = True
        while True:
            rc = self._parse_one(buf, sock, cst, service, probe=first)
            if rc is not None:
                return rc, None
            first = False
            cst = getattr(sock, "thrift_client", None)

    def _parse_one(self, buf, sock, cst, service, probe):
        """-> None when one frame was consumed; a PARSE_* code otherwise."""
        if len(buf) < 8:
            head = buf.fetch(min(len(buf), 8))
            if probe and len(head) >= 6 and head[4] != 0x80:
                return PARSE_TRY_OTHERS
            return PARSE_NOT_ENOUGH_DATA
        head = buf.fetch(8)
        n = struct.unpack("!I", head[:4])[0]
        if head[4] != 0x80 or n > MAX_FRAME:
            return PARSE_TRY_OTHERS if probe else PARSE_BAD
        if len(buf) < 4 + n:
            return PARSE_NOT_ENOUGH_DATA
        sock.preferred_protocol = self
        buf.pop_front(4)
        frame = buf.cutn(n).tobytes()
        try:
            mtype, name, seqid, body = unpack_message(frame)
        except (ValueError, struct.error):
            return PARSE_BAD
        sock.in_messages += 1
        if mtype in (MT_CALL, MT_ONEWAY):
            if service is None:
                return PARSE_BAD
            runtime.start_background(
                self._run_server_method, sock, service, mtype, name, seqid,
                body)
            return None
        # REPLY / EXCEPTION -> complete the matching call
        if cst is None:
            return None  # stale reply: drop
        with cst.lock:
            ctx = cst.calls.pop(seqid, None)
        if ctx is None:
            return None  # timed-out call: drop
        meta = rpc_meta_pb2.RpcMeta()
        meta.correlation_id, meta.attempt_version = ctx
        if mtype == MT_EXCEPTION:
            try:
                fields = ThriftBinaryReader(body).read_struct()
                text = fields.get(1, (0, b""))[1].decode("utf-8", "replace")
            except Exception:
                text = "thrift exception"
            meta.response.error_code = errors.EINTERNAL
            meta.response.error_text = text
            body = b"\x00"
        msg = ParsedMessage(self, meta, IOBuf(body))
        msg.socket = sock
        runtime.start_background(dispatch_response, msg)
        return None

    def _run_server_method(self, sock, service, mtype, name, seqid, body):
        handler = service.find(name)
        if handler is None:
            if mtype != MT_ONEWAY:
                sock.write(IOBuf(pack_application_exception(
                    name, seqid, AE_UNKNOWN_METHOD,
                    f"unknown method {name!r}")))
            return
        try:
            result = handler(body)
        except Exception as e:
            if mtype != MT_ONEWAY:
                sock.write(IOBuf(pack_application_exception(
                    name, seqid, AE_INTERNAL_ERROR, str(e))))
            return
        if mtype != MT_ONEWAY:
            sock.write(IOBuf(pack_message(MT_REPLY, name, seqid,
                                          result or b"\x00")))

    # ------------------------------------------------------------- send path
    def issue_request(self, sock, meta, payload: bytes,
                      attachment: bytes = b"", checksum: bool = False,
                      id_wait=None) -> int:
        cst: _ThriftClientState = init_socket_state(
            sock, "thrift_client", _ThriftClientState, self)
        with cst.lock:
            seqid = cst.next_seqid
            cst.next_seqid = (cst.next_seqid + 1) & 0x7FFFFFFF or 1
            cst.calls[seqid] = (meta.correlation_id, meta.attempt_version)
        frame = pack_message(MT_CALL, meta.request.method_name, seqid,
                             payload or b"\x00")
        rc = sock.write(IOBuf(frame), id_wait=id_wait)
        if rc != 0:
            with cst.lock:
                cst.calls.pop(seqid, None)
        return rc

    # ------------------------------------------------------ engine contracts
    @staticmethod
    def split_attachment(msg: ParsedMessage) -> Tuple[bytes, bytes]:
        return msg.body.tobytes(), b""

    @staticmethod
    def verify_checksum(meta, payload: bytes) -> bool:
        return True
