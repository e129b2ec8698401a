"""trpc_std — the canonical binary protocol of the rebuild.

Counterpart of the reference's baidu_std (``policy/baidu_rpc_protocol.cpp``):
fixed 12-byte header ``b"TRPC" + u32 meta_size + u32 body_size`` followed by
an RpcMeta protobuf and the body (serialized user message + optional trailing
attachment of ``meta.attachment_size`` bytes). One protocol serves both
directions; requests and responses are distinguished by which sub-meta is set.

The server-side dispatch mirrors ``ProcessRpcRequest`` (baidu_rpc_protocol.
cpp:565): admission -> method lookup -> parse -> user code -> SendResponse;
the client side mirrors ``ProcessRpcResponse`` (:907): verify call id ->
deserialize -> end RPC.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.butil.misc import crc32c
from brpc_tpu_torch.proto import rpc_meta_pb2
from brpc_tpu_torch.rpc.protocol import (
    PARSE_BAD,
    PARSE_NOT_ENOUGH_DATA,
    PARSE_TRY_OTHERS,
    ParsedMessage,
    PendingBodyCursor,
    Protocol,
    can_stream_body,
    stream_body_min,
)

MAGIC = b"TRPC"
HEADER_FMT = "!4sII"
HEADER_SIZE = struct.calcsize(HEADER_FMT)  # 12
MAX_BODY_SIZE = 1 << 31  # hard ceiling; the runtime limit is the flag


def max_body_size() -> int:
    """Largest accepted wire message — runtime-settable via /flags."""
    from brpc_tpu_torch import flags as _flags

    return min(_flags.get("max_body_size"), MAX_BODY_SIZE)


class TrpcStdProtocol(Protocol):
    name = "trpc_std"
    magic = MAGIC
    stateful = True  # parse(buf, sock): registers streaming body cursors

    # ------------------------------------------------------------------ wire
    def parse(self, buf: IOBuf,
              sock=None) -> Tuple[int, Optional[ParsedMessage]]:
        if len(buf) < HEADER_SIZE:
            # can we at least rule the protocol out?
            head = buf.fetch(min(len(buf), 4))
            if head and not MAGIC.startswith(head):
                return PARSE_TRY_OTHERS, None
            return PARSE_NOT_ENOUGH_DATA, None
        header = buf.fetch(HEADER_SIZE)
        magic, meta_size, body_size = struct.unpack(HEADER_FMT, header)
        if magic != MAGIC:
            return PARSE_TRY_OTHERS, None
        if meta_size + body_size > max_body_size():
            return PARSE_BAD, None
        total = HEADER_SIZE + meta_size + body_size
        if len(buf) < total:
            if (body_size >= stream_body_min()
                    and len(buf) >= HEADER_SIZE + meta_size
                    and can_stream_body(sock)):
                # header + meta are in hand and the body is large: consume
                # what has arrived NOW and register a cursor for the rest,
                # so the transport's flow-control credits return mid-message
                # instead of after the whole body buffers up
                buf.pop_front(HEADER_SIZE)
                meta_bytes = buf.cutn(meta_size).tobytes()
                try:
                    meta = rpc_meta_pb2.RpcMeta.FromString(meta_bytes)
                except Exception:
                    return PARSE_BAD, None
                cursor = PendingBodyCursor(
                    self, body_size,
                    finish=lambda cur, meta=meta: ParsedMessage(
                        self, meta, cur.body()))
                cursor.feed(buf)
                sock.pending_body = cursor
            return PARSE_NOT_ENOUGH_DATA, None
        buf.pop_front(HEADER_SIZE)
        meta_bytes = buf.cutn(meta_size).tobytes()
        body = buf.cutn(body_size)
        try:
            meta = rpc_meta_pb2.RpcMeta.FromString(meta_bytes)
        except Exception:
            return PARSE_BAD, None
        return 0, ParsedMessage(self, meta, body)

    @staticmethod
    def _pack(meta: rpc_meta_pb2.RpcMeta, payload: bytes,
              attachment: bytes = b"", checksum: bool = False) -> IOBuf:
        meta.attachment_size = len(attachment)
        body_size = len(payload) + len(attachment)
        if payload and checksum:
            meta.checksum = crc32c(payload)
        meta_bytes = meta.SerializeToString()
        out = IOBuf()
        out.append(struct.pack(HEADER_FMT, MAGIC, len(meta_bytes), body_size))
        out.append(meta_bytes)
        if payload:
            out.append(payload)
        if attachment:
            out.append(attachment)
        return out

    def pack_request(self, meta, payload: bytes, attachment: bytes = b"",
                     checksum: bool = False) -> IOBuf:
        return self._pack(meta, payload, attachment, checksum)

    def pack_response(self, meta, payload: bytes, attachment: bytes = b"",
                      checksum: bool = False) -> IOBuf:
        return self._pack(meta, payload, attachment, checksum)

    # ------------------------------------------------------------ server side
    def process_request(self, msg: ParsedMessage, server) -> None:
        # deferred import: protocol layer must not depend on server at import
        from brpc_tpu_torch.rpc.server_processing import process_rpc_request

        process_rpc_request(self, msg, server)

    # ------------------------------------------------------------ client side
    def process_response(self, msg: ParsedMessage) -> None:
        from brpc_tpu_torch.rpc.controller import handle_response_message

        handle_response_message(msg)

    def claim_cid(self, msg: ParsedMessage):
        meta = msg.meta
        if meta.HasField("response"):
            return meta.correlation_id
        return None

    # --------------------------------------------------------------- helpers
    @staticmethod
    def split_attachment(msg: ParsedMessage) -> Tuple[bytes, bytes]:
        """body -> (serialized message bytes, attachment bytes).

        Splits by ref first (cutn), so each side is materialized exactly
        once — flatten-then-slice copied an attachment'd body twice, and on
        the tpu tunnel's zero-copy receive path the body refs are borrowed
        registered blocks whose flow-control credit returns when these
        copies drop the refs."""
        att_size = msg.meta.attachment_size
        body = msg.body
        if att_size and att_size <= len(body):
            payload = body.cutn(len(body) - att_size).tobytes()
            return payload, body.cutn(att_size).tobytes()
        data = body.tobytes()
        body.clear()  # drop refs now, not at message GC
        return data, b""

    @staticmethod
    def verify_checksum(meta, payload: bytes) -> bool:
        return not meta.checksum or crc32c(payload) == meta.checksum
