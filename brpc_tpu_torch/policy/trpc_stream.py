"""trpc_stream — the stream frame protocol.

Counterpart of the reference's ``policy/streaming_rpc_protocol.cpp`` ("STRM"
frames parsed off the same connection as RPC traffic). Wire: ``b"TSTR"`` +
u32 meta_size + u32 body_size, meta = StreamFrameMeta. Frames address the
DESTINATION stream id directly; routing is a versioned-pool lookup, so
frames for a closed stream drop harmlessly (stale-id semantics).
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.policy.trpc_std import max_body_size
from brpc_tpu_torch.proto import rpc_meta_pb2
from brpc_tpu_torch.rpc.protocol import (
    PARSE_BAD,
    PARSE_NOT_ENOUGH_DATA,
    PARSE_TRY_OTHERS,
    ParsedMessage,
    Protocol,
)

MAGIC = b"TSTR"
HEADER_FMT = "!4sII"
HEADER_SIZE = struct.calcsize(HEADER_FMT)


def pack_stream_frame(meta: rpc_meta_pb2.StreamFrameMeta,
                      payload: bytes) -> IOBuf:
    meta_bytes = meta.SerializeToString()
    out = IOBuf()
    out.append(struct.pack(HEADER_FMT, MAGIC, len(meta_bytes), len(payload)))
    out.append(meta_bytes)
    if payload:
        out.append(payload)
    return out


class TrpcStreamProtocol(Protocol):
    name = "trpc_stream"
    magic = MAGIC
    inline_process = True  # frame order = arrival order; see Protocol

    def parse(self, buf: IOBuf) -> Tuple[int, Optional[ParsedMessage]]:
        if len(buf) < HEADER_SIZE:
            head = buf.fetch(min(len(buf), 4))
            if head and not MAGIC.startswith(head):
                return PARSE_TRY_OTHERS, None
            return PARSE_NOT_ENOUGH_DATA, None
        magic, meta_size, body_size = struct.unpack(
            HEADER_FMT, buf.fetch(HEADER_SIZE))
        if magic != MAGIC:
            return PARSE_TRY_OTHERS, None
        if meta_size + body_size > max_body_size():
            return PARSE_BAD, None  # corrupt size field: fail the socket
        total = HEADER_SIZE + meta_size + body_size
        if len(buf) < total:
            return PARSE_NOT_ENOUGH_DATA, None
        buf.pop_front(HEADER_SIZE)
        meta_bytes = buf.cutn(meta_size).tobytes()
        body = buf.cutn(body_size)
        try:
            meta = rpc_meta_pb2.StreamFrameMeta.FromString(meta_bytes)
        except Exception:
            return PARSE_BAD, None
        return 0, ParsedMessage(self, meta, body)

    def process(self, msg: ParsedMessage, server) -> None:
        from brpc_tpu_torch.rpc.stream import (
            FRAME_CLOSE,
            FRAME_DATA,
            FRAME_FEEDBACK,
            get_stream,
        )

        meta = msg.meta
        stream = get_stream(meta.stream_id)
        if stream is None:
            return  # closed/stale stream: drop
        if meta.frame_type == FRAME_DATA:
            stream.on_data(meta.seq, msg.body.tobytes())
        elif meta.frame_type == FRAME_FEEDBACK:
            stream.on_feedback(meta.consumed_bytes)
        elif meta.frame_type == FRAME_CLOSE:
            stream.close(send_frame=False)
