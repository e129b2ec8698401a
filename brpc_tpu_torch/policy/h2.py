"""HTTP/2 connection layer (RFC 7540) — framing, streams, flow control.

Counterpart of the reference's ``policy/http2_rpc_protocol.cpp`` connection
machinery (H2Context/H2Stream there): per-connection HPACK contexts, frame
codec, SETTINGS negotiation, credit-based send windows with queued flushing
on WINDOW_UPDATE, and CONTINUATION reassembly. Protocol semantics (gRPC
message framing, status mapping, dispatch) live in ``grpc_protocol.py``.

The port's copy of the JAX package's ``policy/h2.py``, with the same bytes
on the wire. It refuses what the port's engine (``native/dataplane.cpp``)
refuses on the same port: a SETTINGS_INITIAL_WINDOW_SIZE above 2^31-1 is a
connection error (GOAWAY with FLOW_CONTROL_ERROR, RFC 9113 §6.5.2), and a
HEADERS that would open a stream past the advertised
MAX_CONCURRENT_STREAMS (``MAX_STREAMS``) gets RST_STREAM(REFUSED_STREAM).

Thread model: the receive path (``feed``) runs on the socket's serial parse
loop; the send path (``send_headers``/``send_data``) is called from fiber
workers. Send-side state — the HPACK encoder (whose emission order must
match wire order) and the credit windows — is guarded by ``send_lock``, and
every header block is encoded+written under it in one socket write.
"""

from __future__ import annotations

import struct
import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.policy.hpack import HpackDecoder, HpackEncoder, HpackError

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# frame types (RFC 7540 §6)
DATA = 0x0
HEADERS = 0x1
PRIORITY = 0x2
RST_STREAM = 0x3
SETTINGS = 0x4
PUSH_PROMISE = 0x5
PING = 0x6
GOAWAY = 0x7
WINDOW_UPDATE = 0x8
CONTINUATION = 0x9

FLAG_END_STREAM = 0x1
FLAG_ACK = 0x1
FLAG_END_HEADERS = 0x4
FLAG_PADDED = 0x8
FLAG_PRIORITY = 0x20

# settings ids (RFC 7540 §6.5.2)
S_HEADER_TABLE_SIZE = 0x1
S_ENABLE_PUSH = 0x2
S_MAX_CONCURRENT_STREAMS = 0x3
S_INITIAL_WINDOW_SIZE = 0x4
S_MAX_FRAME_SIZE = 0x5
S_MAX_HEADER_LIST_SIZE = 0x6

# error codes (RFC 7540 §7)
NO_ERROR = 0x0
PROTOCOL_ERROR = 0x1
INTERNAL_ERROR = 0x2
FLOW_CONTROL_ERROR = 0x3
STREAM_CLOSED = 0x5
FRAME_SIZE_ERROR = 0x6
REFUSED_STREAM = 0x7
CANCEL = 0x8

DEFAULT_WINDOW = 65535
DEFAULT_MAX_FRAME = 16384
# our receive windows: effectively unbounded, replenished by thresholds
RECV_STREAM_WINDOW = (1 << 31) - 1
CONN_REPLENISH_AT = 1 << 28
STREAM_REPLENISH_AT = 1 << 26
# reassembled header block ceiling (CONTINUATION-flood guard)
MAX_HEADER_BLOCK = 1 << 20
# our advertised MAX_CONCURRENT_STREAMS, enforced on the server side
MAX_STREAMS = 1024
MAX_WINDOW = (1 << 31) - 1


class H2Error(Exception):
    def __init__(self, code: int, msg: str = ""):
        super().__init__(msg or f"h2 error {code}")
        self.h2_code = code


def pack_frame(ftype: int, flags: int, stream_id: int, payload: bytes) -> bytes:
    n = len(payload)
    return (bytes([(n >> 16) & 0xFF, (n >> 8) & 0xFF, n & 0xFF, ftype, flags])
            + struct.pack("!I", stream_id & 0x7FFFFFFF) + payload)


def pack_settings(pairs: List[Tuple[int, int]], ack: bool = False) -> bytes:
    payload = b"".join(struct.pack("!HI", k, v) for k, v in pairs)
    return pack_frame(SETTINGS, FLAG_ACK if ack else 0, 0, payload)


class H2Stream:
    __slots__ = ("sid", "headers", "trailers", "data", "recv_end",
                 "send_window", "pending", "pending_end", "end_sent", "rst",
                 "headers_done", "recv_consumed", "user", "pending_trailers",
                 "close_on_end")

    def __init__(self, sid: int, send_window: int):
        self.sid = sid
        self.headers: Optional[List[Tuple[str, str]]] = None
        self.trailers: Optional[List[Tuple[str, str]]] = None
        self.data = bytearray()
        self.recv_end = False
        self.headers_done = False
        self.send_window = send_window
        self.pending = deque()       # queued bytes blocked on flow control
        self.pending_end = False     # END_STREAM owed after pending drains
        self.end_sent = False
        self.rst = False
        self.recv_consumed = 0
        self.user = None             # per-stream payload for the protocol
        self.pending_trailers = None  # trailers owed after pending drains
        self.close_on_end = False    # auto-pop once END_STREAM flushed


class H2Conn:
    """One HTTP/2 connection riding a Socket. Role 'client' or 'server'."""

    def __init__(self, sock, role: str,
                 on_stream_complete: Callable,
                 on_stream_reset: Optional[Callable] = None):
        self.sock = sock
        self.role = role
        self.on_stream_complete = on_stream_complete  # (conn, H2Stream, trailers_only)
        self.on_stream_reset = on_stream_reset        # (conn, sid, h2_code)
        self.encoder = HpackEncoder()
        self.decoder = HpackDecoder()
        self.send_lock = threading.Lock()
        self.streams: Dict[int, H2Stream] = {}
        self.next_stream_id = 1 if role == "client" else 2
        self.conn_send_window = DEFAULT_WINDOW
        self.peer_initial_window = DEFAULT_WINDOW
        self.peer_max_frame = DEFAULT_MAX_FRAME
        self.conn_recv_consumed = 0
        self.goaway_received = False
        self.preface_received = role == "client"  # only servers expect one
        self.settings_acked = False
        # CONTINUATION reassembly
        self._hdr_block: Optional[bytearray] = None
        self._hdr_sid = 0
        self._hdr_flags = 0
        self.calls: Dict[int, object] = {}  # client: sid -> call context

    # ------------------------------------------------------------- handshake
    def send_preamble(self) -> None:
        """Client preface / server settings — the first bytes on the wire."""
        out = IOBuf()
        if self.role == "client":
            out.append(PREFACE)
        out.append(pack_settings([
            (S_INITIAL_WINDOW_SIZE, RECV_STREAM_WINDOW),
            (S_MAX_CONCURRENT_STREAMS, MAX_STREAMS),
        ]))
        out.append(pack_frame(WINDOW_UPDATE, 0, 0,
                              struct.pack("!I", RECV_STREAM_WINDOW - DEFAULT_WINDOW)))
        self.sock.write(out)

    # ------------------------------------------------------------- send side
    def _emit_headers_locked(self, sid: int, headers: List[Tuple[str, str]],
                             end_stream: bool, id_wait=None) -> int:
        """Encode+write one header block (HPACK order == wire order), split
        into HEADERS (+CONTINUATIONs) per the peer's frame limit. Caller
        holds send_lock."""
        block = self.encoder.encode(headers)
        frames = IOBuf()
        first, rest = block[:self.peer_max_frame], block[self.peer_max_frame:]
        flags = (FLAG_END_STREAM if end_stream else 0)
        if not rest:
            flags |= FLAG_END_HEADERS
        frames.append(pack_frame(HEADERS, flags, sid, first))
        while rest:
            chunk, rest = rest[:self.peer_max_frame], rest[self.peer_max_frame:]
            frames.append(pack_frame(
                CONTINUATION, FLAG_END_HEADERS if not rest else 0,
                sid, chunk))
        return self.sock.write(frames, id_wait=id_wait)

    def send_headers(self, sid: int, headers: List[Tuple[str, str]],
                     end_stream: bool = False, id_wait=None) -> int:
        with self.send_lock:
            return self._emit_headers_locked(sid, headers, end_stream, id_wait)

    def open_stream_with_headers(self, headers: List[Tuple[str, str]],
                                 end_stream: bool = False, id_wait=None,
                                 call_ctx=None) -> Tuple[H2Stream, int]:
        """Allocate a stream id and emit its HEADERS atomically, so stream
        ids appear on the wire in increasing order (RFC 7540 §5.1.1) and a
        response can never beat the call registration."""
        with self.send_lock:
            sid = self.next_stream_id
            self.next_stream_id += 2
            st = H2Stream(sid, self.peer_initial_window)
            self.streams[sid] = st
            if call_ctx is not None:
                self.calls[sid] = call_ctx
            rc = self._emit_headers_locked(sid, headers, end_stream, id_wait)
            return st, rc

    def send_trailers(self, sid: int, trailers: List[Tuple[str, str]]) -> None:
        """Queue the trailing header block; it must follow all DATA on the
        wire, so it waits for any flow-control-blocked bytes to drain."""
        with self.send_lock:
            st = self.streams.get(sid)
            if st is None or st.rst:
                return
            if st.pending:
                st.pending_trailers = trailers
            else:
                self._emit_trailers_locked(st, trailers)

    def _emit_trailers_locked(self, st: H2Stream, trailers) -> None:
        st.end_sent = True
        self._emit_headers_locked(st.sid, trailers, end_stream=True)
        if self.role == "server":  # response fully sent — stream is done
            self.streams.pop(st.sid, None)

    def send_data(self, sid: int, data: bytes, end_stream: bool = True) -> int:
        """Flow-controlled DATA: write what the windows allow, queue the
        rest for WINDOW_UPDATE-driven flushing."""
        with self.send_lock:
            st = self.streams.get(sid)
            if st is None or st.rst:
                return 0
            if data:
                st.pending.append(memoryview(bytes(data)))
            # empty payloads only carry END_STREAM — a zero-length pending
            # head would wedge the flush loop (allowed=0) and never emit it
            if end_stream:
                st.pending_end = True
            return self._flush_stream_locked(st)

    def _flush_stream_locked(self, st: H2Stream) -> int:
        out = IOBuf()
        while st.pending:
            head = st.pending[0]
            allowed = min(len(head), st.send_window, self.conn_send_window,
                          self.peer_max_frame)
            if allowed <= 0:
                break
            chunk = head[:allowed]
            if allowed == len(head):
                st.pending.popleft()
            else:
                st.pending[0] = head[allowed:]
            st.send_window -= allowed
            self.conn_send_window -= allowed
            end = (not st.pending) and st.pending_end
            if end:
                st.end_sent = True
            out.append(pack_frame(DATA, FLAG_END_STREAM if end else 0,
                                  st.sid, bytes(chunk)))
        if st.pending_end and not st.pending and not st.end_sent:
            # END_STREAM owed but no bytes left to carry it (empty message)
            st.end_sent = True
            out.append(pack_frame(DATA, FLAG_END_STREAM, st.sid, b""))
        rc = self.sock.write(out) if len(out) else 0
        if not st.pending and st.pending_trailers is not None:
            trailers, st.pending_trailers = st.pending_trailers, None
            self._emit_trailers_locked(st, trailers)
        if st.end_sent and st.close_on_end:
            # deferred close: only once the flow-controlled tail (and its
            # END_STREAM) actually went out — an immediate close_stream
            # would strand pending bytes when the peer's window is small
            self.streams.pop(st.sid, None)
        return rc

    def _flush_all_locked(self) -> None:
        for st in list(self.streams.values()):
            if st.pending:
                self._flush_stream_locked(st)

    def send_rst(self, sid: int, code: int) -> None:
        self.sock.write(pack_frame(RST_STREAM, 0, sid, struct.pack("!I", code)))

    def send_goaway(self, code: int, last_sid: int = 0) -> None:
        self.sock.write(pack_frame(GOAWAY, 0, 0,
                                   struct.pack("!II", last_sid, code)))

    def close_stream(self, sid: int) -> None:
        with self.send_lock:
            self.streams.pop(sid, None)
            self.calls.pop(sid, None)

    # ------------------------------------------------------------ recv side
    def feed(self, buf: IOBuf) -> None:
        """Consume every complete frame in buf (serial parse loop). Raises
        H2Error for connection-level errors."""
        if not self.preface_received:
            if len(buf) < len(PREFACE):
                return
            got = buf.fetch(len(PREFACE))
            if got != PREFACE:
                raise H2Error(PROTOCOL_ERROR, "bad connection preface")
            buf.pop_front(len(PREFACE))
            self.preface_received = True
        while True:
            if len(buf) < 9:
                return
            head = buf.fetch(9)
            length = (head[0] << 16) | (head[1] << 8) | head[2]
            ftype, flags = head[3], head[4]
            sid = struct.unpack("!I", head[5:9])[0] & 0x7FFFFFFF
            if length > (1 << 24):
                raise H2Error(FRAME_SIZE_ERROR, "frame too large")
            if len(buf) < 9 + length:
                return
            buf.pop_front(9)
            payload = buf.cutn(length).tobytes()
            self._on_frame(ftype, flags, sid, payload)

    # ---------------------------------------------------------- frame logic
    def _on_frame(self, ftype: int, flags: int, sid: int, payload: bytes) -> None:
        if self._hdr_block is not None and ftype != CONTINUATION:
            raise H2Error(PROTOCOL_ERROR, "expected CONTINUATION")
        if ftype == DATA:
            self._on_data(flags, sid, payload)
        elif ftype == HEADERS:
            # RFC 7540 §6.2 field order: pad length byte (if PADDED), THEN
            # priority fields (if PRIORITY), then the fragment + padding
            pad = 0
            if flags & FLAG_PADDED:
                if not payload:
                    raise H2Error(FRAME_SIZE_ERROR, "HEADERS missing pad len")
                pad = payload[0]
                payload = payload[1:]
            if flags & FLAG_PRIORITY:
                if len(payload) < 5:
                    raise H2Error(FRAME_SIZE_ERROR,
                                  "HEADERS missing priority fields")
                payload = payload[5:]
            if pad > len(payload):
                raise H2Error(PROTOCOL_ERROR, "padding exceeds payload")
            payload = payload[:len(payload) - pad]
            if len(payload) > MAX_HEADER_BLOCK:
                raise H2Error(PROTOCOL_ERROR, "header block too large")
            self._hdr_block = bytearray(payload)
            self._hdr_sid = sid
            self._hdr_flags = flags
            if flags & FLAG_END_HEADERS:
                self._finish_header_block()
        elif ftype == CONTINUATION:
            if self._hdr_block is None or sid != self._hdr_sid:
                raise H2Error(PROTOCOL_ERROR, "unexpected CONTINUATION")
            self._hdr_block += payload
            if len(self._hdr_block) > MAX_HEADER_BLOCK:
                # unbounded reassembly is the h2 CONTINUATION-flood DoS
                raise H2Error(PROTOCOL_ERROR, "header block too large")
            if flags & FLAG_END_HEADERS:
                self._finish_header_block()
        elif ftype == SETTINGS:
            self._on_settings(flags, payload)
        elif ftype == WINDOW_UPDATE:
            self._on_window_update(sid, payload)
        elif ftype == PING:
            if not flags & FLAG_ACK:
                self.sock.write(pack_frame(PING, FLAG_ACK, 0, payload))
        elif ftype == RST_STREAM:
            code = struct.unpack("!I", payload[:4])[0] if len(payload) >= 4 else 0
            st = self.streams.get(sid)
            if st is not None:
                st.rst = True
            if self.on_stream_reset is not None:
                self.on_stream_reset(self, sid, code)
            self.close_stream(sid)
        elif ftype == GOAWAY:
            self.goaway_received = True
        elif ftype == PUSH_PROMISE:
            raise H2Error(PROTOCOL_ERROR, "push not enabled")
        # PRIORITY and unknown frame types: ignore (RFC 7540 §4.1)

    def _on_data(self, flags: int, sid: int, payload: bytes) -> None:
        # flow-control credits cover the WHOLE frame payload, padding
        # included (RFC 7540 §6.9.1) — account before stripping
        frame_len = len(payload)
        if flags & FLAG_PADDED:
            if not payload:
                raise H2Error(FRAME_SIZE_ERROR, "DATA missing pad length")
            pad = payload[0]
            if pad > len(payload) - 1:
                raise H2Error(PROTOCOL_ERROR, "padding exceeds payload")
            payload = payload[1:len(payload) - pad]
        st = self.streams.get(sid)
        if st is not None and st.recv_end:
            raise H2Error(STREAM_CLOSED, "DATA after END_STREAM")
        if st is not None and not st.rst:
            st.data += payload
            st.recv_consumed += frame_len
            if st.recv_consumed > STREAM_REPLENISH_AT and not flags & FLAG_END_STREAM:
                self.sock.write(pack_frame(
                    WINDOW_UPDATE, 0, sid,
                    struct.pack("!I", st.recv_consumed)))
                st.recv_consumed = 0
        # connection window credits are consumed regardless of stream state
        self.conn_recv_consumed += frame_len
        if self.conn_recv_consumed > CONN_REPLENISH_AT:
            self.sock.write(pack_frame(
                WINDOW_UPDATE, 0, 0,
                struct.pack("!I", self.conn_recv_consumed)))
            self.conn_recv_consumed = 0
        if st is not None and flags & FLAG_END_STREAM:
            st.recv_end = True
            self.on_stream_complete(self, st, trailers_only=False)

    def _finish_header_block(self) -> None:
        block, sid, flags = bytes(self._hdr_block), self._hdr_sid, self._hdr_flags
        self._hdr_block = None
        try:
            headers = self.decoder.decode(block)
        except HpackError as e:
            raise H2Error(INTERNAL_ERROR, f"hpack: {e}")
        st = self.streams.get(sid)
        if st is None:
            if self.role != "server":
                return  # response headers for a finished/unknown stream
            if len(self.streams) >= MAX_STREAMS:
                # past the advertised limit (RFC 9113 §5.1.2): refuse the
                # stream after decoding its block (the HPACK table stays in
                # step); its DATA then finds no stream
                self.send_rst(sid, REFUSED_STREAM)
                return
            st = H2Stream(sid, self.peer_initial_window)
            self.streams[sid] = st
        if st.recv_end:
            # a completed request was already dispatched — a second
            # END_STREAM must not run user code twice
            raise H2Error(STREAM_CLOSED, "HEADERS after END_STREAM")
        if not st.headers_done:
            st.headers = headers
            st.headers_done = True
        else:
            st.trailers = headers
        if flags & FLAG_END_STREAM:
            st.recv_end = True
            self.on_stream_complete(self, st,
                                    trailers_only=st.trailers is not None)

    def _on_settings(self, flags: int, payload: bytes) -> None:
        if flags & FLAG_ACK:
            self.settings_acked = True
            return
        flush = False
        with self.send_lock:
            for off in range(0, len(payload) - 5, 6):
                k, v = struct.unpack_from("!HI", payload, off)
                if k == S_INITIAL_WINDOW_SIZE:
                    if v > MAX_WINDOW:
                        raise H2Error(FLOW_CONTROL_ERROR,
                                      "INITIAL_WINDOW_SIZE above 2^31-1")
                    delta = v - self.peer_initial_window
                    self.peer_initial_window = v
                    for st in self.streams.values():
                        st.send_window += delta
                    flush = delta > 0
                elif k == S_MAX_FRAME_SIZE:
                    if DEFAULT_MAX_FRAME <= v <= (1 << 24) - 1:
                        self.peer_max_frame = v
                elif k == S_HEADER_TABLE_SIZE:
                    self.encoder.table.resize(min(v, 4096))
            if flush:
                self._flush_all_locked()
        self.sock.write(pack_settings([], ack=True))

    def _on_window_update(self, sid: int, payload: bytes) -> None:
        if len(payload) < 4:
            raise H2Error(FRAME_SIZE_ERROR, "short WINDOW_UPDATE")
        inc = struct.unpack("!I", payload[:4])[0] & 0x7FFFFFFF
        with self.send_lock:
            if sid == 0:
                self.conn_send_window += inc
                self._flush_all_locked()
            else:
                st = self.streams.get(sid)
                if st is not None:
                    st.send_window += inc
                    if st.pending:
                        self._flush_stream_locked(st)
