"""rtmp — RTMP live-media protocol: server + client (reference
``policy/rtmp_protocol.cpp`` / ``rtmp.cpp``; re-derived subset covering the
live streaming core: handshake, chunk streams, AMF0 command plane,
publish/play relay).

Server side plugs into the normal Server like redis/mongo services::

    server = Server(ServerOptions(rtmp_service=RtmpService()))
    server.start("127.0.0.1:1935")

A publisher connects, issues connect/createStream/publish and pushes
audio (8) / video (9) / data (18) messages; players issuing play on the
same stream name receive every message from that point (live relay, the
reference's RtmpServerStream model). The chunk layer handles fmt0-3
headers, per-csid state, SetChunkSize both ways, and extended timestamps.

``RtmpClient`` is the client stub (reference RtmpClientStream):
blocking control plane + a reader thread delivering frames to callbacks —
examples/tests drive a publisher + player pair end to end.

The port's copy of the JAX package's ``policy/rtmp.py``: the same bytes on
the wire, so either package's client talks to the other's server.
"""

from __future__ import annotations

import os
import socket as _socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.policy import amf0
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.protocol import (
    PARSE_BAD,
    PARSE_NOT_ENOUGH_DATA,
    PARSE_TRY_OTHERS,
    Protocol,
)

HANDSHAKE_SIZE = 1536
RTMP_VERSION = 3

MSG_SET_CHUNK_SIZE = 1
MSG_ACK = 3
MSG_USER_CONTROL = 4
MSG_WINDOW_ACK = 5
MSG_SET_PEER_BW = 6
MSG_AUDIO = 8
MSG_VIDEO = 9
MSG_DATA_AMF0 = 18
MSG_COMMAND_AMF0 = 20

UC_STREAM_BEGIN = 0

DEFAULT_CHUNK = 128
OUR_CHUNK = 4096
MAX_MSG = 16 << 20


# ------------------------------------------------------------ chunk muxing
def pack_chunks(csid: int, mtype: int, stream_id: int, payload: bytes,
                timestamp: int = 0, chunk_size: int = OUR_CHUNK) -> bytes:
    """One message as a fmt0 chunk + fmt3 continuations. Timestamps past
    0xFFFFFF emit the extended-timestamp field on the fmt0 header AND on
    every fmt3 continuation (spec §5.3.1.3)."""
    ext = timestamp >= 0xFFFFFF
    ts_field = 0xFFFFFF if ext else timestamp
    ext_bytes = struct.pack(">I", timestamp & 0xFFFFFFFF) if ext else b""
    out = bytearray()
    out += bytes([(0 << 6) | csid])
    out += struct.pack(">I", ts_field)[1:]      # 24-bit timestamp
    out += struct.pack(">I", len(payload))[1:]  # 24-bit length
    out += bytes([mtype])
    out += struct.pack("<I", stream_id)         # little-endian, per spec
    out += ext_bytes
    pos = 0
    first = True
    while pos < len(payload) or first:
        if not first:
            out += bytes([(3 << 6) | csid])
            out += ext_bytes
        out += payload[pos:pos + chunk_size]
        pos += chunk_size
        first = False
    return bytes(out)


class _ChunkState:
    """Per-csid demux state (timestamp/length/type carry over fmt1-3)."""

    __slots__ = ("timestamp", "ts_delta", "length", "mtype", "stream_id",
                 "acc", "ext_ts")

    def __init__(self):
        self.timestamp = 0
        self.ts_delta = 0
        self.length = 0
        self.mtype = 0
        self.stream_id = 0
        self.acc = bytearray()
        self.ext_ts = False  # last type-0/1/2 header carried 0xFFFFFF


class ChunkReader:
    """Incremental RTMP chunk demuxer: feed bytes, get whole messages."""

    def __init__(self):
        self.chunk_size = DEFAULT_CHUNK
        self._states: Dict[int, _ChunkState] = {}

    def feed(self, buf: IOBuf) -> List[Tuple[int, int, int, bytes, int]]:
        """Consume complete chunks; returns [(csid, mtype, stream_id,
        payload, timestamp)] for every COMPLETED message. Raises
        ValueError on malformed input."""
        done = []
        while True:
            if len(buf) < 1:
                return done
            head = buf.fetch(min(len(buf), 18))
            fmt = head[0] >> 6
            csid = head[0] & 0x3F
            pos = 1
            if csid == 0:
                if len(head) < 2:
                    return done
                csid = 64 + head[1]
                pos = 2
            elif csid == 1:
                if len(head) < 3:
                    return done
                csid = 64 + head[1] + (head[2] << 8)
                pos = 3
            need_hdr = {0: 11, 1: 7, 2: 3, 3: 0}[fmt]
            if len(buf) < pos + need_hdr:
                return done
            hdr = buf.fetch(pos + need_hdr + 4)  # +4 for possible ext ts
            st = self._states.get(csid)
            if st is None:
                if fmt != 0:
                    raise ValueError(f"chunk fmt{fmt} before fmt0 on "
                                     f"csid {csid}")
                st = self._states[csid] = _ChunkState()
            p = pos
            ts = None
            if fmt <= 2:
                ts = (hdr[p] << 16) | (hdr[p + 1] << 8) | hdr[p + 2]
                p += 3
            if fmt <= 1:
                new_len = (hdr[p] << 16) | (hdr[p + 1] << 8) | hdr[p + 2]
                if st.acc and new_len != st.length:
                    # a header must not redefine the length mid-message
                    raise ValueError("chunk header changes length "
                                     "mid-message")
                st.length = new_len
                st.mtype = hdr[p + 3]
                p += 4
            if fmt == 0:
                st.stream_id = struct.unpack_from("<I", hdr, p)[0]
                p += 4
            if fmt <= 2:
                st.ext_ts = ts == 0xFFFFFF
            # when the governing header carried 0xFFFFFF, EVERY chunk of
            # the message (fmt3 continuations included) carries the 4-byte
            # extended timestamp (spec §5.3.1.3)
            if st.ext_ts:
                if len(buf) < p + 4:
                    return done
                if fmt <= 2:
                    ts = struct.unpack_from(">I", hdr, p)[0]
                p += 4
            if st.length > MAX_MSG:
                raise ValueError(f"rtmp message too large: {st.length}")
            if fmt == 0:
                st.timestamp = ts
            elif fmt in (1, 2):
                st.ts_delta = ts
                st.timestamp += ts
            take = min(self.chunk_size, st.length - len(st.acc))
            if len(buf) < p + take:
                return done
            buf.pop_front(p)
            st.acc += buf.cutn(take).tobytes()
            if len(st.acc) >= st.length:
                payload = bytes(st.acc)
                st.acc = bytearray()
                if st.mtype == MSG_SET_CHUNK_SIZE and len(payload) >= 4:
                    # applies IMMEDIATELY (spec §5.4.1): later messages in
                    # this same burst are already chunked at the new size
                    size = struct.unpack(">I", payload[:4])[0] & 0x7FFFFFFF
                    if 1 <= size <= (1 << 24):
                        self.chunk_size = size
                done.append((csid, st.mtype, st.stream_id, payload,
                             st.timestamp))


# -------------------------------------------------------------- the service
class RtmpStream:
    """One live stream: a publisher relaying to subscribers."""

    def __init__(self, name: str):
        self.name = name
        self.publisher = None          # _RtmpConn
        self.subscribers: List[Tuple[object, int]] = []  # (conn, stream_id)
        self.metadata: Optional[bytes] = None  # last @setDataFrame payload
        self.lock = threading.Lock()


class RtmpService:
    """Server-side RTMP app: stream registry + relay (the reference's
    RtmpService/RtmpServerStream pair)."""

    def __init__(self):
        self._streams: Dict[str, RtmpStream] = {}
        self._lock = threading.Lock()

    def stream(self, name: str) -> RtmpStream:
        with self._lock:
            s = self._streams.get(name)
            if s is None:
                s = self._streams[name] = RtmpStream(name)
            return s

    # Attach under the registry lock: a lookup followed by a later attach
    # could otherwise interleave with release_if_idle deleting the entry,
    # leaving the publisher/viewer on an orphaned stream object forever.
    def attach_publisher(self, name: str, conn) -> RtmpStream:
        with self._lock:
            s = self._streams.get(name)
            if s is None:
                s = self._streams[name] = RtmpStream(name)
            with s.lock:
                s.publisher = conn
            return s

    def attach_subscriber(self, name: str, conn,
                          stream_id: int) -> Tuple[RtmpStream, bytes]:
        with self._lock:
            s = self._streams.get(name)
            if s is None:
                s = self._streams[name] = RtmpStream(name)
            with s.lock:
                s.subscribers.append((conn, stream_id))
                meta = s.metadata
            return s, meta

    def stream_names(self) -> List[str]:
        with self._lock:
            return sorted(self._streams)

    def release_if_idle(self, stream: "RtmpStream") -> None:
        """Drop a registry entry once nobody publishes or plays it — an
        untrusted publisher cycling fresh names must not grow the registry
        for the server's lifetime."""
        with self._lock:
            with stream.lock:
                idle = stream.publisher is None and not stream.subscribers
            if idle and self._streams.get(stream.name) is stream:
                del self._streams[stream.name]


# ------------------------------------------------------- server connection
class _RtmpConn:
    """Per-connection server state machine."""

    HS_C0C1 = 0
    HS_C2 = 1
    READY = 2

    def __init__(self, sock, service: RtmpService):
        self.sock = sock
        self.service = service
        self.phase = self.HS_C0C1
        self.reader = ChunkReader()
        self.next_stream_id = 1
        self.publishing: Optional[RtmpStream] = None
        self.playing: List[RtmpStream] = []

    # ---------------------------------------------------------- write side
    def send_msg(self, csid: int, mtype: int, stream_id: int,
                 payload: bytes, timestamp: int = 0) -> None:
        self.sock.write(IOBuf(pack_chunks(csid, mtype, stream_id, payload,
                                          timestamp=timestamp)))

    def send_command(self, stream_id: int, *values) -> None:
        self.send_msg(3, MSG_COMMAND_AMF0, stream_id, amf0.encode(*values))

    # ----------------------------------------------------------- dispatch
    def on_message(self, csid: int, mtype: int, stream_id: int,
                   payload: bytes, timestamp: int = 0) -> None:
        if mtype == MSG_SET_CHUNK_SIZE and len(payload) >= 4:
            size = struct.unpack(">I", payload[:4])[0] & 0x7FFFFFFF
            if 1 <= size <= (1 << 24):
                self.reader.chunk_size = size
            return
        if mtype == MSG_COMMAND_AMF0:
            self.on_command(stream_id, payload)
            return
        if mtype in (MSG_AUDIO, MSG_VIDEO, MSG_DATA_AMF0):
            self.on_media(mtype, payload, timestamp)
            return
        # ACK/window/user-control from clients: bookkeeping only

    def on_command(self, stream_id: int, payload: bytes) -> None:
        try:
            vals = amf0.decode_all(payload)
        except amf0.Amf0Error:
            self.sock.set_failed(errors.EREQUEST, "bad AMF0 command")
            return
        if not vals or not isinstance(vals[0], str):
            return
        cmd, txn = vals[0], vals[1] if len(vals) > 1 else 0.0
        if cmd == "connect":
            # window/bandwidth/StreamBegin preamble like real servers
            self.send_msg(2, MSG_WINDOW_ACK, 0, struct.pack(">I", 2500000))
            self.send_msg(2, MSG_SET_PEER_BW, 0,
                          struct.pack(">IB", 2500000, 2))
            self.send_msg(2, MSG_SET_CHUNK_SIZE, 0,
                          struct.pack(">I", OUR_CHUNK))
            self.send_command(
                0, "_result", txn,
                {"fmsVer": "BRPC-TPU/2", "capabilities": 31.0},
                {"level": "status", "code": "NetConnection.Connect.Success",
                 "description": "Connection succeeded."})
        elif cmd == "createStream":
            sid = self.next_stream_id
            self.next_stream_id += 1
            self.send_command(0, "_result", txn, None, float(sid))
        elif cmd == "publish":
            name = vals[3] if len(vals) > 3 and isinstance(vals[3], str) \
                else ""
            stream = self.service.attach_publisher(name, self)
            self.publishing = stream
            self.send_command(
                stream_id, "onStatus", 0.0, None,
                {"level": "status", "code": "NetStream.Publish.Start",
                 "description": f"{name} is now published."})
        elif cmd == "play":
            name = vals[3] if len(vals) > 3 and isinstance(vals[3], str) \
                else ""
            stream, meta = self.service.attach_subscriber(name, self,
                                                          stream_id)
            self.send_msg(2, MSG_USER_CONTROL, 0,
                          struct.pack(">HI", UC_STREAM_BEGIN, stream_id))
            self.send_command(
                stream_id, "onStatus", 0.0, None,
                {"level": "status", "code": "NetStream.Play.Start",
                 "description": f"Started playing {name}."})
            if meta:  # late joiners still get the stream metadata
                self.send_msg(5, MSG_DATA_AMF0, stream_id, meta)
            self.playing.append(stream)
        elif cmd == "deleteStream" or cmd == "closeStream":
            self.teardown()

    def on_media(self, mtype: int, payload: bytes,
                 timestamp: int = 0) -> None:
        stream = self.publishing
        if stream is None:
            return
        if mtype == MSG_DATA_AMF0:
            stream.metadata = payload
        with stream.lock:
            subs = list(stream.subscribers)
        for conn, sid in subs:
            try:
                conn.send_msg(5 if mtype != MSG_VIDEO else 6, mtype, sid,
                              payload, timestamp)
            except Exception:
                pass

    def teardown(self) -> None:
        released = []
        if self.publishing is not None:
            with self.publishing.lock:
                if self.publishing.publisher is self:
                    self.publishing.publisher = None
            released.append(self.publishing)
            self.publishing = None
        for stream in self.playing:
            with stream.lock:
                stream.subscribers = [(c, s) for c, s in stream.subscribers
                                      if c is not self]
            released.append(stream)
        self.playing = []
        for stream in released:
            self.service.release_if_idle(stream)


class RtmpProtocol(Protocol):
    """Wire adapter: handshake then chunk demux, riding the normal Socket/
    InputMessenger machinery (stateful protocol like tpu_ctrl)."""

    name = "rtmp"
    stateful = True
    inline_process = True  # chunk order is stream order

    def parse(self, buf: IOBuf, sock=None):
        conn: Optional[_RtmpConn] = getattr(sock, "rtmp_conn", None)
        if conn is None:
            srv = sock.owner_server if sock is not None else None
            service = getattr(srv.options, "rtmp_service", None) if srv \
                else None
            if service is None:
                return PARSE_TRY_OTHERS, None
            head = buf.fetch(1)
            if not head or head[0] != RTMP_VERSION:
                return PARSE_TRY_OTHERS, None
            if len(buf) < 1 + HANDSHAKE_SIZE:
                return PARSE_NOT_ENOUGH_DATA, None
            conn = _RtmpConn(sock, service)
            sock.rtmp_conn = conn
            sock.preferred_protocol = self
            sock.on_failed_hook = lambda code, reason: conn.teardown()
            # C0+C1 -> S0+S1+S2 (S2 echoes C1, RTMP spec §5.2)
            buf.pop_front(1)
            c1 = buf.cutn(HANDSHAKE_SIZE).tobytes()
            s1 = struct.pack(">II", int(time.time()) & 0x7FFFFFFF, 0) \
                + os.urandom(HANDSHAKE_SIZE - 8)
            sock.write(IOBuf(bytes([RTMP_VERSION]) + s1 + c1))
            conn.phase = _RtmpConn.HS_C2
            return PARSE_NOT_ENOUGH_DATA, None
        if conn.phase == _RtmpConn.HS_C2:
            if len(buf) < HANDSHAKE_SIZE:
                return PARSE_NOT_ENOUGH_DATA, None
            buf.pop_front(HANDSHAKE_SIZE)  # C2: ignore contents
            conn.phase = _RtmpConn.READY
        try:
            for csid, mtype, stream_id, payload, ts in conn.reader.feed(buf):
                conn.on_message(csid, mtype, stream_id, payload, ts)
        except ValueError:
            return PARSE_BAD, None
        return PARSE_NOT_ENOUGH_DATA, None

    def process(self, msg, server) -> None:  # all work happens in parse
        pass


# ----------------------------------------------------------------- client
class RtmpClient:
    """Minimal RTMP client (reference RtmpClientStream): blocking control
    plane + reader thread for media callbacks."""

    def __init__(self, host: str, port: int, app: str = "live",
                 timeout: float = 5.0):
        self._sock = _socket.create_connection((host, port), timeout=timeout)
        self._sock.settimeout(timeout)
        self._reader = ChunkReader()
        self._buf = IOBuf()
        self._results: Dict[float, list] = {}
        self._cv = threading.Condition()
        self._txn = 0.0
        self.on_frame: Optional[Callable[[int, int, bytes], None]] = None
        self._closed = False
        self._handshake()
        self._thread = threading.Thread(target=self._read_loop,
                                        name="rtmp-read", daemon=True)
        self._thread.start()
        # announce our chunk size BEFORE any message that exceeds the
        # 128-byte protocol default (RTMP spec §5.4.1)
        self._send_msg(2, MSG_SET_CHUNK_SIZE, 0, struct.pack(">I", OUR_CHUNK))
        self._command("connect", {"app": app, "tcUrl":
                                  f"rtmp://{host}:{port}/{app}"})

    # ----------------------------------------------------------- plumbing
    def _handshake(self) -> None:
        c1 = struct.pack(">II", int(time.time()) & 0x7FFFFFFF, 0) \
            + os.urandom(HANDSHAKE_SIZE - 8)
        self._sock.sendall(bytes([RTMP_VERSION]) + c1)
        need = 1 + 2 * HANDSHAKE_SIZE
        got = b""
        while len(got) < need:
            chunk = self._sock.recv(need - len(got))
            if not chunk:
                raise ConnectionError("rtmp handshake EOF")
            got += chunk
        if got[0] != RTMP_VERSION:
            raise ConnectionError(f"bad rtmp version {got[0]}")
        self._sock.sendall(got[1:1 + HANDSHAKE_SIZE])  # C2 echoes S1

    def _send_msg(self, csid: int, mtype: int, stream_id: int,
                  payload: bytes) -> None:
        self._sock.sendall(pack_chunks(csid, mtype, stream_id, payload,
                                       chunk_size=OUR_CHUNK))

    def _command(self, cmd: str, *args, stream_id: int = 0,
                 wait: bool = True):
        self._txn += 1.0
        txn = self._txn
        self._send_msg(3, MSG_COMMAND_AMF0, stream_id,
                       amf0.encode(cmd, txn, *args))
        if not wait:
            return None
        with self._cv:
            ok = self._cv.wait_for(lambda: txn in self._results or
                                   self._closed, timeout=5.0)
            if not ok or self._closed:
                raise TimeoutError(f"rtmp command {cmd!r} timed out")
            return self._results.pop(txn)

    def _read_loop(self) -> None:
        from brpc_tpu_torch.profiling import registry as _prof

        _prof.register_current_thread(_prof.ROLE_POLLER)
        try:
            while not self._closed:
                try:
                    data = self._sock.recv(65536)
                except (TimeoutError, _socket.timeout):
                    continue
                except OSError:
                    break
                if not data:
                    break
                self._buf.append(data)
                for csid, mtype, sid, payload, ts in \
                        self._reader.feed(self._buf):
                    self._on_message(mtype, sid, payload, ts)
        finally:
            with self._cv:
                self._closed = True
                self._cv.notify_all()

    def _on_message(self, mtype: int, sid: int, payload: bytes,
                    timestamp: int = 0) -> None:
        if mtype == MSG_SET_CHUNK_SIZE and len(payload) >= 4:
            self._reader.chunk_size = \
                struct.unpack(">I", payload[:4])[0] & 0x7FFFFFFF
            return
        if mtype == MSG_COMMAND_AMF0:
            try:
                vals = amf0.decode_all(payload)
            except amf0.Amf0Error:
                return
            if vals and vals[0] in ("_result", "_error") and len(vals) > 1:
                with self._cv:
                    self._results[vals[1]] = vals
                    self._cv.notify_all()
            return
        if mtype in (MSG_AUDIO, MSG_VIDEO, MSG_DATA_AMF0):
            cb = self.on_frame
            if cb is not None:
                cb(mtype, sid, payload)

    # -------------------------------------------------------------- calls
    def create_stream(self) -> int:
        vals = self._command("createStream", None)
        return int(vals[3])

    def publish(self, name: str, stream_id: int) -> None:
        self._command("publish", None, name, "live", stream_id=stream_id,
                      wait=False)
        time.sleep(0.05)  # onStatus is advisory; give the server a beat

    def play(self, name: str, stream_id: int) -> None:
        self._command("play", None, name, stream_id=stream_id, wait=False)
        time.sleep(0.05)

    def send_frame(self, mtype: int, stream_id: int, payload: bytes,
                   timestamp: int = 0) -> None:
        self._sock.sendall(pack_chunks(
            5 if mtype != MSG_VIDEO else 6, mtype, stream_id, payload,
            timestamp=timestamp, chunk_size=OUR_CHUNK))

    def send_metadata(self, stream_id: int, name: str, data: dict) -> None:
        self._send_msg(5, MSG_DATA_AMF0, stream_id,
                       amf0.encode(name, data))

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
