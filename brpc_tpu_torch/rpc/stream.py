"""Streaming RPC — ordered byte/message streams with credit flow control.

Rebuild of the reference's stream subsystem (stream.cpp / stream.h:106-138 /
policy/streaming_rpc_protocol.cpp; SURVEY §3.4). Carried-over semantics:

  - A stream piggybacks on an ordinary RPC: the client sends its stream id
    in the request's StreamSettings; the server accepts in its handler and
    answers with its own id in the response meta. After that, DATA/FEEDBACK/
    CLOSE frames flow directly on the connection.
  - Credit window: a writer may have at most ``window_bytes`` unconsumed
    bytes in flight (`_produced < _remote_consumed + window`,
    stream.cpp:318 AppendIfNotFull). stream_write blocks on a butex (or
    returns EAGAIN in non-blocking mode); the receiver's cumulative-consumed
    FEEDBACK (SendFeedback :631 / SetRemoteConsumed :354) wakes writers.
  - Delivery is strictly ordered per stream through an ExecutionQueue.

TPU mapping (SURVEY §5.7): a stream whose peer is a device endpoint is the
chunked DMA pipeline — same windowing, the "connection" is the transfer
engine's queue depth.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

from brpc_tpu_torch.butil.resource_pool import VersionedPool
from brpc_tpu_torch.fiber.butex import Butex
from brpc_tpu_torch.fiber.execution_queue import ExecutionQueue
from brpc_tpu_torch.proto import rpc_meta_pb2
from brpc_tpu_torch.rpc import errors

FRAME_DATA = 1
FRAME_FEEDBACK = 2
FRAME_CLOSE = 3

DEFAULT_WINDOW = 2 << 20  # 2 MB credit window


class StreamOptions:
    def __init__(self,
                 on_received: Optional[Callable[[int, List[bytes]], None]] = None,
                 on_closed: Optional[Callable[[int], None]] = None,
                 window_bytes: int = DEFAULT_WINDOW,
                 blocking_write: bool = True,
                 measure: Optional[Callable[[bytes], int]] = None):
        self.on_received = on_received
        self.on_closed = on_closed
        self.window_bytes = window_bytes
        self.blocking_write = blocking_write
        # credit unit of a message (None = len). Device streams (SURVEY
        # §5.7 mapping, tpu/device_stream.py) send tiny HANDLE records
        # whose credit weight is the HBM bytes they name — the window
        # then bounds device-pool occupancy, not wire bytes. Both ends
        # must agree on the measure.
        self.measure = measure


class Stream:
    def __init__(self, options: StreamOptions):
        self.options = options
        self.stream_id: int = 0          # our id (the peer's destination)
        self.remote_stream_id: int = 0   # peer's id (our destination)
        # the PEER writer's window (from its StreamSettings): feedback must
        # pace that window, not our local receive window
        self.peer_window: int = DEFAULT_WINDOW
        self.socket = None
        self.bound = threading.Event()
        self.closed = False
        self._close_lock = threading.Lock()
        # --- writer-side credit accounting
        self._produced = 0
        self._remote_consumed = 0
        self._write_butex = Butex(0, site="stream.write_window")
        self._seq = 0
        self._write_lock = threading.Lock()
        # --- receiver side
        self._consumed = 0
        self._feedback_sent = 0
        self._recv_queue = ExecutionQueue(self._deliver)
        self._recv_seq_expect = 0

    # ------------------------------------------------------------ lifecycle
    def bind(self, socket, remote_stream_id: int,
             peer_window: int = 0) -> None:
        self.socket = socket
        self.remote_stream_id = remote_stream_id
        if peer_window:
            self.peer_window = peer_window
        self.bound.set()

    def _frame_meta(self, frame_type: int) -> rpc_meta_pb2.StreamFrameMeta:
        meta = rpc_meta_pb2.StreamFrameMeta()
        meta.stream_id = self.remote_stream_id
        meta.source_stream_id = self.stream_id
        meta.frame_type = frame_type
        return meta

    # ----------------------------------------------------------- write path
    def write(self, data: bytes, timeout: Optional[float] = None) -> int:
        """Send one message. Blocks while the credit window is full (or
        returns EAGAIN-ish EOVERCROWDED when blocking_write=False)."""
        from brpc_tpu_torch.policy.trpc_stream import pack_stream_frame

        if self.closed:
            return errors.ESTREAMCLOSED
        import time as _time

        deadline = (_time.monotonic() + timeout) if timeout is not None else None
        # timeout=None means wait indefinitely for the stream to bind —
        # never silently convert it into a fixed budget. close() sets
        # `bound` so a stream that dies before binding unwedges writers.
        if not self.bound.wait(timeout):
            return errors.ERPCTIMEDOUT
        if self.closed:
            return errors.ESTREAMCLOSED
        n = (len(data) if self.options.measure is None
             else self.options.measure(data))
        with self._write_lock:
            # block only while bytes are in flight: a message larger than
            # the whole window must still be sendable once the window is
            # empty, else it could never succeed (reference AppendIfNotFull
            # checks in-flight bytes, not message size)
            while (self._produced > self._remote_consumed
                   and self._produced + n >
                   self._remote_consumed + self.options.window_bytes):
                if self.closed:
                    return errors.ESTREAMCLOSED
                if not self.options.blocking_write:
                    return errors.EOVERCROWDED
                seen = self._write_butex.value
                # one overall deadline, not a fresh budget per feedback wake
                remaining = (None if deadline is None
                             else deadline - _time.monotonic())
                if remaining is not None and remaining <= 0:
                    return errors.ERPCTIMEDOUT
                self._write_lock.release()
                try:
                    ok = self._write_butex.wait(seen, timeout=remaining)
                finally:
                    self._write_lock.acquire()
                if not ok:
                    return errors.ERPCTIMEDOUT
            meta = self._frame_meta(FRAME_DATA)
            meta.seq = self._seq
            packet = pack_stream_frame(meta, data)
            # send under the lock: (a) concurrent writers would otherwise
            # race seq order onto the socket (receiver aborts on gaps);
            # (b) credit/seq roll back if the socket rejects the frame.
            # Socket.write never blocks, so holding the lock is cheap.
            rc = self.socket.write(packet)
            if rc != 0:
                return rc
            self._produced += n
            self._seq += 1
        return 0

    def on_feedback(self, consumed_bytes: int) -> None:
        with self._write_lock:
            if consumed_bytes > self._remote_consumed:
                self._remote_consumed = consumed_bytes
        self._write_butex.add_and_wake()

    # ------------------------------------------------------------ recv path
    def on_data(self, seq: int, payload: bytes) -> None:
        self._recv_queue.execute((seq, payload))

    def _deliver(self, batch) -> None:
        if batch is None:
            return
        msgs = []
        for seq, payload in batch:
            # connection is ordered; seq is an integrity check
            if seq != self._recv_seq_expect:
                self._abort(f"stream frame gap: got {seq}, "
                            f"want {self._recv_seq_expect}")
                return
            self._recv_seq_expect += 1
            msgs.append(payload)
            self._consumed += (len(payload)
                               if self.options.measure is None
                               else self.options.measure(payload))
        if self.options.on_received is not None:
            try:
                self.options.on_received(self.stream_id, msgs)
            except Exception:
                pass
        self._maybe_feedback()

    def _maybe_feedback(self) -> None:
        if self._consumed - self._feedback_sent >= self.peer_window // 2:
            self.flush_feedback()

    def flush_feedback(self) -> None:
        """Send cumulative-consumed feedback NOW (not just at the
        half-window pacing mark). Heavy-consumption receivers (device
        streams: one on-device op per record) call this after each
        delivery batch so a producer's credit accounting converges to
        the exact consumed total — credit equality then doubles as a
        completion signal (tpu/device_stream.py)."""
        from brpc_tpu_torch.policy.trpc_stream import pack_stream_frame

        if self._consumed > self._feedback_sent and self.socket is not None:
            meta = self._frame_meta(FRAME_FEEDBACK)
            meta.consumed_bytes = self._consumed
            self._feedback_sent = self._consumed
            self.socket.write(pack_stream_frame(meta, b""))

    # ---------------------------------------------------------------- close
    def close(self, send_frame: bool = True) -> None:
        from brpc_tpu_torch.policy.trpc_stream import pack_stream_frame

        with self._close_lock:
            if self.closed:
                return
            self.closed = True
        if send_frame and self.socket is not None and self.bound.is_set():
            meta = self._frame_meta(FRAME_CLOSE)
            self.socket.write(pack_stream_frame(meta, b""))
        self._write_butex.add_and_wake()  # unblock writers
        self.bound.set()  # unwedge write()-ers parked waiting for bind
        _stream_pool.remove(self.stream_id)
        if self.options.on_closed is not None:
            try:
                self.options.on_closed(self.stream_id)
            except Exception:
                pass

    def _abort(self, reason: str) -> None:
        self.close(send_frame=True)


_stream_pool: VersionedPool = VersionedPool()


# ------------------------------------------------------------------ user API
def stream_create(options: Optional[StreamOptions] = None) -> int:
    """Client side: create before the RPC; pass the id via
    Controller.stream_id (reference StreamCreate, stream.h:106)."""
    stream = Stream(options or StreamOptions())
    stream.stream_id = _stream_pool.insert(stream)
    return stream.stream_id


def stream_accept(cntl, options: Optional[StreamOptions] = None) -> int:
    """Server side: accept inside the method handler (StreamAccept,
    stream.h:121). Binding completes when the response goes out."""
    meta = getattr(cntl, "_srv_meta", None)  # slim/fast controllers carry
    # no meta pb — those paths only take requests without stream settings
    if meta is None or meta.stream_settings.stream_id == 0:
        raise ValueError("request carries no stream settings")
    settings = meta.stream_settings
    stream = Stream(options or StreamOptions())
    stream.stream_id = _stream_pool.insert(stream)
    stream.bind(cntl._srv_socket, settings.stream_id,
                peer_window=settings.window_bytes)
    cntl._accepted_stream_id = stream.stream_id
    return stream.stream_id


def stream_write(stream_id: int, data: bytes,
                 timeout: Optional[float] = None) -> int:
    stream = _stream_pool.address(stream_id)
    if stream is None:
        return errors.ESTREAMCLOSED
    return stream.write(data, timeout=timeout)


def stream_close(stream_id: int) -> None:
    stream = _stream_pool.address(stream_id)
    if stream is not None:
        stream.close()


def get_stream(stream_id: int) -> Optional[Stream]:
    return _stream_pool.address(stream_id)
