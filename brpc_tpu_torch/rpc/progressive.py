"""ProgressiveAttachment — stream an HTTP response body in chunks
(reference progressive_attachment.cpp: the handler finishes the RPC, then
keeps writing body pieces from any thread; the wire is
Transfer-Encoding: chunked).

    def Download(self, cntl, request, done):
        pa = cntl.create_progressive_attachment()
        threading.Thread(target=pump, args=(pa,)).start()
        return my_pb2.Resp()   # headers go out chunked; body rides pa

Writes before the headers flush are buffered; after close() the
connection returns to normal keep-alive service (chunked framing
terminates the message). Only meaningful for HTTP/1.1 requests — the
binary protocols carry attachments in one message.
"""

from __future__ import annotations

import threading
from typing import Optional

from brpc_tpu_torch.rpc import errors


def _chunk(data: bytes) -> bytes:
    return f"{len(data):x}\r\n".encode() + data + b"\r\n"


class ProgressiveAttachment:
    def __init__(self):
        self._sock = None
        self._lock = threading.Lock()
        self._buffered = []           # writes before the headers went out
        self._closed = False
        self._started = False
        self._keep_alive = True

    # ------------------------------------------------------------ user side
    def write(self, data) -> int:
        """Queue/send one chunk. 0 on success; EFAILEDSOCKET/ESTREAMCLOSED
        when the connection died or close() already ran. The socket write
        happens UNDER the lock (it queues, never blocks) so a concurrent
        close() cannot put its terminator ahead of this chunk."""
        data = bytes(data)
        if not data:
            return 0
        with self._lock:
            if self._closed:
                return errors.ESTREAMCLOSED
            if not self._started:
                self._buffered.append(data)
                return 0
            sock = self._sock
            if sock is None or sock.failed:
                return errors.EFAILEDSOCKET
            return sock.write(_chunk(data))

    def close(self) -> int:
        """Terminal 0-size chunk; the connection stays keep-alive unless
        the request asked for Connection: close."""
        with self._lock:
            if self._closed:
                return 0
            self._closed = True
            if not self._started:
                return 0  # _start flushes buffer + terminator
            sock = self._sock
            if sock is None or sock.failed:
                return errors.EFAILEDSOCKET
            rc = sock.write(b"0\r\n\r\n")
            if not self._keep_alive:
                # drain-then-close: an immediate close would drop queued
                # tail chunks (Socket.write queues past EAGAIN)
                sock.graceful_close()
            return rc

    @property
    def closed(self) -> bool:
        return self._closed

    def _abort(self) -> None:
        """The response was rejected before headers (e.g. HTTP/1.0 peer):
        further writes must fail fast, not buffer forever."""
        with self._lock:
            self._closed = True
            self._started = True
            self._buffered.clear()

    # ------------------------------------------------------- framework side
    def _start(self, sock, keep_alive: bool = True) -> None:
        """Called by the HTTP response path once the chunked headers are on
        the wire: flush buffered writes (and the terminator if the handler
        already closed). The flush happens UNDER the lock — a pump thread
        racing write()/close() must not interleave its chunks ahead of the
        buffered ones (sock.write never blocks: it queues)."""
        with self._lock:
            self._sock = sock
            self._keep_alive = keep_alive
            buffered, self._buffered = self._buffered, []
            for data in buffered:
                sock.write(_chunk(data))
            if self._closed:
                sock.write(b"0\r\n\r\n")
                if not keep_alive:
                    sock.graceful_close()
            self._started = True


def render_chunked_headers(status: int, content_type: str,
                           extra_headers: Optional[dict] = None,
                           keep_alive: bool = True) -> bytes:
    from brpc_tpu_torch.policy.http_protocol import render_response

    return render_response(status, content_type, b"",
                           extra_headers=extra_headers,
                           keep_alive=keep_alive, chunked=True)
