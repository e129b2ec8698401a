"""Socket — the central transport object (reference socket.cpp/socket.h).

Carried-over invariants (SURVEY §2.4 Socket row):
  - Addressed by a 64-bit versioned SocketId (VersionedPool); stale ids
    never resolve after a close/recycle (``versioned_ref_with_id.h:54``).
  - Single-writer write path: the first writer claims the socket and writes
    inline (the common case finishes in one syscall, ``StartWrite``
    socket.cpp:1692); contenders append to the queue without blocking. When
    the kernel buffer fills, the remainder drains from EPOLLOUT events (our
    KeepWrite, socket.cpp:1800).
  - Read events never read on the event thread beyond draining the fd into
    the chain; message processing is handed to fiber workers in order.
  - set_failed wakes every RPC waiting on the socket through the call-id
    error channel, exactly once.
"""

from __future__ import annotations

import itertools
import socket as _socket
import ssl as _ssl
import threading
import time as _time
from collections import deque
from typing import Callable, Optional, Set

from brpc_tpu_torch import fault as _fault
from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.butil.resource_pool import VersionedPool
from brpc_tpu_torch.fiber import call_id as _cid
from brpc_tpu_torch.metrics.reducer import Adder
from brpc_tpu_torch.rpc import errors

# process-wide socket registry: SocketId -> Socket
_socket_pool: VersionedPool = VersionedPool()

# global traffic counters (exposed later via /vars)
g_in_bytes = Adder("g_in_bytes")
g_out_bytes = Adder("g_out_bytes")

_fault.register("socket.write.fail",
                "fail the socket on the next write(); pending calls get "
                "EFAILEDSOCKET and the SocketMap redials on next use")

RECV_CHUNK = 256 * 1024
WRITE_QUEUE_MAX_BYTES = 64 * 1024 * 1024  # EOVERCROWDED beyond this


class Socket:
    def __init__(self, sock: _socket.socket, remote: Optional[EndPoint],
                 dispatcher, on_readable: Optional[Callable] = None):
        self._sock = sock
        self.fd = sock.fileno()
        self.remote = remote
        self.dispatcher = dispatcher
        self.read_buf = IOBuf()
        self.preferred_protocol = None
        # streaming parse: the one in-flight PendingBodyCursor (protocol.py)
        # this connection's cut loop is feeding, or None
        self.pending_body = None
        self.failed = False
        self._eof = False   # clean FIN seen; fail after buffered bytes parse
        self.error_code = 0
        self.error_text = ""
        self._write_lock = threading.Lock()
        self._write_queue: deque = deque()  # of memoryview
        self._write_queued_bytes = 0
        self._write_registered = False
        self._write_armed = False  # EPOLLOUT actually armed in epoll
        self._pending_ids: Set[int] = set()
        self._pending_lock = threading.Lock()
        self.in_bytes = 0
        self.out_bytes = 0
        self.in_messages = 0
        self.out_messages = 0
        self.user_data = None       # server conn state, stream impl, etc.
        self.owner_server = None    # set for accepted connections
        self.last_active = _time.monotonic()  # idle-timeout bookkeeping
        self.ssl = False            # transport is TLS-wrapped
        self.alpn: Optional[str] = None  # ALPN-negotiated protocol (client)
        self.socket_id = _socket_pool.insert(self)
        self._on_readable = on_readable
        self._close_lock = threading.Lock()
        self._close_after_drain = False
        # invoked once from set_failed — transports layered on this socket
        # (tpu tunnel endpoints) tear down with it
        self.on_failed_hook = None

    # --------------------------------------------------------------- factory
    @staticmethod
    def connect(remote: EndPoint, dispatcher, timeout: float = 3.0,
                on_readable: Optional[Callable] = None,
                ssl_options=None) -> "Socket":
        fam, addr = remote.sockaddr()
        sock = _socket.socket(fam, _socket.SOCK_STREAM)
        try:
            sock.settimeout(timeout)
            sock.connect(addr)
            if fam != _socket.AF_UNIX:
                sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
            if ssl_options is not None:
                from brpc_tpu_torch.rpc.ssl_helper import (alpn_selected,
                                                     wrap_client_socket)

                sock = wrap_client_socket(sock, ssl_options, timeout=timeout)
        except OSError:
            sock.close()
            raise
        sock.setblocking(False)
        s = Socket(sock, remote, dispatcher, on_readable=on_readable)
        if ssl_options is not None:
            s.ssl = True
            s.alpn = alpn_selected(sock)
        s.register_read()
        return s

    @staticmethod
    def address(socket_id: int) -> Optional["Socket"]:
        return _socket_pool.address(socket_id)

    @staticmethod
    def live_sockets():
        return _socket_pool.live_objects()

    def register_read(self) -> None:
        if self._on_readable is not None:
            self.dispatcher.add_consumer(self.fd, on_readable=self._on_readable)

    # ------------------------------------------------------------ pending ids
    def add_pending_id(self, cid: int) -> None:
        with self._pending_lock:
            self._pending_ids.add(cid)

    def remove_pending_id(self, cid: int) -> bool:
        """True iff the entry was present (caller owns its error delivery)."""
        with self._pending_lock:
            if cid in self._pending_ids:
                self._pending_ids.discard(cid)
                return True
            return False

    # ------------------------------------------------------------- write path
    def write(self, data, id_wait: Optional[int] = None) -> int:
        """Queue bytes for sending. Returns 0 or an error code.

        Never blocks: the claiming writer sends inline until EAGAIN, the
        rest rides EPOLLOUT. id_wait (a call id) gets an error if the
        socket dies before the bytes could matter.
        """
        if self.failed:
            if id_wait is not None:
                _cid.id_error(id_wait, errors.EFAILEDSOCKET)
            return errors.EFAILEDSOCKET
        if _fault.hit("socket.write.fail") is not None:
            self.set_failed(errors.EFAILEDSOCKET,
                            "fault injected write failure")
            if id_wait is not None:
                _cid.id_error(id_wait, errors.EFAILEDSOCKET)
            return errors.EFAILEDSOCKET
        if type(data) is bytes and data:
            # single-buffer fast lane: an idle socket sends a whole small
            # frame with ONE syscall and one lock round — the general path
            # below costs three lock acquisitions plus deque traffic per
            # write, which is measurable at small-echo rates. Claim the
            # writer role only when nothing is queued; otherwise fall
            # through to the queueing path.
            self.last_active = _time.monotonic()
            if id_wait is not None:
                self.add_pending_id(id_wait)
            claimed_fast = False
            with self._write_lock:
                if (not self._write_queue and not self._write_registered
                        and not isinstance(self._sock, _ssl.SSLSocket)):
                    self._write_registered = True
                    claimed_fast = True
            if claimed_fast:
                try:
                    n = self._sock.send(data)
                except BlockingIOError:
                    n = 0
                except OSError as e:
                    self.set_failed(errors.EFAILEDSOCKET, f"send: {e}")
                    return 0  # failure fans out via pending ids
                if n:
                    self.out_bytes += n
                    g_out_bytes.put(n)
                if n < len(data):
                    # kernel pushback: the unsent tail goes FIRST (writers
                    # that queued behind our claim must stay behind it),
                    # then the normal drain loop takes over (arms EPOLLOUT
                    # on a repeat EAGAIN)
                    with self._write_lock:
                        self._write_queue.appendleft(memoryview(data)[n:])
                        self._write_queued_bytes += len(data) - n
                    self._drain_write_queue()
                    return 0
                drain_more = close_now = False
                with self._write_lock:
                    if self._write_queue:
                        drain_more = True  # appended behind our claim
                    else:
                        self._write_registered = False
                        close_now = self._close_after_drain
                if drain_more:
                    self._drain_write_queue()
                elif close_now:
                    self.close()
                return 0
            views = [memoryview(data)]
            nbytes = len(data)
            with self._write_lock:
                if self._write_queued_bytes > WRITE_QUEUE_MAX_BYTES:
                    if id_wait is not None:
                        self.remove_pending_id(id_wait)
                    return errors.EOVERCROWDED
                self._write_queue.extend(views)
                self._write_queued_bytes += nbytes
                if not self._write_registered:
                    self._write_registered = True
                    claimed_fast = True
            if claimed_fast:
                self._drain_write_queue()
            return 0
        if isinstance(data, IOBuf):
            views = list(data.iter_blocks())
            data.clear()
        elif isinstance(data, bytes):
            # immutable: safe to alias until the kernel send drains it
            views = [memoryview(data)]
        elif isinstance(data, bytearray):
            # caller may mutate/shrink after write returns — snapshot
            views = [memoryview(bytes(data))]
        else:
            views = [data]
        # a queued 0-byte view would livelock the drainer (send returns 0,
        # nothing pops); filter here so the queue only ever holds payload
        views = [v for v in views if v.nbytes]
        nbytes = sum(v.nbytes for v in views)
        self.last_active = _time.monotonic()
        if id_wait is not None:
            self.add_pending_id(id_wait)
        claimed = False
        with self._write_lock:
            if self._write_queued_bytes > WRITE_QUEUE_MAX_BYTES:
                if id_wait is not None:
                    self.remove_pending_id(id_wait)
                return errors.EOVERCROWDED
            self._write_queue.extend(views)
            self._write_queued_bytes += nbytes
            if not self._write_registered:
                # claim the writer role
                self._write_registered = True
                claimed = True
        if claimed:
            self._drain_write_queue()
        return 0

    def _drain_write_queue(self) -> None:
        """Send until the queue empties or the kernel pushes back. Plain
        sockets drain VECTORED (sendmsg: every queued view in one
        syscall — an RPC packet is header+meta+payload views, and one
        send per view was 3-5 syscalls per packet); TLS sockets (no
        sendmsg on SSLSocket) fall back to per-view send."""
        while True:
            heads = None
            with self._write_lock:
                if not self._write_queue:
                    self._write_registered = False
                    # only tell the dispatcher when EPOLLOUT was actually
                    # armed — the common inline-drain path never was, and
                    # a no-op disable still cost a wakeup round trip
                    if self._write_armed:
                        self._write_armed = False
                        self.dispatcher.disable_write(self.fd)
                    close_now = self._close_after_drain
                    break
                # SSLSocket EXPOSES sendmsg but raises NotImplementedError
                sendmsg = None if isinstance(self._sock, _ssl.SSLSocket) \
                    else getattr(self._sock, "sendmsg", None)
                if sendmsg is not None:
                    heads = list(itertools.islice(self._write_queue, 0, 16))
                else:
                    head = self._write_queue[0]
            try:
                if heads is not None:
                    n = sendmsg(heads)
                else:
                    n = self._sock.send(head)
            except (BlockingIOError, _ssl.SSLWantWriteError,
                    _ssl.SSLWantReadError):
                # TLS renegotiation can want a READ to make write progress;
                # the read interest is always armed, so re-arming write
                # covers both cases
                with self._write_lock:
                    self._write_armed = True
                self.dispatcher.enable_write(self.fd, self._on_writable)
                return
            except OSError as e:
                self.set_failed(errors.EFAILEDSOCKET, f"send: {e}")
                return
            self.out_bytes += n
            g_out_bytes.put(n)
            with self._write_lock:
                self._write_queued_bytes -= n
                while n:
                    h = self._write_queue[0]
                    if n >= h.nbytes:
                        n -= h.nbytes
                        self._write_queue.popleft()
                    else:
                        self._write_queue[0] = h[n:]
                        n = 0
        if close_now:
            self.close()

    def _on_writable(self) -> None:
        self._drain_write_queue()

    def graceful_close(self) -> None:
        """Close AFTER the write queue drains — an immediate close() drops
        queued bytes on the floor (progressive responses with
        Connection: close need their tail chunks delivered first)."""
        with self._write_lock:
            if self._write_queue:
                self._close_after_drain = True
                return
        self.close()

    def _retry_read_on_writable(self) -> None:
        """EPOLLOUT follow-up for a TLS read that wanted a write."""
        with self._write_lock:
            if not self._write_registered:
                self.dispatcher.disable_write(self.fd)
        if self._on_readable is not None:
            self._on_readable()

    def kick_read(self) -> None:
        """Deliver one synthetic readable event on a fiber. A TLS handshake
        can leave already-decrypted application bytes buffered inside
        OpenSSL; epoll never announces those, so the registration site must
        kick once."""
        if self._on_readable is not None and not self.failed:
            from brpc_tpu_torch.fiber import runtime as _rt

            _rt.start_background(self._on_readable)

    # -------------------------------------------------------------- read path
    def drain_recv(self) -> int:
        """recv until EAGAIN into read_buf; returns bytes read, -1 on a hard
        error. A clean FIN sets ``_eof`` instead of failing immediately so
        the caller can parse messages that arrived in the same burst
        (close-after-reply must still deliver the reply)."""
        total = 0
        while True:
            try:
                chunk = self._sock.recv(RECV_CHUNK)
            except (BlockingIOError, _ssl.SSLWantReadError):
                break
            except _ssl.SSLWantWriteError:
                # TLS read needs a WRITE (renegotiation/KeyUpdate while the
                # send buffer is full): retry the read on writability, else
                # the connection wedges until unrelated traffic arrives
                self.dispatcher.enable_write(self.fd,
                                             self._retry_read_on_writable)
                break
            except OSError as e:
                self.set_failed(errors.EFAILEDSOCKET, f"recv: {e}")
                return -1
            if not chunk:
                self._eof = True
                break
            total += len(chunk)
            self.in_bytes += len(chunk)
            g_in_bytes.put(len(chunk))
            self.read_buf.append(chunk)
        if total:
            self.last_active = _time.monotonic()
        return total

    def suspend_read(self) -> None:
        """Park read-event delivery while an off-loop cutter owns the read
        side. Guarded by the close lock so a concurrent set_failed (which
        closes the fd — the number may be reused by a brand-new socket)
        can't let us suspend someone else's fd."""
        with self._close_lock:
            if self.failed:
                return
            self.dispatcher.suspend_read(self.fd)

    def resume_read(self) -> None:
        with self._close_lock:
            if self.failed:
                return
            self.dispatcher.resume_read(self.fd)

    # ---------------------------------------------------------------- failure
    def set_failed(self, code: int, reason: str = "") -> None:
        # a "successful" failure code would complete in-flight RPCs as bogus
        # successes through the error channel — coerce to EFAILEDSOCKET
        if code == errors.OK:
            code = errors.EFAILEDSOCKET
        with self._close_lock:
            if self.failed:
                return
            self.failed = True
            self.error_code = code
            self.error_text = reason
            # a half-fed body never completes; drop it (and any borrowed
            # block refs it claimed) with the connection
            self.pending_body = None
        try:
            self.dispatcher.remove_consumer(self.fd)
        except Exception:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        _socket_pool.remove(self.socket_id)
        with self._pending_lock:
            pending = list(self._pending_ids)
            self._pending_ids.clear()
        for cid in pending:
            _cid.id_error(cid, code)
        hook = self.on_failed_hook
        if hook is not None:
            try:
                hook(code, reason)
            except Exception:
                pass
        if self.owner_server is not None:
            self.owner_server._on_connection_closed(self)

    def close(self) -> None:
        self.set_failed(errors.EFAILEDSOCKET, "closed locally")

    @property
    def local_endpoint(self) -> Optional[EndPoint]:
        try:
            host, port = self._sock.getsockname()[:2]
            return EndPoint.from_ip_port(host, port)
        except OSError:
            return None

    def __repr__(self) -> str:
        state = "failed" if self.failed else "ok"
        return f"Socket(fd={self.fd}, remote={self.remote}, {state})"
