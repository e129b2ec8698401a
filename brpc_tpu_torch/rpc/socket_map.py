"""SocketMap — process-global connection sharing (reference socket_map.cpp).

Connection types (reference channel.h:90-95, socket.cpp GetPooledSocket/
GetShortSocket):

- "single" (default): channels to the same endpoint share ONE connection;
  pipelined requests ride it concurrently (responses carry correlation
  ids). The map re-establishes sockets that have failed since last use.
- "pooled": each RPC checks a connection out of a per-endpoint free list
  for its whole lifetime and returns it afterwards — at most one request
  in flight per connection, which is how the reference scales single-peer
  bulk throughput (and what protocols that can't multiplex need).
- "short": a fresh connection per RPC, closed when the call ends.

Return discipline for pooled sockets: only a socket whose checkout ended
CLEANLY (single attempt, OK response) goes back — anything ambiguous
(failure, retry, abandoned attempt) closes it instead, so a late stale
response can never be read by the next checkout (the reference's
stale-response guard, controller.cpp:1059-1066, applied to pooling).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional

from brpc_tpu_torch import fault as _fault
from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.metrics.reducer import Adder
from brpc_tpu_torch.rpc.socket import Socket

# "single" connections silently replaced after a failure — the SocketMap's
# self-healing made visible (and assertable from chaos tests)
g_socketmap_reconnects = Adder("g_socketmap_reconnects")

_fault.register("socketmap.connect.fail",
                "raise OSError from SocketMap._new_socket, as if the peer "
                "refused the dial")


class SocketMap:
    """Keyed by (EndPoint, signature): the reference's ChannelSignature —
    channels with different connection-scoped configuration (e.g. protocol
    family: an h2 connection can't carry trpc_std frames) get distinct
    connections; same-signature channels share one."""

    POOL_MAX_IDLE = 32  # idle pooled conns kept per endpoint

    def __init__(self, dispatcher, messenger):
        # dispatcher=None spreads new connections across the pool
        # (pick_dispatcher); a concrete dispatcher pins them
        self._dispatcher = dispatcher
        self._messenger = messenger
        self._map: Dict[tuple, Socket] = {}
        self._pools: Dict[tuple, deque] = {}  # pooled free lists
        self._lock = threading.Lock()
        # per-key creation locks: a blocking connect to one dead host
        # must not stall channels talking to healthy endpoints
        self._create_locks: Dict[tuple, threading.Lock] = {}

    def get_or_create(self, remote: EndPoint, connect_timeout: float = 3.0,
                      signature: str = "", ssl_options=None) -> Socket:
        if ssl_options is not None:
            # TLS sockets never pool with plaintext ones (nor with TLS
            # sockets using different options)
            signature = f"{signature}|{ssl_options.cache_key()}"
        key = (remote, signature)
        with self._lock:
            sock = self._map.get(key)
            if sock is not None and not sock.failed:
                return sock
            create_lock = self._create_locks.setdefault(key, threading.Lock())
        with create_lock:  # serialize creation per key only
            with self._lock:
                sock = self._map.get(key)
                if sock is not None and not sock.failed:
                    return sock
                replacing_failed = sock is not None
            sock = self._new_socket(remote, connect_timeout, ssl_options)
            if replacing_failed:
                g_socketmap_reconnects.put(1)
            with self._lock:
                self._map[key] = sock
            return sock

    # ------------------------------------------------------ pooled / short
    def _new_socket(self, remote: EndPoint, connect_timeout: float,
                    ssl_options) -> Socket:
        if _fault.hit("socketmap.connect.fail") is not None:
            raise OSError("fault injected connect failure")
        if self._dispatcher is None:
            from brpc_tpu_torch.rpc.event_dispatcher import pick_dispatcher

            disp = pick_dispatcher()
        else:
            disp = self._dispatcher
        sock = Socket.connect(remote, disp, timeout=connect_timeout,
                              ssl_options=ssl_options)
        sock._on_readable = self._messenger.make_on_readable(sock)
        sock.register_read()
        if ssl_options is not None:
            sock.kick_read()
        return sock

    def get_pooled(self, remote: EndPoint, connect_timeout: float = 3.0,
                   signature: str = "", ssl_options=None) -> Socket:
        """Check a connection out of the endpoint's free list (creating one
        when the list is empty). The caller MUST hand it back through
        return_pooled exactly once when the RPC ends."""
        if ssl_options is not None:
            signature = f"{signature}|{ssl_options.cache_key()}"
        key = (remote, signature)
        with self._lock:
            pool = self._pools.setdefault(key, deque())
            while pool:
                sock = pool.popleft()
                if not sock.failed:
                    sock._brpc_pool_key = key
                    return sock
        sock = self._new_socket(remote, connect_timeout, ssl_options)
        sock._brpc_pool_key = key
        return sock

    def return_pooled(self, sock: Socket, reusable: bool) -> None:
        """End of a pooled checkout. reusable=False (failure / ambiguous
        attempt) closes the connection instead of pooling it — a stale
        response left in flight must never reach the next checkout."""
        key = getattr(sock, "_brpc_pool_key", None)
        if key is None:
            return
        sock._brpc_pool_key = None
        if not reusable or sock.failed:
            if not sock.failed:
                sock.close()
            return
        with self._lock:
            pool = self._pools.setdefault(key, deque())
            if len(pool) >= self.POOL_MAX_IDLE:
                drop = True
            else:
                pool.append(sock)
                drop = False
        if drop:
            sock.close()

    def create_short(self, remote: EndPoint, connect_timeout: float = 3.0,
                     signature: str = "", ssl_options=None) -> Socket:
        """A fresh connection owned by one RPC; the caller closes it when
        the call ends (reference GetShortSocket)."""
        if ssl_options is not None:
            signature = f"{signature}|{ssl_options.cache_key()}"
        sock = self._new_socket(remote, connect_timeout, ssl_options)
        sock._brpc_short = True
        return sock

    def pooled_idle_count(self, remote: EndPoint,
                          signature: str = "") -> int:
        with self._lock:
            return len(self._pools.get((remote, signature), ()))

    def remove(self, remote: EndPoint, signature: str = "") -> None:
        key = (remote, signature)
        with self._lock:
            create_lock = self._create_locks.get(key)
        if create_lock is not None:
            # serialize against an in-flight get_or_create so a concurrent
            # connect can't re-insert a socket right after we pop it
            create_lock.acquire()
        try:
            with self._lock:
                sock = self._map.pop(key, None)
                self._create_locks.pop(key, None)  # no unbounded growth
        finally:
            if create_lock is not None:
                create_lock.release()
        if sock is not None and not sock.failed:
            sock.close()

    def size(self) -> int:
        with self._lock:
            return len(self._map)


_global_map: Optional[SocketMap] = None
_global_lock = threading.Lock()


def global_socket_map() -> SocketMap:
    global _global_map
    with _global_lock:
        if _global_map is None:
            from brpc_tpu_torch.rpc.input_messenger import InputMessenger

            _global_map = SocketMap(None, InputMessenger())
        return _global_map
