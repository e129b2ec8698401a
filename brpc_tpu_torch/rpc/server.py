"""Server — service registry + acceptor + per-method stats.

Rebuild of ``server.cpp`` (Start :1276/StartInternal :845, method maps)
and ``acceptor.cpp`` (the listening socket accepts until EAGAIN and spawns
per-connection sockets, :250,336). Server-side request processing lives in
server_processing.py.

The port's copy of the JAX package's ``rpc/server.py`` on its pure-Python
branch: the Python acceptor serves every connection. A
``tpu://host:port/n`` listener fronts card n: its TCP port is the tunnel's
bootstrap, and a connection that says HELLO becomes a tunnel endpoint
(``tpu/transport.py``). What is not ported yet raises at ``start`` and
names its ROADMAP item (Queue 1 item 2(b)): the native dataplane (the C++
core) and the sharded dispatch plane. The builtin Health and view
services are not added.
"""

from __future__ import annotations

import socket as _socket
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Set

from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.metrics.latency_recorder import LatencyRecorder
from brpc_tpu_torch.metrics.reducer import Adder
from brpc_tpu_torch.proto._message import get_message_class
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.event_dispatcher import global_dispatcher, pick_dispatcher
from brpc_tpu_torch.rpc.input_messenger import InputMessenger
from brpc_tpu_torch.rpc.socket import Socket


class Service:
    """Base for user services.

    Two ways to define one:
      - descriptor: subclass with DESCRIPTOR = a ServiceDescriptor of the
        port's message tables (``proto/*_pb2.py``); implement
        a method per rpc (same name) with signature (controller, request,
        done) -> optional response. If the method returns a response without
        calling done, the framework sends it (sync style).
      - manual: subclass and call add_method(name, fn, req_cls, resp_cls).
    """

    DESCRIPTOR = None  # ServiceDescriptor, set by subclass

    def __init__(self):
        self._methods: Dict[str, "MethodEntry"] = {}
        if self.DESCRIPTOR is not None:
            for mdesc in self.DESCRIPTOR.methods:
                impl = getattr(self, mdesc.name, None)
                if impl is None:
                    continue
                self._methods[mdesc.name] = MethodEntry(
                    name=mdesc.name,
                    fn=impl,
                    request_class=get_message_class(mdesc.input_type),
                    response_class=get_message_class(mdesc.output_type),
                    stats_prefix=_method_stats_prefix(
                        self.DESCRIPTOR.name, mdesc.name),
                )

    @property
    def service_name(self) -> str:
        if self.DESCRIPTOR is not None:
            return self.DESCRIPTOR.name
        return type(self).__name__

    def add_method(self, name: str, fn, request_class, response_class) -> None:
        self._methods[name] = MethodEntry(
            name, fn, request_class, response_class,
            stats_prefix=_method_stats_prefix(self.service_name, name))

    def find_method(self, name: str) -> Optional["MethodEntry"]:
        return self._methods.get(name)


class GenericService(Service):
    """Base for master services (reference baidu_master_service.cpp):
    implement ``Process(cntl, request, done)`` where ``request`` is a
    RawMessage holding the untouched serialized request bytes; return (or
    pass to ``done``) a RawMessage with the serialized response. The
    original service/method names are on ``cntl.service_name`` /
    ``cntl.method_name`` — everything a transparent proxy needs."""

    def __init__(self):
        super().__init__()
        from brpc_tpu_torch.rpc.channel import RawMessage

        self.add_method("*", self.Process, RawMessage, RawMessage)

    def Process(self, cntl, request, done):
        raise NotImplementedError


def _method_stats_prefix(service: str, method: str) -> str:
    """/vars name stem for one method's LatencyRecorder: non-identifier
    characters (dots, '*' of GenericService) collapse to '_'."""
    raw = f"rpc_method_{service}_{method}"
    return "".join(c if c.isalnum() or c == "_" else "_" for c in raw)


@dataclass
class MethodEntry:
    name: str
    fn: object
    request_class: type
    response_class: type
    # per-method instrumentation (reference details/method_status.cpp)
    latency: LatencyRecorder = field(default_factory=LatencyRecorder)
    errors_count: Adder = field(default_factory=Adder)
    current_concurrency: int = 0
    max_concurrency: int = 0  # 0 = unlimited (shorthand for a constant limiter)
    limiter: object = None    # policy/limiters.py ConcurrencyLimiter
    stats_prefix: str = ""    # /vars stem; exposed on first dispatch
    _stats_exposed: bool = False
    _conc_lock: threading.Lock = field(default_factory=threading.Lock)

    def set_limiter(self, spec) -> "MethodEntry":
        """spec: int | 'constant:N' | 'auto' | 'timeout[:ms]'
        (reference adaptive_max_concurrency.h string forms)."""
        from brpc_tpu_torch.policy.limiters import create_limiter

        self.limiter = create_limiter(spec)
        return self

    def on_request(self) -> bool:
        """Admission check; False -> ELIMIT."""
        if self.limiter is not None:
            ok = self.limiter.on_request()
            if ok:
                with self._conc_lock:
                    self.current_concurrency += 1
            return ok
        if not self.max_concurrency:
            # unlimited: gauge-only counter, skip the lock (shared-core
            # hot path; a preemption race only drifts the gauge)
            self.current_concurrency += 1
            return True
        with self._conc_lock:
            if self.current_concurrency >= self.max_concurrency:
                return False
            self.current_concurrency += 1
            return True

    def on_response(self, latency_us: float, error_code: int) -> None:
        if self.limiter is None and not self.max_concurrency:
            self.current_concurrency -= 1
        else:
            with self._conc_lock:
                self.current_concurrency -= 1
            if self.limiter is not None:
                self.limiter.on_response(latency_us, error_code)
        self.latency.record(latency_us)
        if error_code != errors.OK:
            self.errors_count.put(1)
        if not self._stats_exposed and self.stats_prefix:
            # lazy /vars registration: only methods that actually serve
            # traffic pay registry slots, and the p50/p90/p99 gauges show
            # up on /vars + /brpc_metrics without any user wiring
            with self._conc_lock:
                if self._stats_exposed:
                    return
                self._stats_exposed = True
            self.latency.expose(self.stats_prefix)
            self.errors_count.expose_as(f"{self.stats_prefix}_errors")


@dataclass
class ServerOptions:
    """reference server.h:62-136 (growing subset)."""

    num_workers: int = 8
    max_concurrency: int = 0          # whole-server admission
    auth: object = None               # Authenticator (policy/auth.py)
    idle_timeout_s: int = -1
    rpc_dump_dir: Optional[str] = None  # sample requests here (rpc_dump)
    # the reference's C++ engine for TRPC traffic; the port has no C++
    # core yet (ROADMAP Queue 1 item 2(b)), so True raises at start()
    native_dataplane: bool = False
    # TLS on the listener (rpc/ssl_helper.ServerSslOptions). The SAME port
    # keeps serving plaintext: the first byte of each connection is sniffed
    # (0x16 = TLS) before wrapping, like the reference single-port design.
    ssl: object = None
    # global request interception hook (reference interceptor.h / server.h
    # :98-105): called with the server Controller BEFORE dispatch; return
    # None to accept, or (error_code, error_text) to reject. Covers the pb
    # RPC lanes (trpc_std, grpc, http); byte-service protocols with their
    # own handler registries (redis/mongo/thrift/nshead services) bypass pb
    # dispatch entirely and enforce their own admission.
    interceptor: object = None


class Server:
    def __init__(self, options: Optional[ServerOptions] = None):
        self.options = options or ServerOptions()
        self._services: Dict[str, Service] = {}
        self._listen_sock: Optional[_socket.socket] = None
        self._listen_ep: Optional[EndPoint] = None
        self._connections: Set[Socket] = set()
        self._conn_lock = threading.Lock()
        self._running = False
        self._logoff = False
        self._messenger = InputMessenger(server=self)
        self._dispatcher = global_dispatcher()
        self.concurrency = 0
        self._concurrency_lock = threading.Lock()
        self.requests_processed = Adder()
        self._idle_sweep_timer = None
        self._tpu_ordinal = -1          # device this server fronts (tpu://)
        self._tpu_endpoints: Set[object] = set()
        self._method_cache = {}         # (service, method) -> MethodEntry
        self._ssl_ctx = None            # built lazily from options.ssl
        self._master_service = None     # catch-all generic service
        self.rpc_dumper = None
        self.tail_retainer = None
        if self.options.rpc_dump_dir:
            from brpc_tpu_torch.trace.rpc_dump import RpcDumper
            from brpc_tpu_torch.trace.tail import TailRetainer

            self.rpc_dumper = RpcDumper(self.options.rpc_dump_dir)
            # settle-time retention front of the same dump stream; inert
            # until the reloadable rpc_dump_tail flag turns it on
            self.tail_retainer = TailRetainer(self.rpc_dumper)

    # -------------------------------------------------------------- services
    def set_master_service(self, service: "Service") -> "Server":
        """Catch-all untyped service (reference baidu_master_service.cpp):
        receives every request whose service/method is not registered, as
        RawMessage byte bags — the generic-proxy building block. The
        service must expose a ``*`` method (subclass GenericService)."""
        if service.find_method("*") is None:
            raise ValueError("master service must define method '*' "
                             "(subclass GenericService)")
        self._master_service = service
        return self

    def add_service(self, service: Service) -> "Server":
        name = service.service_name
        if name in self._services:
            raise ValueError(f"service {name!r} already added")
        self._services[name] = service
        return self

    def find_service(self, name: str) -> Optional[Service]:
        return self._services.get(name)

    @property
    def services(self) -> Dict[str, Service]:
        return dict(self._services)

    # ----------------------------------------------------------- start/stop
    def start(self, address: str = "127.0.0.1:0") -> "Server":
        from brpc_tpu_torch.butil.debug import install_crash_handler
        from brpc_tpu_torch.policy import ensure_registered

        install_crash_handler()  # SIGSEGV/ABRT dump all stacks (butil/debug)
        ensure_registered()
        # always-on low-rate profiler: serving processes keep an N-minute
        # ring of folded-stack windows (/hotspots/continuous)
        from brpc_tpu_torch.profiling import ensure_continuous_started

        ensure_continuous_started()
        # series rings + watch rules ride the same sampler daemon: one
        # O(vars) append per second, gated by var_series_enabled
        from brpc_tpu_torch.metrics.series import ensure_series_installed
        from brpc_tpu_torch.metrics.watch import (
            ensure_watch_hooked,
            install_default_rules,
        )

        ensure_series_installed()
        ensure_watch_hooked()
        install_default_rules()
        from brpc_tpu_torch import flags as _flags

        # not ported yet (ROADMAP Queue 1 item 2(b)): refused, never passed
        # over. The builtin Health and view services (reference
        # server.cpp:499-601) need HTTP, gRPC and builtin/; none is added.
        if int(_flags.get("tpu_shard_workers")) > 0:
            raise NotImplementedError(
                "tpu_shard_workers > 0: the sharded dispatch plane is not "
                "ported (ROADMAP Queue 1 item 2(b))")
        if self.options.native_dataplane:
            raise NotImplementedError(
                "native_dataplane: the C++ core is not ported (ROADMAP "
                "Queue 1 item 2(b))")
        if self.options.ssl is not None and self._ssl_ctx is None:
            # fail FAST on a bad cert path — not per-connection at runtime
            from brpc_tpu_torch.rpc.ssl_helper import build_server_context

            self._ssl_ctx = build_server_context(self.options.ssl)
        ep = EndPoint.parse(address)
        if ep.is_tpu():
            # tpu://host:port/ordinal — the TCP port is the tunnel bootstrap
            # (the RDMA handshake listener); accepted connections upgrade to
            # TpuEndpoints when the TPUC HELLO arrives (tpu/transport.py)
            self._tpu_ordinal = ep.device_ordinal
            fam, addr = EndPoint.from_ip_port(ep.host or "0.0.0.0",
                                              ep.port).sockaddr()
        else:
            fam, addr = ep.sockaddr()
        lsock = _socket.socket(fam, _socket.SOCK_STREAM)
        lsock.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
        lsock.bind(addr)
        lsock.listen(1024)
        lsock.setblocking(False)
        self._listen_sock = lsock
        host, port = lsock.getsockname()[:2]
        if ep.is_tpu():
            self._listen_ep = EndPoint.from_tpu(host, ep.device_ordinal,
                                                port=port)
        else:
            self._listen_ep = EndPoint.from_ip_port(host, port)
        self._running = True
        self._logoff = False
        self._dispatcher.add_consumer(
            lsock.fileno(), on_readable=self._on_new_connections
        )
        self._schedule_idle_sweep()
        return self

    def listen_endpoint(self) -> Optional[EndPoint]:
        return self._listen_ep

    def stop(self) -> None:
        """Graceful: reject new requests (ELOGOFF), keep serving in-flight."""
        self._logoff = True
        if self._idle_sweep_timer is not None:
            from brpc_tpu_torch.fiber.timer import timer_del

            timer_del(self._idle_sweep_timer)
            self._idle_sweep_timer = None
        if self._listen_sock is not None:
            try:
                self._dispatcher.remove_consumer(self._listen_sock.fileno())
                self._listen_sock.close()
            except OSError:
                pass
            self._listen_sock = None

    def join(self, timeout: float = 5.0) -> None:
        import time

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._concurrency_lock:
                if self.concurrency == 0:
                    break
            time.sleep(0.01)
        with self._conn_lock:
            conns = list(self._connections)
            eps = list(self._tpu_endpoints)
            self._tpu_endpoints.clear()
        for e in eps:
            e.close()   # BYE + pool teardown; also fails the bootstrap conn
        for c in conns:
            c.close()
        if self.tail_retainer is not None:
            # detach the watch transition hook; held-but-undecided traces
            # drop (the process is going away — nothing left to correlate)
            self.tail_retainer.close()
        self._running = False

    @property
    def is_running(self) -> bool:
        return self._running and not self._logoff

    # -------------------------------------------------------------- acceptor
    def _on_new_connections(self) -> None:
        """accept until EAGAIN (reference acceptor.cpp OnNewConnections)."""
        while self._listen_sock is not None:
            try:
                conn, peer = self._listen_sock.accept()
            except (BlockingIOError, OSError):
                return
            try:
                conn.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
            except OSError:
                pass
            remote = EndPoint.from_ip_port(*peer[:2]) if isinstance(peer, tuple) else None
            if self.options.ssl is not None:
                # sniff + handshake block — run in a fiber, never on the
                # dispatcher (a slow TLS client must not stall the loop)
                from brpc_tpu_torch.fiber import runtime as _rt

                _rt.start_background(self._tls_sniff_accept, conn, remote)
                continue
            conn.setblocking(False)
            self._register_connection(conn, remote)

    def _register_connection(self, conn, remote) -> Socket:
        # accepted connections spread across the dispatcher pool; only
        # the listener stays pinned to self._dispatcher
        sock = Socket(conn, remote, pick_dispatcher())
        sock.owner_server = self
        sock._on_readable = self._messenger.make_on_readable(sock)
        with self._conn_lock:
            self._connections.add(sock)
        sock.register_read()
        return sock

    def _tls_sniff_accept(self, conn, remote) -> None:
        """First-byte sniff: 0x16 = TLS handshake record -> wrap; anything
        else keeps the plaintext path. One port serves both (reference
        ssl_helper.cpp sniffing in the socket input path)."""
        from brpc_tpu_torch.rpc import ssl_helper

        wrapped = False
        try:
            conn.settimeout(5.0)
            first = conn.recv(1, _socket.MSG_PEEK)
            if first and first[0] == ssl_helper.TLS_HANDSHAKE_BYTE:
                conn = ssl_helper.wrap_server_socket(conn, self._ssl_ctx)
                wrapped = True
            else:
                conn.setblocking(False)
        except OSError as e:
            import logging

            logging.getLogger("brpc_tpu_torch").warning(
                "TLS accept from %s failed: %s", remote, e)
            try:
                conn.close()
            except OSError:
                pass
            return
        sock = self._register_connection(conn, remote)
        if wrapped:
            # the handshake read may have pulled the client's first request
            # bytes into OpenSSL's buffer — epoll won't announce them
            sock.kick_read()

    def _schedule_idle_sweep(self) -> None:
        """Re-arming 5 s sweep closing connections idle beyond the
        reloadable idle_timeout_s flag (ServerOptions.idle_timeout_s takes
        precedence when >=0 was given explicitly; <=0 disables). stop()
        cancels the chain via the stored timer id."""
        from brpc_tpu_torch.fiber.timer import timer_add

        def sweep() -> None:
            if not self._running or self._logoff:
                return  # stop() cancels the chain; a mid-flight sweep
                        # must not resurrect it
            from brpc_tpu_torch import flags as _flags

            limit = self.options.idle_timeout_s
            if limit is None or limit < 0:
                limit = _flags.get("idle_timeout_s")
            if limit and limit > 0:
                import time as _time

                now = _time.monotonic()
                with self._conn_lock:
                    idle = [c for c in self._connections
                            if now - c.last_active > limit]
                for c in idle:
                    c.set_failed(errors.EFAILEDSOCKET,
                                 f"idle > {limit:.0f}s")
            self._schedule_idle_sweep()

        self._idle_sweep_timer = timer_add(sweep, 5.0)

    def _on_connection_closed(self, sock: Socket) -> None:
        with self._conn_lock:
            self._connections.discard(sock)
            ep = getattr(sock, "_tpu_endpoint", None)
            if ep is not None:
                self._tpu_endpoints.discard(ep)

    def _register_tpu_endpoint(self, ep) -> None:
        with self._conn_lock:
            self._tpu_endpoints.add(ep)

    def connection_count(self) -> int:
        with self._conn_lock:
            return len(self._connections)

    # ------------------------------------------------------------- admission
    def add_concurrency(self) -> bool:
        if not self.options.max_concurrency:
            # no limit configured: the counter is observability-only, and
            # a lock round-trip per RPC is measurable on the shared core.
            # A lost update under preemption only drifts the gauge.
            self.concurrency += 1
            return True
        with self._concurrency_lock:
            if self.concurrency >= self.options.max_concurrency:
                return False
            self.concurrency += 1
            return True

    def sub_concurrency(self) -> None:
        if not self.options.max_concurrency:
            self.concurrency -= 1
            return
        with self._concurrency_lock:
            self.concurrency -= 1
