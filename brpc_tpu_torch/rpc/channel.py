"""Channel — the client stub (reference channel.cpp:293,379,433).

``init`` accepts a single endpoint ("host:port", "unix:...",
"tpu://host/n", "tpu://host:port/n").
``call_method`` drives the full client call stack of SURVEY §3.1: controller
setup -> call-id creation -> timers -> serialize -> issue (select, pack,
wait-free write) -> sync join or async done.

The port's copy of the JAX package's ``rpc/channel.py`` on its pure-Python
branch: every call takes the full Controller pipeline (the reference's
``native_transport`` fast lane needs its C++ core). A ``tpu://host/n``
target runs the call in process on card n (``tpu/tpusocket.py``); a
``tpu://host:port/n`` target dials the cross-process tunnel
(``tpu/transport.py``). What is not ported yet raises and names its
ROADMAP item (Queue 1 item 2(b)): naming services with load balancers, and
``native_transport``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.fiber import call_id as _cid
from brpc_tpu_torch.metrics.latency_recorder import LatencyRecorder
from brpc_tpu_torch.policy import compress as _compress
from brpc_tpu_torch.proto._message import get_message_class
from brpc_tpu_torch.rpc.controller import Controller
from brpc_tpu_torch.rpc.protocol import find_protocol
from brpc_tpu_torch.rpc.socket_map import global_socket_map


@dataclass
class MethodDescriptor:
    service_name: str
    method_name: str
    request_class: type = None
    response_class: type = None

    @staticmethod
    def from_pb(method_desc) -> "MethodDescriptor":
        return MethodDescriptor(
            service_name=method_desc.containing_service.name,
            method_name=method_desc.name,
            request_class=get_message_class(method_desc.input_type),
            response_class=get_message_class(method_desc.output_type),
        )


@dataclass
class ChannelOptions:
    """reference channel.h:42-140 (the subset that exists so far)."""

    timeout_ms: int = 1000
    connect_timeout_ms: int = 3000
    max_retry: int = 3
    backup_request_ms: int = 0  # 0 = disabled
    protocol: str = "trpc_std"
    compress_type: int = _compress.COMPRESS_NONE
    auth: object = None           # policy/auth.py Authenticator
    retry_policy: object = None   # policy/retry.py RetryPolicy
    backup_request_policy: object = None  # policy/retry.py BackupRequestPolicy
    # crc32c over the body. Off by default: TCP already checksums, and the
    # pure-Python crc32c is slow on MB payloads — flip on for lossy
    # transports.
    enable_checksum: bool = False
    # the reference's C++ engine for trpc_std traffic; the port has no C++
    # core yet (ROADMAP Queue 1 item 2(b)), so True raises at init()
    native_transport: bool = False
    # TLS to the server (rpc/ssl_helper.ClientSslOptions). None = plaintext.
    ssl: object = None
    # connection type (reference channel.h:90-95): "single" shares one
    # multiplexed connection per endpoint; "pooled" checks a connection
    # out of a free list per RPC (one request in flight per conn — how the
    # reference scales single-peer bulk throughput); "short" dials a fresh
    # connection per RPC and closes it after. Streaming RPCs always bind
    # single-style (the stream owns its connection).
    connection_type: str = "single"


class Channel:
    def __init__(self, options: Optional[ChannelOptions] = None):
        self.options = options or ChannelOptions()
        self._protocol = None
        self._remote: Optional[EndPoint] = None
        self._socket_map = None
        self._init_done = False
        self.latency_recorder = LatencyRecorder()

    # ------------------------------------------------------------------ init
    def init(self, target: str, lb_name: Optional[str] = None) -> "Channel":
        from brpc_tpu_torch.policy import ensure_registered

        ensure_registered()
        self._protocol = find_protocol(self.options.protocol)
        if self._protocol is None:
            raise ValueError(f"unknown protocol {self.options.protocol!r}")
        if lb_name:
            raise NotImplementedError(
                "naming services and load balancers are not ported "
                "(ROADMAP Queue 1 item 2(b))")
        if self.options.native_transport:
            raise NotImplementedError(
                "native_transport: the C++ core is not ported (ROADMAP "
                "Queue 1 item 2(b))")
        self._remote = EndPoint.parse(target)
        self._socket_map = global_socket_map()
        self._init_done = True
        return self

    # ------------------------------------------------------------ call stack
    def call_method(self, method: MethodDescriptor, request,
                    response=None, controller: Optional[Controller] = None,
                    done=None):
        """Sync when done is None (returns response); async otherwise
        (returns the controller immediately)."""
        if not self._init_done:
            raise RuntimeError("Channel.init() not called")
        cntl = controller or Controller()
        if response is None and method.response_class is not None:
            response = method.response_class()
        if cntl.compress_type == _compress.COMPRESS_NONE:
            cntl.compress_type = self.options.compress_type
        cid = cntl._begin_call(self, method, request, response, done)
        try:
            _cid.id_lock(cid)
        except _cid.IdGone:
            pass  # a tiny timeout already fired and finished the RPC
        else:
            try:
                cntl._issue_rpc()
            finally:
                try:  # never leave the id locked (join would hang forever)
                    _cid.id_unlock(cid)
                except _cid.IdGone:
                    pass
        if done is not None:
            return cntl
        cntl.join()
        if cntl.failed():
            raise RpcError(cntl)
        return response

    # ------------------------------------------------------------- internals
    def _select_socket(self, cntl: Controller):
        ep = self._remote
        # connection type: streaming binds single-style (the stream owns
        # its conn); everything else honors options.connection_type
        ctype = self.options.connection_type
        if cntl is not None and getattr(cntl, "stream_id", 0):
            ctype = "single"
        timeout_ms = int(self.options.connect_timeout_ms)
        if ep.is_tpu():
            from brpc_tpu_torch.tpu.tpusocket import get_tpu_socket

            # deadline-aware dial: a healing tunnel may retry-with-backoff
            # inside connect — bound that by the call's remaining budget so
            # a short-timeout RPC fails fast instead of riding the full
            # connect_timeout worth of re-handshake attempts
            connect_s = timeout_ms / 1000.0
            call_ms = getattr(cntl, "timeout_ms", 0) if cntl is not None \
                else 0
            if call_ms and call_ms > 0:
                connect_s = min(connect_s, call_ms / 1000.0)
            return get_tpu_socket(ep, connect_timeout=connect_s)
        # the frame protocols share one connection per endpoint (the
        # reference keys connection-scoped protocols apart; none is ported)
        signature = ""
        sm = self._socket_map
        if ctype == "pooled":
            return self._tag_return(
                sm.get_pooled(ep, connect_timeout=timeout_ms / 1000.0,
                              signature=signature,
                              ssl_options=self.options.ssl),
                sm.return_pooled)
        if ctype == "short":
            return sm.create_short(
                ep, connect_timeout=timeout_ms / 1000.0,
                signature=signature, ssl_options=self.options.ssl)
        return sm.get_or_create(
            ep, connect_timeout=timeout_ms / 1000.0,
            signature=signature, ssl_options=self.options.ssl,
        )

    @staticmethod
    def _tag_return(sock, return_fn):
        sock._brpc_pool_return = return_fn
        return sock

    @staticmethod
    def _release_socket(sock, reusable: bool) -> None:
        """End-of-RPC hand-back for pooled/short checkouts (no-op for
        single-type shared sockets)."""
        if sock is None:
            return
        if getattr(sock, "_brpc_short", False):
            sock._brpc_short = False
            if not sock.failed:
                sock.close()
            return
        ret = getattr(sock, "_brpc_pool_return", None)
        if ret is not None and getattr(sock, "_brpc_pool_key", None) \
                is not None:
            ret(sock, reusable)

    def _on_rpc_end(self, cntl: Controller) -> None:
        self.latency_recorder.record(cntl.latency_us)

class RawMessage:
    """Pre-serialized payload that rides the normal call stack — what
    rpc_replay and generic proxies use (the reference's baidu_master_service
    "untyped request" niche): SerializeToString/ParseFromString just pass
    bytes through."""

    def __init__(self, data: bytes = b""):
        self.data = data

    def SerializeToString(self) -> bytes:
        return self.data

    def ParseFromString(self, data: bytes) -> None:
        self.data = data


class RpcError(Exception):
    def __init__(self, cntl: Controller):
        super().__init__(f"[E{cntl.error_code}] {cntl.error_text()}")
        self.controller = cntl
        self.error_code = cntl.error_code


class Stub:
    """Typed call surface generated from a pb service descriptor.

    stub = Stub(channel, echo_pb2.DESCRIPTOR.services_by_name['EchoService'])
    (``echo_pb2`` of ``brpc_tpu_torch.proto``)
    resp = stub.Echo(request)                      # sync
    cntl = stub.Echo(request, done=cb)             # async
    """

    def __init__(self, channel: Channel, service_descriptor):
        self._channel = channel
        for mdesc in service_descriptor.methods:
            md = MethodDescriptor.from_pb(mdesc)
            setattr(self, mdesc.name, self._make_call(md))

    def _make_call(self, md: MethodDescriptor):
        def call(request, response=None, controller=None, done=None):
            return self._channel.call_method(
                md, request, response=response, controller=controller, done=done
            )

        return call
