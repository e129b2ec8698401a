"""Channel — the client stub (reference channel.cpp:293,379,433).

``init`` accepts a single endpoint ("host:port", "unix:...",
"tpu://host/n", "tpu://host:port/n") or a naming-service url + load
balancer name ("list://a:1,b:2", "rr"; ``policy/naming.py``,
``policy/load_balancers.py``).
``call_method`` drives the full client call stack of SURVEY §3.1: controller
setup -> call-id creation -> timers -> serialize -> issue (LB select, pack,
wait-free write) -> sync join or async done. With a load balancer each
attempt selects a server, a failed attempt retries on the next pick, the
call's latency and error feed the balancer back, and a cluster-recover
policy sheds calls (EREJECT) while the cluster comes back.

The port's copy of the JAX package's ``rpc/channel.py``. A
``tpu://host/n`` target runs the call in process on card n
(``tpu/tpusocket.py``); a ``tpu://host:port/n`` target dials the
cross-process tunnel (``tpu/transport.py``). With ``native_transport=True``
trpc_std calls ride the port's C++ engine (``rpc/native_transport.py``):
TCP and ``tpu://host:port/n`` (the engine's TPUC shared-memory tunnel)
connections are the engine's, and plain unary calls take the fast lane
(engine-packed requests, engine-parsed responses, sync callers parked in
the engine). A ``protocol="grpc"`` Channel with ``native_transport=True``
rides the engine's h2 lane (``dp_connect_grpc``: the engine packs HEADERS
and DATA and parses the trailers), fast lane included. ``unix:`` and TLS
targets keep the Python socket (the engine carries neither). An engine
that cannot be built raises at ``init``: there is no Python fallback.
"""

from __future__ import annotations

import threading
import time as _time
from dataclasses import dataclass
from typing import Optional

from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.fiber import call_id as _cid
from brpc_tpu_torch.metrics.latency_recorder import LatencyRecorder
from brpc_tpu_torch.policy import compress as _compress
from brpc_tpu_torch.proto._message import get_message_class
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.controller import Controller
from brpc_tpu_torch.rpc.protocol import find_protocol
from brpc_tpu_torch.rpc.socket_map import global_socket_map
from brpc_tpu_torch.trace import span as _span


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
    # crc32c over the body. Off by default: TCP already checksums — flip on
    # for lossy transports.
    enable_checksum: bool = False
    # carry trpc_std traffic over the C++ engine (rpc/native_transport.py):
    # connect/write/frame-cut run on native threads, Python only completes
    # calls. Ignored for non-TRPC protocols and unix:/TLS endpoints; an
    # engine that cannot be built raises at init().
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
        self._lb = None
        self._ns_thread = None
        self._socket_map = None
        self._init_done = False
        self._fast_base = False
        self._fast_sock = None  # cached native socket (single-remote only)
        self.latency_recorder = LatencyRecorder()

    # ------------------------------------------------------------------ init
    def init(self, target: str, lb_name: Optional[str] = None) -> "Channel":
        self._setup()
        if lb_name:
            from brpc_tpu_torch.policy.load_balancers import (
                create_load_balancer)
            from brpc_tpu_torch.policy.naming import start_naming_service

            self._lb = create_load_balancer(lb_name)
            self._ns_thread = start_naming_service(target, self._lb)
        else:
            self._remote = EndPoint.parse(target)
        self._set_fast_base()
        self._init_done = True
        return self

    def init_with_lb(self, lb) -> "Channel":
        """Init over an externally-managed load balancer (PartitionChannel
        feeds per-partition LBs from one naming watcher)."""
        self._setup()
        self._lb = lb
        self._set_fast_base()
        self._init_done = True
        return self

    def _setup(self) -> None:
        from brpc_tpu_torch.policy import ensure_registered

        ensure_registered()
        self._protocol = find_protocol(self.options.protocol)
        if self._protocol is None:
            raise ValueError(f"unknown protocol {self.options.protocol!r}")
        if self.options.native_transport:
            from brpc_tpu_torch.rpc.native_transport import get_dataplane

            get_dataplane()  # builds the engine now: a failure raises here
        self._socket_map = global_socket_map()

    def _set_fast_base(self) -> None:
        """Channel-constant half of the fast-path eligibility check (the
        per-call half lives in _fast_call). The fast lane rides the
        engine's dp_call/dp_respond packers."""
        o = self.options
        self._fast_base = (
            o.native_transport
            and (getattr(self._protocol, "magic", None) == b"TRPC"
                 or getattr(self._protocol, "name", "") == "grpc")
            and o.auth is None
            and not o.enable_checksum
            and o.compress_type == _compress.COMPRESS_NONE
            and not o.backup_request_ms
            and o.backup_request_policy is None
            and o.retry_policy is None
            and o.ssl is None)

    # ------------------------------------------------------------ call stack
    def call_method(self, method: MethodDescriptor, request,
                    response=None, controller: Optional[Controller] = None,
                    done=None):
        """Sync when done is None (returns response); async otherwise
        (returns the controller immediately)."""
        if not self._init_done:
            raise RuntimeError("Channel.init() not called")
        if self._fast_base:
            status, value = self._fast_call(method, request, response,
                                            controller, done)
            if status:
                return value
            controller = value or controller  # may carry a sampled span
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
        if self._lb is not None:
            recover = self._lb.recover_policy
            ep = self._lb.select_server(cntl)
            if ep is None:
                if recover is not None:
                    # total cluster loss: arm de-thundered recovery
                    # (reference cluster_recover_policy.cpp StartRecover)
                    recover.start_recover()
                raise ConnectionError("no available server")
            if recover is not None and recover.recovering and \
                    recover.do_reject(self._lb.usable_count()):
                raise errors.SelectError(
                    errors.EREJECT, "request shed during cluster recovery")
        else:
            ep = self._remote
        # connection type: streaming binds single-style (the stream owns
        # its conn); everything else honors options.connection_type
        ctype = self.options.connection_type
        if cntl is not None and getattr(cntl, "stream_id", 0):
            ctype = "single"
        timeout_ms = int(self.options.connect_timeout_ms)
        if (self.options.native_transport and self.options.ssl is None
                and getattr(self._protocol, "magic", None) == b"TRPC"
                and (ep.port if ep.is_tpu() else not ep.is_unix())):
            # the engine's TCP lane, or its TPUC tunnel (tpu://host:port/n)
            from brpc_tpu_torch.rpc.native_transport import get_dataplane

            dp = get_dataplane()
            if ctype == "pooled":
                return self._tag_return(dp.get_pooled(ep, timeout_ms),
                                        dp.return_pooled)
            if ctype == "short":
                return dp.connect_short(ep, timeout_ms)
            return dp.get_or_connect(ep, timeout_ms)
        if (self.options.native_transport and self.options.ssl is None
                and not ep.is_unix() and not ep.is_tpu()
                and getattr(self._protocol, "name", "") == "grpc"):
            # grpc rides the engine's native h2 lane ("single" semantics:
            # h2 multiplexes streams, pooling adds nothing)
            from brpc_tpu_torch.rpc.native_transport import get_dataplane

            return get_dataplane().get_or_connect(ep, timeout_ms, grpc=True)
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
        # connection-scoped protocols (grpc/redis/thrift/...) can't share a
        # socket with each other or with frame protocols: key the shared
        # map by the protocol itself. HTTP is not connection-scoped and
        # shares the endpoint's connection.
        signature = (self._protocol.name
                     if hasattr(self._protocol, "issue_request") else "")
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
        if self._lb is not None and cntl._current_socket is not None:
            self._lb.feedback(cntl._current_socket.remote,
                              cntl.error_code, cntl.latency_us)

    # ------------------------------------------------------------- fast path
    # Engine-packed calls (dp_call) completed by engine-parsed EV_RESPONSE
    # events: no Python protobuf meta, no versioned call-id lock, no timer
    # syscalls on the per-RPC path (the reference keeps all of this
    # native in baidu_rpc_protocol.cpp). Anything the packed meta
    # cannot carry — compression, checksums, auth, streams, backup
    # requests, propagated or sampled traces — falls back to the full
    # Controller pipeline, which remains the semantic reference.

    def _fast_call(self, md, request, response, controller, done):
        """Returns (True, result) when handled, else (False, controller)."""
        cntl = controller
        if cntl is not None and (
                cntl.compress_type != _compress.COMPRESS_NONE
                or cntl.stream_id or (cntl.backup_request_ms or 0) > 0):
            return (False, cntl)
        # sampled or propagated traces ride the fast path too: the packed
        # meta carries trace_id/span_id natively (ReqLite fields)
        span = _span.start_client_span(md.service_name, md.method_name,
                                       _span.current_span())
        opts = self.options
        timeout_ms = opts.timeout_ms
        max_retry = opts.max_retry
        att = b""
        log_id = 0
        if cntl is not None:
            if cntl.timeout_ms is not None:
                timeout_ms = cntl.timeout_ms
            if cntl.max_retry is not None:
                max_retry = cntl.max_retry
            att = cntl.request_attachment or b""
            log_id = cntl.log_id
        svc_b = getattr(md, "_svc_b", None)
        if svc_b is None:
            svc_b = md._svc_b = md.service_name.encode()
            md._meth_b = md.method_name.encode()
        meth_b = md._meth_b
        if span is not None:
            # request marshalling is parse's mirror image — without the
            # mark a multi-MB request shows up as unattributed span time
            t_ser = _time.perf_counter_ns()
            payload = request.SerializeToString()
            span.add_phase("parse_us",
                           (_time.perf_counter_ns() - t_ser) / 1000.0)
        else:
            payload = request.SerializeToString()
        if response is None and md.response_class is not None:
            response = md.response_class()
        if done is not None:
            call = _AsyncFastCall(self, md, svc_b, meth_b, payload, att,
                                  log_id, timeout_ms, max_retry, response,
                                  cntl, done, span)
            issued = call.issue()
            if issued is None:
                if cntl is not None:
                    # the ctor planted itself on the caller's controller —
                    # the full pipeline must join by call id instead
                    cntl._fast_call_ref = None
                if cntl is None and span is not None:
                    cntl = Controller()
                if cntl is not None:
                    cntl.span = span
                return (False, cntl)  # socket isn't native: full path
            return (True, call.cntl)
        return self._fast_sync(md, svc_b, meth_b, payload, att, log_id,
                               timeout_ms, max_retry, response, cntl, span)

    def _fast_sync(self, md, svc_b, meth_b, payload, att, log_id,
                   timeout_ms, max_retry, response, cntl, span):
        # Sync callers park INSIDE the engine (dp_call_sync): the GIL is
        # released for the whole round trip and the engine's parse thread
        # completes the call directly — no poller dispatch, no
        # threading.Event, no per-completion GIL battle between N sync
        # client threads (the pre-r4 shape collapsed at 8 threads).
        global _nt
        if _nt is None:  # lazy: import cycle at module load
            from brpc_tpu_torch.rpc import native_transport

            _nt = native_transport
        DPE_EOF, DPE_IO = _nt.DPE_EOF, _nt.DPE_IO
        DPE_NOTFOUND, DPE_TIMEDOUT = _nt.DPE_NOTFOUND, _nt.DPE_TIMEDOUT
        EngineSyncRec = _nt.EngineSyncRec
        NativeSocket = _nt.NativeSocket
        _fast_cid = _nt._fast_cid

        start_ns = _time.perf_counter_ns()
        deadline = (_time.monotonic() + timeout_ms / 1000.0) \
            if timeout_ms and timeout_ms > 0 else 0.0
        retries = 0
        code = errors.OK
        text = ""
        single = self.options.connection_type == "single"
        # single-remote cache; lb and pooled/short paths re-select
        sock = self._fast_sock if single else None
        body = b""
        att_size = 0
        resp_size = 0
        while True:
            try:
                if sock is None or sock.failed:
                    sock = self._select_socket(cntl)
                    if single and self._lb is None \
                            and isinstance(sock, NativeSocket):
                        self._fast_sock = sock
            except errors.SelectError as e:
                code, text = e.code, str(e)
                sock = None
                break
            except Exception as e:
                code, text = errors.EHOSTDOWN, str(e)
                sock = None
            else:
                if not isinstance(sock, NativeSocket):
                    # nothing was sent: a pooled/short checkout goes
                    # straight back (the full pipeline re-selects)
                    self._release_socket(sock, True)
                    if cntl is None and span is not None:
                        cntl = Controller()
                    if cntl is not None:
                        cntl.span = span
                    return (False, cntl)
                if deadline:
                    left_ms = int((deadline - _time.monotonic()) * 1000)
                    if left_ms <= 0:
                        code, text = errors.ERPCTIMEDOUT, \
                            "deadline exceeded"
                        break
                else:
                    left_ms = 0
                cid = next(_fast_cid)
                # sentinel: completions that need Python anyway (EV_FRAME
                # donations, decompression, ZC tunnels, set_failed fan-out)
                # forward to the parked waiter via dp_sync_complete_py
                rec = EngineSyncRec(sock._dp, cid)
                sock._fast_calls[cid] = rec
                if sock.failed:
                    # raced set_failed's fan-out: our entry may be missed
                    sock._fast_calls.pop(cid, None)
                    code, text = errors.EFAILEDSOCKET, "socket failed"
                else:
                    sock.out_messages += 1
                    sock.out_bytes += len(payload) + len(att)
                    rc, acode, atext, abody, asize = sock._dp.call_sync(
                        sock.conn_id, svc_b, meth_b, cid, log_id, left_ms,
                        payload, att,
                        span.trace_id if span else 0,
                        span.span_id if span else 0)
                    sock._fast_calls.pop(cid, None)
                    if rc == DPE_TIMEDOUT:
                        code, text = errors.ERPCTIMEDOUT, \
                            "deadline exceeded"
                        break
                    if rc != 0:
                        if rc in (DPE_EOF, DPE_IO, DPE_NOTFOUND):
                            sock.set_failed(errors.EFAILEDSOCKET,
                                            f"native send failed ({rc})")
                        code = _map_dpe(rc)
                        text = atext or f"native call failed ({rc})"
                    else:
                        sock.in_messages += 1
                        sock.in_bytes += len(abody)
                        code, text = acode, atext
                        body, att_size = abody, asize
                        resp_size = len(abody)
            if code == errors.OK:
                break
            if code in errors.DEFAULT_RETRYABLE and retries < max_retry \
                    and (not deadline or _time.monotonic() < deadline):
                retries += 1
                code, text = errors.OK, ""
                if sock is not None and not single:
                    self._release_socket(sock, False)  # ambiguous checkout
                    sock = None
                elif self._lb is not None:
                    sock = None  # LB channels re-pick per attempt
                continue
            break
        latency_us = (_time.perf_counter_ns() - start_ns) // 1000
        resp_att = b""
        if code == errors.OK:
            if att_size:
                cut = len(body) - att_size
                resp_att = body[cut:]
                body = body[:cut]
            t_parse = _time.perf_counter_ns()
            try:
                if response is not None:
                    response.ParseFromString(body)
            except Exception as e:
                code, text = errors.ERESPONSE, f"parse response: {e}"
            if span is not None:
                span.add_phase(
                    "parse_us",
                    (_time.perf_counter_ns() - t_parse) / 1000.0)
        if not single:
            self._release_socket(sock, code == errors.OK)
        self.latency_recorder.record(latency_us)
        if span is not None:
            span.request_size = len(payload) + len(att)
            span.response_size = resp_size
            span.end(code)
        if self._lb is not None and sock is not None \
                and getattr(sock, "remote", None) is not None:
            self._lb.feedback(sock.remote, code, latency_us)
        if cntl is not None:
            cntl._error_code = code
            cntl._error_text = text
            cntl.latency_us = latency_us
            cntl._current_socket = sock
            cntl.response_attachment = resp_att
            cntl._retry_count = retries
            cntl._finished = True
        if code != errors.OK:
            raise RpcError(cntl if cntl is not None
                           else _FastErr(md, code, text))
        return (True, response)


_nt = None  # lazy brpc_tpu_torch.rpc.native_transport (import cycle at load)


def _map_dpe(rc: int) -> int:
    from brpc_tpu_torch.rpc import native_transport

    return native_transport._DPE_TO_ERR.get(rc, errors.EFAILEDSOCKET)


class _FastErr:
    """Minimal error carrier for RpcError when no Controller exists."""

    __slots__ = ("error_code", "_text", "latency_us")

    def __init__(self, md, code, text):
        self.error_code = code
        self._text = text or errors.error_text(code)
        self.latency_us = 0

    def error_text(self) -> str:
        return self._text

    def failed(self) -> bool:
        return self.error_code != errors.OK


class FastClientController:
    """What an async fast-path `done` receives: the documented read surface
    of a finished client Controller, without the state machine."""

    __slots__ = ("_error_code", "_error_text", "latency_us", "response",
                 "response_attachment", "request_attachment", "log_id",
                 "compress_type", "_current_socket", "_retry_count",
                 "timeout_ms", "max_retry", "backup_request_ms", "stream_id",
                 "span", "_fast_call_ref")

    def __init__(self):
        self._error_code = errors.OK
        self._error_text = ""
        self.latency_us = 0
        self.response = None
        self.response_attachment = b""
        self.request_attachment = b""
        self.log_id = 0
        self.compress_type = _compress.COMPRESS_NONE
        self._current_socket = None
        self._retry_count = 0
        self.timeout_ms = None
        self.max_retry = None
        self.backup_request_ms = None
        self.stream_id = 0
        self.span = None
        self._fast_call_ref = None

    def failed(self) -> bool:
        return self._error_code != errors.OK

    @property
    def error_code(self) -> int:
        return self._error_code

    def error_text(self) -> str:
        return self._error_text

    def set_failed(self, code: int, text: str = "") -> None:
        self._error_code = code
        self._error_text = text or errors.error_text(code)

    def join(self, timeout=None) -> bool:
        call = self._fast_call_ref
        if call is None:
            return True
        return call.join_wait(timeout)


_join_install_lock = threading.Lock()  # join_wait's one-Event guarantee


class _AsyncFastCall:
    """Async fast-path call: completion-driven retries, coarse deadline
    sweep instead of a per-call timer (rpc/native_transport.py sweeper)."""

    __slots__ = ("channel", "md", "svc_b", "meth_b", "payload", "att",
                 "log_id", "timeout_ms", "max_retry", "retries", "deadline",
                 "start_ns", "response", "cntl", "done", "sock", "span",
                 "settled", "join_ev")

    def __init__(self, channel, md, svc_b, meth_b, payload, att, log_id,
                 timeout_ms, max_retry, response, cntl, done, span=None):
        self.channel = channel
        self.md = md
        self.svc_b = svc_b
        self.meth_b = meth_b
        self.payload = payload
        self.att = att
        self.log_id = log_id
        self.timeout_ms = timeout_ms
        self.max_retry = max_retry
        self.retries = 0
        self.deadline = (_time.monotonic() + timeout_ms / 1000.0) \
            if timeout_ms and timeout_ms > 0 else 0.0
        self.start_ns = _time.perf_counter_ns()
        self.response = response
        if cntl is None:
            cntl = FastClientController()
        self.cntl = cntl
        self.done = done
        self.sock = None
        self.span = span
        self.settled = False
        # join() support: the controller the caller holds can block until
        # completion like the slow path's call-id join — but the Event is
        # LAZY (join_wait): done-style callers never join, and an Event
        # alloc+set per RPC is measurable at pipelined rates
        self.join_ev = None
        cntl._fast_call_ref = self

    def issue(self):
        """True = in flight; None = not a native socket (caller falls back
        to the full pipeline; only possible before the first send)."""
        global _nt
        if _nt is None:
            from brpc_tpu_torch.rpc import native_transport

            _nt = native_transport
        FastCallRec = _nt.FastCallRec
        NativeSocket = _nt.NativeSocket
        _fast_cid = _nt._fast_cid
        on_flusher_thread = _nt.on_flusher_thread

        ch = self.channel
        single = ch.options.connection_type == "single"
        sock = ch._fast_sock if single else None
        try:
            if sock is None or sock.failed or ch._lb is not None:
                sock = ch._select_socket(self.cntl)
                if single and ch._lb is None \
                        and isinstance(sock, NativeSocket):
                    ch._fast_sock = sock
        except errors.SelectError as e:
            self._finalize(e.code, str(e))
            return True
        except Exception as e:
            return self._retry_or_finalize(errors.EHOSTDOWN, str(e))
        if not isinstance(sock, NativeSocket):
            ch._release_socket(sock, True)  # unused checkout goes back
            if self.retries == 0:
                return None
            self._finalize(errors.EHOSTDOWN, "server set changed lanes")
            return True
        self.sock = sock
        cid = next(_fast_cid)
        rec = FastCallRec()
        rec.on_complete = self._complete
        rec.deadline = self.deadline
        sock._fast_calls[cid] = rec
        if sock.failed:
            if sock._fast_calls.pop(cid, None) is None:
                # set_failed's fan-out took our entry: IT owns completion
                # (a second path here would double-run done)
                return True
            return self._retry_or_finalize(errors.EFAILEDSOCKET,
                                           "socket failed")
        span = self.span
        # capture sizes BEFORE the send: the GIL is released inside the
        # ctypes call, so completion may run before this thread resumes
        nbytes = len(self.payload) + len(self.att)
        rc = sock._dp.call2(sock.conn_id, self.svc_b, self.meth_b, cid,
                            self.log_id, self.timeout_ms, self.payload,
                            self.att, on_flusher_thread(),
                            span.trace_id if span else 0,
                            span.span_id if span else 0)
        if rc != 0:
            if sock._fast_calls.pop(cid, None) is None:
                return True  # concurrent failure fan-out owns completion
            if rc in (1, 2, 5):
                sock.set_failed(errors.EFAILEDSOCKET,
                                f"native send failed ({rc})")
            return self._retry_or_finalize(_map_dpe(rc),
                                           f"native send failed ({rc})")
        sock.out_messages += 1
        sock.out_bytes += nbytes
        return True

    def _retry_or_finalize(self, code: int, text: str):
        if code in errors.DEFAULT_RETRYABLE and self.retries < self.max_retry \
                and (not self.deadline or _time.monotonic() < self.deadline):
            self.retries += 1
            if self.sock is not None \
                    and self.channel.options.connection_type != "single":
                self.channel._release_socket(self.sock, False)
                self.sock = None
            from brpc_tpu_torch.rpc.native_transport import on_flusher_thread

            if on_flusher_thread():
                # re-issuing may reconnect (a blocking TCP connect) — never
                # on the poller; hand the retry to a fiber
                from brpc_tpu_torch.fiber import runtime as _rt

                _rt.start_background(self._reissue)
            else:
                self._reissue()
            return True
        self._finalize(code, text)
        return True

    def _reissue(self) -> None:
        r = self.issue()
        if r is None:
            self._finalize(errors.EHOSTDOWN, "server set changed lanes")

    def join_wait(self, timeout=None) -> bool:
        if self.settled:
            return True
        ev = self.join_ev
        if ev is None:
            with _join_install_lock:  # two joiners must share ONE event
                ev = self.join_ev
                if ev is None:
                    ev = threading.Event()
                    self.join_ev = ev
            if self.settled:  # finalize raced the install: don't hang
                ev.set()
        return ev.wait(timeout)

    def _complete(self, rec) -> None:
        if rec.code != errors.OK:
            self._retry_or_finalize(rec.code, rec.text)
            return
        body = rec.body
        resp_att = b""
        if rec.att_size:
            cut = len(body) - rec.att_size
            resp_att = body[cut:]
            body = body[:cut]
        code, text = errors.OK, ""
        t_parse = _time.perf_counter_ns()
        try:
            if self.response is not None:
                self.response.ParseFromString(body)
        except Exception as e:
            code, text = errors.ERESPONSE, f"parse response: {e}"
        if self.span is not None:
            self.span.response_size = len(rec.body)
            self.span.add_phase(
                "parse_us", (_time.perf_counter_ns() - t_parse) / 1000.0)
        self.cntl.response_attachment = resp_att
        self._finalize(code, text)

    def _finalize(self, code: int, text: str) -> None:
        if self.settled:  # double-completion guard (failure fan-out races)
            return
        self.settled = True
        cntl = self.cntl
        cntl._error_code = code
        cntl._error_text = text or (errors.error_text(code) if code else "")
        cntl.latency_us = (_time.perf_counter_ns() - self.start_ns) // 1000
        cntl._current_socket = self.sock
        cntl._retry_count = self.retries
        if isinstance(cntl, Controller):
            cntl._finished = True
            cntl._response = self.response
        else:
            cntl.response = self.response
        ch = self.channel
        ch.latency_recorder.record(cntl.latency_us)
        if self.span is not None:
            self.span.request_size = len(self.payload) + len(self.att)
            self.span.end(code)
        if ch._lb is not None and self.sock is not None \
                and getattr(self.sock, "remote", None) is not None:
            ch._lb.feedback(self.sock.remote, code, cntl.latency_us)
        if ch.options.connection_type != "single":
            ch._release_socket(self.sock, code == errors.OK)
        ev = self.join_ev
        if ev is not None:  # joiners wake before done runs (slow-path order)
            ev.set()
        try:
            self.done(cntl)
        except Exception:
            import logging

            logging.getLogger("brpc_tpu_torch").exception("fast done raised")
        # break the cntl <-> call reference cycle so the call (and its
        # payload/attachment bytes) is refcount-freed the moment the last
        # holder drops it; a post-completion join() falls through to the
        # settled/call-id path and returns immediately
        cntl._fast_call_ref = None


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
