"""Controller — per-RPC state machine, client and server roles.

Rebuild of ``controller.cpp`` (client path: IssueRPC :1047,
OnVersionedRPCReturned :598, EndRPC :874; server path: peer/attachment
accessors). Every client-side state transition — response arrival, timeout,
socket failure, backup-request fire, retry — happens under the RPC's call-id
lock, and stale attempt responses are rejected by attempt-version
verification (the controller.cpp:1059-1066 race guard).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from brpc_tpu_torch.fiber import call_id as _cid
from brpc_tpu_torch.fiber.timer import timer_add, timer_del
from brpc_tpu_torch.policy import compress as _compress
from brpc_tpu_torch.proto import rpc_meta_pb2
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.trace import span as _span


class Controller:
    def __init__(self):
        # shared
        self._error_code = errors.OK
        self._error_text = ""
        self.request_attachment = b""
        self.response_attachment = b""
        self.log_id = 0
        # multi-tenant QoS identity: rides RequestMeta like log_id does
        # (client sets before the call; server side carries the decoded
        # values for admission/fair-share billing). priority: higher =
        # more protected under overload shedding.
        self.tenant_id = ""
        self.priority = 0
        self.compress_type = _compress.COMPRESS_NONE
        # client side
        self.timeout_ms: Optional[int] = None
        self.backup_request_ms: Optional[int] = None
        self.max_retry: Optional[int] = None
        self._retry_count = 0
        self._backup_sent = False
        self._call_id: Optional[int] = None
        self._channel = None
        self._method = None
        self._request = None
        self._response = None
        self._done: Optional[Callable] = None
        self._timeout_timer: Optional[int] = None
        self._backup_timer: Optional[int] = None
        self._start_us = 0
        self.latency_us = 0
        self._current_socket = None
        # pooled/short sockets displaced by retries/backup attempts: their
        # checkouts are ambiguous and must close at RPC end (a stale
        # response must never reach the next pooled checkout)
        self._extra_conn_sockets = []
        self._finished = False
        # server side
        self.is_server_side = False
        self.server = None
        self.peer = None
        self.method_name = ""
        self.service_name = ""
        self._srv_meta = None
        self._srv_socket = None
        self._response_sent = False
        self.http_request = None  # HttpMessage when the call arrived via http
        self.auth_context = None  # AuthContext from the server Authenticator
        # streaming
        self.stream_id = 0            # client: stream created before call
        self._accepted_stream_id = 0  # server: stream accepted in handler
        # tracing
        self.span = None

    # ----------------------------------------------------------------- state
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

    def call_id(self) -> Optional[int]:
        return self._call_id

    @property
    def response(self):
        return self._response

    # ============================================================ client role
    def _begin_call(self, channel, method, request, response, done) -> int:
        self._channel = channel
        self._method = method
        self._request = request
        self._response = response
        self._done = done
        self._start_us = time.perf_counter_ns() // 1000
        if self.span is None:
            self.span = _span.start_client_span(
                method.service_name, method.method_name,
                parent=_span.current_span())
        self._call_id = _cid.id_create(data=self, on_error=_handle_id_error)
        opts = channel.options
        if self.timeout_ms is None:
            self.timeout_ms = opts.timeout_ms
        if self.max_retry is None:
            self.max_retry = opts.max_retry
        if self.backup_request_ms is None:
            self.backup_request_ms = opts.backup_request_ms
        if self.timeout_ms and self.timeout_ms > 0:
            self._timeout_timer = timer_add(
                _fire_id_error, self.timeout_ms / 1000.0,
                self._call_id, errors.ERPCTIMEDOUT,
            )
        if self.backup_request_ms and self.backup_request_ms > 0:
            self._backup_timer = timer_add(
                _fire_id_error, self.backup_request_ms / 1000.0,
                self._call_id, errors.EBACKUPREQUEST,
            )
        return self._call_id

    def _issue_rpc(self) -> None:
        """Pick a socket, pack, write. Caller holds the call-id lock."""
        if self.span is not None:
            # the span is "current" across dial + write so the transport
            # (tpu:// credit stalls, healer dials) annotates this attempt
            prev_span = _span.set_current(self.span)
            try:
                self._issue_rpc_inner()
            finally:
                _span.set_current(prev_span)
        else:
            self._issue_rpc_inner()

    def _issue_rpc_inner(self) -> None:
        cid = self._call_id
        try:
            sock = self._channel._select_socket(self)
        except errors.SelectError as e:
            self._error_text = str(e)
            _cid.id_error(cid, e.code)
            return
        except Exception as e:
            # route the failure through the error channel (deferred while we
            # hold the lock) so retry logic sees one uniform path
            self._error_text = str(e)
            _cid.id_error(cid, errors.EHOSTDOWN)
            return
        prev = self._current_socket
        if prev is not None and prev is not sock and (
                getattr(prev, "_brpc_pool_key", None) is not None
                or getattr(prev, "_brpc_short", False)):
            self._extra_conn_sockets.append(prev)
        self._current_socket = sock
        meta = rpc_meta_pb2.RpcMeta()
        meta.request.service_name = self._method.service_name
        meta.request.method_name = self._method.method_name
        meta.request.log_id = self.log_id
        meta.request.timeout_ms = self.timeout_ms or 0
        if self.tenant_id:
            meta.request.tenant_id = self.tenant_id
        if self.priority:
            meta.request.priority = self.priority
        meta.correlation_id = cid
        meta.attempt_version = _cid.id_version(cid)
        meta.compress_type = self.compress_type
        auth = self._channel.options.auth
        if auth is not None:
            meta.auth_token = auth.generate_credential()
        if self.span is not None:
            meta.request.trace_id = self.span.trace_id
            meta.request.span_id = self.span.span_id
        if self.stream_id:
            from brpc_tpu_torch.rpc.stream import get_stream

            stream = get_stream(self.stream_id)
            if stream is not None:
                meta.stream_settings.stream_id = self.stream_id
                meta.stream_settings.window_bytes = stream.options.window_bytes
                meta.stream_settings.need_feedback = True
        t_ser = time.perf_counter_ns() if self.span is not None else 0
        payload = _compress.compress(
            self._request.SerializeToString(), self.compress_type
        )
        if self.span is not None:
            # request marshalling mirrors response parse — stamp it so a
            # multi-MB request doesn't read as unattributed span time
            self.span.add_phase(
                "parse_us", (time.perf_counter_ns() - t_ser) / 1000.0)
        proto = self._channel._protocol
        if hasattr(proto, "issue_request"):
            # connection-scoped protocols (grpc/h2) pack+write themselves:
            # stream allocation and HPACK emission need the socket
            t_iss = time.perf_counter_ns() if self.span is not None else 0
            rc = proto.issue_request(
                sock, meta, payload, self.request_attachment,
                checksum=self._channel.options.enable_checksum, id_wait=cid)
            if self.span is not None:
                # stream open + HPACK emission + DATA write is this lane's
                # whole send pipeline: without the mark an h2 client span
                # shows an empty timeline between serialize and the wait
                self.span.add_phase(
                    "send_us", (time.perf_counter_ns() - t_iss) / 1000.0)
        else:
            t_pack = time.perf_counter_ns() if self.span is not None else 0
            packet = proto.pack_request(
                meta, payload, self.request_attachment,
                checksum=self._channel.options.enable_checksum,
            )
            if self.span is not None:
                # packetization is the head of the send pipeline
                self.span.add_phase(
                    "send_us", (time.perf_counter_ns() - t_pack) / 1000.0)
            rc = sock.write(packet, id_wait=cid)
        if rc not in (0, errors.EFAILEDSOCKET):
            # overcrowded etc: surface through the error channel
            _cid.id_error(cid, rc)

    # ----------------------------------------------------- error/retry logic
    def _on_id_error(self, code: int, text: str = "") -> None:
        """Runs with the call-id lock held."""
        if self._finished:
            _cid.id_unlock(self._call_id)
            return
        if code == errors.EBACKUPREQUEST:
            # hedge: duplicate the attempt, same version — first response wins
            backup_policy = (self._channel.options.backup_request_policy
                             if self._channel is not None else None)
            try:
                allowed = (backup_policy is None
                           or backup_policy.do_backup(self))
            except Exception:  # buggy user policy must not wedge the id lock
                allowed = False
            if allowed and not self._backup_sent and not self.failed():
                self._backup_sent = True
                self._issue_rpc()
            _cid.id_unlock(self._call_id)
            return
        # consult the channel's retry policy (reference RetryPolicy::DoRetry
        # — runs with error_code visible on the controller)
        prev_code = self._error_code
        self._error_code = code
        policy = (self._channel.options.retry_policy
                  if self._channel is not None else None)
        if code == errors.ERPCTIMEDOUT:
            # the deadline budget is spent and its timer gone — a "retry"
            # here would run with no timeout at all
            retryable = False
        elif policy is not None:
            try:
                retryable = bool(policy.do_retry(self))
            except Exception:  # buggy user policy -> no retry, finish the RPC
                retryable = False
        else:
            retryable = code in errors.DEFAULT_RETRYABLE
        self._error_code = prev_code
        if retryable and self._retry_count < (self.max_retry or 0):
            self._retry_count += 1
            _cid.id_bump_version(self._call_id)  # stale responses now dropped
            self._issue_rpc()
            _cid.id_unlock(self._call_id)
            return
        self.set_failed(code, text)
        self._finish_locked()

    def _on_response(self, meta, payload: bytes, attachment: bytes) -> None:
        """Runs with the call-id lock held (version already verified)."""
        if self._finished:
            _cid.id_unlock(self._call_id)
            return
        if meta.response.error_code == errors.EFAILEDSOCKET:
            # the server's lane to the handler failed before it answered
            # (a shard worker died with the call): a socket failure, so
            # the retry policy and max_retry decide, as on the fast path
            self._on_id_error(errors.EFAILEDSOCKET,
                              meta.response.error_text)
            return
        if meta.response.error_code != errors.OK:
            self.set_failed(meta.response.error_code,
                            meta.response.error_text)
            self._finish_locked()
            return
        if self.span is not None:
            self.span.response_size = len(payload) + len(attachment)
        t_parse = time.perf_counter_ns()
        try:
            data = _compress.decompress(payload, meta.compress_type)
            if self._response is not None:
                self._response.ParseFromString(data)
            self.response_attachment = attachment
        except Exception as e:
            self.set_failed(errors.ERESPONSE, f"parse response: {e}")
        if self.span is not None:
            self.span.add_phase(
                "parse_us", (time.perf_counter_ns() - t_parse) / 1000.0)
        if (self.stream_id and not self.failed()
                and meta.stream_settings.stream_id):
            # the server accepted: bind our stream to this connection,
            # addressing the server's stream id
            from brpc_tpu_torch.rpc.stream import get_stream

            stream = get_stream(self.stream_id)
            if stream is not None:
                stream.bind(self._current_socket,
                            meta.stream_settings.stream_id,
                            peer_window=meta.stream_settings.window_bytes)
        self._finish_locked()

    def _finish_locked(self) -> None:
        """Complete the RPC: cancel timers, wake joiners, run done."""
        self._finished = True
        cid = self._call_id
        if self._timeout_timer is not None:
            timer_del(self._timeout_timer)
        if self._backup_timer is not None:
            timer_del(self._backup_timer)
        if self._current_socket is not None:
            self._current_socket.remove_pending_id(cid)
        if self._channel is not None:
            # pooled/short checkouts end with the RPC: displaced attempts
            # close; the final socket pools only on a clean OK (backup
            # hedges leave an abandoned in-flight request behind)
            for s in self._extra_conn_sockets:
                self._channel._release_socket(s, False)
            self._extra_conn_sockets.clear()
            self._channel._release_socket(
                self._current_socket,
                self._error_code == errors.OK and not self._backup_sent)
        self.latency_us = time.perf_counter_ns() // 1000 - self._start_us
        if self._error_code != errors.OK:
            from brpc_tpu_torch import flags as _flags

            if _flags.get("log_error_text"):
                import logging

                logging.getLogger("brpc_tpu_torch").warning(
                    "RPC %s.%s failed: [E%d] %s",
                    self._method.service_name if self._method else "?",
                    self._method.method_name if self._method else "?",
                    self._error_code, self._error_text)
        if self.span is not None:
            if self._retry_count:
                self.span.annotate(f"retries={self._retry_count}")
            if self._backup_sent:
                self.span.annotate("backup request sent")
            self.span.end(self._error_code)
        if self._channel is not None:
            self._channel._on_rpc_end(self)
        done = self._done
        _cid.id_about_to_destroy(cid)
        _cid.id_unlock_and_destroy(cid)
        if done is not None:
            if getattr(threading.current_thread(), "brpc_no_user_code",
                       False):
                # completing inline on an I/O/poller thread: user code may
                # block (even issue sync RPCs) — hand it to a fiber worker
                from brpc_tpu_torch.fiber import runtime as _rt

                _rt.start_background(_run_done, done, self)
            else:
                try:
                    done(self)
                except Exception:
                    pass

    def join(self, timeout: Optional[float] = None) -> bool:
        call = getattr(self, "_fast_call_ref", None)
        if call is not None:  # async fast-path call: no call id
            return call.join_wait(timeout)
        if self._call_id is None:
            return True
        return _cid.id_join(self._call_id, timeout)

    # ============================================================ server role
    def create_progressive_attachment(self):
        """Server-side, HTTP only: stream the response body in chunks after
        the RPC completes (reference Controller::CreateProgressiveAttachment,
        progressive_attachment.cpp). The pb response is not serialized into
        the body; chunks written to the returned object ARE the body."""
        if not self.is_server_side or self.http_request is None:
            # the reference returns NULL off-HTTP; silently buffering data
            # that no response path will ever flush is worse than failing
            raise ValueError("progressive attachments are HTTP-only "
                             "(this request arrived via a binary protocol)")
        from brpc_tpu_torch.rpc.progressive import ProgressiveAttachment

        pa = ProgressiveAttachment()
        self._progressive = pa
        return pa

    @classmethod
    def server_controller(cls, server, sock, meta) -> "Controller":
        c = cls()
        c.is_server_side = True
        c.server = server
        c._srv_socket = sock
        c._srv_meta = meta
        c.peer = sock.remote
        c.service_name = meta.request.service_name
        c.method_name = meta.request.method_name
        c.log_id = meta.request.log_id
        c.tenant_id = meta.request.tenant_id
        c.priority = meta.request.priority
        return c


def _handle_id_error(data, call_id: int, code: int) -> None:
    """on_error hook registered at id_create; lock is held on entry."""
    cntl: Controller = data
    cntl._on_id_error(code)


def _run_done(done, cntl) -> None:
    try:
        done(cntl)
    except Exception:
        pass


def _fire_id_error(call_id: int, code: int) -> None:
    """Timer thread -> error channel (never blocks the timer thread long)."""
    _cid.id_error(call_id, code)


def handle_response_message(msg) -> None:
    """Client-side entry from InputMessenger (reference ProcessRpcResponse).

    Protocol-generic: any protocol that can produce an RpcMeta-shaped
    ``msg.meta`` (trpc_std natively; http by header synthesis) funnels
    through the same attempt-version verification and completion path.
    """
    meta = msg.meta
    cid = meta.correlation_id
    try:
        cntl = _cid.id_lock_verify(cid, meta.attempt_version)
    except _cid.IdGone:
        # Stale attempt or finished RPC. The cut-time claim_cid removed the
        # socket's pending entry for this cid; if the call is still LIVE
        # (newer attempt in flight), restore the entry so a later socket
        # failure still reaches the call (pre-claim semantics).
        sock = msg.socket
        if sock is None:
            return
        try:
            _cid.id_version(cid)
        except _cid.IdGone:
            return  # finished RPC: nothing to restore
        if sock.failed:
            # fan-out already ran without our entry: deliver ourselves
            _cid.id_error(cid, sock.error_code or errors.EFAILEDSOCKET)
            return
        sock.add_pending_id(cid)
        if sock.failed and sock.remove_pending_id(cid):
            # set_failed snapshotted before our add AND nobody else took
            # the entry (remove returned True) — deliver exactly once
            _cid.id_error(cid, sock.error_code or errors.EFAILEDSOCKET)
        return
    if cntl.span is not None:
        # queue_us on a client span: response cut on the wire (stamped by
        # the parse loop) -> this dispatch
        arrival = getattr(msg, "arrival", 0.0)
        if arrival:
            cntl.span.add_phase(
                "queue_us", max(0.0, (time.monotonic() - arrival) * 1e6))
    t_split = time.perf_counter_ns() if cntl.span is not None else 0
    payload, attachment = msg.protocol.split_attachment(msg)
    ok = msg.protocol.verify_checksum(meta, payload)
    if cntl.span is not None:
        # attachment split + checksum walk the whole body: wire-format
        # parsing, so it rides the parse mark — plus whatever frame-path
        # parse work a stateful protocol banked on the message
        cntl.span.add_phase(
            "parse_us", getattr(msg, "pre_parse_us", 0.0)
            + (time.perf_counter_ns() - t_split) / 1000.0)
    if not ok:
        cntl.set_failed(errors.ERESPONSE, "response checksum mismatch")
        cntl._finish_locked()
        return
    cntl._on_response(meta, payload, attachment)
