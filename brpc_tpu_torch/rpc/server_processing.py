"""Server-side request processing (reference ProcessRpcRequest,
policy/baidu_rpc_protocol.cpp:565-854, and SendRpcResponse :270).

Pipeline: logoff/admission checks -> service+method lookup -> attachment
split -> checksum -> decompress+parse -> user code -> send response. Each
request runs in its own fiber task (pipelined requests on one connection
execute concurrently and may complete out of order — responses carry the
correlation id). User methods may complete synchronously (return a
response) or keep ``done`` and call it later from any thread; method stats
are settled exactly once either way.
"""

from __future__ import annotations

import time

from brpc_tpu_torch import fault as _fault
from brpc_tpu_torch.metrics.reducer import Adder
from brpc_tpu_torch.policy import compress as _compress
from brpc_tpu_torch.proto import rpc_meta_pb2
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.profiling import registry as _prof
from brpc_tpu_torch.rpc.controller import Controller
from brpc_tpu_torch.trace import span as _tspan

# per-thread phase marker for the statistical profiler: the sampler reads
# it from outside this thread to attribute CPU samples to span phases
_set_phase = _prof.set_phase

# requests rejected because their client timeout budget was already spent
# before the handler could run (server-side deadline enforcement)
g_server_deadline_expired = Adder("g_server_deadline_expired")

_fault.register("rpc.handler.crash",
                "raise inside the service method (both dispatch paths) — "
                "must surface as EINTERNAL, never a dead connection")
_fault.register("rpc.handler.delay",
                "sleep delay_ms inside the service method (both dispatch "
                "paths) before user code runs — the stall lands in the "
                "span's execute_us phase, so a record->replay->diff loop "
                "must localize it there (match_method= filters)")

# phase marks other layers may stamp while user code runs: handler wall
# time is reported net of these so a span's phases stay additive
_EXEC_EXCLUDE = ("respond_us", "send_us", "credit_wait_us", "batch_wait_us")


def _other_marks(span) -> float:
    if span is None:
        return 0.0
    ph = span.phases
    return sum(ph.get(k, 0.0) for k in _EXEC_EXCLUDE)


def run_interceptor(server, cntl):
    """Global interception hook (reference interceptor.h Accept): returns
    None to accept or an (error_code, error_text) reject tuple. A hook
    that raises OR returns a malformed verdict rejects with EINTERNAL —
    it must never leave the request unanswered."""
    try:
        verdict = server.options.interceptor(cntl)
        if verdict is None:
            return None
        return (int(verdict[0]),
                str(verdict[1]) if len(verdict) > 1 else "")
    except Exception as e:
        return (errors.EINTERNAL, f"interceptor error: {e}")


def process_rpc_request(protocol, msg, server) -> None:
    meta = msg.meta
    sock = msg.socket
    if server is None:
        return  # request arrived on a client-only connection: drop
    # the common trpc_std request — no auth/interceptor/dump hooks, no
    # attachment/checksum/compress/stream policy riding the meta — takes
    # the slim lane: FastServerController + a slotted done instead of the
    # full Controller and two closures per request. Anything unusual (or a
    # method-lookup miss, which may route to the master service) falls
    # through to the complete pipeline below.
    if (protocol.name == "trpc_std"
            and server.options.auth is None
            and server.options.interceptor is None
            and server.rpc_dumper is None
            and not meta.attachment_size
            and not meta.checksum
            and meta.compress_type == _compress.COMPRESS_NONE
            and not meta.HasField("stream_settings")
            and _process_request_slim(protocol, msg, server, meta)):
        return
    server.requests_processed.put(1)
    cntl = Controller.server_controller(server, sock, meta)
    from brpc_tpu_torch.trace import span as _span

    cntl.span = _span.start_server_span(
        meta, meta.request.service_name, meta.request.method_name,
        peer=str(sock.remote))
    if cntl.span is not None:
        # queue_us: wire arrival (stamped by the parse loop) -> dispatch.
        # The span's clock starts at dispatch, so rewind its start to the
        # arrival instant — the queue wait is part of the request's life
        # and the phase marks must stay additive within the span window
        arrival = getattr(msg, "arrival", 0.0)
        if arrival:
            q_us = max(0.0, (time.monotonic() - arrival) * 1e6)
            cntl.span.start_mono_us -= q_us
            cntl.span.start_us -= q_us
            cntl.span.add_phase("queue_us", q_us)

    def send_error(code: int, text: str = "") -> None:
        if cntl.span is not None:  # rejected requests must reach /rpcz too
            cntl.span.end(code)
        _send_response(protocol, sock, meta, code,
                       text or errors.error_text(code),
                       b"", b"", _compress.COMPRESS_NONE)

    if not server.is_running:
        return send_error(errors.ELOGOFF)
    if not server.add_concurrency():
        return send_error(errors.ELIMIT, "server max_concurrency reached")
    start_us = time.perf_counter_ns() // 1000

    # ---- server-side deadline: timeout_ms rides the RequestMeta but was
    # never checked here — a request whose client budget is already spent
    # (queueing, decompress backlog) would compute a response nobody waits
    # for. Reject before the handler; batch enqueue re-checks deadline_mono.
    budget_ms = int(meta.request.timeout_ms or 0)
    if budget_ms > 0:
        arrival = getattr(msg, "arrival", 0.0)
        if arrival:
            if (time.monotonic() - arrival) * 1000.0 >= budget_ms:
                g_server_deadline_expired.put(1)
                server.sub_concurrency()
                return send_error(
                    errors.ERPCTIMEDOUT,
                    f"request deadline ({budget_ms}ms) already spent "
                    f"before dispatch")
            cntl.deadline_mono = arrival + budget_ms / 1000.0

    # ---- admission + lookup; failures settle server concurrency here
    err = None
    entry = None
    try:
        auth_ctx = None
        if server.options.auth is not None:
            auth_ctx = server.options.auth.verify_credential(
                meta.auth_token, sock.remote)
        if server.options.auth is not None and auth_ctx is None:
            err = (errors.EAUTH, "")
        else:
            cntl.auth_context = auth_ctx
        if err is None and server.options.interceptor is not None:
            err = run_interceptor(server, cntl)
        if err is None:
            service = server.find_service(meta.request.service_name)
            if service is None:
                err = (errors.ENOSERVICE,
                       f"no service {meta.request.service_name!r}")
            else:
                entry = service.find_method(meta.request.method_name)
                if entry is None:
                    err = (errors.ENOMETHOD,
                           f"no method {meta.request.method_name!r}")
                elif not entry.on_request():
                    entry = None
                    err = (errors.ELIMIT, "method concurrency limit")
            if entry is None and server._master_service is not None \
                    and err[0] in (errors.ENOSERVICE, errors.ENOMETHOD):
                # catch-all generic service takes UNMATCHED requests only
                # (reference baidu_master_service.cpp) — a known method shed
                # by its concurrency limit must stay ELIMIT, not get
                # re-executed by the proxy
                entry = server._master_service.find_method("*")
                if entry.on_request():
                    err = None
                else:
                    entry = None
                    err = (errors.ELIMIT, "master service concurrency limit")
    except BaseException:
        server.sub_concurrency()
        raise
    if entry is None:
        server.sub_concurrency()
        return send_error(*err)
    # `entry` accounting from here on settles exactly once through _settle.
    settled = [False]
    # v2 dump record opened at dispatch, committed at settle so it carries
    # the span's COMPLETE phase timeline (rpc_dump.RpcDumper.begin/commit)
    pending_dump = [None]
    # tail retention twin: opened when the head sampler passed but tail
    # mode is on — the retention decision happens at settle (trace/tail.py)
    pending_tail = [None]

    def _settle(error_code: int) -> None:
        if settled[0]:
            return
        settled[0] = True
        entry.on_response(time.perf_counter_ns() // 1000 - start_us, error_code)
        server.sub_concurrency()
        if cntl.span is not None:
            cntl.span.end(error_code)
        if pending_dump[0] is not None:
            dumper = getattr(server, "rpc_dumper", None)
            if dumper is not None:
                dumper.commit(pending_dump[0], cntl.span, error_code)
        elif pending_tail[0] is not None:
            retainer = getattr(server, "tail_retainer", None)
            if retainer is not None:
                retainer.offer(pending_tail[0], cntl.span, error_code,
                               entry.latency.latency_percentile(0.99))

    responded = [False]

    def done(response=None) -> None:
        if responded[0]:
            return
        responded[0] = True
        prev_ph = _set_phase("respond")
        t_resp = time.perf_counter_ns()
        payload_out = b""
        if response is not None and not cntl.failed():
            payload_out = _compress.compress(
                response.SerializeToString(), cntl.compress_type
            )
        accepted = cntl._accepted_stream_id
        if accepted and cntl.failed():
            # the client will never bind to a failed RPC's stream — reclaim
            # it instead of leaking it in the pool holding the socket
            from brpc_tpu_torch.rpc.stream import stream_close

            stream_close(accepted)
            accepted = 0
        # the span is "current" across the response write so the tunnel's
        # send pipeline (credit stalls, quanta) annotates THIS request
        prev = _span.set_current(cntl.span)
        try:
            _send_response(
                protocol, sock, meta, cntl.error_code, cntl.error_text(),
                payload_out, cntl.response_attachment, cntl.compress_type,
                accepted_stream_id=accepted,
            )
        finally:
            _span.set_current(prev)
        if cntl.span is not None:
            cntl.span.response_size = (len(payload_out)
                                       + len(cntl.response_attachment or b""))
            # respond_us excludes transport phases recorded during the
            # write (send/credit_wait are their own marks)
            el = (time.perf_counter_ns() - t_resp) / 1000.0
            ph = cntl.span.phases
            el -= ph.get("send_us", 0.0) + ph.get("credit_wait_us", 0.0)
            cntl.span.add_phase("respond_us", max(0.0, el))
        _set_phase(prev_ph)
        _settle(cntl.error_code)

    try:
        _set_phase("parse")
        t_split = time.perf_counter_ns() if cntl.span is not None else 0
        payload, attachment = protocol.split_attachment(msg)
        if cntl.span is not None:
            cntl.span.request_size = len(payload) + len(attachment)
        dumper = getattr(server, "rpc_dumper", None)
        if dumper is not None and dumper.ask_to_be_sampled():
            pending_dump[0] = dumper.begin(meta, payload + attachment)
        elif dumper is not None:
            retainer = getattr(server, "tail_retainer", None)
            if retainer is not None and retainer.enabled():
                pending_tail[0] = dumper.begin(meta, payload + attachment)
        checksum_ok = protocol.verify_checksum(meta, payload)
        if cntl.span is not None:
            # attachment split + checksum walk the whole body: wire-format
            # parsing, so it rides the parse mark
            cntl.span.add_phase(
                "parse_us", (time.perf_counter_ns() - t_split) / 1000.0)
        if not checksum_ok:
            cntl.set_failed(errors.EREQUEST, "request checksum mismatch")
            return done()
        t_parse = time.perf_counter_ns()
        try:
            data = _compress.decompress(payload, meta.compress_type)
            request = entry.request_class()
            request.ParseFromString(data)
        except Exception as e:
            cntl.set_failed(errors.EREQUEST, f"parse request: {e}")
            return done()
        if cntl.span is not None:
            cntl.span.add_phase(
                "parse_us", (time.perf_counter_ns() - t_parse) / 1000.0)
        cntl.request_attachment = attachment

        # USER CODE (reference svc->CallMethod, :838-854); the server span
        # is "current" while it runs so downstream calls stitch the trace
        prev_span = _span.set_current(cntl.span)
        _set_phase("execute")
        t_exec = time.perf_counter_ns()
        ex0 = _other_marks(cntl.span)
        try:
            if _fault.hit("rpc.handler.crash") is not None:
                raise RuntimeError("fault injected handler crash")
            _fault.maybe_sleep(
                _fault.hit("rpc.handler.delay",
                           method=meta.request.method_name))
            ret = entry.fn(cntl, request, done)
        except Exception as e:  # user bug -> EINTERNAL, not a dead connection
            cntl.set_failed(errors.EINTERNAL, f"method raised: {e}")
            ret = None
        finally:
            _span.set_current(prev_span)
            if cntl.span is not None:
                # handler wall time minus marks other layers stamped while
                # it ran (inline done(), batch flush) — keeps phases additive
                el = (time.perf_counter_ns() - t_exec) / 1000.0
                cntl.span.add_phase(
                    "execute_us",
                    max(0.0, el - (_other_marks(cntl.span) - ex0)))
        if not responded[0] and (ret is not None or cntl.failed()):
            done(ret)
        # else: user code kept `done` for async completion; stats settle then
    except BaseException:
        _settle(errors.EINTERNAL)
        raise
    finally:
        _set_phase(None)


# ===================================================================== slim
# The reference's Python-socket counterpart of its native fast path: the
# same admission state machine with a FastServerController, responses
# packed through protocol.pack_response and written to the request's
# socket. Every small TCP request without stream settings takes it (queued
# AND run-to-completion dispatch both land here via process_rpc_request).

_slim_collector = None


def _slim_error(protocol, sock, meta, span, code: int, text: str = "") -> None:
    if span is not None:  # rejected requests must reach /rpcz too
        span.end(code)
    _send_response(protocol, sock, meta, code,
                   text or errors.error_text(code),
                   b"", b"", _compress.COMPRESS_NONE)


class _SlimDone:
    """The slim path's `done` callable + stats settlement in one slotted
    object (the full path builds two closures and two flag cells per
    request; this allocates once)."""

    __slots__ = ("protocol", "sock", "meta", "cntl", "entry", "server",
                 "start_us", "responded", "settled")

    def __init__(self, protocol, sock, meta, cntl, entry, server, start_us):
        self.protocol = protocol
        self.sock = sock
        self.meta = meta
        self.cntl = cntl
        self.entry = entry
        self.server = server
        self.start_us = start_us
        self.responded = False
        self.settled = False

    def __call__(self, response=None) -> None:
        if self.responded:
            return
        self.responded = True
        prev_ph = _set_phase("respond")
        cntl = self.cntl
        span = cntl.span
        t_resp = time.perf_counter_ns() if span is not None else 0
        payload_out = b""
        ct = cntl.compress_type
        if response is not None and not cntl.failed():
            payload_out = _compress.compress(response.SerializeToString(),
                                             ct)
        code = cntl._error_code
        meta = self.meta
        rmeta = rpc_meta_pb2.RpcMeta()
        rmeta.response.error_code = code
        if code != errors.OK:
            rmeta.response.error_text = cntl._error_text
        rmeta.correlation_id = meta.correlation_id
        rmeta.attempt_version = meta.attempt_version
        rmeta.compress_type = ct
        packet = self.protocol.pack_response(
            rmeta, payload_out, cntl.response_attachment, checksum=False)
        if span is not None:
            # span "current" across the write: the tunnel's send pipeline
            # (credit stalls, quanta) annotates THIS request
            prev = _tspan.set_current(span)
            try:
                self.sock.write(packet)
            finally:
                _tspan.set_current(prev)
            span.response_size = (len(payload_out)
                                  + len(cntl.response_attachment or b""))
            el = (time.perf_counter_ns() - t_resp) / 1000.0
            ph = span.phases
            el -= ph.get("send_us", 0.0) + ph.get("credit_wait_us", 0.0)
            span.add_phase("respond_us", max(0.0, el))
        else:
            self.sock.write(packet)
        _set_phase(prev_ph)
        self.settle(code)

    def settle(self, error_code: int) -> None:
        if self.settled:
            return
        self.settled = True
        self.entry.on_response(
            time.perf_counter_ns() // 1000 - self.start_us, error_code)
        self.server.sub_concurrency()
        span = self.cntl.span
        if span is not None:
            span.end(error_code)


def _process_request_slim(protocol, msg, server, meta) -> bool:
    """Returns False (before touching any request state) when the caller
    should take the full pipeline instead — only a method-lookup miss,
    which may involve the master service's catch-all routing."""
    global _slim_collector
    req = meta.request
    svc = req.service_name
    meth = req.method_name
    entry = server._method_cache.get((svc, meth))
    if entry is None:
        service = server.find_service(svc)
        entry = service.find_method(meth) if service is not None else None
        if entry is None:
            return False
        server._method_cache[(svc, meth)] = entry
    sock = msg.socket
    server.requests_processed.put(1)

    if _slim_collector is None:  # cache the module: tests swap _collector
        from brpc_tpu_torch.metrics import collector as _slim_collector_

        _slim_collector = _slim_collector_
    coll = _slim_collector._collector or _slim_collector.global_collector()
    # span pre-gate (fast-path idiom): an untraced request during a
    # standing collector denial can never be sampled — skip the sampling
    # walk entirely
    if req.trace_id == 0 and time.monotonic() < coll._deny_until:
        span = None
    else:
        span = _tspan.start_server_span(meta, svc, meth,
                                        peer=str(sock.remote))
        if span is not None:
            arrival = getattr(msg, "arrival", 0.0)
            if arrival:
                q_us = max(0.0, (time.monotonic() - arrival) * 1e6)
                span.start_mono_us -= q_us
                span.start_us -= q_us
                span.add_phase("queue_us", q_us)

    if not server.is_running:
        _slim_error(protocol, sock, meta, span, errors.ELOGOFF)
        return True
    if not server.add_concurrency():
        _slim_error(protocol, sock, meta, span, errors.ELIMIT,
                    "server max_concurrency reached")
        return True
    start_us = time.perf_counter_ns() // 1000
    budget_ms = int(req.timeout_ms or 0)
    deadline_mono = 0.0
    if budget_ms > 0:
        arrival = getattr(msg, "arrival", 0.0)
        if arrival:
            if (time.monotonic() - arrival) * 1000.0 >= budget_ms:
                g_server_deadline_expired.put(1)
                server.sub_concurrency()
                _slim_error(protocol, sock, meta, span, errors.ERPCTIMEDOUT,
                            f"request deadline ({budget_ms}ms) already "
                            f"spent before dispatch")
                return True
            deadline_mono = arrival + budget_ms / 1000.0
    if not entry.on_request():
        # a known method shed by its limit stays ELIMIT (never re-routed
        # to the master service — full-pipeline contract)
        server.sub_concurrency()
        _slim_error(protocol, sock, meta, span, errors.ELIMIT,
                    "method concurrency limit")
        return True

    cntl = FastServerController(server, sock, svc, meth, req.log_id,
                                budget_ms)
    cntl.span = span
    cntl._srv_socket = sock  # batch runtime reads this (priority flush)
    if req.tenant_id:
        cntl.tenant_id = req.tenant_id
    if req.priority:
        cntl.priority = req.priority
    if deadline_mono:
        cntl.deadline_mono = deadline_mono
    done = _SlimDone(protocol, sock, meta, cntl, entry, server, start_us)

    try:
        _set_phase("parse")
        t_parse = time.perf_counter_ns() if span is not None else 0
        body = msg.body
        if span is not None:
            span.request_size = len(body)
        data = body.tobytes()
        body.clear()  # drop block refs now, not at message GC
        try:
            request = entry.request_class()
            request.ParseFromString(data)
        except Exception as e:
            cntl.set_failed(errors.EREQUEST, f"parse request: {e}")
            done()
            return True
        if span is not None:
            span.add_phase(
                "parse_us", (time.perf_counter_ns() - t_parse) / 1000.0)
        prev_span = _tspan.set_current(span)
        _set_phase("execute")
        t_exec = time.perf_counter_ns() if span is not None else 0
        ex0 = _other_marks(span)
        try:
            if _fault.hit("rpc.handler.crash") is not None:
                raise RuntimeError("fault injected handler crash")
            _fault.maybe_sleep(
                _fault.hit("rpc.handler.delay", method=meth))
            ret = entry.fn(cntl, request, done)
        except Exception as e:  # user bug -> EINTERNAL, not a dead conn
            cntl.set_failed(errors.EINTERNAL, f"method raised: {e}")
            ret = None
        finally:
            _tspan.set_current(prev_span)
            if span is not None:
                el = (time.perf_counter_ns() - t_exec) / 1000.0
                span.add_phase(
                    "execute_us",
                    max(0.0, el - (_other_marks(span) - ex0)))
        if not done.responded and (ret is not None or cntl.failed()):
            done(ret)
        # else: user code kept `done` for async completion
    except BaseException:
        done.settle(errors.EINTERNAL)
        raise
    finally:
        _set_phase(None)
    return True


class FastServerController:
    """Slim server-side controller for the slim path: the documented
    server-role Controller surface without the client-role machinery
    (a full Controller's ~45 attribute writes are measurable at 100k+
    QPS on the shared core). Rarely-written fields live as CLASS
    defaults — the constructor performs six writes, not sixteen; setters
    shadow the defaults per instance."""

    compress_type = _compress.COMPRESS_NONE
    request_attachment = b""
    response_attachment = b""
    _error_code = errors.OK
    _error_text = ""
    auth_context = None
    span = None
    is_server_side = True
    _accepted_stream_id = 0
    stream_id = 0
    deadline_mono = 0.0  # monotonic deadline (0 = none); batch admit checks
    # QoS identity class defaults — most traffic is single-tenant; the
    # slim dispatch shadows them per instance only when the meta carries
    # them
    tenant_id = ""
    priority = 0

    def __init__(self, server, sock, svc, meth, log_id, timeout_ms):
        self.server = server
        self.peer = sock.remote
        self.service_name = svc
        self.method_name = meth
        self.log_id = log_id
        self.timeout_ms = timeout_ms

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

    def create_progressive_attachment(self):
        raise ValueError("progressive attachments are HTTP-only "
                         "(this request arrived via a binary protocol)")


def _send_response(protocol, sock, request_meta, code, text, payload,
                   attachment, compress_type,
                   accepted_stream_id: int = 0) -> None:
    meta = rpc_meta_pb2.RpcMeta()
    meta.response.error_code = code
    if code != errors.OK:
        meta.response.error_text = text
    meta.correlation_id = request_meta.correlation_id
    meta.attempt_version = request_meta.attempt_version
    meta.compress_type = compress_type
    if accepted_stream_id:
        from brpc_tpu_torch.rpc.stream import get_stream

        meta.stream_settings.stream_id = accepted_stream_id
        accepted = get_stream(accepted_stream_id)
        if accepted is not None:  # tell the client our writer window
            meta.stream_settings.window_bytes = accepted.options.window_bytes
    # checksum responses iff the client checksummed the request
    packet = protocol.pack_response(meta, payload, attachment or b"",
                                    checksum=bool(request_meta.checksum))
    sock.write(packet)
