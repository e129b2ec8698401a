"""Server-side HTTP request processing.

The HTTP analog of ``rpc/server_processing.py`` (reference
``policy/http_rpc_protocol.cpp`` ProcessHttpRequest): route builtin
observability paths to ``brpc_tpu_torch.builtin`` handlers, and
``/Service/Method`` paths to registered services — JSON bodies through
json2pb, binary pb bodies straight through. Admission (server
concurrency, method limiters, auth) and per-method stats flow through the
same MethodEntry hooks as the binary protocol, so /status numbers are
protocol-agnostic.

The port's copy of the JAX package's ``policy/http_server.py``; its
json2pb walks the port's message tables.
"""

from __future__ import annotations

import time

from brpc_tpu_torch import json2pb
from brpc_tpu_torch.policy import compress as _compress
from brpc_tpu_torch.policy.http_protocol import (
    CONTENT_JSON,
    CONTENT_PROTO,
    CONTENT_TEXT,
    H_ATTACHMENT,
    H_AUTH,
    H_CID,
    H_COMPRESS,
    H_ERROR_CODE,
    H_ERROR_TEXT,
    H_LOG_ID,
    _ERR_TO_STATUS,
    HttpMessage,
    render_response,
)
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.controller import Controller


def _reply(sock, http: HttpMessage, status: int, content_type: str, body,
           extra=None) -> None:
    keep = http.keep_alive()
    sock.write(render_response(status, content_type, body,
                               extra_headers=extra, keep_alive=keep))
    sock.out_messages += 1
    if not keep:
        sock.close()


def _rpc_error_reply(sock, http: HttpMessage, code: int, text: str,
                     as_json: bool) -> None:
    status = _ERR_TO_STATUS.get(code, 500)
    extra = {H_ERROR_CODE: str(code),
             H_ERROR_TEXT: text.replace("\r", " ").replace("\n", " ")}
    cid = http.header(H_CID)
    if cid:
        extra[H_CID] = cid
    if as_json:
        import json

        body = json.dumps({"error_code": code, "error_text": text})
        _reply(sock, http, status, CONTENT_JSON, body, extra)
    else:
        _reply(sock, http, status, CONTENT_TEXT, text, extra)


def process_http_request(msg, server) -> None:
    http: HttpMessage = msg.meta
    sock = msg.socket
    if server is None:
        return  # HTTP request on a client-only connection
    server.requests_processed.put(1)

    # ------------------------------------------------------ builtin services
    from brpc_tpu_torch import builtin

    try:
        handled = builtin.dispatch(server, http)
    except Exception as e:
        # a broken handler must still answer — a swallowed exception would
        # leave the client hanging until its timeout
        return _reply(sock, http, 500, CONTENT_TEXT,
                      f"builtin service failed: {e}\n")
    if handled is not None:
        status, ctype, body, extra = handled
        return _reply(sock, http, status, ctype, body, extra)

    # ------------------------------------------------------------- RPC path
    parts = [p for p in http.path.split("/") if p]
    as_json = http.content_type != CONTENT_PROTO
    if len(parts) != 2:
        return _rpc_error_reply(sock, http, errors.ENOSERVICE,
                                f"no such path {http.path!r}", as_json)
    service_name, method_name = parts

    # synthesized request meta so server Controllers look protocol-uniform;
    # created before admission so rejections reach /rpcz like the binary path
    from brpc_tpu_torch.proto import rpc_meta_pb2
    from brpc_tpu_torch.trace import span as _span_mod

    meta = rpc_meta_pb2.RpcMeta()
    meta.request.service_name = service_name
    meta.request.method_name = method_name
    try:
        meta.request.log_id = int(http.header(H_LOG_ID, "0") or "0")
    except ValueError:
        pass
    cntl = Controller.server_controller(server, sock, meta)
    cntl.http_request = http
    cntl.span = _span_mod.start_server_span(
        meta, service_name, method_name, peer=str(sock.remote))

    def reject(code: int, text: str) -> None:
        if cntl.span is not None:
            cntl.span.end(code)
        _rpc_error_reply(sock, http, code, text, as_json)

    if not server.is_running:
        return reject(errors.ELOGOFF, errors.error_text(errors.ELOGOFF))
    if not server.add_concurrency():
        return reject(errors.ELIMIT, "server max_concurrency reached")
    start_us = time.perf_counter_ns() // 1000

    err = None
    entry = None
    auth_ctx = None
    try:
        if server.options.auth is not None:
            auth_ctx = server.options.auth.verify_credential(
                http.header(H_AUTH), sock.remote)
        if server.options.auth is not None and auth_ctx is None:
            err = (errors.EAUTH, errors.error_text(errors.EAUTH))
        else:
            cntl.auth_context = auth_ctx
            # global hook, HTTP RPC lane — after auth like the binary lane
            # (process_rpc_request), so cntl.auth_context is populated
            if err is None and server.options.interceptor is not None:
                from brpc_tpu_torch.rpc.server_processing import run_interceptor

                err = run_interceptor(server, cntl)
        if err is None:
            service = server.find_service(service_name)
            if service is None:
                err = (errors.ENOSERVICE, f"no service {service_name!r}")
            else:
                entry = service.find_method(method_name)
                if entry is None:
                    err = (errors.ENOMETHOD, f"no method {method_name!r}")
                elif not entry.on_request():
                    entry = None
                    err = (errors.ELIMIT, "method concurrency limit")
    except BaseException:
        server.sub_concurrency()
        raise
    if entry is None:
        server.sub_concurrency()
        return reject(*err)

    settled = [False]

    def _settle(error_code: int) -> None:
        if settled[0]:
            return
        settled[0] = True
        entry.on_response(time.perf_counter_ns() // 1000 - start_us,
                          error_code)
        server.sub_concurrency()
        if cntl.span is not None:
            cntl.span.end(error_code)

    responded = [False]

    def done(response=None) -> None:
        if responded[0]:
            return
        responded[0] = True
        if cntl.failed():
            _rpc_error_reply(sock, http, cntl.error_code, cntl.error_text(),
                             as_json)
            return _settle(cntl.error_code)
        pa = getattr(cntl, "_progressive", None)
        if pa is not None:
            # streamed body (reference progressive_attachment.cpp): chunked
            # headers now, chunks from the attachment — the pb response is
            # NOT serialized into the body. HTTP/1.0 peers don't understand
            # chunked framing at all — reject rather than corrupt
            from brpc_tpu_torch.rpc.progressive import render_chunked_headers

            if http.version == "HTTP/1.0":
                pa._abort()  # pump threads must see ESTREAMCLOSED, not
                #              buffer into a response that never starts
                _rpc_error_reply(sock, http, errors.EREQUEST,
                                 "progressive responses need HTTP/1.1",
                                 as_json)
                return _settle(errors.EREQUEST)
            keep = http.keep_alive()
            ctype = http.header("accept") or "application/octet-stream"
            if "," in ctype or ctype == "*/*":
                ctype = "application/octet-stream"
            sock.write(render_chunked_headers(200, ctype, keep_alive=keep))
            sock.out_messages += 1
            # pa closes the socket after the terminator when keep is False
            pa._start(sock, keep_alive=keep)
            return _settle(errors.OK)
        extra = {}
        cid = http.header(H_CID)
        if cid:
            extra[H_CID] = cid
        try:
            if as_json:
                body = json2pb.pb_to_json(response) if response is not None else ""
                ctype = CONTENT_JSON
            else:
                payload = (response.SerializeToString()
                           if response is not None else b"")
                compress_type = cntl.compress_type
                payload = _compress.compress(payload, compress_type)
                if compress_type:
                    extra[H_COMPRESS] = str(compress_type)
                att = cntl.response_attachment or b""
                if att:
                    extra[H_ATTACHMENT] = str(len(att))
                body = payload + att
                ctype = CONTENT_PROTO
        except Exception as e:
            _rpc_error_reply(sock, http, errors.ERESPONSE,
                             f"serialize response: {e}", as_json)
            return _settle(errors.ERESPONSE)
        _reply(sock, http, 200, ctype, body, extra)
        _settle(errors.OK)

    try:
        t_parse = time.perf_counter_ns()
        try:
            if as_json:
                request = json2pb.json_to_pb(http.body, entry.request_class)
            else:
                compress_type = int(http.header(H_COMPRESS, "0") or "0")
                att_size = int(http.header(H_ATTACHMENT, "0") or "0")
                raw = http.body[:-att_size] if att_size else http.body
                cntl.request_attachment = (
                    http.body[-att_size:] if att_size else b"")
                request = entry.request_class()
                request.ParseFromString(
                    _compress.decompress(raw, compress_type))
        except Exception as e:
            cntl.set_failed(errors.EREQUEST, f"parse request: {e}")
            return done()
        if cntl.span is not None:
            cntl.span.request_size = len(http.body)
            cntl.span.add_phase(
                "parse_us", (time.perf_counter_ns() - t_parse) / 1000.0)

        from brpc_tpu_torch.trace import span as _span

        prev_span = _span.set_current(cntl.span)
        t_exec = time.perf_counter_ns()
        try:
            ret = entry.fn(cntl, request, done)
        except Exception as e:
            cntl.set_failed(errors.EINTERNAL, f"method raised: {e}")
            ret = None
        finally:
            _span.set_current(prev_span)
            if cntl.span is not None:
                cntl.span.add_phase(
                    "execute_us",
                    (time.perf_counter_ns() - t_exec) / 1000.0)
        if not responded[0] and (ret is not None or cntl.failed()):
            done(ret)
    except BaseException:
        _settle(errors.EINTERNAL)
        raise
