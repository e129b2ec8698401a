"""gRPC over HTTP/2 (h2c prior-knowledge) — wire-compatible unary RPC.

Counterpart of the reference's ``policy/http2_rpc_protocol.cpp`` +
``grpc.cpp`` (status mapping, grpc-timeout): requests are POSTs to
``/<package.Service>/<Method>`` with ``content-type: application/grpc``,
messages carry the 5-byte length-prefix, responses end with
``grpc-status``/``grpc-message`` trailers. Both directions funnel into the
same engine paths as trpc_std: ``process_rpc_request`` server-side and
``handle_response_message`` client-side, so limiters, auth, spans, retries
and metrics all apply unchanged.

The protocol is *stateful*: each socket owns an ``H2Conn`` (HPACK contexts,
windows, stream table). parse() consumes frames and dispatches completed
streams itself, returning PARSE_NOT_ENOUGH_DATA to the InputMessenger —
h2 frames are connection-scoped, not per-message cuttable.

The port's copy of the JAX package's ``policy/grpc_protocol.py``: the same
bytes on the wire, so either package's client talks to the other's server.
"""

from __future__ import annotations

import threading
import time as _time
import urllib.parse
from typing import List, Optional, Tuple

from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.fiber import call_id as _cid
from brpc_tpu_torch.fiber import runtime
from brpc_tpu_torch.policy import compress as _compress
from brpc_tpu_torch.policy import h2 as _h2
from brpc_tpu_torch.proto import rpc_meta_pb2
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.protocol import (
    PARSE_BAD,
    PARSE_NOT_ENOUGH_DATA,
    PARSE_TRY_OTHERS,
    ParsedMessage,
    Protocol,
)

CONTENT_GRPC = "application/grpc"

_conn_init_lock = threading.Lock()

# gRPC status codes (subset we map; google.rpc.Code)
G_OK = 0
G_CANCELLED = 1
G_UNKNOWN = 2
G_INVALID_ARGUMENT = 3
G_DEADLINE_EXCEEDED = 4
G_NOT_FOUND = 5
G_RESOURCE_EXHAUSTED = 8
G_UNIMPLEMENTED = 12
G_INTERNAL = 13
G_UNAVAILABLE = 14
G_UNAUTHENTICATED = 16

# reference grpc.cpp ErrorCodeToGrpcStatus equivalent
BRPC_TO_GRPC = {
    errors.OK: G_OK,
    errors.ENOSERVICE: G_UNIMPLEMENTED,
    errors.ENOMETHOD: G_UNIMPLEMENTED,
    errors.EREQUEST: G_INVALID_ARGUMENT,
    errors.ERPCTIMEDOUT: G_DEADLINE_EXCEEDED,
    errors.ELIMIT: G_RESOURCE_EXHAUSTED,
    errors.EOVERCROWDED: G_RESOURCE_EXHAUSTED,
    errors.ELOGOFF: G_UNAVAILABLE,
    errors.EHOSTDOWN: G_UNAVAILABLE,
    errors.EFAILEDSOCKET: G_UNAVAILABLE,
    errors.EAUTH: G_UNAUTHENTICATED,
    errors.ECANCELED: G_CANCELLED,
    errors.EINTERNAL: G_INTERNAL,
    errors.ERESPONSE: G_INTERNAL,
}
GRPC_TO_BRPC = {
    G_OK: errors.OK,
    G_CANCELLED: errors.ECANCELED,
    G_INVALID_ARGUMENT: errors.EREQUEST,
    G_DEADLINE_EXCEEDED: errors.ERPCTIMEDOUT,
    G_NOT_FOUND: errors.ENOMETHOD,
    G_RESOURCE_EXHAUSTED: errors.ELIMIT,
    G_UNIMPLEMENTED: errors.ENOMETHOD,
    G_UNAVAILABLE: errors.EHOSTDOWN,
    G_UNAUTHENTICATED: errors.EAUTH,
    G_INTERNAL: errors.EINTERNAL,
}


def encode_timeout(ms: int) -> str:
    """grpc-timeout header value (largest unit that fits 8 digits)."""
    if ms % 3600000 == 0 and ms // 3600000 < 10 ** 8:
        return f"{ms // 3600000}H" if ms >= 3600000 else f"{ms}m"
    if ms < 10 ** 8:
        return f"{ms}m"
    return f"{ms // 1000}S"


def decode_timeout(value: str) -> Optional[int]:
    """-> milliseconds, None if unparseable."""
    if not value:
        return None
    unit = value[-1]
    try:
        n = int(value[:-1])
    except ValueError:
        return None
    scale = {"H": 3600000, "M": 60000, "S": 1000, "m": 1,
             "u": 0.001, "n": 0.000001}.get(unit)
    if scale is None:
        return None
    return max(1, int(n * scale))


def _prefix(payload: bytes, compressed: bool) -> bytes:
    return bytes([1 if compressed else 0]) + len(payload).to_bytes(4, "big")


def _split_message(data: bytes) -> Tuple[bool, bytes]:
    """Strip the 5-byte gRPC message prefix -> (compressed_flag, message)."""
    if len(data) < 5:
        return False, b""
    compressed = data[0] == 1
    n = int.from_bytes(data[1:5], "big")
    return compressed, bytes(data[5:5 + n])


def _encoding_to_compress(name: str) -> int:
    if name == "gzip":
        return _compress.COMPRESS_GZIP
    if name == "deflate":
        return _compress.COMPRESS_ZLIB
    return _compress.COMPRESS_NONE


def _compress_to_encoding(ctype: int) -> str:
    if ctype == _compress.COMPRESS_GZIP:
        return "gzip"
    if ctype == _compress.COMPRESS_ZLIB:
        return "deflate"
    return "identity"


class GrpcProtocol(Protocol):
    name = "grpc"
    stateful = True  # parse() receives the socket; state lives on it

    # ------------------------------------------------------------- recv path
    def parse(self, buf: IOBuf, sock=None):
        conn: Optional[_h2.H2Conn] = getattr(sock, "h2_conn", None)
        if conn is None:
            # server side: detect the client connection preface
            head = buf.fetch(min(len(buf), len(_h2.PREFACE)))
            if not _h2.PREFACE.startswith(head):
                return PARSE_TRY_OTHERS, None
            if len(head) < len(_h2.PREFACE):
                return PARSE_NOT_ENOUGH_DATA, None
            conn = _h2.H2Conn(sock, "server",
                              on_stream_complete=self._on_server_stream,
                              on_stream_reset=self._on_reset)
            sock.h2_conn = conn
            sock.preferred_protocol = self
            conn.send_preamble()
        try:
            conn.feed(buf)
        except _h2.H2Error as e:
            try:
                conn.send_goaway(e.h2_code)
            except Exception:
                pass
            return PARSE_BAD, None
        return PARSE_NOT_ENOUGH_DATA, None

    # ------------------------------------------------------------- send path
    def issue_request(self, sock, meta, payload: bytes,
                      attachment: bytes = b"", checksum: bool = False,
                      id_wait=None) -> int:
        """Client side — called by Controller._issue_rpc in place of
        pack_request+write (gRPC needs per-connection stream state)."""
        conn: Optional[_h2.H2Conn] = getattr(sock, "h2_conn", None)
        if conn is None:
            with _conn_init_lock:  # two first-callers must not double-preface
                conn = getattr(sock, "h2_conn", None)
                if conn is None:
                    conn = _h2.H2Conn(
                        sock, "client",
                        on_stream_complete=self._on_client_stream,
                        on_stream_reset=self._on_reset)
                    sock.h2_conn = conn
                    sock.preferred_protocol = self
                    conn.send_preamble()
        if conn.goaway_received:
            # drain the connection: fail the socket so the SocketMap makes a
            # fresh one, and surface a retryable error through the id channel
            sock.set_failed(errors.EFAILEDSOCKET, "h2 GOAWAY received")
            return errors.EHOSTDOWN
        path = f"/{meta.request.service_name}/{meta.request.method_name}"
        headers: List[Tuple[str, str]] = [
            (":method", "POST"),
            (":scheme", "http"),
            (":path", path),
            (":authority", str(sock.remote or "localhost")),
            ("content-type", CONTENT_GRPC),
            ("te", "trailers"),
            ("user-agent", "grpc-brpc-tpu/1.0"),
        ]
        if meta.request.timeout_ms:
            headers.append(("grpc-timeout", encode_timeout(meta.request.timeout_ms)))
        if meta.compress_type:
            headers.append(("grpc-encoding", _compress_to_encoding(meta.compress_type)))
        if meta.auth_token:
            headers.append(("authorization", meta.auth_token))
        if meta.request.log_id:
            headers.append(("x-brpc-log-id", str(meta.request.log_id)))
        if meta.request.trace_id:
            headers.append(("x-brpc-trace-id", str(meta.request.trace_id)))
            headers.append(("x-brpc-span-id", str(meta.request.span_id)))
        body = payload + attachment  # gRPC has no attachment: ride the body
        ctx = (meta.correlation_id, meta.attempt_version,
               meta.request.service_name, meta.request.method_name)
        st, rc = conn.open_stream_with_headers(
            headers, end_stream=False, id_wait=id_wait, call_ctx=ctx)
        if rc != 0:
            conn.close_stream(st.sid)
            return rc
        conn.send_data(st.sid, _prefix(body, meta.compress_type != 0) + body,
                       end_stream=True)
        return 0

    # ----------------------------------------------- server stream complete
    def _on_server_stream(self, conn: _h2.H2Conn, st: _h2.H2Stream,
                          trailers_only: bool) -> None:
        sock = conn.sock
        sock.in_messages += 1
        hdrs = dict(st.headers or [])
        path = hdrs.get(":path", "")
        parts = path.strip("/").split("/")
        if not hdrs.get("content-type", "").startswith(CONTENT_GRPC):
            # plain HTTP/2 request (browser/curl --http2): the builtin
            # dashboard answers on h2 exactly like it does on HTTP/1.1
            # (the reference serves /status etc. over h2 too). Dispatch on
            # a fiber: builtins may block (e.g. /hotspots/cpu profiles for
            # seconds) and must not stall this connection's frame parsing
            runtime.start_background(self._serve_plain_http, conn, st,
                                     hdrs)
            return
        if hdrs.get(":method") != "POST" or len(parts) != 2:
            self._reject(conn, st.sid, G_UNIMPLEMENTED, f"bad path {path!r}")
            return
        service_full, method = parts
        meta = rpc_meta_pb2.RpcMeta()
        # accept both full (pkg.Service) and bare (Service) names
        meta.request.service_name = service_full.rpartition(".")[2]
        meta.request.method_name = method
        meta.correlation_id = st.sid
        timeout = decode_timeout(hdrs.get("grpc-timeout", ""))
        if timeout:
            meta.request.timeout_ms = timeout
        if hdrs.get("authorization"):
            meta.auth_token = hdrs["authorization"]
        try:
            meta.request.log_id = int(hdrs.get("x-brpc-log-id", "0"))
            meta.request.trace_id = int(hdrs.get("x-brpc-trace-id", "0"))
            meta.request.span_id = int(hdrs.get("x-brpc-span-id", "0"))
        except ValueError:
            pass
        compressed, message = _split_message(st.data)
        meta.compress_type = (_encoding_to_compress(
            hdrs.get("grpc-encoding", "gzip")) if compressed
            else _compress.COMPRESS_NONE)
        shim = _H2ServerCall(conn, st.sid)
        msg = ParsedMessage(shim, meta, IOBuf(message))
        msg.socket = sock
        server = sock.owner_server
        from brpc_tpu_torch.rpc.server_processing import process_rpc_request

        runtime.start_background(process_rpc_request, shim, msg, server)

    def _serve_plain_http(self, conn: _h2.H2Conn, st: _h2.H2Stream,
                          hdrs: dict) -> None:
        """Builtin-dashboard dispatch for non-grpc h2 requests."""
        import urllib.parse as _up

        from brpc_tpu_torch import builtin
        from brpc_tpu_torch.policy.http_protocol import HttpMessage

        http = HttpMessage()
        http.method = hdrs.get(":method", "GET")
        http.uri = hdrs.get(":path", "/")
        path, _, query = http.uri.partition("?")
        http.path = path
        http.query = dict(_up.parse_qsl(query))
        http.headers = {k: v for k, v in (st.headers or [])
                        if not k.startswith(":")}
        http.body = bytes(st.data)
        server = conn.sock.owner_server
        try:
            handled = builtin.dispatch(server, http)
        except Exception as e:
            handled = (500, "text/plain", f"builtin service failed: {e}\n",
                       None)
        if handled is None:
            handled = (404, "text/plain",
                       f"no such builtin path {http.path!r} "
                       f"(rpc over h2 needs content-type {CONTENT_GRPC})\n",
                       None)
        status, ctype, body, extra = handled
        if isinstance(body, str):
            body = body.encode()
        headers = [(":status", str(status)), ("content-type", ctype)]
        if extra:
            headers += [(str(k).lower(), str(v)) for k, v in extra.items()]
        st.close_on_end = True  # pop only after the tail + END_STREAM flush
        conn.send_headers(st.sid, headers, end_stream=False)
        conn.send_data(st.sid, body, end_stream=True)

    def _reject(self, conn, sid, grpc_code, text) -> None:
        conn.send_headers(sid, [
            (":status", "200"), ("content-type", CONTENT_GRPC),
            ("grpc-status", str(grpc_code)),
            ("grpc-message", urllib.parse.quote(text)),
        ], end_stream=True)
        conn.close_stream(sid)

    # ----------------------------------------------- client stream complete
    def _on_client_stream(self, conn: _h2.H2Conn, st: _h2.H2Stream,
                          trailers_only: bool) -> None:
        ctx = conn.calls.pop(st.sid, None)
        conn.close_stream(st.sid)
        if ctx is None:
            return
        cid, attempt_version, _svc, _method = ctx
        conn.sock.in_messages += 1
        t0 = _time.perf_counter_ns()
        hdrs = dict(st.headers or [])
        trailer = dict(st.trailers or [])
        meta = rpc_meta_pb2.RpcMeta()
        meta.correlation_id = cid
        meta.attempt_version = attempt_version
        status_s = trailer.get("grpc-status", hdrs.get("grpc-status"))
        http_status = hdrs.get(":status", "200")
        if status_s is None:
            if http_status != "200":
                meta.response.error_code = errors.EINTERNAL
                meta.response.error_text = f"HTTP/2 status {http_status}"
            else:
                meta.response.error_code = errors.ERESPONSE
                meta.response.error_text = "missing grpc-status"
        else:
            try:
                g = int(status_s)
            except ValueError:
                g = G_UNKNOWN
            meta.response.error_code = GRPC_TO_BRPC.get(g, errors.EINTERNAL)
            if g != G_OK:
                meta.response.error_text = urllib.parse.unquote(
                    trailer.get("grpc-message", hdrs.get("grpc-message", ""))
                ) or f"grpc-status {g}"
        compressed, message = _split_message(st.data)
        meta.compress_type = (_encoding_to_compress(
            hdrs.get("grpc-encoding", "gzip")) if compressed
            else _compress.COMPRESS_NONE)
        msg = ParsedMessage(self, meta, IOBuf(message))
        # trailer/meta assembly + length-prefix split is wire-format
        # parsing done on the h2 frame path; credit it to the span's
        # parse mark when the dispatcher stamps it
        msg.pre_parse_us = (_time.perf_counter_ns() - t0) / 1000.0
        msg.socket = conn.sock
        from brpc_tpu_torch.rpc.controller import handle_response_message

        runtime.start_background(handle_response_message, msg)

    def _on_reset(self, conn: _h2.H2Conn, sid: int, h2_code: int) -> None:
        if conn.role != "client":
            return
        ctx = conn.calls.pop(sid, None)
        if ctx is None:
            return
        code = (errors.EFAILEDSOCKET if h2_code == _h2.REFUSED_STREAM
                else errors.ECANCELED)
        _cid.id_error(ctx[0], code)

    # ------------------------------------------------------ engine contracts
    @staticmethod
    def split_attachment(msg: ParsedMessage) -> Tuple[bytes, bytes]:
        return msg.body.tobytes(), b""  # prefix already stripped

    @staticmethod
    def verify_checksum(meta, payload: bytes) -> bool:
        return True  # h2 framing; gRPC has no body checksum


class _H2ServerCall:
    """Per-request response path handed to process_rpc_request: packs the
    response as HEADERS + DATA + trailers on this request's stream."""

    name = "grpc"

    def __init__(self, conn: _h2.H2Conn, sid: int):
        self.conn = conn
        self.sid = sid

    split_attachment = staticmethod(GrpcProtocol.split_attachment)
    verify_checksum = staticmethod(GrpcProtocol.verify_checksum)

    def pack_response(self, meta, payload: bytes, attachment: bytes = b"",
                      checksum: bool = False) -> IOBuf:
        """Sends the response itself (frame emission must be atomic with
        HPACK encoding); returns an empty IOBuf for the engine's write."""
        conn, sid = self.conn, self.sid
        code = meta.response.error_code
        if code == errors.OK:
            body = payload + (attachment or b"")
            headers = [(":status", "200"), ("content-type", CONTENT_GRPC)]
            if meta.compress_type:
                headers.append(
                    ("grpc-encoding", _compress_to_encoding(meta.compress_type)))
            conn.send_headers(sid, headers, end_stream=False)
            conn.send_data(sid, _prefix(body, meta.compress_type != 0) + body,
                           end_stream=False)
            conn.send_trailers(sid, [("grpc-status", "0")])
        else:
            grpc_code = BRPC_TO_GRPC.get(code, G_UNKNOWN)
            conn.send_headers(sid, [
                (":status", "200"), ("content-type", CONTENT_GRPC),
                ("grpc-status", str(grpc_code)),
                ("grpc-message",
                 urllib.parse.quote(meta.response.error_text or "")),
            ], end_stream=True)
            conn.close_stream(sid)
        return IOBuf()
