"""HTTP/1.1 protocol — browser dashboard, JSON/pb RPC, builtin services.

Counterpart of the reference's ``policy/http_rpc_protocol.cpp`` (+ the
vendored ``details/http_parser.cpp``): the same server port that speaks
trpc_std also answers HTTP — the InputMessenger probes protocols per
connection, so ``curl`` and browsers hit the builtin dashboard while RPC
clients use the binary protocol (bRPC's single-port multi-protocol
hallmark).

Three server-side paths:
  - builtin services: ``/``, ``/status``, ``/vars``, ``/flags``, … routed to
    ``brpc_tpu_torch.builtin`` handlers.
  - pb services over JSON: ``POST /<Service>/<Method>`` with a JSON body
    (or GET with query-less empty request) — json2pb both ways.
  - pb services over binary pb: same path with content-type
    ``application/proto`` — what our own Channel(protocol="http") sends.

Client side: ``Channel(options.protocol="http")`` packs RPCs as pb-over-
HTTP; responses correlate by the ``x-trpc-cid`` header our servers echo
(attempt version rides the same header — the retry race guard works the
same as trpc_std). For plain external HTTP servers use ``http_fetch``,
a self-contained blocking client.

The port's copy of the JAX package's ``policy/http_protocol.py``: the
same bytes on the wire, so either package's client talks to the other's
server.
"""

from __future__ import annotations

import socket as _socket
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qsl, urlsplit

from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.proto import rpc_meta_pb2
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.protocol import (
    PARSE_BAD,
    PARSE_NOT_ENOUGH_DATA,
    PARSE_TRY_OTHERS,
    ChunkedBodyCursor,
    ParsedMessage,
    PendingBodyCursor,
    Protocol,
    can_stream_body,
    stream_body_min,
)

MAX_HEADER = 64 * 1024
_METHODS = (b"GET", b"POST", b"PUT", b"DELETE", b"HEAD", b"OPTIONS",
            b"PATCH", b"TRACE", b"CONNECT")
_STARTS = _METHODS + (b"HTTP/",)

CONTENT_JSON = "application/json"
CONTENT_PROTO = "application/proto"
CONTENT_TEXT = "text/plain"
CONTENT_HTML = "text/html"

# correlation header: "<call_id>.<attempt_version>" — echoed by the server
H_CID = "x-trpc-cid"
H_ERROR_CODE = "x-trpc-error-code"
H_ERROR_TEXT = "x-trpc-error-text"
H_COMPRESS = "x-trpc-compress"
H_ATTACHMENT = "x-trpc-attachment-size"
H_LOG_ID = "x-trpc-log-id"
H_AUTH = "authorization"

_STATUS_REASON = {
    200: "OK", 400: "Bad Request", 403: "Forbidden", 404: "Not Found",
    405: "Method Not Allowed", 500: "Internal Server Error",
    501: "Not Implemented", 503: "Service Unavailable",
}

# RPC error code -> HTTP status (reference http_status_code.h mapping)
_ERR_TO_STATUS = {
    errors.OK: 200,
    errors.ENOSERVICE: 404,
    errors.ENOMETHOD: 404,
    errors.EREQUEST: 400,
    errors.EAUTH: 403,
    errors.ELIMIT: 503,
    errors.ELOGOFF: 503,
    errors.EOVERCROWDED: 503,
}


class HttpMessage:
    """One parsed HTTP request or response."""

    __slots__ = ("is_request", "method", "uri", "path", "query", "version",
                 "status", "reason", "headers", "body")

    def __init__(self):
        self.is_request = True
        self.method = ""
        self.uri = ""
        self.path = ""
        self.query: Dict[str, str] = {}
        self.version = "HTTP/1.1"
        self.status = 200
        self.reason = "OK"
        self.headers: Dict[str, str] = {}   # keys lower-cased
        self.body = b""

    def header(self, name: str, default: str = "") -> str:
        return self.headers.get(name.lower(), default)

    @property
    def content_type(self) -> str:
        return self.header("content-type").split(";")[0].strip().lower()

    def keep_alive(self) -> bool:
        conn = self.header("connection").lower()
        if self.version == "HTTP/1.0":
            return conn == "keep-alive"
        return conn != "close"


def _could_be_http(head: bytes) -> bool:
    """Could these first bytes still become an HTTP start-line?"""
    for s in _STARTS:
        n = min(len(head), len(s))
        if head[:n] == s[:n]:
            return True
    return False


def _parse_headers(block: bytes) -> Optional[Tuple[List[str], Dict[str, str]]]:
    lines = block.split(b"\r\n")
    try:
        start = lines[0].decode("latin-1")
    except UnicodeDecodeError:
        return None
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        k, sep, v = line.partition(b":")
        if not sep:
            return None
        headers[k.decode("latin-1").strip().lower()] = (
            v.decode("latin-1").strip())
    return start.split(" ", 2), headers


def _decode_chunked(data: bytes) -> Optional[Tuple[bytes, int]]:
    """Decode a chunked body. Returns (body, consumed) or None if
    incomplete; raises ValueError on malformed framing."""
    out = []
    pos = 0
    while True:
        nl = data.find(b"\r\n", pos)
        if nl < 0:
            if len(data) - pos > 16:
                raise ValueError("oversized chunk-size line")
            return None
        size_token = data[pos:nl].split(b";")[0].strip()
        size = int(size_token, 16)  # ValueError -> malformed
        chunk_start = nl + 2
        chunk_end = chunk_start + size
        if len(data) < chunk_end + 2:
            return None
        if data[chunk_end:chunk_end + 2] != b"\r\n":
            raise ValueError("missing chunk terminator")
        if size == 0:
            return b"".join(out), chunk_end + 2
        out.append(data[chunk_start:chunk_end])
        pos = chunk_end + 2


def parse_http_message(buf: IOBuf, sock=None,
                       proto=None) -> Tuple[int, Optional[HttpMessage]]:
    """Cut one HTTP/1.1 message. With ``sock`` + ``proto`` (the cut-loop
    entry), a large incomplete content-length body registers a streaming
    pending-body cursor instead of waiting for full buffering; standalone
    callers (http_fetch) omit both and keep whole-message semantics."""
    head = buf.fetch(min(len(buf), MAX_HEADER))
    if not head:
        return PARSE_NOT_ENOUGH_DATA, None
    if not _could_be_http(head):
        return PARSE_TRY_OTHERS, None
    idx = head.find(b"\r\n\r\n")
    if idx < 0:
        if len(head) >= MAX_HEADER:
            return PARSE_BAD, None
        return PARSE_NOT_ENOUGH_DATA, None
    parsed = _parse_headers(head[:idx])
    if parsed is None:
        return PARSE_BAD, None
    start, headers = parsed
    msg = HttpMessage()
    msg.headers = headers
    if start[0].startswith("HTTP/"):
        if len(start) < 2:
            return PARSE_BAD, None
        msg.is_request = False
        msg.version = start[0]
        try:
            msg.status = int(start[1])
        except ValueError:
            return PARSE_BAD, None
        msg.reason = start[2] if len(start) > 2 else ""
    else:
        if len(start) < 3:
            return PARSE_BAD, None
        msg.method, msg.uri, msg.version = start[0], start[1], start[2]
        parts = urlsplit(msg.uri)
        msg.path = parts.path or "/"
        msg.query = dict(parse_qsl(parts.query, keep_blank_values=True))
    body_start = idx + 4
    if headers.get("transfer-encoding", "").lower() == "chunked":
        data = buf.fetch(len(buf))
        try:
            decoded = _decode_chunked(data[body_start:])
        except ValueError:
            return PARSE_BAD, None
        if decoded is None:
            if proto is not None and can_stream_body(sock):
                # incomplete chunked body on the cut-loop entry: pop the
                # parsed headers and stream the chunk frames through an
                # incremental cursor — each arriving chunk is claimed on
                # arrival (credits return mid-message), and the unknown
                # total length is discovered at the 0-size chunk
                buf.pop_front(body_start)

                def _finish_chunked(cur, msg=msg, proto=proto):
                    msg.body = cur.body()
                    return ParsedMessage(proto, msg, IOBuf(msg.body))

                cursor = ChunkedBodyCursor(proto, finish=_finish_chunked)
                cursor.feed(buf)
                if cursor.failed:
                    return PARSE_BAD, None
                # cannot already be done: the whole-buffer decode above
                # just said the body is incomplete
                sock.pending_body = cursor
            return PARSE_NOT_ENOUGH_DATA, None
        msg.body, consumed = decoded
        buf.pop_front(body_start + consumed)
        return 0, msg
    try:
        clen = int(headers.get("content-length", "0") or "0")
    except ValueError:
        return PARSE_BAD, None
    if clen < 0:
        return PARSE_BAD, None
    if len(buf) < body_start + clen:
        if (proto is not None and clen >= stream_body_min()
                and can_stream_body(sock)):
            # headers are parsed and the declared body is large: stream the
            # remainder through a cursor so arriving bytes are consumed
            # (and any transport credits returned) before the body completes
            buf.pop_front(body_start)

            def _finish(cur, msg=msg, proto=proto):
                msg.body = bytes(cur.claimed())
                return ParsedMessage(proto, msg, IOBuf(msg.body))

            cursor = PendingBodyCursor(proto, clen, finish=_finish)
            cursor.feed(buf)
            sock.pending_body = cursor
        return PARSE_NOT_ENOUGH_DATA, None
    buf.pop_front(body_start)
    msg.body = buf.cutn(clen).tobytes() if clen else b""
    return 0, msg


def render_response(status: int, content_type: str, body,
                    extra_headers: Optional[Dict[str, str]] = None,
                    keep_alive: bool = True, chunked: bool = False) -> bytes:
    """chunked=True emits Transfer-Encoding: chunked headers with NO body
    (the caller streams chunks afterwards — progressive attachments)."""
    if isinstance(body, str):
        body = body.encode("utf-8")
    if chunked and body:
        raise ValueError("chunked=True renders headers only; the caller "
                         "streams the body as chunks")
    reason = _STATUS_REASON.get(status, "Unknown")
    lines = [f"HTTP/1.1 {status} {reason}",
             f"Content-Type: {content_type}",
             ("Transfer-Encoding: chunked" if chunked
              else f"Content-Length: {len(body)}"),
             "Connection: " + ("keep-alive" if keep_alive else "close")]
    for k, v in (extra_headers or {}).items():
        lines.append(f"{k}: {v}")
    head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
    return head if chunked else head + body


def render_request(method: str, path: str, host: str, body: bytes = b"",
                   content_type: str = CONTENT_JSON,
                   extra_headers: Optional[Dict[str, str]] = None) -> bytes:
    lines = [f"{method} {path} HTTP/1.1",
             f"Host: {host}",
             f"Content-Length: {len(body)}"]
    if content_type:
        # even for an empty body: the server classifies json vs pb by it
        lines.append(f"Content-Type: {content_type}")
    for k, v in (extra_headers or {}).items():
        lines.append(f"{k}: {v}")
    head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
    return head + body


class HttpProtocol(Protocol):
    name = "http"
    stateful = True  # parse(buf, sock): streams large content-length bodies

    # ------------------------------------------------------------------ wire
    def parse(self, buf: IOBuf, sock=None):
        rc, msg = parse_http_message(buf, sock=sock, proto=self)
        if rc != 0:
            return rc, None
        return 0, ParsedMessage(self, msg, IOBuf(msg.body))

    # ----------------------------------------------------------- client pack
    def pack_request(self, meta: rpc_meta_pb2.RpcMeta, payload: bytes,
                     attachment: bytes = b"", checksum: bool = False) -> IOBuf:
        """pb-over-HTTP: POST /<service>/<method>, correlation in headers."""
        path = f"/{meta.request.service_name}/{meta.request.method_name}"
        headers = {
            H_CID: f"{meta.correlation_id}.{meta.attempt_version}",
            "Accept": CONTENT_PROTO,
        }
        if meta.compress_type:
            headers[H_COMPRESS] = str(meta.compress_type)
        if meta.request.log_id:
            headers[H_LOG_ID] = str(meta.request.log_id)
        if meta.auth_token:
            headers[H_AUTH] = meta.auth_token
        if attachment:
            headers[H_ATTACHMENT] = str(len(attachment))
        out = IOBuf()
        out.append(render_request(
            "POST", path, "trpc", payload + attachment,
            content_type=CONTENT_PROTO, extra_headers=headers))
        return out

    # ------------------------------------------------------------ dispatch
    def process(self, msg: ParsedMessage, server) -> None:
        if msg.meta.is_request:
            self.process_request(msg, server)
        else:
            self.process_response(msg)

    def process_request(self, msg: ParsedMessage, server) -> None:
        from brpc_tpu_torch.policy import http_server

        http_server.process_http_request(msg, server)

    def process_response(self, msg: ParsedMessage) -> None:
        """Synthesize an RpcMeta from the response headers and feed the
        shared client completion path."""
        from brpc_tpu_torch.rpc.controller import handle_response_message

        http: HttpMessage = msg.meta
        cid_hdr = http.header(H_CID)
        if not cid_hdr:
            return  # not an RPC response we can correlate — drop
        meta = rpc_meta_pb2.RpcMeta()
        try:
            cid_s, _, ver_s = cid_hdr.partition(".")
            meta.correlation_id = int(cid_s)
            meta.attempt_version = int(ver_s or "0")
        except ValueError:
            return
        try:
            code = http.header(H_ERROR_CODE)
            if code:
                meta.response.error_code = int(code)
                meta.response.error_text = http.header(H_ERROR_TEXT)
            elif http.status != 200:
                meta.response.error_code = errors.EINTERNAL
                meta.response.error_text = f"HTTP {http.status} {http.reason}"
            meta.compress_type = int(http.header(H_COMPRESS, "0") or "0")
            meta.attachment_size = int(http.header(H_ATTACHMENT, "0") or "0")
        except ValueError:
            # malformed headers must still complete the call, not strand it
            meta.response.error_code = errors.ERESPONSE
            meta.response.error_text = "malformed response headers"
            meta.compress_type = 0
            meta.attachment_size = 0
        msg.meta = meta
        handle_response_message(msg)

    # --------------------------------------------------------------- helpers
    @staticmethod
    def split_attachment(msg: ParsedMessage) -> Tuple[bytes, bytes]:
        att = msg.meta.attachment_size
        body = msg.body.tobytes()
        if att:
            return body[:-att], body[-att:]
        return body, b""

    @staticmethod
    def verify_checksum(meta, payload: bytes) -> bool:
        return True  # TCP + HTTP framing; no separate body checksum


# ----------------------------------------------------------- blocking client
def _recv_chunk(s) -> bytes:
    # blocking read lives in its own frame so the sampling profiler
    # classifies threads parked here as waiting, not on-cpu (socket reads
    # happen at C level — the Python leaf frame is all the sampler sees)
    return s.recv(65536)


def http_fetch(hostport: str, method: str = "GET", path: str = "/",
               body: bytes = b"", content_type: str = CONTENT_JSON,
               headers: Optional[Dict[str, str]] = None,
               timeout: float = 5.0) -> HttpMessage:
    """Self-contained HTTP client for tools/tests (talks to any server)."""
    host, _, port = hostport.rpartition(":")
    with _socket.create_connection((host, int(port)), timeout=timeout) as s:
        s.sendall(render_request(method, path, hostport, body,
                                 content_type=content_type,
                                 extra_headers=headers))
        buf = IOBuf()
        while True:
            rc, msg = parse_http_message(buf)
            if rc == 0:
                return msg
            if rc == PARSE_BAD:
                raise ValueError("malformed HTTP response")
            chunk = _recv_chunk(s)
            if not chunk:
                raise ConnectionError("connection closed mid-response")
            buf.append(chunk)
