"""BuiltinViewService — the dashboard over the BINARY protocol.

Reference counterpart: the target half of ``tools/rpc_view`` (the
reference proxies builtin pages of servers that expose no HTTP port by
speaking baidu_std to them). Here every server can mount this pb service;
``tools/rpc_view.py --serve`` then fronts it with a browsable HTTP proxy.
The handler synthesizes an HttpMessage and routes through the SAME
builtin dispatch the HTTP port uses, so /status, /vars, /flags, /rpcz...
render identically over either protocol.
"""

from __future__ import annotations

from urllib.parse import parse_qsl, urlsplit

from brpc_tpu_torch.proto import builtin_view_pb2
from brpc_tpu_torch.rpc.server import Service


class BuiltinViewService(Service):
    DESCRIPTOR = builtin_view_pb2.DESCRIPTOR.services_by_name[
        "BuiltinViewService"]

    def Get(self, cntl, request, done):
        from brpc_tpu_torch import builtin
        from brpc_tpu_torch.policy.http_protocol import HttpMessage

        http = HttpMessage()
        http.is_request = True
        http.method = "GET"
        http.uri = request.path or "/"
        parts = urlsplit(http.uri)
        http.path = parts.path or "/"
        # keep_blank_values: ?setvalue= must reach handlers as "" exactly
        # like the HTTP port's parser (policy/http_protocol.py)
        http.query = dict(parse_qsl(parts.query, keep_blank_values=True))
        if request.accept:
            http.headers["accept"] = request.accept
        server = getattr(cntl, "server", None)
        out = builtin.dispatch(server, http)
        if out is None:
            return builtin_view_pb2.ViewResponse(
                status=404, content_type="text/plain",
                body=f"no builtin page {http.path!r}\n".encode())
        status, ctype, body, _extra = out
        if isinstance(body, str):
            body = body.encode("utf-8", "replace")
        return builtin_view_pb2.ViewResponse(
            status=status, content_type=ctype, body=body)
