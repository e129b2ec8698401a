"""The proxy half of the reference's ``tools/rpc_view``, on the port: a
Server whose builtin pages forward to a target server over the binary
protocol, so a server with no HTTP surface can still be browsed. The
target side is ``BuiltinViewService``, which every port Server mounts.

The port's own copy of ``tools/rpc_view.py``'s ``serve`` (that tool
imports the JAX package): the same page discovery and per-server
overrides.
"""

from __future__ import annotations

import sys

from brpc_tpu_torch import builtin
from brpc_tpu_torch.proto import builtin_view_pb2
from brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, Stub
from brpc_tpu_torch.rpc.channel import RpcError

_VIEW_DESC = builtin_view_pb2.DESCRIPTOR.services_by_name[
    "BuiltinViewService"]


def serve(listen: str, target: str, *, protocol: str = "trpc_std",
          timeout: float = 10.0) -> Server:
    """Start the proxy on ``listen``: its builtin pages forward to
    ``target`` over ``protocol``. Returns the started Server."""
    ch = Channel(ChannelOptions(protocol=protocol,
                                timeout_ms=int(timeout * 1000)))
    stub = Stub(ch.init(target), _VIEW_DESC)

    def forward(server, http):
        req = builtin_view_pb2.ViewRequest(
            path=http.uri or "/", accept=http.header("accept", ""))
        try:
            resp = stub.Get(req)
        except RpcError as e:
            return (502, "text/plain",
                    f"rpc_view: target {target} unreachable: "
                    f"{e.error_code} {e}\n")
        return (resp.status, resp.content_type or "text/plain",
                bytes(resp.body))

    # learn the target's page list (text index: "/name  help") and mount
    # a forwarding handler per page as PER-SERVER overrides (the global
    # registry is process-wide; overriding it would hijack every other
    # server's pages, and loop forever when proxy and target share a
    # process)
    builtin.ensure_builtin_registered()
    names = {"index"}
    try:
        resp = stub.Get(builtin_view_pb2.ViewRequest(path="/index"))
        for line in bytes(resp.body).decode("utf-8", "replace").splitlines():
            if line.strip().startswith("/"):
                names.add(line.split()[0].lstrip("/"))
    except RpcError as e:  # target down at startup: still serve 502s
        print(f"rpc_view: cannot list target pages yet: {e}",
              file=sys.stderr)
        names |= {s.name for s in builtin.list_builtin()}
    srv = Server()
    srv.builtin_overrides = {n: forward for n in names}
    return srv.start(listen)
