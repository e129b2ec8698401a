#!/usr/bin/env python
"""rpc_view — browse ANY server's builtin pages, over any protocol.

Counterpart of the reference ``tools/rpc_view``: a standalone PROXY that
speaks the RPC protocol to the target (so servers with no HTTP surface
are still browsable) and renders HTTP to your browser. The target side is
``BuiltinViewService`` (mounted on every server); the proxy side is a
real port Server whose builtin pages forward to the target.

Proxy mode (the reference's shape):

    python -m brpc_tpu_torch.tools.rpc_view --serve 0.0.0.0:8888 \\
        127.0.0.1:8000
    # now browse http://localhost:8888/status, /vars, /flags, /rpcz ...

One-shot CLI mode (fetch one page; binary protocol by default, --http to
hit the target's HTTP port directly):

    python -m brpc_tpu_torch.tools.rpc_view 127.0.0.1:8000 status
    python -m brpc_tpu_torch.tools.rpc_view 127.0.0.1:8000 \\
        flags/idle_timeout_s --set 30

Offline dump mode (no server): render rpc_dump files — record count,
per-method histogram, byte totals, v1/v2 format detection:

    python -m brpc_tpu_torch.tools.rpc_view --dump DIR
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from brpc_tpu_torch.proto import builtin_view_pb2  # noqa: E402

_VIEW_DESC = builtin_view_pb2.DESCRIPTOR.services_by_name[
    "BuiltinViewService"]


def _view_stub(target: str, protocol: str, timeout: float):
    from brpc_tpu_torch.rpc import Channel, ChannelOptions, Stub

    ch = Channel(ChannelOptions(protocol=protocol,
                                timeout_ms=int(timeout * 1000)))
    ch.init(target)
    return Stub(ch, _VIEW_DESC)


def fetch(target: str, path: str, *, protocol: str = "trpc_std",
          timeout: float = 5.0, accept: str = ""):
    """One page via the binary protocol: (status, content_type, body)."""
    stub = _view_stub(target, protocol, timeout)
    resp = stub.Get(builtin_view_pb2.ViewRequest(path=path, accept=accept))
    return resp.status, resp.content_type, bytes(resp.body)


def serve(listen: str, target: str, *, protocol: str = "trpc_std",
          timeout: float = 10.0, block: bool = True):
    """Run the proxy: a Server whose builtin pages forward to `target`
    over the binary protocol. Returns the Server (joins when block)."""
    from brpc_tpu_torch import builtin
    from brpc_tpu_torch.rpc import Server, ServerOptions
    from brpc_tpu_torch.rpc.channel import RpcError

    stub = _view_stub(target, protocol, timeout)

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

    # learn the target's page list (text index: "/name  help") and mount a
    # forwarding handler per page as PER-SERVER overrides (the global
    # registry is process-wide; overriding it would hijack every other
    # server's pages — and loop forever when proxy and target share a
    # process)
    builtin.ensure_builtin_registered()
    names = {"index"}
    try:
        resp = stub.Get(builtin_view_pb2.ViewRequest(path="/index"))
        body = bytes(resp.body)
        for line in body.decode("utf-8", "replace").splitlines():
            if line.strip().startswith("/"):
                names.add(line.split()[0].lstrip("/"))
    except Exception as e:  # target down at startup: still serve 502s
        print(f"rpc_view: cannot list target pages yet: {e}",
              file=sys.stderr)
        names |= {s.name for s in builtin.list_builtin()}
    srv = Server(ServerOptions())
    srv.builtin_overrides = {n: forward for n in names}
    srv.start(listen)
    print(f"rpc_view: proxying {target} ({protocol}) at "
          f"http://{srv.listen_endpoint()}/", flush=True)
    if block:
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            srv.stop()
            srv.join()
    return srv


def render_dump(path: str) -> str:
    """Human summary of the rpc_dump file/dir at ``path``: record count,
    per-method histogram, byte totals, and v1/v2 format detection."""
    from brpc_tpu_torch.trace.rpc_dump import RpcDumpLoader

    per_method = {}
    versions = {}
    records = 0
    meta_bytes = body_bytes = 0
    with_phases = 0
    for rec in RpcDumpLoader(path):
        records += 1
        versions[rec.version] = versions.get(rec.version, 0) + 1
        per_method[rec.method_key] = per_method.get(rec.method_key, 0) + 1
        meta_bytes += len(rec.meta.SerializeToString())
        body_bytes += len(rec.body)
        if rec.info.get("phases"):
            with_phases += 1
    fmt = "/".join(f"v{v}" for v in sorted(versions)) or "empty"
    lines = [f"dump: {path}",
             f"records: {records} ({fmt}; "
             f"{with_phases} with phase timelines)",
             f"bytes: {meta_bytes} meta + {body_bytes} body",
             "",
             "== per-method records =="]
    if not per_method:
        lines.append("(none)")
    width = max((len(m) for m in per_method), default=0)
    for m, n in sorted(per_method.items(), key=lambda kv: -kv[1]):
        lines.append(f"{m:<{width}}  {n}")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("server", nargs="?", default=None,
                   help="target host:port (omit with --dump)")
    p.add_argument("page", nargs="?", default="status",
                   help="builtin page path (default: status)")
    p.add_argument("--serve", metavar="LISTEN", default=None,
                   help="run as a browsable HTTP proxy on LISTEN")
    p.add_argument("--protocol", default="trpc_std",
                   help="wire protocol to the target (default trpc_std)")
    p.add_argument("--set", dest="setvalue", default=None,
                   help="set a flag value (page must be flags/<name>)")
    p.add_argument("--http", action="store_true",
                   help="fetch over plain HTTP instead of the binary "
                        "protocol")
    p.add_argument("--timeout", type=float, default=5.0)
    p.add_argument("--dump", metavar="PATH", default=None,
                   help="render local rpc_dump file/dir instead of "
                        "querying a server")
    args = p.parse_args(argv)

    if args.dump is not None:
        try:
            sys.stdout.write(render_dump(args.dump))
        except OSError as e:
            print(f"cannot read {args.dump}: {e}", file=sys.stderr)
            return 1
        return 0
    if args.server is None:
        p.error("server is required unless --dump is given")

    if args.serve:
        serve(args.serve, args.server, protocol=args.protocol,
              timeout=max(args.timeout, 10.0))
        return 0

    path = "/" + args.page.lstrip("/")
    if args.setvalue is not None:
        path += f"?setvalue={args.setvalue}"
    try:
        if args.http:
            from brpc_tpu_torch.policy.http_protocol import http_fetch

            resp = http_fetch(args.server, "GET", path,
                              timeout=args.timeout)
            status, body = resp.status, resp.body
        else:
            status, _ctype, body = fetch(args.server, path,
                                         protocol=args.protocol,
                                         timeout=args.timeout)
    except Exception as e:
        print(f"cannot reach {args.server}: {e}", file=sys.stderr)
        return 1
    sys.stdout.write(body.decode("utf-8", errors="replace"))
    return 0 if status == 200 else 1


if __name__ == "__main__":
    raise SystemExit(main())
