"""rpc_view proxy example on the port (reference tools/rpc_view; the JAX
package's ``examples/dashboard_proxy/client.py``): browse a server's
builtin pages THROUGH a proxy that speaks the binary protocol to it.

    python -m brpc_tpu_torch.examples.dashboard_proxy.client

It touches no device.
"""

from brpc_tpu_torch.policy.http_protocol import http_fetch
from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import Server, ServerOptions, Service
from brpc_tpu_torch.tools import rpc_view


class Echo(Service):
    DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]

    def Echo(self, cntl, request, done):
        return echo_pb2.EchoResponse(message=request.message)


def main(argv=None) -> int:
    backend = Server(ServerOptions())
    backend.add_service(Echo())
    backend.start("127.0.0.1:0")
    proxy = None
    try:
        proxy = rpc_view.serve("127.0.0.1:0",
                               str(backend.listen_endpoint()), block=False)
        pep = str(proxy.listen_endpoint())
        resp = http_fetch(pep, "GET", "/status", timeout=5)
        assert resp.status == 200 and b"EchoService" in resp.body
        print(f"browsed backend {backend.listen_endpoint()} through proxy "
              f"http://{pep}/status over trpc_std OK")
        return 0
    finally:
        if proxy is not None:
            proxy.stop()
            proxy.join(timeout=5)
        backend.stop()
        backend.join(timeout=5)


if __name__ == "__main__":
    raise SystemExit(main())
