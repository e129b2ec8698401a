"""HTTP server example on the port (reference example/http_c++; the JAX
package's ``examples/http/server.py``): the same port answers pb-RPC,
restful JSON and the builtin dashboard.

    python -m brpc_tpu_torch.examples.http.server [--port 8010]
    curl localhost:8010/EchoService/Echo -d '{"message":"hi"}'
    curl localhost:8010/status

It touches no device.
"""

import argparse
import sys
import time

from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import Server, Service


class EchoServiceImpl(Service):
    DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]

    def Echo(self, cntl, request, done):
        if cntl.http_request is not None:
            print(f"via HTTP {cntl.http_request.method} "
                  f"{cntl.http_request.path}", flush=True)
        return echo_pb2.EchoResponse(message=request.message)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8010)
    ap.add_argument("--run_seconds", type=float, default=0)
    args = ap.parse_args(argv)
    server = Server().add_service(EchoServiceImpl())
    server.start(f"0.0.0.0:{args.port}")
    print(f"HTTP+RPC server on {server.listen_endpoint()}", flush=True)
    try:
        time.sleep(args.run_seconds or 1e9)
    except KeyboardInterrupt:
        pass
    server.stop()
    server.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
