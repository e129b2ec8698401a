"""Echo server on the port (reference example/echo_c++/server.cpp; the
JAX package's ``examples/echo/server.py``).

    python -m brpc_tpu_torch.examples.echo.server [--port 8000]

It touches no device: the echo travels the port's RPC stack over TCP.
"""

import argparse
import sys
import time

from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import Server, ServerOptions, Service


class EchoServiceImpl(Service):
    DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]

    def Echo(self, cntl, request, done):
        # attachments round-trip untouched by serialization, as the
        # reference example shows
        cntl.response_attachment = cntl.request_attachment
        return echo_pb2.EchoResponse(message=request.message,
                                     payload=request.payload)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--idle_timeout_s", type=int, default=-1)
    ap.add_argument("--run_seconds", type=float, default=0,
                    help="exit after N seconds (0 = forever)")
    args = ap.parse_args(argv)

    server = Server(ServerOptions(idle_timeout_s=args.idle_timeout_s))
    server.add_service(EchoServiceImpl())
    server.start(f"0.0.0.0:{args.port}")
    print(f"EchoServer listening on {server.listen_endpoint()}", flush=True)
    try:
        if args.run_seconds:
            time.sleep(args.run_seconds)
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        pass
    server.stop()
    server.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
