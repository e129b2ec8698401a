"""gRPC server example (reference example/grpc_c++): any gRPC client can
call this: the port speaks h2c gRPC alongside every other protocol. The
JAX package's ``examples/grpc_echo/server.py`` on the port's RPC stack.

    python -m brpc_tpu_torch.examples.grpc_echo.server [--port 8020]
"""

import argparse
import sys
import time

from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import Server, Service


class EchoServiceImpl(Service):
    DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]

    def Echo(self, cntl, request, done):
        return echo_pb2.EchoResponse(message=request.message,
                                     payload=request.payload)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8020)
    ap.add_argument("--run_seconds", type=float, default=0)
    args = ap.parse_args(argv)
    server = Server().add_service(EchoServiceImpl())
    server.start(f"0.0.0.0:{args.port}")
    print(f"gRPC server on {server.listen_endpoint()} "
          f"(grpc.health.v1.Health served builtin)", flush=True)
    try:
        time.sleep(args.run_seconds or 1e9)
    except KeyboardInterrupt:
        pass
    server.stop()
    server.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
