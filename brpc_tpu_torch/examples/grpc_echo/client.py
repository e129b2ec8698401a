"""gRPC client example (the JAX package's ``examples/grpc_echo/client.py``
on the port's RPC stack).

    python -m brpc_tpu_torch.examples.grpc_echo.client [--server 127.0.0.1:8020] [-n 10]
"""

import argparse
import sys

from brpc_tpu_torch.proto import echo_pb2, health_pb2
from brpc_tpu_torch.rpc import Channel, ChannelOptions, Stub


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--server", default="127.0.0.1:8020")
    ap.add_argument("-n", type=int, default=10)
    args = ap.parse_args(argv)

    ch = Channel(ChannelOptions(protocol="grpc")).init(args.server)
    stub = Stub(ch, echo_pb2.DESCRIPTOR.services_by_name["EchoService"])
    for i in range(args.n):
        resp = stub.Echo(echo_pb2.EchoRequest(message=f"grpc {i}"))
        print("Received:", resp.message, flush=True)
    health = Stub(ch, health_pb2.DESCRIPTOR.services_by_name["Health"])
    status = health.Check(health_pb2.HealthCheckRequest()).status
    print("health:", health_pb2.HealthCheckResponse.ServingStatus.Name(status))
    print(ch.latency_recorder.describe())
    return 0


if __name__ == "__main__":
    sys.exit(main())
