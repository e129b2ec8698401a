"""ParallelChannel fan-out example (reference example/parallel_echo_c++):
spins up N echo servers in-process, fans each request out to all of them,
and merges the responses.

The port of the JAX package's ``examples/parallel_echo/client.py``:
host only, over the port's RPC stack.

    python -m brpc_tpu_torch.examples.parallel_echo.client [--servers 3] [-n 5]
"""

import argparse
import sys

from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import Channel, MethodDescriptor, Server, Service
from brpc_tpu_torch.rpc.combo_channels import ParallelChannel, ResponseMerger

ECHO_MD = MethodDescriptor("EchoService", "Echo",
                           echo_pb2.EchoRequest, echo_pb2.EchoResponse)


class NamedEcho(Service):
    DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]

    def __init__(self, name):
        super().__init__()
        self.name = name

    def Echo(self, cntl, request, done):
        return echo_pb2.EchoResponse(message=f"[{self.name}]")


class ConcatMerger(ResponseMerger):
    def merge(self, response, sub):
        response.message += sub.message
        return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--servers", type=int, default=3)
    ap.add_argument("-n", type=int, default=5)
    args = ap.parse_args(argv)

    servers = [Server().add_service(NamedEcho(f"srv{i}")).start("127.0.0.1:0")
               for i in range(args.servers)]
    pc = ParallelChannel()
    for s in servers:
        pc.add_channel(Channel().init(str(s.listen_endpoint())),
                       response_merger=ConcatMerger())
    for i in range(args.n):
        resp = pc.call_method(ECHO_MD, echo_pb2.EchoRequest(message=f"r{i}"))
        print(f"request {i} -> merged {resp.message}", flush=True)
    for s in servers:
        s.stop()
        s.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
