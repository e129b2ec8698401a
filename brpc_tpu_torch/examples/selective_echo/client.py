"""SelectiveChannel example (reference example/selective_echo_c++): LB over
channels — each call picks one healthy sub-channel; failures steer traffic
to survivors.

The port of the JAX package's ``examples/selective_echo/client.py``:
host only, over the port's RPC stack.

    python -m brpc_tpu_torch.examples.selective_echo.client [--servers 3] [-n 12]
"""

import argparse
import sys

from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import Channel, MethodDescriptor, Server, Service
from brpc_tpu_torch.rpc.combo_channels import SelectiveChannel

ECHO_MD = MethodDescriptor("EchoService", "Echo",
                           echo_pb2.EchoRequest, echo_pb2.EchoResponse)


class NamedEcho(Service):
    DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]

    def __init__(self, name):
        super().__init__()
        self.name = name
        self.hits = 0

    def Echo(self, cntl, request, done):
        self.hits += 1
        return echo_pb2.EchoResponse(message=self.name)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--servers", type=int, default=3)
    ap.add_argument("-n", type=int, default=12)
    args = ap.parse_args(argv)

    impls = [NamedEcho(f"srv{i}") for i in range(args.servers)]
    servers = [Server().add_service(im).start("127.0.0.1:0") for im in impls]
    sc = SelectiveChannel()
    for s in servers:
        sc.add_channel(Channel().init(str(s.listen_endpoint())))
    for i in range(args.n):
        resp = sc.call_method(ECHO_MD, echo_pb2.EchoRequest(message=f"r{i}"))
        print(f"request {i} answered by {resp.message}", flush=True)
    # kill one server: traffic must flow to the survivors
    servers[0].stop()
    servers[0].join()
    print("-- killed srv0 --", flush=True)
    for i in range(args.n):
        resp = sc.call_method(ECHO_MD, echo_pb2.EchoRequest(message=f"k{i}"))
        assert resp.message != "srv0"
        print(f"request {i} answered by {resp.message}", flush=True)
    print("hits:", {im.name: im.hits for im in impls})
    for s in servers[1:]:
        s.stop()
        s.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
