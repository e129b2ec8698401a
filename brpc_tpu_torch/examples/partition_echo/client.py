"""PartitionChannel example (reference example/partition_echo_c++): shard
one logical service over N partition servers discovered through a naming
service whose tags say which partition each server holds ("i/n" syntax).

The port of the JAX package's ``examples/partition_echo/client.py``:
host only, over the port's RPC stack.

    python -m brpc_tpu_torch.examples.partition_echo.client [--partitions 3] [-n 4]
"""

import argparse
import sys

from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import Channel, MethodDescriptor, Server, Service
from brpc_tpu_torch.rpc.combo_channels import PartitionChannel, ResponseMerger

ECHO_MD = MethodDescriptor("EchoService", "Echo",
                           echo_pb2.EchoRequest, echo_pb2.EchoResponse)


class PartitionEcho(Service):
    DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]

    def __init__(self, index):
        super().__init__()
        self.index = index

    def Echo(self, cntl, request, done):
        return echo_pb2.EchoResponse(message=f"p{self.index};")


class ConcatMerger(ResponseMerger):
    def merge(self, response, sub):
        response.message += sub.message
        return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--partitions", type=int, default=3)
    ap.add_argument("-n", type=int, default=4)
    args = ap.parse_args(argv)

    n = args.partitions
    servers = [Server().add_service(PartitionEcho(i)).start("127.0.0.1:0")
               for i in range(n)]
    # list:// naming service with "i/n" partition tags (the reference's
    # PartitionParser syntax)
    ns = "list://" + ",".join(
        f"{s.listen_endpoint()} {i}/{n}" for i, s in enumerate(servers))
    print("naming service:", ns, flush=True)

    pc = PartitionChannel()
    pc.init(ns, n, response_merger=ConcatMerger())
    for i in range(args.n):
        resp = pc.call_method(ECHO_MD, echo_pb2.EchoRequest(message=f"q{i}"))
        print(f"request {i} -> {resp.message}", flush=True)
        assert sorted(resp.message.strip(";").split(";")) == \
            [f"p{k}" for k in range(n)]
    for s in servers:
        s.stop()
        s.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
