"""Backup-request (hedging) example (reference example/backup_request_c++):
two replicas, one slow — the backup timer fires a duplicate attempt and the
fast replica's answer wins, cutting tail latency.

The port of the JAX package's ``examples/backup_request/client.py``:
host only, over the port's RPC stack.

    python -m brpc_tpu_torch.examples.backup_request.client [-n 10]
"""

import argparse
import sys
import time

from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import (
    Channel,
    ChannelOptions,
    Controller,
    MethodDescriptor,
    Server,
    Service,
)

ECHO_MD = MethodDescriptor("EchoService", "Echo",
                           echo_pb2.EchoRequest, echo_pb2.EchoResponse)


class Replica(Service):
    DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]

    def __init__(self, name, delay_s=0.0):
        super().__init__()
        self.name = name
        self.delay_s = delay_s

    def Echo(self, cntl, request, done):
        if self.delay_s:
            time.sleep(self.delay_s)
        return echo_pb2.EchoResponse(message=self.name)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=10)
    ap.add_argument("--backup_ms", type=int, default=30)
    args = ap.parse_args(argv)

    slow = Server().add_service(Replica("slow", delay_s=0.5)).start("127.0.0.1:0")
    fast = Server().add_service(Replica("fast")).start("127.0.0.1:0")
    ns = f"list://{slow.listen_endpoint()},{fast.listen_endpoint()}"
    ch = Channel(ChannelOptions(backup_request_ms=args.backup_ms,
                                timeout_ms=2000))
    ch.init(ns, "rr")
    hedged = 0
    for i in range(args.n):
        cntl = Controller()
        t0 = time.time()
        resp = ch.call_method(ECHO_MD, echo_pb2.EchoRequest(message="x"),
                              controller=cntl)
        ms = (time.time() - t0) * 1e3
        if cntl._backup_sent:
            hedged += 1
        print(f"call {i}: answered by {resp.message} in {ms:.1f}ms "
              f"(backup={'yes' if cntl._backup_sent else 'no'})", flush=True)
    print(f"{hedged}/{args.n} calls hedged; without backup requests every "
          f"other call would wait 500ms")
    for s in (slow, fast):
        s.stop()
        s.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
