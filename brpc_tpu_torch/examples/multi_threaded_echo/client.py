"""Multi-threaded echo benchmark client (reference
example/multi_threaded_echo_c++/client.cpp — prints QPS + latency
percentiles once per second).

The port of the JAX package's ``examples/multi_threaded_echo/client.py``:
host only, over the port's RPC stack.

    python -m brpc_tpu_torch.examples.multi_threaded_echo.client \
        --server 127.0.0.1:8000 --threads 8 --seconds 10 [--payload_bytes 16]
"""

import argparse
import sys
import threading
import time

from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import Channel, ChannelOptions, RpcError, Stub


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--server", default="127.0.0.1:8000")
    ap.add_argument("--protocol", default="trpc_std")
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--payload_bytes", type=int, default=16)
    args = ap.parse_args(argv)

    channel = Channel(ChannelOptions(protocol=args.protocol,
                                     timeout_ms=2000))
    channel.init(args.server)
    stub = Stub(channel, echo_pb2.DESCRIPTOR.services_by_name["EchoService"])
    payload = b"x" * args.payload_bytes
    stop = threading.Event()
    errors_seen = [0]

    def worker():
        req = echo_pb2.EchoRequest(message="bench", payload=payload)
        # a load generator: each iteration blocks in one synchronous Echo RPC
        # until its response arrives
        while not stop.is_set():  # tpulint: disable=bounded-spin
            try:
                stub.Echo(req)
            except RpcError:
                errors_seen[0] += 1

    threads = [threading.Thread(target=worker, name=f"echo-{i}")
               for i in range(args.threads)]
    for t in threads:
        t.start()
    deadline = time.time() + args.seconds
    lat = channel.latency_recorder
    while time.time() < deadline:
        time.sleep(1)
        print(f"qps={lat.qps():.0f} {lat.describe()} "
              f"errors={errors_seen[0]}", flush=True)
    stop.set()
    for t in threads:
        t.join()
    print(f"final: count={lat.count()} {lat.describe()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
