"""Payload sweep benchmark client on the port, the rdma_performance analog
(reference example/rdma_performance/client.cpp:254-266 prints MB/s and
windowed latency percentiles per payload size; the JAX package's
``examples/transport_sweep/client.py``).

Server side: any echo server, e.g. the port's echo example, or a native
one in the same process with ``--serve``:

    python -m brpc_tpu_torch.examples.transport_sweep.client \
        --server 127.0.0.1:8000 [--sizes 64,4096,65536,1048576] \
        [--threads 4] [--attachment] [--native]
    python -m brpc_tpu_torch.examples.transport_sweep.client \
        --serve tpu://127.0.0.1:0/0 --native --seconds 1

``--native`` carries the calls over the port's C++ engine
(``native_transport=True``): TCP, or its shared-memory tunnel for a
``tpu://host:port/n`` server.
"""

import argparse
import sys
import threading
import time

from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Controller,
                                Server, ServerOptions, Service, Stub)


class _Echo(Service):
    DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]

    def Echo(self, cntl, request, done):
        cntl.response_attachment = cntl.request_attachment
        return echo_pb2.EchoResponse(message=request.message,
                                     payload=request.payload)


def percentile(lat, p):
    return lat[min(len(lat) - 1, int(p * len(lat)))] if lat else 0.0


def run_size(stub, size, threads, seconds, use_attachment):
    """Echo ``size`` bytes from ``threads`` callers for ``seconds``; prints
    one line and returns its numbers."""
    payload = b"\xab" * size
    stop = threading.Event()
    lats = [[] for _ in range(threads)]

    def worker(idx):
        # a load generator: each iteration blocks in one synchronous Echo RPC
        # until its response arrives
        while not stop.is_set():  # tpulint: disable=bounded-spin
            t0 = time.perf_counter()
            if use_attachment:
                cntl = Controller()
                cntl.request_attachment = payload
                stub.Echo(echo_pb2.EchoRequest(message="s"), controller=cntl)
                assert len(cntl.response_attachment) == size
            else:
                r = stub.Echo(echo_pb2.EchoRequest(message="s",
                                                   payload=payload))
                assert len(r.payload) == size
            lats[idx].append(time.perf_counter() - t0)

    ts = [threading.Thread(target=worker, args=(i,), name=f"sweep-{i}")
          for i in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    stop.wait(seconds)
    stop.set()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    lat = sorted(x for lst in lats for x in lst)
    n = len(lat)
    mbps = 2 * size * n / wall / 1e6
    print(f"{size:>9}B  {mbps:10.1f} MB/s  qps={n / wall:9,.0f}  "
          f"avg={sum(lat) / n * 1e6:8.0f}us  "
          f"p90={percentile(lat, 0.90) * 1e6:8.0f}us  "
          f"p99={percentile(lat, 0.99) * 1e6:8.0f}us  "
          f"p999={percentile(lat, 0.999) * 1e6:8.0f}us")
    return {"size": size, "mbps": mbps, "qps": n / wall, "calls": n,
            "p99_us": percentile(lat, 0.99) * 1e6}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--server", default="127.0.0.1:8000")
    ap.add_argument("--serve", default="",
                    help="start a native echo server here first (e.g. "
                         "127.0.0.1:0 or tpu://127.0.0.1:0/0) and sweep it")
    ap.add_argument("--sizes", default="64,4096,65536,1048576")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--attachment", action="store_true",
                    help="carry the payload as an attachment (skips "
                         "message serialization: the bulk-data lane)")
    ap.add_argument("--native", action="store_true",
                    help="use the C++ engine client transport")
    args = ap.parse_args(argv)
    server = None
    target = args.server
    if args.serve:
        server = Server(ServerOptions(native_dataplane=True))
        server.add_service(_Echo())
        server.start(args.serve)
        target = str(server.listen_endpoint())
    try:
        ch = Channel(ChannelOptions(protocol="trpc_std", timeout_ms=60000,
                                    native_transport=args.native))
        ch.init(target)
        stub = Stub(ch, echo_pb2.DESCRIPTOR.services_by_name["EchoService"])
        stub.Echo(echo_pb2.EchoRequest(message="warmup"))
        print(f"# sweep against {target} threads={args.threads} "
              f"attachment={args.attachment} native={args.native}")
        for size in (int(s) for s in args.sizes.split(",")):
            run_size(stub, size, args.threads, args.seconds,
                     args.attachment)
    finally:
        if server is not None:
            server.stop()
            server.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
