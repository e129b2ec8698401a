"""tpu:// transfer sweep on the port (reference
example/rdma_performance/client.cpp; the JAX package's
``examples/tpu_transfer/client.py``): a payload sweep printing bandwidth
and latency percentiles, where the "wire" is the card: each Echo goes
host to device, through the copy kernel (``csrc/copy.cu``), and back.

    python -m brpc_tpu_torch.examples.tpu_transfer.client \
        [--device tpu://localhost/0] [--sizes 4096,65536,1048576] [-n 32]

``--device`` names the in-process target, card 0 by default; ``cpu``
runs the same on the CPU. At the end it prints the copy kernel's
launches.
"""

import argparse
import sys
import time

from brpc_tpu_torch.examples import device_store, report_launches
from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import Channel, ChannelOptions, Stub

CARD = "tpu://localhost/0"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=CARD,
                    help="a tpu://localhost/n target, or cpu")
    ap.add_argument("--sizes", default="4096,65536,1048576")
    ap.add_argument("-n", type=int, default=32)
    args = ap.parse_args(argv)
    target = args.device
    if target == "cpu":
        device_store("cpu")  # tpu:// ordinal 0 is the CPU from here on
        target = CARD

    ch = Channel(ChannelOptions(timeout_ms=60000)).init(target)
    stub = Stub(ch, echo_pb2.DESCRIPTOR.services_by_name["EchoService"])

    print(f"{'size':>10} {'avg_ms':>9} {'p99_ms':>9} {'MB/s':>10}")
    for size in (int(s) for s in args.sizes.split(",")):
        payload = b"\xab" * size
        lats = []
        # warm-up (the first call loads the copy kernel)
        stub.Echo(echo_pb2.EchoRequest(message="warm", payload=payload))
        t0 = time.time()
        for _ in range(args.n):
            t1 = time.time()
            resp = stub.Echo(echo_pb2.EchoRequest(message="b",
                                                  payload=payload))
            lats.append((time.time() - t1) * 1e3)
            assert len(resp.payload) == size
        wall = time.time() - t0
        lats.sort()
        mbs = (size * 2 * args.n / wall) / 1e6  # bytes moved both ways
        p99 = lats[min(len(lats) - 1, int(len(lats) * 0.99))]
        print(f"{size:>10} {sum(lats)/len(lats):>9.2f} {p99:>9.2f} "
              f"{mbs:>10.1f}", flush=True)
    report_launches()
    return 0


if __name__ == "__main__":
    sys.exit(main())
