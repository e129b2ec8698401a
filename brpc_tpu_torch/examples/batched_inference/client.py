"""Batched-inference client on the port (the JAX package's
``examples/batched_inference/client.py``): fire a pipelined async burst
and show that the server answered it as a handful of vectorized calls.

    python -m brpc_tpu_torch.examples.batched_inference.client \
        [--server 127.0.0.1:8014] [-n 32] [--poison 1]

Each response's message carries the batch size it rode in
(``batch=N sum=...``): a burst of 32 typically comes back in a few
batches of up to 16 rather than 32 singletons. ``--poison k`` adds k
requests with a malformed payload, each of which must fail alone
(EREQUEST) while its batchmates succeed. Host only: the model runs in
the server.
"""

import argparse
import collections
import sys
import threading

import numpy as np

from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import Channel, ChannelOptions, Stub, errors

DIM = 64


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--server", default="127.0.0.1:8014")
    ap.add_argument("-n", type=int, default=32)
    ap.add_argument("--poison", type=int, default=0)
    ap.add_argument("--timeout_ms", type=int, default=10000)
    args = ap.parse_args(argv)

    channel = Channel(ChannelOptions(timeout_ms=args.timeout_ms))
    channel.init(args.server)
    stub = Stub(channel, echo_pb2.DESCRIPTOR.services_by_name["EchoService"])

    total = args.n + args.poison
    done_ev = threading.Event()
    results = []
    lock = threading.Lock()

    def done_for(poisoned):
        def done(cntl):
            with lock:
                results.append((poisoned, cntl))
                if len(results) == total:
                    done_ev.set()
        return done

    rng = np.random.default_rng(0)
    # the poisoned requests go out in the middle of the burst, so they
    # share a batch with good ones
    order = [False] * args.n
    for k in range(args.poison):
        order.insert((k + 1) * len(order) // (args.poison + 1), True)
    for poisoned in order:
        x = rng.standard_normal(DIM - 1 if poisoned else DIM)
        stub.Echo(echo_pb2.EchoRequest(
            message="infer", payload=x.astype(np.float32).tobytes()),
            done=done_for(poisoned))
    if not done_ev.wait(30):
        print(f"timed out: {len(results)}/{total} done", file=sys.stderr)
        return 1

    sizes = collections.Counter()
    bad_ok = 0
    for poisoned, cntl in results:
        if poisoned:
            bad_ok += cntl.error_code == errors.EREQUEST
            continue
        if cntl.failed():
            print(f"FAILED: {cntl.error_code} {cntl.error_text}")
            return 1
        msg = cntl._response.message          # "batch=N sum=..."
        sizes[int(msg.split("batch=")[1].split(" ")[0])] += 1
    print(f"{len(results)} responses; items per observed batch size:")
    for size in sorted(sizes, reverse=True):
        print(f"  batch={size:<3d} carried {sizes[size]} request(s)")
    coalesced = sum(n for s, n in sizes.items() if s > 1)
    print(f"{coalesced}/{args.n} requests rode a multi-request batch")
    if args.poison:
        print(f"poisoned requests failed alone: {bad_ok}/{args.poison} "
              f"EREQUEST")
        if bad_ok != args.poison:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
