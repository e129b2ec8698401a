"""Echo client on the port (reference example/echo_c++/client.cpp; the
JAX package's ``examples/echo/client.py``).

    python -m brpc_tpu_torch.examples.echo.client [--server 127.0.0.1:8000] \
        [-n 10]
"""

import argparse
import sys

from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import Channel, ChannelOptions, Controller, Stub


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--server", default="127.0.0.1:8000")
    ap.add_argument("--protocol", default="trpc_std")
    ap.add_argument("--timeout_ms", type=int, default=1000)
    ap.add_argument("-n", type=int, default=10)
    ap.add_argument("--attachment", default="echo attachment")
    args = ap.parse_args(argv)

    channel = Channel(ChannelOptions(protocol=args.protocol,
                                     timeout_ms=args.timeout_ms))
    channel.init(args.server)
    stub = Stub(channel, echo_pb2.DESCRIPTOR.services_by_name["EchoService"])

    for i in range(args.n):
        cntl = Controller()
        cntl.request_attachment = args.attachment.encode()
        resp = stub.Echo(echo_pb2.EchoRequest(message=f"hello {i}"),
                         controller=cntl)
        print(f"Received: {resp.message!r} attachment="
              f"{cntl.response_attachment!r} latency={cntl.latency_us}us",
              flush=True)
    print(channel.latency_recorder.describe())
    return 0


if __name__ == "__main__":
    sys.exit(main())
