"""Streaming echo client on the port (reference
example/streaming_echo_c++/client.cpp; the JAX package's
``examples/streaming_echo/client.py``): opens a stream over the Echo RPC,
pushes N messages, awaits the echoes.

    python -m brpc_tpu_torch.examples.streaming_echo.client \
        [--server 127.0.0.1:8001] [-n 100]
"""

import argparse
import sys
import threading

from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import Channel, Controller, Stub
from brpc_tpu_torch.rpc.stream import (StreamOptions, stream_close,
                                       stream_create, stream_write)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--server", default="127.0.0.1:8001")
    ap.add_argument("-n", type=int, default=100)
    ap.add_argument("--message_bytes", type=int, default=64)
    args = ap.parse_args(argv)

    got = []
    done = threading.Event()

    def on_received(sid, msgs):
        got.extend(msgs)
        if len(got) >= args.n:
            done.set()

    sid = stream_create(StreamOptions(on_received=on_received))
    cntl = Controller()
    cntl.stream_id = sid
    ch = Channel().init(args.server)
    stub = Stub(ch, echo_pb2.DESCRIPTOR.services_by_name["EchoService"])
    resp = stub.Echo(echo_pb2.EchoRequest(message="open stream"),
                     controller=cntl)
    print(f"RPC reply: {resp.message}", flush=True)

    body = b"m" * args.message_bytes
    for i in range(args.n):
        rc = stream_write(sid, body + str(i).encode())
        if rc != 0:
            print(f"stream_write failed rc={rc}")
            return 1
    if not done.wait(timeout=10):
        print(f"timed out with {len(got)}/{args.n} echoes")
        return 1
    print(f"echoed {len(got)} messages, last={got[-1][-8:]!r}")
    stream_close(sid)
    return 0


if __name__ == "__main__":
    sys.exit(main())
