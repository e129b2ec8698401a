"""Streaming echo server on the port (reference
example/streaming_echo_c++/server.cpp; the JAX package's
``examples/streaming_echo/server.py``): accepts a stream on the Echo RPC
and echoes every message back on it.

    python -m brpc_tpu_torch.examples.streaming_echo.server [--port 8001]

It touches no device.
"""

import argparse
import sys
import time

from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import Server, Service
from brpc_tpu_torch.rpc.stream import (StreamOptions, stream_accept,
                                       stream_write)


class StreamingEchoService(Service):
    DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]

    def Echo(self, cntl, request, done):
        def on_received(sid, msgs):
            for m in msgs:
                stream_write(sid, m)

        def on_closed(sid):
            print(f"stream {sid} closed", flush=True)

        sid = stream_accept(cntl, StreamOptions(on_received=on_received,
                                                on_closed=on_closed))
        print(f"accepted stream {sid}", flush=True)
        return echo_pb2.EchoResponse(message="stream-accepted")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8001)
    ap.add_argument("--run_seconds", type=float, default=0)
    args = ap.parse_args(argv)
    server = Server().add_service(StreamingEchoService())
    server.start(f"0.0.0.0:{args.port}")
    print(f"StreamingEchoServer on {server.listen_endpoint()}", flush=True)
    try:
        time.sleep(args.run_seconds or 1e9)
    except KeyboardInterrupt:
        pass
    server.stop()
    server.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
