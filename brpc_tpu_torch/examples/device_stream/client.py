"""Streaming-into-device-memory client on the port (the JAX package's
``examples/device_stream/client.py``; ``tpu/device_stream.py``).

Stages chunks into the server's device memory (Put: the one host to
device crossing), then streams the HANDLES: the stream's credit window
counts the device bytes the records name, so the producer stalls exactly
when the server's card holds ``--window`` bytes of unconsumed blocks.
Payload bytes never transit Python again after the Put.

    python -m brpc_tpu_torch.examples.device_stream.server
    python -m brpc_tpu_torch.examples.device_stream.client \
        [--server 127.0.0.1:8310]
"""

import argparse
import sys
import time

from brpc_tpu_torch.proto import device_lane_pb2
from brpc_tpu_torch.rpc import Channel, ChannelOptions, Controller, Stub
from brpc_tpu_torch.rpc.stream import get_stream, stream_close
from brpc_tpu_torch.tpu.device_stream import open_device_stream, send_handle


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--server", default="127.0.0.1:8310")
    ap.add_argument("-n", type=int, default=8, help="blocks to stream")
    ap.add_argument("--block-kb", type=int, default=256)
    ap.add_argument("--window-kb", type=int, default=512,
                    help="device occupancy budget (credit window)")
    args = ap.parse_args(argv)

    dsvc = device_lane_pb2.DESCRIPTOR.services_by_name["DeviceDataService"]
    ch = Channel(ChannelOptions(timeout_ms=30000)).init(args.server)
    put = Stub(ch, dsvc)

    sid = open_device_stream(args.server,
                             window_bytes=args.window_kb << 10)
    total = 0
    t0 = time.perf_counter()
    for i in range(args.n):
        cntl = Controller()
        cntl.request_attachment = bytes([i & 0xFF]) * (args.block_kb << 10)
        h = put.Put(device_lane_pb2.DeviceHandle(), controller=cntl)
        rc = send_handle(sid, h.handle, h.nbytes, timeout=30)
        assert rc == 0, f"send_handle rc={rc}"
        total += h.nbytes
        print(f"streamed block {i}: handle={h.handle} "
              f"({h.nbytes >> 10} KB)", flush=True)
    # credit equality is completion (receivers flush exact feedback)
    st = get_stream(sid)
    deadline = time.time() + 30
    while st._remote_consumed < total and time.time() < deadline:
        time.sleep(0.01)
    wall = time.perf_counter() - t0
    stream_close(sid)
    assert st._remote_consumed >= total, "credits never returned"
    print(f"consumed on-device: {total >> 10} KB in {wall*1e3:.0f} ms "
          f"(window {args.window_kb} KB)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
