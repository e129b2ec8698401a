"""Streaming-into-device-memory server on the port (the JAX package's
``examples/device_stream/server.py``; ``tpu/device_stream.py``).

Accepts device streams on the Echo RPC: each incoming 16-byte handle
record is consumed ON THE DEVICE (a transient copy) and freed, and
credits flow back through the stream's feedback, so the credit window
bounds this process's device-pool occupancy.

    python -m brpc_tpu_torch.examples.device_stream.server \
        [--listen 127.0.0.1:8310] [--device cpu]

The store is on ``cuda`` unless ``--device cpu`` is given. On SIGINT or
SIGTERM it stops and prints the copy kernels' launches it made.
"""

import argparse
import signal
import sys

from brpc_tpu_torch.examples import device_store, report_launches
from brpc_tpu_torch.rpc import Server
from brpc_tpu_torch.tpu.device_lane import DeviceDataService
from brpc_tpu_torch.tpu.device_stream import DeviceStreamEchoService


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--listen", default="127.0.0.1:8310")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)
    store = device_store(args.device)
    server = Server()
    server.add_service(DeviceDataService(store))
    server.add_service(DeviceStreamEchoService(store))
    server.start(args.listen)
    print(f"device-stream server on {server.listen_endpoint()}",
          flush=True)
    stop = []
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    # signal.pause() parks the thread until SIGINT/SIGTERM arrives; each wakeup
    # re-tests the flag the handler set
    while not stop:  # tpulint: disable=bounded-spin
        signal.pause()
    server.stop()
    server.join()
    report_launches(store)
    return 0


if __name__ == "__main__":
    sys.exit(main())
