"""Device-resident payload server on the port (the JAX package's
``examples/device_data/server.py``): this process owns the card; clients
orchestrate device-resident data over any transport (the tpu:// shared
memory tunnel here). The listener is the C++ engine's
(``native_dataplane=True``), as in the JAX package's example.

    python -m brpc_tpu_torch.examples.device_data.server \
        [--listen tpu://127.0.0.1:8300/0] [--device cpu]

The store is on ``cuda`` unless ``--device cpu`` is given. On SIGINT or
SIGTERM it stops and prints the copy kernels' launches it made.
"""

import argparse
import signal
import sys

from brpc_tpu_torch.examples import device_store, report_launches
from brpc_tpu_torch.rpc import Server, ServerOptions
from brpc_tpu_torch.tpu.device_lane import DeviceDataService


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--listen", default="tpu://127.0.0.1:8300/0")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)
    store = device_store(args.device)
    server = Server(ServerOptions(native_dataplane=True))
    server.add_service(DeviceDataService(store))
    server.start(args.listen)
    lane = "native engine" if server._native_lid is not None else "python"
    print(f"DeviceDataService on {server.listen_endpoint()} "
          f"({store.device}, {lane} listener)", flush=True)
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
