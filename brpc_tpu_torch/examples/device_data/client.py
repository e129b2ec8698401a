"""Device-resident payload example on the port (the JAX package's
``examples/device_data/client.py``; ``tpu/device_lane.py``).

A client ships a tensor into the serving process's device memory once
(Put), moves it on the device by handle (Copy, Pump: the data never
touches the host), checks the resident and moved accounting (Stats), and
pulls bytes back only when it needs them (Get).

Both ends ride the C++ engine (``native_transport=True`` here,
``native_dataplane=True`` on the server), as the JAX package's example
does. Run a server first (any transport; the shared-memory tunnel shown
here):

    python -m brpc_tpu_torch.examples.device_data.server \
        --listen tpu://127.0.0.1:8300/0
    python -m brpc_tpu_torch.examples.device_data.client \
        --server tpu://127.0.0.1:8300/0
"""

import argparse
import sys

from brpc_tpu_torch.proto import device_lane_pb2
from brpc_tpu_torch.rpc import Channel, ChannelOptions, Controller, Stub


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--server", default="tpu://127.0.0.1:8300/0")
    ap.add_argument("--mb", type=int, default=4, help="payload MB")
    ap.add_argument("--copies", type=int, default=8)
    ap.add_argument("--pump-rounds", type=int, default=4)
    args = ap.parse_args(argv)

    ch = Channel(ChannelOptions(protocol="trpc_std", timeout_ms=120000,
                                native_transport=True))
    ch.init(args.server)
    stub = Stub(ch, device_lane_pb2.DESCRIPTOR.services_by_name[
        "DeviceDataService"])

    blob = bytes(range(256)) * (args.mb * 4096)
    cntl = Controller()
    cntl.request_attachment = blob
    put = stub.Put(device_lane_pb2.DeviceHandle(), controller=cntl)
    print(f"Put: handle={put.handle} ({put.nbytes >> 20} MB now on the "
          f"device)")

    h = put.handle
    for i in range(args.copies):
        h = stub.Copy(device_lane_pb2.DeviceHandle(handle=h)).handle
    print(f"Copy x{args.copies}: final handle={h} (moved on-device only)")

    pumped = stub.Pump(device_lane_pb2.PumpRequest(
        handle=h, rounds=args.pump_rounds))
    print(f"Pump x{args.pump_rounds}: checksum={pumped.checksum} "
          f"moved={pumped.moved_bytes >> 20} MB through device memory "
          f"(verified)")

    st = stub.Stats(device_lane_pb2.DeviceStatsRequest(fence=True))
    print(f"Stats: {st.handles} handles, {st.resident_bytes >> 20} MB "
          f"resident, {st.moved_bytes >> 20} MB moved")

    back = Controller()
    got = stub.Get(device_lane_pb2.DeviceHandle(handle=h), controller=back)
    assert back.response_attachment == blob, "device round trip corrupted"
    print(f"Get: {got.nbytes >> 20} MB back on the host, content verified")

    stub.Free(device_lane_pb2.DeviceHandle(handle=h))
    stub.Free(device_lane_pb2.DeviceHandle(handle=put.handle))
    return 0


if __name__ == "__main__":
    sys.exit(main())
