"""RTMP live relay demo: a server, a publisher pushing synthetic frames,
and a player receiving them (reference example: rtmp_c++ / live relay).
The JAX package's ``examples/rtmp_live/client.py`` on the port's RPC stack.

    python -m brpc_tpu_torch.examples.rtmp_live.client [-n 10]
"""

import argparse
import sys
import threading
import time

from brpc_tpu_torch.policy.rtmp import (MSG_AUDIO, MSG_VIDEO, RtmpClient,
                                        RtmpService)
from brpc_tpu_torch.rpc import Server, ServerOptions


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=10, help="frames to publish")
    args = ap.parse_args(argv)

    server = Server(ServerOptions(rtmp_service=RtmpService()))
    server.start("127.0.0.1:0")
    ep = server.listen_endpoint()
    print(f"rtmp server on {ep}")

    publisher = RtmpClient(ep.host, ep.port, app="live")
    player = RtmpClient(ep.host, ep.port, app="live")
    got = []
    done = threading.Event()

    def on_frame(mtype, sid, payload):
        kind = {MSG_VIDEO: "video", MSG_AUDIO: "audio"}.get(mtype, "data")
        got.append(kind)
        print(f"[player] {kind} frame {len(payload)}B "
              f"(#{len(got)})")
        if len(got) >= args.n:
            done.set()

    player.on_frame = on_frame
    psid = publisher.create_stream()
    publisher.publish("demo", psid)
    ssid = player.create_stream()
    player.play("demo", ssid)
    publisher.send_metadata(psid, "@setDataFrame",
                            {"width": 1280.0, "height": 720.0, "fps": 30.0})
    for i in range(args.n):
        mtype = MSG_VIDEO if i % 3 != 2 else MSG_AUDIO
        publisher.send_frame(mtype, psid, bytes([i]) * (1000 + i),
                             timestamp=i * 33)
        time.sleep(0.01)
    ok = done.wait(5)
    publisher.close()
    player.close()
    server.stop()
    server.join()
    print(f"relayed {len(got)} frames " + ("OK" if ok else "(incomplete)"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
