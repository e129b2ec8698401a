"""The native lanes end to end: the port's counterpart of ``bench.py``'s
``bench_native_lane`` and ``bench_native_tpu_lane``.

    python3 brpc_tpu_torch/bench/native_lane.py [--cpu] [--ms 2000]
    python3 brpc_tpu_torch/bench/native_lane.py --serve [--cpu]

``--serve`` is the server: a fresh interpreter that owns the card and
listens through the C++ engine (``native_dataplane=True``) on TCP
(``127.0.0.1:0``) and on the engine's TPUC shared-memory tunnel
(``tpu://127.0.0.1:0/0``), three listeners on each. The first answers
``EchoService.Echo`` in C++ (``register_native_echo``) and serves the
card's ``DeviceDataService``; the second answers it with the Python
``EchoService`` of ``bench/tpu_lane.py`` (phase 20's handler); the third
is the control (``register_null_method``: the poll loop echoes the raw
body back, with no decode, admission or method status). It prints
``LISTEN`` and the six endpoints, serves until its standard input closes,
fences the card and prints ``SERVED <json>`` (its kernel launches, its
dispatcher's launches and ops, the native method stats).

Without ``--serve`` it is the client: it starts that server as a child,
then on each lane drives the engine's C++ bench client
(``bench_echo_native``, the analog of the reference's C++ client
binaries) against the native echo: 16 B at 16 connections x 8 deep, 16 B
ping-pong, 64 B at depth 1 (the p50 / p99 beside the Python lane's), then
64 B, 4 KiB, 64 KiB, 1 MiB and 16 MiB; then the engine's C++ gRPC
client (``bench_echo_native(grpc=True)``, grpc over h2 end to end in the
engine) at the same shapes against the same native echo on TCP. Then, on
each lane, the like-for-like rows: ``bench/tpu_lane.py``'s sweep (its
Python client threads, its sizes and call counts) through a
``native_transport=True`` Channel, against the Python echo and against
the control; and the same sweep through a ``protocol="grpc"`` Channel
against the Python echo on TCP, once on the Python h2 lane and once on
the engine's h2 lane (only the client's lane differs: the listener's h2
half is the engine's either way). Then
the data plane of ``bench/tpu_lane.py`` (Puts, Copy, Pumps with their
checksums, transient copies, Stats) through a ``native_transport=True``
Channel over the tunnel, and the server's copy launches held to what
those calls imply (``tpu_lane.check_served``).

One JSON line per lane and one for the data plane; ``--cpu`` runs the
same on the CPU (a dry run: no card numbers, shorter windows).
``chip_smoke.py`` runs this client in its phase 20n.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "..", ".."))
sys.path.insert(0, ROOT)

from brpc_tpu_torch import rpc  # noqa: E402
from brpc_tpu_torch.bench import tpu_lane  # noqa: E402
from brpc_tpu_torch.butil.endpoint import EndPoint  # noqa: E402
from brpc_tpu_torch.rpc.native_transport import bench_echo_native  # noqa: E402

# (payload bytes, connections, depth): bench.py's native sweep; the
# tunnel's at its single-core shapes (pipeline depth does the
# overlapping), with 64 B added so both lanes cover the same sizes
SWEEP = {
    "tcp": [(64, 8, 4), (4096, 8, 4), (65536, 8, 4), (1 << 20, 4, 4),
            (16 << 20, 2, 4)],
    "tunnel": [(64, 4, 4), (4096, 4, 4), (65536, 1, 4), (1 << 20, 1, 2),
               (16 << 20, 1, 2)],
}


# ------------------------------------------------------------------ server
def serve(cpu):
    from brpc_tpu_torch.tpu import device_lane, mesh, pallas_ops

    if cpu:
        mesh.use_cpu()
    dev = mesh.resolve_device(EndPoint.parse("tpu://localhost/0"))
    store = device_lane.global_store(dev)
    servers = []
    for handler in ("native", "python", "null"):
        for addr in ("127.0.0.1:0", "tpu://127.0.0.1:0/0"):
            srv = rpc.Server(rpc.ServerOptions(native_dataplane=True))
            if handler == "native":
                srv.add_service(device_lane.DeviceDataService(store))
            srv.add_service(tpu_lane.EchoServiceImpl(None))
            srv.start(addr)
            if handler == "native":
                srv.register_native_echo("EchoService", "Echo")
            elif handler == "null":
                srv.register_null_method("EchoService", "Echo")
            servers.append(srv)
    print("LISTEN " + " ".join(str(s.listen_endpoint()) for s in servers),
          flush=True)
    sys.stdin.read()  # the client closing the pipe is the stop signal
    stats = [[list(x[:2]) + [x[2]] for x in s.native_method_stats()]
             for s in servers]
    python_calls = [s.find_service("EchoService").find_method("Echo")
                    .latency.count() for s in servers]
    for srv in servers:
        srv.stop()
        srv.join()
    store.fence()
    launches, ops, _ = device_lane.step_dispatch.snapshot()
    print("SERVED " + json.dumps({
        "launches": pallas_ops.launches.snapshot(),
        "dispatch_launches": launches, "dispatch_ops": ops,
        "stream_blocks": 0, "stream_errors": 0,
        "native_method_stats": stats, "python_echo_calls": python_calls,
        "foreign_modules": tpu_lane.foreign_modules()}), flush=True)
    return 0


class ChildServer:
    """``native_lane.py --serve`` in a fresh interpreter."""

    def __init__(self, cpu):
        cmd = [sys.executable, os.path.abspath(__file__), "--serve"]
        if cpu:
            cmd.append("--cpu")
        self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, cwd=ROOT,
                                     text=True)
        line = self.proc.stdout.readline().strip()
        if not line.startswith("LISTEN "):
            self.proc.kill()
            self.proc.communicate()
            raise RuntimeError(f"native_lane server failed to start: "
                               f"{line!r}")
        eps = line.split(" ")[1:]
        self.tcp, self.tunnel = eps[0:2]
        self.python = {"tcp": eps[2], "tunnel": eps[3]}
        self.null = {"tcp": eps[4], "tunnel": eps[5]}

    def close(self, timeout=120):
        try:
            out, _ = self.proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.communicate()
            raise
        if self.proc.returncode != 0:
            raise RuntimeError(f"native_lane server exited "
                               f"{self.proc.returncode}")
        for line in out.splitlines():
            if line.startswith("SERVED "):
                return json.loads(line.split(" ", 1)[1])
        raise RuntimeError("native_lane server printed no SERVED line")


# ------------------------------------------------------------------ client
def lane(endpoint, tunnel, ms, grpc=False):
    """The C++ bench client against the native echo on one lane
    (``grpc``: the engine's gRPC client, on TCP)."""
    ep = EndPoint.parse(endpoint)

    def bench(conns, depth, payload):
        r = bench_echo_native(ep.host, ep.port, conns=conns, depth=depth,
                              payload=payload, duration_ms=ms, tpu=tunnel,
                              grpc=grpc)
        if r["qps"] <= 0:
            raise AssertionError(f"no echo completed at {payload} B: {r}")
        return r

    out = {"multi_conn_16b": dict(bench(16, 8, 16), conns=16, depth=8),
           "ping_pong_16b": bench(1, 1, 16),
           "depth1_64b": bench(1, 1, 64), "sizes": {}}
    for size, conns, depth in SWEEP["tunnel" if tunnel else "tcp"]:
        out["sizes"][str(size)] = dict(bench(conns, depth, size),
                                       conns=conns, depth=depth)
    out["gb_per_s_1mib"] = out["sizes"][str(1 << 20)]["gbps"]
    out["qps_64b"] = out["sizes"]["64"]["qps"]
    out["depth1_p50_us"] = out["ping_pong_16b"]["p50_us"]
    out["depth1_p99_us"] = out["ping_pong_16b"]["p99_us"]
    return out


def python_lane(endpoint, protocol="trpc_std", native=True):
    """``tpu_lane.py``'s sweep (phase 20's Python client threads, sizes
    and calls) through a ``native_transport=True`` Channel: against the
    Python echo it differs from phase 20 in the lane alone.
    ``protocol="grpc"`` runs it over h2, on the engine's h2 client lane or
    (``native=False``) on the Python one."""
    stub = rpc.Stub(tpu_lane.channel(endpoint, native=native,
                                     protocol=protocol), tpu_lane.ECHO)
    tpu_lane.run_calls(stub, b"w" * 1024, 2, 10)  # warm-up
    _, lats = tpu_lane.run_calls(stub, tpu_lane.pattern(64, 64), 1,
                                 tpu_lane.DEPTH1_CALLS)
    out = {"depth1_64b": {"p50_ms": tpu_lane.pct(lats, 0.5) * 1e3,
                          "p99_ms": tpu_lane.pct(lats, 0.99) * 1e3},
           "sizes": {}}
    for size, threads, calls in tpu_lane.SWEEP:
        wall, lats = tpu_lane.run_calls(stub, tpu_lane.pattern(size, size),
                                        threads, calls)
        out["sizes"][str(size)] = {
            "threads": threads, "calls": calls,
            "gb_per_s": 2 * size * len(lats) / wall / 1e9,
            "qps": len(lats) / wall, "p50_ms": tpu_lane.pct(lats, 0.5) * 1e3,
            "p99_ms": tpu_lane.pct(lats, 0.99) * 1e3}
    out["gb_per_s_1mib"] = out["sizes"][str(1 << 20)]["gb_per_s"]
    out["qps_64b"] = out["sizes"]["64"]["qps"]
    return out


def run(cpu, ms=None):
    """Server up, both lanes, the data plane over the native tunnel,
    server down; returns the rows and the server's report."""
    ms = ms or (200 if cpu else 2000)
    tpu_lane.shm_free()
    srv = ChildServer(cpu)
    try:
        out = {"tcp": lane(srv.tcp, False, ms),
               "tunnel": lane(srv.tunnel, True, ms),
               "grpc": lane(srv.tcp, False, ms, grpc=True)}
        for name in ("tcp", "tunnel"):
            out[name]["python_echo"] = python_lane(srv.python[name])
            out[name]["null_echo"] = python_lane(srv.null[name])
        for name, native in (("python_h2", False), ("engine_h2", True)):
            out["grpc"][name] = python_lane(srv.python["tcp"], "grpc",
                                            native)
        out["data_plane"], expect, _ = tpu_lane.data_plane(
            srv.tunnel, cpu, native=True)
    except BaseException:
        srv.proc.kill()
        srv.proc.communicate()
        raise
    served = srv.close()
    tpu_lane.check_served(served, expect, 0, cpu)
    if served["foreign_modules"] or tpu_lane.foreign_modules():
        raise AssertionError(f"the lane loaded {served['foreign_modules']}"
                             f" (server), {tpu_lane.foreign_modules()} "
                             f"(client)")
    stats = served["native_method_stats"]
    if len(stats) != 6 or any(stats[2:]) or not all(
            len(lst) == 1 and lst[0][2]["requests"] > 0
            and not lst[0][2]["errors"] for lst in stats[:2]):
        # the C++ echoes answered, and only they keep native method status
        raise AssertionError(f"native echo stats: {served}")
    calls = served["python_echo_calls"]
    if calls[:2] != [0, 0] or 0 in calls[2:4] or calls[4:] != [0, 0]:
        # the Python handler ran on its listeners alone: never behind the
        # C++ echo, never behind the control
        raise AssertionError(f"Python echo calls per listener: {calls}")
    out["served"] = served
    out["expect"] = expect
    return out


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--ms", type=int, default=0,
                    help="window of each bench_echo_native run")
    args = ap.parse_args(argv[1:])
    if args.serve:
        return serve(args.cpu)
    if not args.cpu:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip(), flush=True)
    out = run(args.cpu, args.ms or None)
    for key in ("tcp", "tunnel", "grpc", "data_plane", "served"):
        print(json.dumps({"native_" + key: out[key]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
