"""The ``tpu://`` lane through the cross-process tunnel: the port's
counterpart of ``tools/bench_server.py`` with ``bench.py``'s
``bench_tpu_sweep`` and ``bench_device_lane``.

    python3 brpc_tpu_torch/bench/tpu_lane.py [--cpu]
    python3 brpc_tpu_torch/bench/tpu_lane.py --serve [--cpu]

``--serve`` is the server: a fresh interpreter that owns the card, serves
a host ``EchoService`` (the bytes echo back from the host), the card's
``DeviceDataService`` and a device-stream consumer
(``DeviceStreamEchoService``, each block consumed by a transient copy and
kept) on ``tpu://127.0.0.1:0/0``, prints ``LISTEN <endpoint>`` and serves
until its standard input closes; it then fences the card and prints
``SERVED <json>``: its kernel launches, its dispatcher's launches and
ops, and what the stream consumed.

Without ``--serve`` the script is the client: it starts that server
(``subprocess``, never a fork of a process with CUDA up), then, through
one ``Channel`` on the tunnel:

- the sweep: depth-1 p50 / p99 at 64 B and 4 KiB, then 64 B - 16 MiB
  echoes at ``bench.py``'s threads and its ``QUICK`` calls, every
  response compared with its request; GB/s counts the
  bytes both ways. With it the client's tunnel counters: bytes borrowed
  (received in the shared-memory blocks, no copy) and copied, ACK frames
  and the credits they carried, and the borrowed peak against the window.
  The bulk sizes must ride the blocks: the run fails if no bytes were
  borrowed, if the client's endpoint fell back to inline frames, if more
  than a tenth of the 16 MiB bytes were copied, or if the peak reached
  the window.
- the data plane: 1 MiB Puts (warm, then timed), a 64 KiB Put -> Copy ->
  Get round trip, 8 MiB Pumps of 1024 rounds (the checksum equal to the
  host's sum of the payload's first and last int32), the op rate of
  ``Copy`` with ``nbytes = -256`` (256 transient copies per call), the
  transient and batched-copy moved bytes, Free and a fenced Stats whose
  moved bytes equal what the calls reported.
- a device stream: records naming one resident 8 MiB block, the window
  four blocks, completion when the stream's credits come home; the block
  is read back with ``Get`` and compared.

Every phase prints one JSON line; ``--cpu`` runs the same on the CPU (a
dry run, no card numbers, and a quarter of the data-plane calls). ``chip_smoke.py`` runs this client inside its
``tpu://`` phase.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "..", ".."))
sys.path.insert(0, ROOT)

from brpc_tpu_torch import rpc  # noqa: E402
from brpc_tpu_torch.butil.endpoint import EndPoint  # noqa: E402
from brpc_tpu_torch.butil.iobuf import supports_block_ownership  # noqa: E402
from brpc_tpu_torch.proto import device_lane_pb2, echo_pb2  # noqa: E402
from brpc_tpu_torch.rpc.stream import get_stream, stream_close  # noqa: E402
from brpc_tpu_torch.tpu import device_stream, transport  # noqa: E402

ECHO = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]
DSVC = device_lane_pb2.DESCRIPTOR.services_by_name["DeviceDataService"]
TIMEOUT_MS = 120000


# bench.py's SWEEP at QUICK counts: (payload bytes, threads, calls per
# thread), and the depth-1 calls at 64 B and 4 KiB
SWEEP = [(64, 8, 60), (4096, 8, 60), (65536, 4, 40), (1 << 20, 4, 20),
         (16 << 20, 2, 3)]
DEPTH1_CALLS = 60


# bench_device_lane: 1 MiB puts (warm, timed), an 8 MiB pump block
PUT_BYTES = 1 << 20
PUMP_BYTES = 8 << 20
PUMP_ROUNDS = 1024
OP_RATE_K = 256          # transient copies per Copy call
LANE_BLOB = bytes(range(256)) * 256   # the 64 KiB round trip
SHM_NEEDED = 4 * (transport.DEFAULT_BLOCK_SIZE
                  * transport.DEFAULT_BLOCK_COUNT)


def lane_counts(cpu):
    """(warm puts, timed puts, pumps, Copy -256 calls, stream records)."""
    return (4, 4, 4, 8, 2) if cpu else (16, 16, 8, 64, 8)


def pattern(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def pct(xs, q):
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else 0.0


def foreign_modules():
    """The modules of JAX, of the JAX package or of protobuf this process
    has loaded (the port needs none)."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "brpc_tpu")
                  or m.startswith("google.protobuf"))


# ------------------------------------------------------------------ server
class EchoServiceImpl(rpc.Service):
    """The host echo of tools/bench_server.py: the bytes come back from
    the host; ``device-stream[:window]`` messages open a device stream."""

    DESCRIPTOR = ECHO

    def __init__(self, stream_impl):
        super().__init__()
        self.stream_impl = stream_impl

    def Echo(self, cntl, request, done):
        if request.message.startswith("device-stream"):
            return self.stream_impl.Echo(cntl, request, done)
        cntl.response_attachment = cntl.request_attachment
        return echo_pb2.EchoResponse(message=request.message,
                                     payload=request.payload)


def serve(cpu):
    from brpc_tpu_torch.tpu import device_lane, mesh, pallas_ops

    if cpu:
        mesh.use_cpu()
    dev = mesh.resolve_device(EndPoint.parse("tpu://localhost/0"))
    store = device_lane.global_store(dev)
    stream_impl = device_stream.DeviceStreamEchoService(store,
                                                        free_after=False)
    server = rpc.Server()
    server.add_service(device_lane.DeviceDataService(store))
    server.add_service(EchoServiceImpl(stream_impl))
    server.start("tpu://127.0.0.1:0/0")
    print(f"LISTEN {server.listen_endpoint()}", flush=True)
    sys.stdin.read()  # the client closing the pipe is the stop signal
    server.stop()
    server.join()
    store.fence()   # nothing queued on the card outlives the process
    launches, ops, _ = device_lane.step_dispatch.snapshot()
    print("SERVED " + json.dumps({
        "launches": pallas_ops.launches.snapshot(),
        "dispatch_launches": launches, "dispatch_ops": ops,
        "stream_blocks": stream_impl.consumed_blocks,
        "stream_bytes": stream_impl.consumed_bytes,
        "stream_errors": stream_impl.errors,
        "foreign_modules": foreign_modules()}), flush=True)
    return 0


class ChildServer:
    """``tpu_lane.py --serve`` in a fresh interpreter."""

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
            raise RuntimeError(f"tpu_lane server failed to start: {line!r}")
        self.endpoint = line.split(" ", 1)[1]

    def close(self, timeout=120):
        """Stop the server (communicate closes its standard input);
        returns its SERVED report."""
        try:
            out, _ = self.proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.communicate()
            raise
        if self.proc.returncode != 0:
            raise RuntimeError(f"tpu_lane server exited "
                               f"{self.proc.returncode}")
        for line in out.splitlines():
            if line.startswith("SERVED "):
                return json.loads(line.split(" ", 1)[1])
        raise RuntimeError("tpu_lane server printed no SERVED line")


def shm_free():
    """Free bytes of /dev/shm (the block pools' backing); raises when
    the tunnel's four pools would not fit."""
    free = shutil.disk_usage("/dev/shm").free
    if free < SHM_NEEDED:
        raise RuntimeError(f"/dev/shm has {free} bytes free; the tunnel's "
                           f"block pools need {SHM_NEEDED}")
    return free


# ------------------------------------------------------------------ client
def channel(endpoint):
    return rpc.Channel(rpc.ChannelOptions(
        protocol="trpc_std", timeout_ms=TIMEOUT_MS)).init(endpoint)


def run_calls(stub, payload, threads, calls):
    """threads x calls sync echoes, each response compared with its
    request; returns (wall s, sorted latencies s)."""
    lat = [[] for _ in range(threads)]
    failures = []
    barrier = threading.Barrier(threads + 1)

    def worker(idx):
        req = echo_pb2.EchoRequest(message=f"b{idx}", payload=payload)
        barrier.wait()
        try:
            for _ in range(calls):
                t0 = time.perf_counter()
                resp = stub.Echo(req)
                lat[idx].append(time.perf_counter() - t0)
                if resp.payload != payload or resp.message != req.message:
                    raise AssertionError(f"echo of {len(payload)} B came "
                                         f"back different")
        except BaseException as e:  # noqa: BLE001
            failures.append(e)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(threads)]
    for t in ts:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    if failures:
        raise RuntimeError(f"{len(failures)}/{threads} echo workers failed; "
                           f"first: {failures[0]!r}") from failures[0]
    return wall, sorted(x for xs in lat for x in xs)


def _counters():
    return {k: getattr(transport, f"g_tunnel_{k}").get_value()
            for k in ("borrowed_bytes", "copied_bytes", "ack_frames",
                      "ack_credits")}


def sweep(endpoint):
    """bench_tpu_sweep through the port's tunnel; returns its JSON row."""
    stub = rpc.Stub(channel(endpoint), ECHO)
    spec = SWEEP
    run_calls(stub, b"w" * 1024, 2, 10)  # warm-up
    depth1 = {}
    for size in (64, 4096):
        _, lats = run_calls(stub, pattern(size, size), 1, DEPTH1_CALLS)
        depth1[size] = {"p50_ms": pct(lats, 0.5) * 1e3,
                        "p99_ms": pct(lats, 0.99) * 1e3}
    # the first bulk call pays the block pools' page faults
    run_calls(stub, pattern(max(s for s, _, _ in spec), 1), 1, 1)
    transport.reset_borrowed_peak()
    c0 = _counters()
    rows, bulk = {}, None
    for size, threads, calls in spec:
        b0 = _counters()
        wall, lats = run_calls(stub, pattern(size, size), threads, calls)
        rows[size] = {"threads": threads, "calls": calls,
                      "gb_per_s": 2 * size * len(lats) / wall / 1e9,
                      "qps": len(lats) / wall,
                      "p50_ms": pct(lats, 0.5) * 1e3,
                      "p99_ms": pct(lats, 0.99) * 1e3}
        if size == 16 << 20:
            b1 = _counters()
            bulk = (b1["borrowed_bytes"] - b0["borrowed_bytes"],
                    b1["copied_bytes"] - b0["copied_bytes"])
    c1 = _counters()
    d = {k: c1[k] - c0[k] for k in c0}
    # response bytes that had to ride the blocks (above the inline cap)
    want_blocks = sum(s * t * c for s, t, c in spec
                      if s > transport.INLINE_MAX)
    peak = transport.borrowed_peak_blocks()
    state = transport.tunnel_state()
    inline = [e["key"] for e in state["client_endpoints"]
              if e["inline_only"]]
    bulk_frac = bulk[1] / max(1, sum(bulk))
    row = {
        "sizes": {str(k): v for k, v in rows.items()},
        "depth1": {str(k): v for k, v in depth1.items()},
        "gb_per_s_1mib": rows[1 << 20]["gb_per_s"],
        "qps_64b": rows[64]["qps"],
        "borrowed_bytes": d["borrowed_bytes"],
        "copied_bytes": d["copied_bytes"],
        "ack_frames": d["ack_frames"], "ack_credits": d["ack_credits"],
        "credits_per_ack": d["ack_credits"] / max(1, d["ack_frames"]),
        "borrowed_peak_blocks": peak,
        "window_blocks": transport.DEFAULT_BLOCK_COUNT,
        "copied_frac_16mib": bulk_frac,
        "block_bytes_expected": want_blocks,
    }
    if inline:
        raise AssertionError(f"tunnel {inline} fell back to inline frames:"
                             f" the shared-memory pools did not attach")
    if d["borrowed_bytes"] + d["copied_bytes"] < want_blocks:
        raise AssertionError(f"the blocks carried {d['borrowed_bytes']} + "
                             f"{d['copied_bytes']} B, want at least "
                             f"{want_blocks}")
    if supports_block_ownership():
        if d["borrowed_bytes"] <= 0 or bulk_frac > 0.10:
            raise AssertionError(f"bulk bytes were not borrowed: {row}")
        if peak >= transport.DEFAULT_BLOCK_COUNT:
            raise AssertionError(f"borrowed peak {peak} reached the window")
    return row


def data_plane(endpoint, cpu=False):
    """bench_device_lane through the port's tunnel; returns its JSON row
    and what the server's counters must show for it."""
    stub = rpc.Stub(channel(endpoint), DSVC)
    warm_puts, puts, pumps, op_calls, _ = lane_counts(cpu)
    moved = 0

    def put(data):
        c = rpc.Controller()
        c.request_attachment = data
        r = stub.Put(device_lane_pb2.DeviceHandle(), controller=c)
        if r.nbytes != len(data) or r.handle <= 0:
            raise AssertionError(f"Put answered {r}")
        return r.handle

    def get(h):
        c = rpc.Controller()
        r = stub.Get(device_lane_pb2.DeviceHandle(handle=h), controller=c)
        if r.nbytes != len(c.response_attachment):
            raise AssertionError(f"Get answered {r}")
        return c.response_attachment

    payload = b"\xab" * PUT_BYTES
    handles = [put(payload) for _ in range(warm_puts)]
    t0 = time.perf_counter()
    handles += [put(payload) for _ in range(puts)]
    put_s = time.perf_counter() - t0

    small = put(LANE_BLOB)
    cp = stub.Copy(device_lane_pb2.DeviceHandle(handle=small))
    moved += 2 * cp.nbytes
    if get(cp.handle) != LANE_BLOB or cp.nbytes != len(LANE_BLOB):
        raise AssertionError("device round trip corrupt")

    block = pattern(PUMP_BYTES, 9)
    words = np.frombuffer(block, dtype=np.int32).reshape(-1, 2048)
    want = int(np.array([words[0, 0], words[-1, -1]], np.int32).sum(
        dtype=np.int32))
    src = put(block)
    warm = stub.Pump(device_lane_pb2.PumpRequest(handle=src, rounds=1))
    moved += warm.moved_bytes
    if warm.checksum != want or warm.moved_bytes != 4 * PUMP_BYTES:
        raise AssertionError(f"warm pump {warm}, want checksum {want}")
    t0 = time.perf_counter()
    pumped = 0
    for _ in range(pumps):
        r = stub.Pump(device_lane_pb2.PumpRequest(handle=src,
                                                  rounds=PUMP_ROUNDS))
        if r.checksum != want or r.moved_bytes != 4 * PUMP_ROUNDS * \
                PUMP_BYTES:
            raise AssertionError(f"pump {r}, want checksum {want}")
        pumped += r.moved_bytes
    pump_s = time.perf_counter() - t0
    moved += pumped

    one = stub.Copy(device_lane_pb2.DeviceHandle(handle=small, nbytes=-1))
    if (one.handle, one.nbytes) != (0, len(LANE_BLOB)):
        raise AssertionError(f"transient Copy answered {one}")
    moved += 2 * one.nbytes
    stub.Stats(device_lane_pb2.DeviceStatsRequest(fence=True))
    req = device_lane_pb2.DeviceHandle(handle=small, nbytes=-OP_RATE_K)
    t0 = time.perf_counter()
    for _ in range(op_calls):
        r = stub.Copy(req)
        if (r.handle, r.nbytes) != (0, OP_RATE_K * len(LANE_BLOB)):
            raise AssertionError(f"Copy -{OP_RATE_K} answered {r}")
        moved += 2 * r.nbytes
    stats = stub.Stats(device_lane_pb2.DeviceStatsRequest(fence=True))
    op_s = time.perf_counter() - t0
    try:
        stub.Copy(device_lane_pb2.DeviceHandle(handle=1 << 40))
    except rpc.RpcError as e:
        if e.error_code != rpc.errors.ENOMETHOD:
            raise
    else:
        raise AssertionError("Copy of an unknown handle answered")
    for h in handles + [cp.handle]:
        if stub.Free(device_lane_pb2.DeviceHandle(handle=h)).handle != h:
            raise AssertionError(f"Free of {h} refused")
    if stub.Free(device_lane_pb2.DeviceHandle(handle=cp.handle)).handle:
        raise AssertionError("a second Free of one handle answered it")
    end = stub.Stats(device_lane_pb2.DeviceStatsRequest(fence=True))
    if end.handles != 2 or end.resident_bytes != len(LANE_BLOB) + \
            PUMP_BYTES:
        raise AssertionError(f"Stats after Free: {end}")
    row = {
        "put_gb_per_s": puts * PUT_BYTES / put_s / 1e9,
        "pump_gb_per_s": pumped / pump_s / 1e9,
        "pump_checksum": want,
        "pump_ms_per_1024_rounds": pump_s / pumps * 1e3,
        "op_rate_copies_per_s": op_calls * OP_RATE_K / op_s,
        "moved_bytes": stats.moved_bytes,
    }
    # what the server's counts must show (the stream adds its records):
    # one Copy that keeps its output, every pump round's two copies, the
    # transient copies
    expect = {"kept_copies": 1,
              "hbm_copy": 1 + 2 * (1 + pumps * PUMP_ROUNDS),
              "transient_ops": 1 + op_calls * OP_RATE_K}
    if stats.moved_bytes != moved:
        raise AssertionError(f"Stats moved {stats.moved_bytes} B, the "
                             f"calls reported {moved}")
    return row, expect, src


def stream(endpoint, src, cpu=False):
    """Device-stream records naming the resident block ``src`` (its
    bytes are pattern(PUMP_BYTES, 9)); the window holds four blocks."""
    n_recs = lane_counts(cpu)[4]
    opts = rpc.ChannelOptions(protocol="trpc_std", timeout_ms=TIMEOUT_MS)
    sid = device_stream.open_device_stream(
        endpoint, window_bytes=4 * PUMP_BYTES, channel_options=opts)
    st = get_stream(sid)
    t0 = time.perf_counter()
    for _ in range(n_recs):
        rc = device_stream.send_handle(sid, src, PUMP_BYTES, timeout=120)
        if rc != 0:
            raise AssertionError(f"send_handle rc={rc}")
    target = n_recs * PUMP_BYTES
    deadline = time.monotonic() + 300
    while st._remote_consumed < target and time.monotonic() < deadline:
        time.sleep(0.001)
    wall = time.perf_counter() - t0
    stream_close(sid)
    if st._remote_consumed < target:
        raise AssertionError("stream credits never came home")
    stub = rpc.Stub(channel(endpoint), DSVC)
    c = rpc.Controller()
    stub.Get(device_lane_pb2.DeviceHandle(handle=src), controller=c)
    if c.response_attachment != pattern(PUMP_BYTES, 9):
        raise AssertionError("the streamed block came back different")
    return {"records": n_recs, "block_bytes": PUMP_BYTES,
            "window_bytes": 4 * PUMP_BYTES,
            "gb_per_s_2x_block": 2 * target / wall / 1e9}


def check_served(served, expect, n_recs, cpu):
    """The server's own counts against what the calls imply: every
    transient copy (the calls' and one per stream record) run, in batched
    launches of at most 32 copies; on the card, the copy kernel's
    launches exact (on the CPU the plain versions run and count none)."""
    got = {k: v for k, v in served["launches"].items() if v}
    kept = expect["kept_copies"]
    ops = expect["transient_ops"] + n_recs
    batched = served["dispatch_launches"] - kept
    want = {} if cpu else {"hbm_copy": expect["hbm_copy"],
                           "hbm_copy_batched": batched}
    if got != want or served["dispatch_ops"] != ops + kept or \
            not -(-ops // 32) <= batched <= ops:
        raise AssertionError(f"server launches {served}, expected "
                             f"{expect} and {n_recs} stream records")
    if served["stream_blocks"] != n_recs or served["stream_errors"]:
        raise AssertionError(f"stream consumer: {served}")


def run(cpu):
    """The whole client: server up, sweep, data plane and stream (fewer
    calls on the CPU), server down; returns the rows, the server's report
    and what the calls imply of it (``expect``, checked by
    check_served)."""
    free = shm_free()
    srv = ChildServer(cpu)
    try:
        out = {"shm_free_bytes": free, "endpoint": srv.endpoint}
        out["sweep"] = sweep(srv.endpoint)
        out["data_plane"], expect, src = data_plane(srv.endpoint, cpu)
        out["stream"] = stream(srv.endpoint, src, cpu)
    except BaseException:
        srv.proc.kill()
        raise
    served = srv.close()
    check_served(served, expect, out["stream"]["records"], cpu)
    if served["foreign_modules"] or foreign_modules():
        raise AssertionError(f"the lane loaded {served['foreign_modules']}"
                             f" (server), {foreign_modules()} (client)")
    out["served"] = served
    out["expect"] = expect
    return out


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv[1:])
    if args.serve:
        return serve(args.cpu)
    if not args.cpu:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip(), flush=True)
    out = run(args.cpu)
    for key in ("sweep", "data_plane", "stream", "served"):
        print(json.dumps({key: out[key]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
