"""Adaptive batching against per-request dispatch: the port's counterpart
of ``bench.py``'s ``bench_batch_lane``, over ``BatchBenchService`` of
the port's ``tools/bench_server.py``.

    python3 brpc_tpu_torch/bench/batch_lane.py [--cpu]
    python3 brpc_tpu_torch/bench/batch_lane.py --serve [--cpu]

``--serve`` is the server: a fresh interpreter that owns the card and
serves ``BatchBench`` on ``127.0.0.1:0``, prints ``LISTEN <endpoint>``
and serves until its standard input closes; it then prints ``SERVED
<json>``: its device, and its forward calls and the items they carried
by method.

``BatchBench`` serves one model two ways. The model is the reference's:
a 32-layer MLP 256 wide, ``h = relu(h @ W[l] + b[l])``, float32, W and b
drawn from a ``torch.Generator`` seeded 0 (W scaled by 1/sqrt(256), b by
0.01), on ``cuda`` unless ``--cpu``. ``Infer`` makes one forward call
per RPC (B = 1); ``InferBatched`` (``batch.make_batched``, buckets
1 / 8 / 32, ``flush_on_poll_batch=False``) coalesces concurrent RPCs
into one padded forward call per flush. Requests reuse EchoRequest:
``payload`` carries 256 float32 features; a response's ``payload`` is
the output row and its message the row's sum.

Without ``--serve`` the script is the client: it starts that server
(``subprocess``, never a fork of a process with CUDA up), warms both
methods, then drives each from a pipelined async client (a call's
``done`` issues the next; 16 in flight per-request, 32 batched) and
prints one JSON line, ``{"batch_lane": ...}``: QPS and p50 / p99 latency
of each, their ratio (batched over per-request), the largest relative
difference (by row norm) between a batched and a per-request answer to
the same request, ``g_batch_size`` and ``g_batch_queue_delay_us`` as the
server's ``/vars`` page renders them (fetched over HTTP from the same
port, as ``bench.py``'s batch lane reads them) with their averages, and
the server's ``SERVED`` numbers. ``--cpu`` is a
dry run on the CPU, with a quarter of the calls.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "..", ".."))
sys.path.insert(0, ROOT)

from brpc_tpu_torch.proto import echo_pb2  # noqa: E402
from brpc_tpu_torch.rpc import (Channel, ChannelOptions,  # noqa: E402
                                MethodDescriptor, Server)

from brpc_tpu_torch.tools import bench_server  # noqa: E402

DIM = bench_server.DIM
# (in flight, calls): the reference's warm-ups and timed runs
WARM = {"Infer": (4, 30), "InferBatched": (8, 60)}
TIMED = {"Infer": (16, 600), "InferBatched": (32, 4000)}


class BatchBenchService(bench_server.BatchBenchService):
    """``bench_server``'s BatchBench, each response also carrying its
    output row, with forward calls and the items they carried counted by
    method."""

    def __init__(self, device):
        self._lock = threading.Lock()
        self.calls = {"Infer": [0, 0], "InferBatched": [0, 0]}
        super().__init__(device)

    def _note(self, method, items):
        with self._lock:
            self.calls[method][0] += 1
            self.calls[method][1] += items

    def _response(self, y):
        return echo_pb2.EchoResponse(message=f"{float(y.sum()):.4f}",
                                     payload=y.tobytes())

    def Infer(self, cntl, request, done):
        resp = super().Infer(cntl, request, done)
        self._note("Infer", 1)
        return resp

    def InferBatched(self, batch):
        out = super().InferBatched(batch)
        self._note("InferBatched", batch.size)
        return out


def serve(cpu: bool) -> int:
    from brpc_tpu_torch.tpu.device_lane import resolve_device

    device = resolve_device("cpu" if cpu else None)
    svc = BatchBenchService(device)
    server = Server().add_service(svc).start("127.0.0.1:0")
    print(f"LISTEN {server.listen_endpoint()}", flush=True)
    sys.stdin.read()  # the parent holds the pipe
    server.stop()
    server.join()
    print("SERVED " + json.dumps({
        "device": str(device),
        "calls": {m: {"forward_calls": c, "items": n}
                  for m, (c, n) in svc.calls.items()}}), flush=True)
    return 0


BATCH_VARS = ("g_batch_size", "g_batch_queue_delay_us")


def read_vars(endpoint: str) -> dict:
    """The batching counters from the server's ``/vars/<name>`` pages
    over HTTP: each page's line (``name : avg (count=n)``) and its
    average."""
    from brpc_tpu_torch.policy.http_protocol import http_fetch

    out = {}
    for name in BATCH_VARS:
        resp = http_fetch(endpoint, "GET", f"/vars/{name}", timeout=10)
        if resp.status != 200:
            raise RuntimeError(f"/vars/{name}: HTTP {resp.status}")
        line = resp.body.decode().splitlines()[0]
        out[name] = line
        out[f"{name}_avg"] = float(line.split(" : ", 1)[1].split()[0])
    return out


def pipelined(ch, method, req, depth, total, timeout=300.0):
    """``total`` calls of ``method`` with ``depth`` in flight (each done
    issues the next). Returns (QPS, sorted latencies in s, the last
    response)."""
    md = MethodDescriptor("BatchBench", method, echo_pb2.EchoRequest,
                          echo_pb2.EchoResponse)
    done_ev = threading.Event()
    lock = threading.Lock()
    state = {"issued": 0, "completed": 0, "errors": [], "resp": None}
    lats = []

    def issue():
        ch.call_method(md, req, done=make_done(time.perf_counter()))

    def make_done(t0):
        def done(cntl):
            again = False
            with lock:
                lats.append(time.perf_counter() - t0)
                if cntl.failed():
                    state["errors"].append((cntl.error_code,
                                            cntl.error_text()))
                else:
                    state["resp"] = cntl._response
                state["completed"] += 1
                if state["issued"] < total:
                    state["issued"] += 1
                    again = True
                elif state["completed"] >= total:
                    done_ev.set()
            if again:
                issue()
        return done

    t_start = time.perf_counter()
    with lock:
        n0 = min(depth, total)
        state["issued"] = n0
    for _ in range(n0):
        issue()
    if not done_ev.wait(timeout):
        raise RuntimeError(f"{method} stalled: {state['completed']}/"
                           f"{total}")
    if state["errors"]:
        raise RuntimeError(f"{len(state['errors'])} {method} calls failed: "
                           f"{state['errors'][:3]}")
    wall = time.perf_counter() - t_start
    lats.sort()
    return len(lats) / wall, lats, state["resp"]


def pct(xs, q):
    return float(xs[min(len(xs) - 1, int(q * len(xs)))])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    if args.serve:
        return serve(args.cpu)

    cmd = [sys.executable, os.path.abspath(__file__), "--serve"]
    if args.cpu:
        cmd.append("--cpu")
    proc = subprocess.Popen(cmd, cwd=ROOT, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True)
    served = None
    try:
        line = proc.stdout.readline()
        if not line.startswith("LISTEN "):
            raise RuntimeError(f"server never came up: {line!r}")
        endpoint = line.split()[1]
        ch = Channel(ChannelOptions(timeout_ms=30000)).init(endpoint)
        rng = np.random.default_rng(7)
        req = echo_pb2.EchoRequest(
            message="b",
            payload=rng.standard_normal(DIM, dtype=np.float32).tobytes())
        for method, (depth, total) in WARM.items():
            pipelined(ch, method, req, depth, total)
        out = {}
        rows = {}
        div = 4 if args.cpu else 1
        for method, (depth, total) in TIMED.items():
            qps, lats, resp = pipelined(ch, method, req, depth,
                                        total // div)
            rows[method] = np.frombuffer(resp.payload, np.float32)
            out[method] = {"in_flight": depth, "calls": total // div,
                           "qps": qps, "p50_ms": pct(lats, 0.5) * 1e3,
                           "p99_ms": pct(lats, 0.99) * 1e3}
        a, b = rows["InferBatched"], rows["Infer"]
        out["batched_over_per_request"] = (out["InferBatched"]["qps"]
                                           / out["Infer"]["qps"])
        out["max_rel_diff"] = float(np.linalg.norm(a - b)
                                    / max(np.linalg.norm(b), 1e-30))
        out["vars"] = read_vars(endpoint)
    finally:
        proc.stdin.close()
        rest = proc.stdout.read()
        proc.wait(timeout=60)
        for line in rest.splitlines():
            if line.startswith("SERVED "):
                served = json.loads(line.split(" ", 1)[1])
    if served is None:
        raise RuntimeError(f"the server printed no SERVED line: {rest!r}")
    out["server"] = served
    print(json.dumps({"batch_lane": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
