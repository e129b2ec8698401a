"""Where the RPC front's time goes on a card: the serving engine driven
directly (``submit(..., done=)``) and through the port's ``Server`` and
``Channel`` (streamed ``Generate`` calls), in turns, in one process:

    python3 brpc_tpu_torch/bench/rpc_front.py [--rounds 3] [--requests 256]

Every run is a sustained window: ``--requests`` requests (``chip_smoke.py``'s
8 shapes over and over, at the llm_server example's widths) kept at the
engine's ``max_batch`` in flight by a closed loop of that many client
threads, on one engine (built once, warmed up). A round runs, in turns
(every other round in reverse order): engine-direct; RPC with a stream per
request (``TokenDelta`` frames); RPC without streams (the response alone);
RPC with the interpreter's switch interval at 0.5 ms instead of 5 ms; RPC
with the always-on continuous profiler paused; RPC from a client in a
second process (``rpc_front.py --client HOST:PORT`` is that client).

Each run prints one JSON line: tokens/s (first call to the last
completion), TTFT p50 / p99 (the engine's, or the client's call to first
frame), latency p50 / p99 (call to completion), the engine's step time
p50 and its steps over the window, and the engine thread's time in
``_stream_delta`` (serializing and writing the frames) per step and as a
share of the window's step time. After the rounds, one ``summary`` line
per run kind gives each metric's min / median / max across rounds, and
its tokens/s over the same round's engine-direct run. Tokens must equal
the engine-direct run's for every request shape; a mismatch is printed
and the script exits 1 after the summary. The card's name and power
limit come first. ``--cpu`` runs the same logic on the CPU (a dry run of
the script, no card numbers).
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "..", ".."))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from brpc_tpu_torch import errors, flags, rpc  # noqa: E402
from brpc_tpu_torch.examples.llm_server import client  # noqa: E402
from brpc_tpu_torch.proto import serving_pb2  # noqa: E402
from brpc_tpu_torch.serving.service import LlmServingService  # noqa: E402

SHAPES = list(zip(cs.PROMPT_LENS, cs.MAX_NEW))
CONCURRENCY = 8  # the engine's max_batch (chip_smoke.build_engine)
RETRY_S = 0.001
# every call's deadline: a non-streamed Generate answers only when its
# whole request is done, which a loaded host can stretch past a second
CALL_TIMEOUT_MS = 600000
KINDS = ("direct", "rpc", "rpc_no_stream", "rpc_switch_0.5ms",
         "rpc_no_profiler", "rpc_client_process")
METRICS = ("tokens_per_s", "ttft_us_p50", "ttft_us_p99", "latency_us_p50",
           "latency_us_p99", "step_us_p50", "frame_write_us_per_step",
           "frame_write_share")


def closed_loop(n, one):
    """``one(i)`` for i in 0..n-1 from CONCURRENCY threads, each taking
    the next index when its last call returns. ``one`` returns (tokens,
    t_call, t_first, t_done, refusals) on the monotonic clock: a request
    the engine refuses with EOVERCROWDED (its KV pool above the watermark)
    is sent again after RETRY_S, as a client of the server would, and its
    times run from the first attempt. Returns the tokens in index order
    and the window's figures."""
    rows = [None] * n
    nxt = iter(range(n))
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                i = next(nxt, None)
            if i is None:
                return
            rows[i] = one(i)

    threads = [threading.Thread(target=worker) for _ in range(CONCURRENCY)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    missing = [i for i, r in enumerate(rows) if r is None]
    if missing:
        raise AssertionError(f"{len(missing)} requests got no answer")
    wall = max(r[3] for r in rows) - min(r[1] for r in rows)
    ttft = [(r[2] - r[1]) * 1e6 for r in rows]
    lat = [(r[3] - r[1]) * 1e6 for r in rows]
    tokens = sum(len(r[0]) for r in rows)
    return [r[0] for r in rows], {
        "requests": n, "refusals": sum(r[4] for r in rows),
        "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "ttft_us_p50": cs.pct(ttft, 50), "ttft_us_p99": cs.pct(ttft, 99),
        "latency_us_p50": cs.pct(lat, 50), "latency_us_p99": cs.pct(lat, 99)}


def direct_one(engine):
    def one(i):
        plen, max_new = SHAPES[i % len(SHAPES)]
        ev, box = threading.Event(), []
        t0, refusals = time.monotonic(), 0
        while True:
            code, _ = engine.submit(
                engine.model.synth_prompt(plen), max_new,
                done=lambda res: (box.append(res), ev.set()))
            if code != errors.EOVERCROWDED:
                break
            refusals += 1
            time.sleep(RETRY_S)
        if code != 0:
            raise AssertionError(f"submit({plen}, {max_new}) refused: {code}")
        t_sent = time.monotonic()
        ev.wait()
        res = box[0]
        if res.error_code:
            raise AssertionError(f"request {i} failed: {res}")
        return (res.tokens, t0, t_sent + res.ttft_us / 1e6,
                time.monotonic(), refusals)
    return one


def channel(target):
    """The bench's Channel: CALL_TIMEOUT_MS for every call it carries."""
    return rpc.Channel(rpc.ChannelOptions(
        timeout_ms=CALL_TIMEOUT_MS)).init(target)


def rpc_one(stub, stream=True):
    def one(i):
        plen, max_new = SHAPES[i % len(SHAPES)]
        req = serving_pb2.GenerateRequest(prompt_len=plen,
                                          max_new_tokens=max_new)
        t0, refusals = time.monotonic(), 0
        while not stream:
            try:
                toks = list(stub.Generate(req).tokens)
            except rpc.RpcError as e:
                if e.error_code != errors.EOVERCROWDED:
                    raise
                refusals += 1
                time.sleep(RETRY_S)
                continue
            t1 = time.monotonic()
            return toks, t0, t1, t1, refusals
        while True:
            g = client.generate(stub, req, timeout_ms=CALL_TIMEOUT_MS)
            if g.error_code != errors.EOVERCROWDED:
                break
            refusals += 1
            time.sleep(RETRY_S)
        if g.response is None:
            raise AssertionError(f"Generate {i} failed: {g.error_code} "
                                 f"{g.error_text}")
        toks = list(g.response.tokens)
        if g.frame_tokens != toks or g.frames != max_new:
            raise AssertionError(f"request {i}: {g.frames} frames "
                                 f"{g.frame_tokens} do not join to {toks}")
        return toks, t0, g.t_first, g.t_done, refusals
    return one


class FrameTimer:
    """Times the engine thread's ``_stream_delta`` calls (one TokenDelta
    serialized and written per call), through an instance attribute that
    wraps the engine's own method."""

    def __init__(self, engine):
        self.us = 0.0
        inner = engine._stream_delta

        def timed(seq, toks, done):
            t0 = time.perf_counter_ns()
            inner(seq, toks, done)
            if seq.stream_id:
                self.us += (time.perf_counter_ns() - t0) / 1000.0
        engine._stream_delta = timed


def engine_window(engine, frames, run):
    """``run()``'s row with the engine's step figures over its window."""
    n0, us0 = len(engine.step_samples), frames.us
    toks, row = run()
    steps = engine.step_samples[n0:]
    written = frames.us - us0
    row.update(step_us_p50=cs.pct(steps, 50), steps=len(steps),
               frame_write_us_per_step=written / len(steps),
               frame_write_share=written / sum(steps))
    return toks, row


def client_process(target, n):
    """``--client HOST:PORT``: one streamed window from this process, its
    JSON row and tokens on stdout."""
    stub = rpc.Stub(channel(target), client.DESC)
    client.generate(stub, serving_pb2.GenerateRequest(
        prompt_len=16, max_new_tokens=2))  # connect and warm up
    toks, row = closed_loop(n, rpc_one(stub))
    print(json.dumps({"row": row, "tokens": toks}), flush=True)
    return 0


def in_second_process(server, n):
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--client",
         str(server.listen_endpoint()), "--requests", str(n)],
        capture_output=True, text=True, timeout=900,
        check=True).stdout.strip().splitlines()[-1]
    res = json.loads(out)
    return res["tokens"], res["row"]


def run_kind(kind, engine, server, stub, frames, n):
    switch = sys.getswitchinterval()
    hz = flags.get("tpu_prof_continuous_hz")
    if kind == "rpc_switch_0.5ms":
        sys.setswitchinterval(0.0005)
    if kind == "rpc_no_profiler":
        flags.set_flag("tpu_prof_continuous_hz", "0")
        time.sleep(0.3)  # the sampler notices within 0.25 s
    try:
        if kind == "direct":
            run = lambda: closed_loop(n, direct_one(engine))  # noqa: E731
        elif kind == "rpc_client_process":
            run = lambda: in_second_process(server, n)  # noqa: E731
        else:
            run = lambda: closed_loop(  # noqa: E731
                n, rpc_one(stub, stream=kind != "rpc_no_stream"))
        return engine_window(engine, frames, run)
    finally:
        sys.setswitchinterval(switch)
        flags.set_flag("tpu_prof_continuous_hz", str(hz))


def spread(xs):
    return [min(xs), float(np.median(xs)), max(xs)]


def summarize(rows):
    """Each kind's metrics as [min, median, max] across rounds, and its
    tokens/s over the same round's engine-direct run."""
    out = []
    for kind in KINDS:
        mine = [r for r in rows if r["run"] == kind]
        line = {"summary": kind, "runs": len(mine)}
        for m in METRICS:
            line[m] = spread([r[m] for r in mine])
        line["over_direct"] = spread([
            r["tokens_per_s"] / next(d["tokens_per_s"] for d in rows
                                     if d["run"] == "direct"
                                     and d["round"] == r["round"])
            for r in mine])
        out.append(line)
    return out


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--client", default="")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv[1:])
    if args.client:
        return client_process(args.client, args.requests)
    if args.cpu:
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            print("rpc_front: no CUDA device", file=sys.stderr)
            return 2
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip(), flush=True)
        cs._build.build_all()
        dev = torch.device("cuda", 0)
    engine = cs.build_engine(dev, "auto")
    frames = FrameTimer(engine)
    server = rpc.Server().add_service(LlmServingService(engine)) \
        .start("127.0.0.1:0")
    stub = rpc.Stub(channel(str(server.listen_endpoint())),
                    client.DESC)
    rows, want, bad = [], {}, 0
    try:
        cs.serve(engine, [(16, 2)])
        for r in range(args.rounds):
            order = KINDS if r % 2 == 0 else KINDS[::-1]
            for kind in order:
                toks, row = run_kind(kind, engine, server, stub, frames,
                                     args.requests)
                for i, t in enumerate(toks):
                    shape = SHAPES[i % len(SHAPES)]
                    if want.setdefault(shape, t) != t:
                        bad += 1
                        print(json.dumps({"mismatch": kind, "round": r,
                                          "request": i, "tokens": t,
                                          "want": want[shape]}), flush=True)
                row = {"round": r, "run": kind, **row}
                rows.append(row)
                print(json.dumps(row), flush=True)
    finally:
        server.stop()
        server.join(timeout=5)
        engine.stop()
    for line in summarize(rows):
        print(json.dumps(line), flush=True)
    print(json.dumps({"token_mismatches": bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
