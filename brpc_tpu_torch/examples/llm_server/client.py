"""Streaming LLM client on the port: opens a stream per request, prints
tokens as TokenDelta frames arrive, and reports TTFT against the whole
generation's latency. The flags are the JAX package's
``examples/llm_server/client.py``'s.

    python -m brpc_tpu_torch.examples.llm_server.client \\
        [--server 127.0.0.1:8011] [--prompt_len 32] [--max_new_tokens 24] \\
        [-n 4]
"""

import argparse
import sys
import threading
import time

from brpc_tpu_torch.proto import serving_pb2
from brpc_tpu_torch.rpc import Channel, Controller, RpcError, Stub
from brpc_tpu_torch.rpc.stream import (StreamOptions, stream_close,
                                       stream_create)

DESC = serving_pb2.DESCRIPTOR.services_by_name["LlmService"]


class Generation:
    """One streamed Generate as the client saw it: the response (None if
    the RPC failed, then ``error_code``), the tokens of its TokenDelta
    frames in arrival order, and monotonic times of the call, the first
    frame and the response."""

    def __init__(self):
        self.response = None
        self.error_code = 0
        self.error_text = ""
        self.frame_tokens = []
        self.frames = 0
        self.t_call = self.t_first = self.t_done = 0.0
        self.last_frame = threading.Event()


def generate(stub, request, timeout_ms=60000, on_delta=None) -> Generation:
    """One Generate with a stream: TokenDelta frames stream back while the
    RPC is in flight; returns once the response and the last frame are
    in (or the RPC failed)."""
    g = Generation()

    def on_received(sid, msgs):
        for raw in msgs:
            delta = serving_pb2.TokenDelta.FromString(raw)
            if not g.frames:
                g.t_first = time.monotonic()
            g.frames += 1
            g.frame_tokens.extend(delta.tokens)
            if on_delta is not None:
                on_delta(delta)
            if delta.done:
                g.last_frame.set()

    sid = stream_create(StreamOptions(on_received=on_received))
    cntl = Controller()
    cntl.stream_id = sid
    cntl.timeout_ms = timeout_ms
    g.t_call = time.monotonic()
    try:
        g.response = stub.Generate(request, controller=cntl)
        g.t_done = time.monotonic()
        g.last_frame.wait(timeout_ms / 1000.0)
    except RpcError as e:
        g.t_done = time.monotonic()
        g.error_code, g.error_text = e.error_code, cntl.error_text()
    stream_close(sid)
    return g


def _run_one(stub, prompt_len: int, max_new: int, label: str) -> int:
    def show(delta):
        print(f"  [{label}] += {list(delta.tokens)}", flush=True)

    g = generate(stub, serving_pb2.GenerateRequest(
        prompt_len=prompt_len, max_new_tokens=max_new), on_delta=show)
    if g.response is None:
        print(f"  [{label}] FAILED: [E{g.error_code}] {g.error_text}")
        return 1
    ttft_ms = (g.t_first - g.t_call) * 1e3 if g.t_first else float("nan")
    print(f"  [{label}] {len(g.response.tokens)} tokens, "
          f"ttft {ttft_ms:.1f}ms < total {(g.t_done - g.t_call) * 1e3:.1f}"
          f"ms, finish={g.response.finish_reason}", flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--server", default="127.0.0.1:8011")
    ap.add_argument("--prompt_len", type=int, default=32)
    ap.add_argument("--max_new_tokens", type=int, default=24)
    ap.add_argument("-n", type=int, default=4,
                    help="concurrent generations")
    args = ap.parse_args(argv)

    stub = Stub(Channel().init(args.server), DESC)
    # warmup: builds the server's kernels so the timed runs below measure
    # serving, not compilation
    _run_one(stub, args.prompt_len, 2, "warmup")

    threads = []
    rc = [0] * args.n
    for i in range(args.n):
        def run(i=i):
            rc[i] = _run_one(stub, args.prompt_len + i,
                             args.max_new_tokens, f"req{i}")
        t = threading.Thread(target=run)
        t.start()
        threads.append(t)
    for t in threads:
        t.join()
    return 1 if any(rc) else 0


if __name__ == "__main__":
    sys.exit(main())
