#!/usr/bin/env python
"""record_serving_corpus — regenerate tests/data/serving_corpus/.

Stands up the serving plane (small continuous-batching engine,
brpc_tpu_torch/serving/) with rpc_dump sampling at ratio 1.0, drives a
deterministic mix of LlmService.Generate requests, and writes the dump
files that the serving tests replay as a gate: ``rpc_replay`` re-sends
the recorded bodies against a fresh server, ``trace.diff`` aligns the
recorded phase timelines (prefill_us/decode_us) against the replayed
ones by trace id.

The traffic is replayable bit-for-bit: prompts are synthesized from
``prompt_len`` alone (model.synth_prompt) and decode is greedy argmax,
so a replay against the same ModelConfig regenerates the exact token
streams. Warmup happens through direct engine.submit calls — they never
cross the RPC surface, so the corpus holds only the recorded schedule.

    python -m brpc_tpu_torch.tools.record_serving_corpus \\
        [--out tests/data/serving_corpus] [--torch-device cpu]
"""

import argparse
import os
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# the schedule: (prompt_len, max_new_tokens) with ~20ms inter-arrival
# gaps — mixed lengths so the replayed engine steps mixed batches
SCHEDULE = [(16, 4), (32, 8), (16, 6), (16, 4), (32, 8), (16, 6),
            (16, 4), (32, 8), (16, 6), (16, 4), (32, 8), (16, 6)]
GAP_S = 0.02


def build_engine(device=None):
    """The corpus engine, started, on ``device`` (``cuda`` unless
    ``"cpu"``)."""
    from brpc_tpu_torch.serving import (EngineConfig, KVCacheConfig,
                                        ModelConfig, PagedKVCache,
                                        ServingEngine, TinyTransformer)

    cfg = ModelConfig(vocab=256, d_model=32, n_heads=2, n_layers=2)
    kv = PagedKVCache(KVCacheConfig(block_size=16, num_blocks=256),
                      cfg.n_layers, cfg.kv_dim, device=device)
    model = TinyTransformer(cfg, kv)
    return ServingEngine(model, kv, EngineConfig(max_batch=8,
                                                 token_budget=512)).start()


def warm_engine(engine):
    """Compile every bucket the schedule touches, off the RPC surface."""
    for _ in range(2):  # donated pools give each program a 2nd signature
        evs = []
        for plen, max_new in SCHEDULE:
            ev = threading.Event()
            code, _ = engine.submit(engine.model.synth_prompt(plen),
                                    max_new,
                                    done=lambda _r, ev=ev: ev.set())
            if code != 0:
                raise RuntimeError(f"warmup rejected: {code}")
            evs.append(ev)
        for ev in evs:
            if not ev.wait(180):
                raise RuntimeError("warmup timed out")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "data",
                                                  "serving_corpus"))
    ap.add_argument("--torch-device", default="cuda",
                    help="the engine's device: cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from brpc_tpu_torch import flags as _flags
    from brpc_tpu_torch.metrics.collector import global_collector
    from brpc_tpu_torch.proto import serving_pb2
    from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Server,
                              ServerOptions, Stub)

    _flags.set_flag("rpcz_sample_ratio", "1.0")
    _flags.set_flag("rpc_dump_ratio", "1.0")
    _flags.set_flag("collector_max_samples_per_second", "0")
    global_collector()._deny_until = 0.0

    engine = build_engine(device=args.torch_device)
    warm_engine(engine)
    from brpc_tpu_torch.serving.service import LlmServingService

    os.makedirs(args.out, exist_ok=True)
    for f in os.listdir(args.out):
        if f.endswith(".dump"):
            os.remove(os.path.join(args.out, f))
    server = Server(ServerOptions(rpc_dump_dir=args.out)) \
        .add_service(LlmServingService(engine)).start("127.0.0.1:0")
    try:
        ch = Channel(ChannelOptions(protocol="trpc_std", timeout_ms=30000))
        ch.init(str(server.listen_endpoint()))
        stub = Stub(ch, serving_pb2.DESCRIPTOR.services_by_name["LlmService"])
        for plen, max_new in SCHEDULE:
            resp = stub.Generate(serving_pb2.GenerateRequest(
                prompt_len=plen, max_new_tokens=max_new))
            assert len(resp.tokens) == max_new, resp
            time.sleep(GAP_S)
        deadline = time.monotonic() + 5.0
        while (server.rpc_dumper.sampled_count < len(SCHEDULE)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        n = server.rpc_dumper.sampled_count
        server.rpc_dumper.close()
        if n < len(SCHEDULE):
            print(f"only {n}/{len(SCHEDULE)} requests sampled",
                  file=sys.stderr)
            return 1
    finally:
        server.stop()
        server.join(timeout=2)
        engine.stop()
        _flags.set_flag("rpc_dump_ratio", "0.0")
        _flags.set_flag("collector_max_samples_per_second", "1000")
    files = sorted(f for f in os.listdir(args.out) if f.endswith(".dump"))
    total = sum(os.path.getsize(os.path.join(args.out, f)) for f in files)
    print(f"recorded {n} Generate requests -> {args.out} "
          f"({', '.join(files)}; {total} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
