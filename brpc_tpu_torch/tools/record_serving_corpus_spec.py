#!/usr/bin/env python
"""record_serving_corpus_spec — regenerate tests/data/serving_corpus_spec/.

The speculative-decoding twin of record_serving_corpus: same recording
harness (rpc_dump at ratio 1.0 around LlmService.Generate), but the
engine runs the draft+verify lane (``EngineConfig(spec_k=4)``) and the
traffic is repetition-heavy — templated/code-shaped prompts sent as
explicit ``prompt_tokens`` (``synth_prompt``'s ``(i*31+7) % vocab`` walk
never repeats an n-gram, so prompt-lookup would draft nothing from it)
plus longer generations, whose greedy decode settles into repeating
runs the matcher feeds on. That makes this corpus the tier-1 gate for
the speculative lane's whole economics: replay exercises drafting,
fused verify, acceptance, and KV rollback on every request, and
trace_diff holds the phase timelines to the recorded shape.

Greedy acceptance keeps the recorded token streams bit-identical to
what a non-speculative engine produces from the same prompts — the
oracle test in tests/test_serving_spec.py asserts exactly that over
this same schedule.

    python -m brpc_tpu_torch.tools.record_serving_corpus_spec \\
        [--out tests/data/serving_corpus_spec] [--torch-device cpu]
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

SPEC_K = 4

# templated-text motifs: short token phrases repeated the way generated
# code repeats identifiers and keywords — trailing n-grams recur early,
# so prompt-lookup hits from the first decode steps
_MOTIFS = [
    [7, 12, 19, 3, 12, 19],
    [41, 41, 9, 77, 41, 41, 9],
    [120, 5, 64, 5, 120, 5, 64],
]


def spec_prompt(plen: int, motif: int):
    """Deterministic repetition-heavy prompt: ``plen`` tokens tiled from
    a fixed motif (function of the schedule entry alone, so replays and
    oracle runs regenerate it exactly)."""
    m = _MOTIFS[motif % len(_MOTIFS)]
    reps = plen // len(m) + 1
    return (m * reps)[:plen]


# (prompt_len, max_new_tokens, motif): longer max_new than the base
# corpus — the speculative win compounds over decode steps
SCHEDULE = [(18, 24, 0), (24, 32, 1), (16, 24, 2), (18, 24, 0),
            (24, 32, 1), (16, 24, 2), (18, 48, 0), (24, 48, 2)]
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
    return ServingEngine(model, kv,
                         EngineConfig(max_batch=8, token_budget=512,
                                      spec_k=SPEC_K)).start()


def warm_engine(engine):
    """Compile every bucket the schedule touches, off the RPC surface."""
    import numpy as np

    for _ in range(2):  # donated pools give each program a 2nd signature
        evs = []
        for plen, max_new, motif in SCHEDULE:
            ev = threading.Event()
            code, _ = engine.submit(
                np.asarray(spec_prompt(plen, motif), dtype=np.int32),
                max_new, done=lambda _r, ev=ev: ev.set())
            if code != 0:
                raise RuntimeError(f"warmup rejected: {code}")
            evs.append(ev)
        for ev in evs:
            if not ev.wait(180):
                raise RuntimeError("warmup timed out")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "data",
                                                  "serving_corpus_spec"))
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
        for plen, max_new, motif in SCHEDULE:
            resp = stub.Generate(serving_pb2.GenerateRequest(
                prompt_tokens=spec_prompt(plen, motif),
                max_new_tokens=max_new))
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
    stats = engine.spec_stats.snapshot() if engine.spec_stats else {}
    files = sorted(f for f in os.listdir(args.out) if f.endswith(".dump"))
    total = sum(os.path.getsize(os.path.join(args.out, f)) for f in files)
    print(f"recorded {n} Generate requests -> {args.out} "
          f"({', '.join(files)}; {total} bytes); "
          f"accept_rate={stats.get('accept_rate', 0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
