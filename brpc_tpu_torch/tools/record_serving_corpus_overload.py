#!/usr/bin/env python
"""record_serving_corpus_overload — regenerate
tests/data/serving_corpus_overload/.

A diurnal-overload companion to record_serving_corpus.py: TWO QoS
tenants share one serving plane —

- ``prod``  (priority 1, the protected lane): steady arrivals across the
  whole window, the traffic that must survive.
- ``batch`` (priority 0, best-effort): quiet at first, then a burst
  phase whose recorded inter-arrival gaps are dense enough that
  replaying with ``rpc_replay --rate-mult N`` (N >= 2) pushes a
  saturable engine past capacity mid-window.

Each request is stamped with ``cntl.tenant_id`` / ``cntl.priority`` so
the v2 dump records carry the QoS identity and rpc_replay re-stamps it:
a replayed overload wave sheds the same tenants the live one would.

Recording itself runs WITHOUT QoS and inside engine capacity (the
schedule is fired open-loop at recorded offsets, asynchronously) so
every record commits clean with a full phase timeline; the overload is
manufactured at replay time by rate-multiplying the recorded gaps.

    python -m brpc_tpu_torch.tools.record_serving_corpus_overload \\
        [--out tests/data/serving_corpus_overload] [--torch-device cpu]
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

PROD, BATCH = "prod", "batch"

# the schedule: (offset_s, tenant, priority, prompt_len, max_new_tokens).
# prod ticks every 50ms for the whole ~1s window; batch idles through the
# first 350ms then bursts 16 requests at 10ms gaps — the diurnal spike.
SCHEDULE = sorted(
    [(i * 0.05, PROD, 1, 16, 4) for i in range(20)]
    + [(i * 0.05, BATCH, 0, 16, 4) for i in range(4)]
    + [(0.40 + i * 0.01, BATCH, 0, 32, 8) for i in range(16)],
    key=lambda r: r[0])


def build_engine(qos=None, device=None):
    """The corpus engine, started, on ``device`` (``cuda`` unless
    ``"cpu"``); tests pass ``qos=QosConfig(...)`` to stand up the same
    plane with fair-share admission armed."""
    from brpc_tpu_torch.serving import (EngineConfig, KVCacheConfig,
                                        ModelConfig, PagedKVCache,
                                        ServingEngine, TinyTransformer)

    cfg = ModelConfig(vocab=256, d_model=32, n_heads=2, n_layers=2)
    kv = PagedKVCache(KVCacheConfig(block_size=16, num_blocks=256),
                      cfg.n_layers, cfg.kv_dim, device=device)
    model = TinyTransformer(cfg, kv)
    return ServingEngine(model, kv, EngineConfig(max_batch=8,
                                                 token_budget=512,
                                                 qos=qos)).start()


def warm_engine(engine):
    """Compile every bucket the schedule touches, off the RPC surface."""
    buckets = sorted({(plen, max_new) for _, _, _, plen, max_new
                      in SCHEDULE})
    for _ in range(2):  # donated pools give each program a 2nd signature
        evs = []
        for plen, max_new in buckets:
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
    ap.add_argument("--out", default=os.path.join(
        REPO, "tests", "data", "serving_corpus_overload"))
    ap.add_argument("--torch-device", default="cuda",
                    help="the engine's device: cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from brpc_tpu_torch import flags as _flags
    from brpc_tpu_torch.metrics.collector import global_collector
    from brpc_tpu_torch.proto import serving_pb2
    from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Controller, Server,
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
        # open-loop dispatch at recorded offsets: arrival gaps land in the
        # dump regardless of service time, so --rate-mult replays compress
        # the burst faithfully
        evs = []
        failures = []
        base = time.monotonic()
        for offset, tenant, priority, plen, max_new in SCHEDULE:
            fire_at = base + offset
            now = time.monotonic()
            if fire_at > now:
                time.sleep(fire_at - now)
            cntl = Controller()
            cntl.tenant_id = tenant
            cntl.priority = priority
            ev = threading.Event()

            def on_done(c, ev=ev, want=max_new):
                if c.failed() or len(c.response.tokens) != want:
                    failures.append(c.error_text() if c.failed()
                                    else "short generation")
                ev.set()

            stub.Generate(serving_pb2.GenerateRequest(
                prompt_len=plen, max_new_tokens=max_new),
                controller=cntl, done=on_done)
            evs.append(ev)
        for ev in evs:
            if not ev.wait(180):
                failures.append("request timed out")
                break
        if failures:
            print(f"recording failed: {failures[0]}", file=sys.stderr)
            return 1
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
    n_prod = sum(1 for r in SCHEDULE if r[1] == PROD)
    print(f"recorded {n} Generate requests ({n_prod} {PROD}, "
          f"{n - n_prod} {BATCH}) -> {args.out} "
          f"({', '.join(files)}; {total} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
