"""LLM serving example on the port: the serving plane's flagship server.

The port's continuous-batching engine (paged KV over DeviceStore,
iteration-level scheduling, the flash prefill kernel on the card) behind
LlmService, with token streaming over the Stream API. The flags and their
defaults are the JAX package's ``examples/llm_server/server.py``'s.
Browse http://<host>:<port>/serving while the client runs to watch batch
occupancy and the KV watermark; the same port answers Generate over JSON:

    python -m brpc_tpu_torch.examples.llm_server.server [--port 8011] \\
        [--scheduling continuous] [--device cpu]
    curl localhost:8011/LlmService/Generate \\
        -d '{"prompt_len": 16, "max_new_tokens": 8}'
    curl localhost:8011/serving

The engine runs on ``cuda`` unless ``--device cpu`` is given, and raises
with no card.
"""

import argparse
import sys
import time

from brpc_tpu_torch.rpc import Server
from brpc_tpu_torch.serving import (EngineConfig, KVCacheConfig,
                                    ModelConfig, PagedKVCache,
                                    ServingEngine, TinyTransformer)
from brpc_tpu_torch.serving.service import LlmServingService


def build_engine(args, device=None) -> ServingEngine:
    """The example's engine, started, on ``device`` (``cuda`` unless
    ``"cpu"``)."""
    model_cfg = ModelConfig(vocab=args.vocab, d_model=args.d_model,
                            n_heads=args.n_heads, n_layers=args.n_layers)
    kv = PagedKVCache(
        KVCacheConfig(block_size=args.block_size,
                      num_blocks=args.num_blocks,
                      watermark=args.watermark),
        model_cfg.n_layers, model_cfg.kv_dim, device=device)
    model = TinyTransformer(model_cfg, kv)
    engine = ServingEngine(model, kv, EngineConfig(
        max_batch=args.max_batch, token_budget=args.token_budget,
        scheduling=args.scheduling))
    return engine.start()


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8011)
    ap.add_argument("--scheduling", choices=("continuous", "static"),
                    default="continuous")
    ap.add_argument("--max_batch", type=int, default=8)
    ap.add_argument("--token_budget", type=int, default=512)
    ap.add_argument("--block_size", type=int, default=16)
    ap.add_argument("--num_blocks", type=int, default=256)
    ap.add_argument("--watermark", type=float, default=0.90)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--d_model", type=int, default=64)
    ap.add_argument("--n_heads", type=int, default=4)
    ap.add_argument("--n_layers", type=int, default=2)
    ap.add_argument("--run_seconds", type=float, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    engine = build_engine(args, device=args.device)
    server = Server().add_service(LlmServingService(engine))
    server.start(f"0.0.0.0:{args.port}")
    print(f"LlmServer on {server.listen_endpoint()} "
          f"({args.scheduling} batching, "
          f"{args.num_blocks}x{args.block_size}-token KV blocks, "
          f"{engine.kv.store.device}) — see /serving", flush=True)
    try:
        time.sleep(args.run_seconds or 1e9)
    except KeyboardInterrupt:
        pass
    server.stop()
    server.join()
    engine.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
