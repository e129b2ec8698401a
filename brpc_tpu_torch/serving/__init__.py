"""The LLM serving engine's prefill/decode path, in PyTorch.

- :mod:`brpc_tpu_torch.serving.kv_cache` — paged KV-cache block manager
  over DeviceStore handles (block tables, refcounts, watermark admission,
  ledger audits).
- :mod:`brpc_tpu_torch.serving.model` — the toy transformer: weights by
  handle, flash-attention prefill, one decode step per engine step.
- :mod:`brpc_tpu_torch.serving.weights` — carries weights to and from
  the JAX model.
- :mod:`brpc_tpu_torch.serving.engine` — the iteration-level scheduler
  (continuous batching); its ``submit(..., done=...)`` is the entry point
  below the RPC front.
- :mod:`brpc_tpu_torch.serving.service` — ``LlmServingService``
  (``Generate`` with per-token streams, ``Stats``) for a
  ``brpc_tpu_torch.rpc.Server``; imported on its own, so the engine's
  users load no RPC code.
"""

from brpc_tpu_torch.serving.kv_cache import (KVCacheConfig, KVCacheFull,
                                             PagedKVCache)
from brpc_tpu_torch.serving.model import ModelConfig, TinyTransformer
from brpc_tpu_torch.serving.engine import (EngineConfig, GenerateResult,
                                           ServingEngine)

__all__ = [
    "KVCacheConfig", "KVCacheFull", "PagedKVCache",
    "ModelConfig", "TinyTransformer",
    "EngineConfig", "GenerateResult", "ServingEngine",
]
