"""The LLM serving engine's prefill/decode path, in PyTorch.

- :mod:`brpc_tpu_torch.serving.kv_cache` — paged KV-cache block manager
  over DeviceStore handles (block tables, refcounts, watermark admission,
  ledger audits); ``ShardedKVCache``, one ledger per dp shard of the
  serving mesh over stacked pools, and its ``ShardTable``.
- :mod:`brpc_tpu_torch.serving.model` — the toy transformer: weights by
  handle, flash-attention prefill, one decode step per engine step.
- :mod:`brpc_tpu_torch.serving.mesh_model` — ``MeshTransformer``, the
  same model over a dp x sp x tp mesh: prefill tp-sharded over heads
  (one kernel launch per head slice), decode grouped by owning dp shard
  at one launch and one host sync a step. Loaded on first use.
- :mod:`brpc_tpu_torch.serving.weights` — carries weights to and from
  the JAX model.
- :mod:`brpc_tpu_torch.serving.prefix_cache` — radix tree over token
  prefixes mapping to refcounted KV block chains: admission forks the
  longest cached prefix (no copy), completion commits blocks back
  (insert-or-share), eviction is watermark-aware LRU over refcount-1
  chains; ``ShardedPrefixCache``, one tree per dp shard, prefix-hash
  placed.
- :mod:`brpc_tpu_torch.serving.speculative` — the speculative-decoding
  draft lane: host-side prompt-lookup drafting feeding the model's one
  ``verify_step`` launch per step; greedy acceptance keeps the tokens
  those of plain decode while committing up to k+1 a step.
- :mod:`brpc_tpu_torch.serving.engine` — the iteration-level scheduler
  (continuous batching, the prefix cache on by default, ``spec_k``
  speculative decoding); its ``submit(..., done=...)`` is the entry
  point below the RPC front.
- :mod:`brpc_tpu_torch.serving.migration` — KV block-chain migration
  over the record lane: ``KVMigrator`` (source: quiesce, stream,
  release on the ACK) and ``MigrationReceiver`` (destination: staging
  chain, pool write, adopt). A prefill-role engine hands each chain to a
  decode-role engine; a stopping engine drains its live chains to a
  survivor. Loaded on first use (``KVMigrator`` / ``MigrationReceiver``
  below), so co-located deployments never load it.
- :mod:`brpc_tpu_torch.serving.qos` — multi-tenant QoS: weighted
  fair-share lanes (``TenantScheduler``), the AIMD admission ceiling
  (``QosLimiter``) and the sampler-tick governor that sheds best-effort
  work (``QosGovernor``), under ``EngineConfig(qos=QosConfig(...))``.
- :mod:`brpc_tpu_torch.serving.router` — ``ShardedLlmChannel``, the
  client of a shard-per-server fleet: each Generate goes to its one
  owner partition (``GenerateRouter`` over a ``PartitionChannel``),
  Stats fans out and sums, a two-stage fleet's handoff is followed and
  stitched. Loaded on first use.
- :mod:`brpc_tpu_torch.serving.service` — ``LlmServingService``
  (``Generate`` with per-token streams and ``resume_seq_id``,
  ``MigrateOpen`` / ``MigrateCommit``, ``Stats``) for a
  ``brpc_tpu_torch.rpc.Server``; imported on its own, so the engine's
  users load no RPC code.
"""

from brpc_tpu_torch.serving.kv_cache import (KVCacheConfig, KVCacheFull,
                                             PagedKVCache, ShardedKVCache,
                                             ShardTable)
from brpc_tpu_torch.serving.model import ModelConfig, TinyTransformer
from brpc_tpu_torch.serving.engine import (EngineConfig, GenerateResult,
                                           ServingEngine, active_engines)
from brpc_tpu_torch.serving.prefix_cache import (PrefixCache,
                                                 ShardedPrefixCache,
                                                 build_prefix_cache,
                                                 prefix_route_key)
from brpc_tpu_torch.serving.qos import (QosConfig, QosGovernor, QosLimiter,
                                        TenantScheduler)
from brpc_tpu_torch.serving.speculative import (AdaptiveK,
                                                accept_longest_prefix,
                                                draft_tokens)



def __getattr__(name):
    # the mesh model, the router and the migration plane load on first
    # use: plain single-device and co-located deployments never import
    # them
    if name == "MeshTransformer":
        from brpc_tpu_torch.serving.mesh_model import MeshTransformer
        return MeshTransformer
    if name == "ShardedLlmChannel":
        from brpc_tpu_torch.serving.router import ShardedLlmChannel
        return ShardedLlmChannel
    if name == "KVMigrator":
        from brpc_tpu_torch.serving.migration import KVMigrator
        return KVMigrator
    if name == "MigrationReceiver":
        from brpc_tpu_torch.serving.migration import MigrationReceiver
        return MigrationReceiver
    raise AttributeError(name)


__all__ = [
    "KVCacheConfig", "KVCacheFull", "PagedKVCache", "ShardedKVCache",
    "ShardTable",
    "ModelConfig", "TinyTransformer", "MeshTransformer",
    "EngineConfig", "GenerateResult", "ServingEngine", "active_engines",
    "KVMigrator", "MigrationReceiver", "ShardedLlmChannel",
    "QosConfig", "QosGovernor", "QosLimiter", "TenantScheduler",
    "PrefixCache", "ShardedPrefixCache", "build_prefix_cache",
    "prefix_route_key",
    "AdaptiveK", "accept_longest_prefix", "draft_tokens",
]
