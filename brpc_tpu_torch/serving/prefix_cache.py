"""Radix prefix cache: copy-on-write KV reuse over the paged pools.

The port of the single-pool half of ``brpc_tpu/serving/prefix_cache.py``
(RadixAttention, Zheng et al. 2024, over PagedAttention, Kwon et al.
2023): a radix tree over token-id prefixes whose nodes map to committed,
refcounted KV block chains in the :class:`~brpc_tpu_torch.serving.
kv_cache.PagedKVCache` ledger. Each node covers exactly ONE full block
(``block_size`` token ids) and pins one physical block through
``retain_block``; a root-to-node path is a block-aligned prefix chain.

On admission the engine matches the longest block-aligned cached prefix
of the prompt and *forks* the chain (``adopt_sequence``: refcount++, no
device copy), then prefills only the suffix. The match is capped at
``len(prompt) - 1`` tokens, so at least one suffix token runs through
the model (the engine needs a first sampled token). A write into a
shared block goes copy-on-write (``cow_block``), so forked generations
are token for token the cold ones.

On completion the engine *commits* the sequence's full blocks: walking
existing nodes shares them (the committer's duplicate frees with the
sequence), new nodes take a cache hold on the committer's block.

Eviction is LRU over leaves whose block only the tree holds (refcount 1):
a block a live sequence still shares is never evicted. Commits trim the
tree back under ``serving_prefix_evict_watermark`` occupancy, and an
admission that would be refused EOVERCROWDED first asks the tree to give
blocks back (``evict_for_admission``); the watermark itself is unchanged.

Counters: the six ``g_serving_prefix_*`` Adders and the
``g_serving_prefix_hit_ratio`` gauge; fault point ``serving.prefix.evict``
forces eviction churn at every fork.

**Sharded mode** (:class:`ShardedPrefixCache`): one tree per dp shard of
a :class:`~brpc_tpu_torch.serving.kv_cache.ShardedKVCache`, each over its
shard's ledger. Placement is prefix-hash routed: ``prefix_route_key``
folds the first block of token ids, and the shard plane's ``shard_for``
maps it to a shard, so same-prefix traffic lands on the shard that holds
the chain. The client-side half of that routing is
``serving/router.GenerateRouter`` over a ``PartitionChannel``
(``ShardedLlmChannel(..., block_size=)``): the client computes the same
shard for a prompt as this cache does.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from brpc_tpu_torch import fault as _fault
from brpc_tpu_torch import flags as _flags
from brpc_tpu_torch.metrics.reducer import Adder
from brpc_tpu_torch.metrics.status import PassiveStatus
from brpc_tpu_torch.serving.kv_cache import PagedKVCache, ShardedKVCache

_fault.register("serving.prefix.evict",
                "force radix prefix-cache eviction churn (blocks=)")

g_serving_prefix_hit_seqs = Adder("g_serving_prefix_hit_seqs")
g_serving_prefix_hit_blocks = Adder("g_serving_prefix_hit_blocks")
g_serving_prefix_hit_tokens = Adder("g_serving_prefix_hit_tokens")
g_serving_prefix_miss_seqs = Adder("g_serving_prefix_miss_seqs")
g_serving_prefix_inserted_blocks = Adder("g_serving_prefix_inserted_blocks")
g_serving_prefix_evicted_blocks = Adder("g_serving_prefix_evicted_blocks")


def _hit_ratio() -> float:
    hits = g_serving_prefix_hit_seqs.get_value()
    misses = g_serving_prefix_miss_seqs.get_value()
    total = hits + misses
    return hits / total if total else 0.0


g_serving_prefix_hit_ratio = PassiveStatus(_hit_ratio) \
    .expose("g_serving_prefix_hit_ratio")
g_serving_prefix_hit_ratio.prometheus_type = "gauge"


def prefix_route_key(tokens, block_size: int) -> Optional[int]:
    """Fold the first block of token ids into a 64-bit route key (FNV-1a,
    the spread of the reference's ``generate_route_key``), so every
    prompt sharing a cacheable first block hashes alike. None when the
    prompt cannot hit the cache at all (shorter than one full block plus
    the mandatory suffix token)."""
    if len(tokens) < block_size + 1:
        return None
    key = 0xCBF29CE484222325
    for t in tokens[:block_size]:
        key = ((key ^ (int(t) & 0xFFFFFFFF)) * 0x100000001B3) \
            & 0xFFFFFFFFFFFFFFFF
    return key


class _Node:
    """One full block of token ids; pins one physical block in the pool
    ledger while it lives in the tree."""

    __slots__ = ("key", "block", "children", "parent", "stamp")

    def __init__(self, key: Tuple[int, ...], block: int, parent):
        self.key = key
        self.block = block
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.stamp = 0


class PrefixCache:
    """Radix tree over one pool's block-aligned prefixes.

    Lock order: the tree lock is OUTER, the pool's ledger lock inner
    (every ``kv.*`` call below takes it), never the reverse."""

    def __init__(self, kv: PagedKVCache, shard: int = 0):
        self.kv = kv
        self.shard = shard
        self._lock = threading.Lock()
        self._root = _Node((), -1, None)
        self._tick = 0  # monotonic LRU clock (stamps, not wall time)
        self._nodes = 0
        self.hit_seqs = 0
        self.miss_seqs = 0
        self.hit_blocks = 0
        self.hit_tokens = 0
        self.inserted_blocks = 0
        self.evicted_blocks = 0

    @staticmethod
    def enabled() -> bool:
        return bool(_flags.get("serving_prefix_cache_enabled"))

    # ------------------------------------------------------------- matching
    def _key(self, tokens, i: int) -> Tuple[int, ...]:
        bs = self.kv.config.block_size
        return tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])

    def _walk_locked(self, tokens) -> List[_Node]:
        """Longest cached block-aligned chain covering a PROPER prefix of
        ``tokens``: capped at ``len(tokens) - 1`` so the suffix prefill
        always has a token to run."""
        limit = max(0, (len(tokens) - 1) // self.kv.config.block_size)
        chain: List[_Node] = []
        node = self._root
        for i in range(limit):
            node = node.children.get(self._key(tokens, i))
            if node is None:
                break
            chain.append(node)
        return chain

    def match_len(self, tokens) -> int:
        """Cached-prefix length in tokens (block-aligned, < len(tokens))."""
        with self._lock:
            return len(self._walk_locked(tokens)) * self.kv.config.block_size

    def route_shard(self, tokens) -> Optional[int]:
        return None  # single pool: nowhere to route

    # ---------------------------------------------------------------- fork
    def fork(self, seq_id: int, tokens) -> int:
        """Admission-side hit path: match the longest cached prefix, adopt
        its chain for ``seq_id`` (refcount++, zero copies), and return the
        matched token count; 0 on a miss (the caller allocates cold)."""
        self._maybe_fault_evict()
        if not self.enabled():
            return 0
        with self._lock:
            chain = self._walk_locked(tokens)
            if not chain:
                self.miss_seqs += 1
                g_serving_prefix_miss_seqs.put(1)
                return 0
            self._tick += 1
            for n in chain:
                n.stamp = self._tick
            blocks = [n.block for n in chain]
            matched = len(blocks) * self.kv.config.block_size
            self.kv.adopt_sequence(seq_id, blocks, matched)
            self.hit_seqs += 1
            self.hit_blocks += len(blocks)
            self.hit_tokens += matched
        g_serving_prefix_hit_seqs.put(1)
        g_serving_prefix_hit_blocks.put(len(blocks))
        g_serving_prefix_hit_tokens.put(matched)
        return matched

    # -------------------------------------------------------------- commit
    def commit(self, seq_id: int, tokens, valid_len: int) -> int:
        """Completion-side insert-or-share: walk ``seq_id``'s table along
        the tree, sharing existing nodes and pinning new ones. Only FULL
        blocks whose K/V are entirely written (``valid_len``) commit.
        Returns blocks newly inserted."""
        if not self.enabled():
            return 0
        table = self.kv.block_table(seq_id)
        if table is None:
            return 0
        n_full = min(int(valid_len), len(tokens)) // self.kv.config.block_size
        inserted = 0
        with self._lock:
            self._tick += 1
            node = self._root
            for i in range(n_full):
                key = self._key(tokens, i)
                child = node.children.get(key)
                if child is None:
                    self.kv.retain_block(table[i])
                    child = _Node(key, table[i], node)
                    node.children[key] = child
                    self._nodes += 1
                    inserted += 1
                child.stamp = self._tick
                node = child
        if inserted:
            self.inserted_blocks += inserted
            g_serving_prefix_inserted_blocks.put(inserted)
        self._trim()
        return inserted

    # ------------------------------------------------------------ eviction
    def _evictable_leaves_locked(self) -> List[_Node]:
        """Leaves whose block the tree is the SOLE owner of (refcount 1)."""
        out: List[_Node] = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif self.kv.block_ref(n.block) == 1:
                out.append(n)
        return out

    def _evict_locked(self, nblocks: int) -> int:
        """LRU-evict up to ``nblocks`` leaf blocks; freeing a leaf can
        expose its parent, so the candidates are recomputed each time."""
        evicted = 0
        while evicted < nblocks:
            leaves = self._evictable_leaves_locked()
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.stamp)
            del victim.parent.children[victim.key]
            self._nodes -= 1
            self.kv.release_block(victim.block)
            evicted += 1
        if evicted:
            self.evicted_blocks += evicted
            g_serving_prefix_evicted_blocks.put(evicted)
        return evicted

    def _maybe_fault_evict(self) -> None:
        p = _fault.hit("serving.prefix.evict")
        if p is None:
            return
        with self._lock:
            self._evict_locked(int(p.get("blocks", 1)))

    def _trim(self) -> int:
        """Give blocks back until pool occupancy is under
        ``serving_prefix_evict_watermark`` (or nothing evictable is left:
        shared chains stay)."""
        mark = float(_flags.get("serving_prefix_evict_watermark"))
        total = 0
        while self.kv.used_ratio() > mark:
            with self._lock:
                if not self._evict_locked(1):
                    break
            total += 1
        return total

    def evict_for_admission(self, ntokens: int, shard: Optional[int] = None,
                            route_key: Optional[int] = None) -> bool:
        """Give blocks back until the pool would admit ``ntokens``, on the
        EOVERCROWDED path BEFORE refusing. True if admission now passes;
        only tree-held (refcount-1) blocks are released."""
        while not self.kv.can_admit(ntokens):
            with self._lock:
                if not self._evict_locked(1):
                    return False
        return True

    # ------------------------------------------------------------ lifecycle
    def clear(self) -> int:
        """Release every tree hold (engine stop): the pool must audit idle
        afterwards."""
        released = 0
        with self._lock:
            stack = list(self._root.children.values())
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                self.kv.release_block(n.block)
                released += 1
            self._root.children.clear()
            self._nodes = 0
        return released

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            nodes = self._nodes
        hits, misses = self.hit_seqs, self.miss_seqs
        total = hits + misses
        return {
            "enabled": self.enabled(),
            "nodes": nodes,
            "blocks": nodes,
            "hit_seqs": hits,
            "miss_seqs": misses,
            "hit_blocks": self.hit_blocks,
            "hit_tokens": self.hit_tokens,
            "inserted_blocks": self.inserted_blocks,
            "evicted_blocks": self.evicted_blocks,
            "hit_ratio": hits / total if total else 0.0,
        }


class ShardedPrefixCache:
    """One radix tree per dp shard, each over its shard's ledger pool.

    ``route_shard`` puts ``prefix_route_key`` through the shard plane's
    splitmix64 ``shard_for``: admission and placement agree, and
    same-prefix traffic lands where the chain lives."""

    def __init__(self, kv: ShardedKVCache):
        from brpc_tpu_torch.shard.plane import shard_for
        self.kv = kv
        self._route = shard_for
        self.trees = [PrefixCache(pool, shard=i)
                      for i, pool in enumerate(kv.pools)]

    @staticmethod
    def enabled() -> bool:
        return PrefixCache.enabled()

    def route_shard(self, tokens) -> Optional[int]:
        """Prefix-hash placement for a prompt, or None when it cannot hit
        the cache (too short): callers fall back to seq-id routing."""
        if not self.enabled():
            return None
        key = prefix_route_key(tokens, self.kv.config.block_size)
        if key is None:
            return None
        return self._route(key, self.kv.n_shards)

    def match_len(self, tokens) -> int:
        shard = self.route_shard(tokens)
        if shard is None:
            return 0
        return self.trees[shard].match_len(tokens)

    def fork(self, seq_id: int, tokens) -> int:
        shard = self.route_shard(tokens)
        if shard is None:
            return 0
        matched = self.trees[shard].fork(seq_id, tokens)
        if matched:
            # the chain pins the sequence to its shard (the adopt
            # registered it in that pool's ledger; routing must agree)
            self.kv.pin_shard(seq_id, shard)
        return matched

    def commit(self, seq_id: int, tokens, valid_len: int) -> int:
        got = self.kv._pool_of(seq_id)
        if got is None:
            return 0
        return self.trees[got[0]].commit(seq_id, tokens, valid_len)

    def evict_for_admission(self, ntokens: int, shard: Optional[int] = None,
                            route_key: Optional[int] = None) -> bool:
        if shard is None and route_key is not None:
            shard = self.kv.shard_of(route_key)
        if shard is None:
            return any(t.evict_for_admission(ntokens) for t in self.trees)
        return self.trees[shard].evict_for_admission(ntokens)

    def clear(self) -> int:
        return sum(t.clear() for t in self.trees)

    def snapshot(self) -> Dict[str, object]:
        shards = [t.snapshot() for t in self.trees]
        agg = {k: sum(s[k] for s in shards)
               for k in ("nodes", "blocks", "hit_seqs", "miss_seqs",
                         "hit_blocks", "hit_tokens", "inserted_blocks",
                         "evicted_blocks")}
        total = agg["hit_seqs"] + agg["miss_seqs"]
        agg["hit_ratio"] = agg["hit_seqs"] / total if total else 0.0
        agg["enabled"] = self.enabled()
        agg["shards"] = shards
        return agg


def build_prefix_cache(kv):
    """The engine's factory: per-shard trees over a ShardedKVCache, one
    tree over a plain pool."""
    if isinstance(kv, ShardedKVCache):
        return ShardedPrefixCache(kv)
    return PrefixCache(kv)
