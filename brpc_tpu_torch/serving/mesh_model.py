"""Mesh-sharded serving model: prefill and decode over dp x sp x tp.

The port of ``brpc_tpu/serving/mesh_model.py``. :class:`MeshTransformer`
serves the toy transformer over the serving mesh (``tpu/mesh.
serving_mesh``) against a :class:`~brpc_tpu_torch.serving.kv_cache.
ShardedKVCache`, every mesh position replayed in this process (the
single-controller mesh of ``tpu/mesh.py``). Only what a position's
program makes observable is computed, and computed once:

- **prefill**: the reference's every dp group traces the prompt and its
  sp positions replicate it, but only the owner's pool slice keeps the
  result. Here the owner's prefill runs once, tp-sharded over heads:
  each tp slice's heads go through ``pallas_ops.flash_attention`` (on
  the card one kernel launch per slice per layer, on head-sliced strided
  views of the fused QKV product) and the slices are concatenated in
  head order before the output projection, so ``wo`` contracts the same
  (S, H * hd) operand as on one device. The owner's slice of the stacked
  pools takes the K/V.
- **ring lane**: prompts of ``ring_threshold`` tokens or more run the
  inherited ring prefill over this mesh's ``sp`` axis, scattering into
  the owner's slice.
- **decode**: the batch is grouped by owning dp shard; each group with
  live rows runs the single-device decode body (``model._decode_body``)
  once against its own pool slice, padded to the TOTAL batch's bucket
  (so a group's products have the single-device shapes), and the step
  still notes one launch and one host sync: the per-step audit the
  engine holds under an armed ledger.

``prefill_suffix`` and ``verify_step`` go through ``decode_step``
unchanged: a sequence's rows share its ShardTable, so grouping keeps
them contiguous and in position order on the owning shard.

**Over a mesh with a rank per position** (``tpu/launch.py``) the engine,
the ledgers and this object stay on rank 0, and every rank holds the
weights (built from the config's seed, or sent by :meth:`load_params`).
Each step is one program over the ranks (``Mesh.run``), sent from
:meth:`prefill` and :meth:`decode_step`, the engine's only calls into
the model:

- **prefill** runs on the owning dp shard's ranks at sp 0, one per tp
  rank: each computes the residual stream, launches the serving kernel
  on its own head slice, and the slices are gathered over tp in head
  order before ``wo``, so the tokens are bit for bit the replayed mesh's
  and one device's; the shard's first rank (tp 0) writes the K/V into
  the pools it holds (``ShardedKVCache``) and returns the first token.
- **ring lane**: every rank of the owning shard takes part: its sp
  block of its tp heads runs the ring over the sp ranks
  (``ring.ring_attention_local``), and the blocks are gathered over tp
  and sp.
- **decode**: rank 0 sends each dp group's (tokens, positions, slot
  tables); each shard's first rank runs ``_decode_body`` against its own
  pools and returns its rows. The step still notes one launch and one
  host sync on rank 0's engine thread.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence

import numpy as np
import torch

from brpc_tpu_torch.serving.kv_cache import ShardedKVCache, holds_pools
from brpc_tpu_torch.serving.model import (ModelConfig, TinyTransformer,
                                          _decode_body, _next_pow2,
                                          _prefill_body, _prefill_bucket)
from brpc_tpu_torch.tpu import launch, pallas_ops, ring
from brpc_tpu_torch.tpu.device_lane import step_dispatch


class MeshTransformer(TinyTransformer):
    """TinyTransformer served across the dp x sp x tp serving mesh."""

    def __init__(self, config: ModelConfig, kv: ShardedKVCache,
                 store=None, mesh=None):
        mesh = mesh if mesh is not None else kv.mesh
        for ax in ("dp", "sp", "tp"):
            if ax not in mesh.axis_names:
                raise ValueError(f"serving mesh needs a {ax!r} axis, "
                                 f"got {mesh.axis_names}")
        dp, tp = int(mesh.shape["dp"]), int(mesh.shape["tp"])
        if config.n_heads % tp:
            raise ValueError(f"n_heads={config.n_heads} must divide tp={tp}")
        if dp != kv.n_shards:
            raise ValueError(f"mesh dp={dp} != kv shards {kv.n_shards}")
        super().__init__(config, kv, store=store, mesh=mesh)
        self.dp, self.tp = dp, tp
        self.ranked = mesh.ranked
        if self.ranked:
            if not kv.ranked or kv.mesh.shape != mesh.shape:
                raise ValueError("a rank mesh model serves a KV cache "
                                 "over the same ranks")
            self.key = f"model-{next(_model_keys)}"
            mesh.run(_rank_model_init, self.key, config, kv.key)

    def load_params(self, params: Dict[str, torch.Tensor]) -> None:
        super().load_params(params)
        if self.ranked:
            self.mesh.run(_rank_model_load, self.key,
                          {n: t.detach().cpu() for n, t in params.items()})

    def close(self) -> None:
        if self.ranked and launch.active() is not None:
            self.mesh.run(_rank_model_free, self.key)
        super().close()

    def _first_rank(self, shard: int) -> int:
        c = {a: 0 for a in self.mesh.axis_names}
        c["dp"] = shard
        return int(np.ravel_multi_index([c[a] for a in
                                         self.mesh.axis_names],
                                        self.mesh.devices.shape))

    def prefill(self, tokens: np.ndarray, table: Sequence[int]) -> int:
        if not self.ranked:
            return super().prefill(tokens, table)
        cfg = self.config
        s = len(tokens)
        ring_lane = s >= cfg.ring_threshold
        self.kv.assert_writable(table, 0, s)
        sp = int(self.mesh.shape["sp"])
        bucket = ((s + sp - 1) // sp) * sp if ring_lane else \
            _prefill_bucket(s)
        toks = np.zeros(bucket, dtype=np.int64)
        toks[:s] = tokens
        slots = self._slots_for(table, s, bucket)
        shard = getattr(table, "shard", 0)
        # the reference notes one launch per layer's ring call
        for _ in range(cfg.n_layers if ring_lane else 1):
            step_dispatch.note_launch(1)
        got = self.mesh.run(_rank_prefill, self.key, shard, toks, slots, s,
                            ring_lane)
        first = int(got[self._first_rank(shard)])
        step_dispatch.note_host_sync()
        return first

    # ------------------------------------------------------------- prefill
    def _attend(self, q, k, v, use_flash: bool) -> torch.Tensor:
        """tp head shards: each slice of H / tp heads in its own call (one
        kernel launch each on the card, strided views, no copy), the
        outputs concatenated back in head order."""
        attend = super()._attend
        hl = self.config.n_heads // self.tp
        return torch.cat([
            attend(q[:, i * hl:(i + 1) * hl], k[:, i * hl:(i + 1) * hl],
                   v[:, i * hl:(i + 1) * hl], use_flash)
            for i in range(self.tp)], dim=1)

    # -------------------------------------------------------------- decode
    def decode_step(self, tokens: np.ndarray, positions: np.ndarray,
                    tables: List[Sequence[int]]) -> np.ndarray:
        """ONE logical launch for the whole mesh: sequences grouped by
        owning dp shard, each group's rows run once against its pool
        slice, one host materialization for every group."""
        bs = self.kv.block_size
        B = len(tokens)
        self.kv.assert_writable_batch(tables, positions)
        groups: List[List[int]] = [[] for _ in range(self.dp)]
        for i, t in enumerate(tables):
            groups[getattr(t, "shard", 0)].append(i)
        # bucket by the TOTAL batch, as the reference: the shard split
        # depends on seq-id hashing, and the total keeps each group's
        # products at the single-device shapes
        b_bucket = max(2, _next_pow2(B))
        max_blocks = max(len(t) for t in tables)
        l_bucket = max(2, _next_pow2(max_blocks)) * bs
        live = [g for g in groups if g]
        step_dispatch.note_launch(1)
        if self.ranked:
            return self._decode_on_ranks(tokens, positions, tables, groups,
                                         b_bucket, l_bucket)
        outs = []
        with torch.no_grad():
            for g in live:
                toks, pos, slot_tables = self._pack(
                    g, tokens, positions, tables, b_bucket, l_bucket)
                kpool, vpool = self.kv.pool_views(tables[g[0]])
                _, _, nxt = _decode_body(
                    self.config, self._params, kpool, vpool,
                    self._to_dev(toks), self._to_dev(pos),
                    self._to_dev(slot_tables), b_bucket, l_bucket)
                outs.append(nxt[:len(g)])
        self.kv.pools_written()
        flat = torch.cat(outs).to(torch.int32).cpu().numpy()
        step_dispatch.note_host_sync()
        out = np.zeros(B, dtype=np.int32)
        order = [i for g in live for i in g]
        out[order] = flat
        return out

    def _pack(self, rows, tokens, positions, tables, b_bucket, l_bucket):
        """One dp group's rows padded to the buckets: (tokens, positions,
        slot tables)."""
        toks = np.zeros(b_bucket, dtype=np.int64)
        pos = np.zeros(b_bucket, dtype=np.int64)
        slot_tables = np.zeros((b_bucket, l_bucket), dtype=np.int64)
        for j, i in enumerate(rows):
            toks[j] = tokens[i]
            pos[j] = positions[i]
            slot_tables[j] = self._slots_for(tables[i], positions[i] + 1,
                                             l_bucket)
        return toks, pos, slot_tables

    def _decode_on_ranks(self, tokens, positions, tables, groups, b_bucket,
                         l_bucket) -> np.ndarray:
        """One program: each dp group's rows to its shard's first rank,
        the next tokens back."""
        work = {shard: (*self._pack(g, tokens, positions, tables, b_bucket,
                                    l_bucket), len(g))
                for shard, g in enumerate(groups) if g}
        got = self.mesh.run(_rank_decode, self.key, work, b_bucket, l_bucket)
        out = np.zeros(len(tokens), dtype=np.int32)
        for shard in work:
            out[groups[shard]] = got[self._first_rank(shard)]
        step_dispatch.note_host_sync()
        return out


# ------------------------------------------------ the ranks' programs
_model_keys = itertools.count()


def _rank_model_init(mesh, key, config, kv_key):
    flat, offsets = TinyTransformer._init_weights(config)
    f32 = torch.from_numpy(flat).to(mesh.device)
    params = {name: f32[pos:pos + int(np.prod(shape))].view(shape)
              for name, pos, shape in offsets}
    launch.state()[key] = {"config": config, "params": params,
                           "kv": kv_key}


def _rank_model_load(mesh, key, params):
    dst = launch.state()[key]["params"]
    with torch.no_grad():
        for name, t in params.items():
            dst[name].copy_(t)


def _rank_model_free(mesh, key):
    launch.state().pop(key, None)


def _use_flash(config, device) -> bool:
    if config.attn == "flash":
        return True
    return config.attn == "auto" and device.type == "cuda"


@torch.no_grad()
def _rank_prefill(mesh, key, shard, toks, slots, length, ring_lane):
    """One prompt's prefill on the owning shard's ranks (sp 0 only, but
    for the ring lane): each tp rank attends over its heads (the ring
    lane over its sp block too) and the pieces are gathered in head (and
    position) order before ``wo``; the first token from the shard's
    first rank."""
    st = launch.state()[key]
    cfg, p = st["config"], st["params"]
    c = mesh.coords()
    if c["dp"] != shard or (c["sp"] and not ring_lane):
        return None
    dev = mesh.device
    tp, t = mesh.shape["tp"], c["tp"]
    hl = cfg.n_heads // tp
    heads = slice(t * hl, (t + 1) * hl)
    pools = launch.state()[st["kv"]] if holds_pools(mesh) else None
    flash = (pallas_ops.flash_attention if _use_flash(cfg, dev)
             else pallas_ops.attention_reference)

    def attend(q, k, v):
        if ring_lane:
            qh, kh, vh = (mesh.block(u[None, :, heads], (None, "sp"))
                          for u in (q, k, v))
            att = ring.ring_attention_local(qh, kh, vh, mesh, "sp",
                                            causal=True)
            if tp > 1:
                att = torch.cat(launch.all_gather(att, mesh.group("tp")),
                                dim=2)
            if mesh.shape["sp"] > 1:
                att = torch.cat(launch.all_gather(att, mesh.group("sp")),
                                dim=1)
            return att
        att = flash(q[:, heads], k[:, heads], v[:, heads], causal=True)
        if tp > 1:
            att = torch.cat(launch.all_gather(att, mesh.group("tp")), dim=1)
        return att

    nxt = _prefill_body(cfg, p, pools, torch.from_numpy(toks).to(dev),
                        torch.from_numpy(slots).to(dev), length, attend)
    return int(nxt) if pools is not None else None


@torch.no_grad()
def _rank_decode(mesh, key, work, b_bucket, l_bucket):
    if not holds_pools(mesh) or mesh.coord("dp") not in work:
        return None
    st = launch.state()[key]
    kpool, vpool = launch.state()[st["kv"]]
    toks, pos, slot_tables, n = work[mesh.coord("dp")]

    def dev(a):
        return torch.from_numpy(a).to(mesh.device)

    _, _, nxt = _decode_body(st["config"], st["params"], kpool, vpool,
                             dev(toks), dev(pos), dev(slot_tables), b_bucket,
                             l_bucket)
    return nxt[:n].to(torch.int32).cpu().numpy()
