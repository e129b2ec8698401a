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
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from brpc_tpu_torch.serving.kv_cache import ShardedKVCache
from brpc_tpu_torch.serving.model import (ModelConfig, TinyTransformer,
                                          _decode_body, _next_pow2)
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
        outs = []
        with torch.no_grad():
            for g in live:
                toks = np.zeros(b_bucket, dtype=np.int64)
                pos = np.zeros(b_bucket, dtype=np.int64)
                slot_tables = np.zeros((b_bucket, l_bucket), dtype=np.int64)
                for j, i in enumerate(g):
                    toks[j] = tokens[i]
                    pos[j] = positions[i]
                    slot_tables[j] = self._slots_for(
                        tables[i], positions[i] + 1, l_bucket)
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
