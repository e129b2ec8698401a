"""Toy transformer for the serving plane, in PyTorch.

The port of ``brpc_tpu/serving/model.py``:

- **Weights by handle**: the parameters are packed into one flat fp32
  buffer made from ``np.random.RandomState(seed)`` exactly as the JAX
  model makes it (so the bytes are identical), staged onto the device
  through ``DeviceStore.put``; every parameter is a float32 view of that
  one uint8 device tensor.
- **Paged KV**: prefill scatters K/V into the :class:`PagedKVCache` pools
  at block-table slots; decode appends each sequence's new K/V, gathers
  its paged context and picks the next token greedily for the whole
  batch. The pools are updated in place (JAX donates and replaces them).
- **Flash-attention prefill**: prompt self-attention runs the CUDA flash
  kernel (``tpu/pallas_ops.flash_attention``) on the card, all heads in
  one launch, and the plain version on the CPU.

Prefill and decode keep the JAX model's shape buckets (prefill: a power
of two >= 16, then a multiple of 128; decode: a power-of-two batch and
block count) and its ``step_dispatch`` launch and host-sync notes, so
the engine's per-step (1 launch, 1 host sync) audit holds. Prompts at or
past ``ring_threshold`` need ring attention, which is not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from brpc_tpu_torch.serving.kv_cache import PagedKVCache
from brpc_tpu_torch.tpu import pallas_ops
from brpc_tpu_torch.tpu.device_lane import step_dispatch


class ModelConfig:
    def __init__(self, vocab: int = 512, d_model: int = 64,
                 n_heads: int = 4, n_layers: int = 2,
                 max_context: int = 1024, seed: int = 0,
                 attn: str = "auto", ring_threshold: int = 4096):
        if d_model % n_heads:
            raise ValueError("d_model must divide n_heads")
        if attn not in ("auto", "flash", "reference"):
            raise ValueError(f"unknown attn {attn!r}")
        self.vocab = vocab
        self.d_model = d_model
        self.n_heads = n_heads
        self.n_layers = n_layers
        self.max_context = max_context
        self.seed = seed
        # "auto": the flash kernel on the card, the plain version on the
        # CPU; "flash" forces the kernel path, "reference" the plain one
        self.attn = attn
        self.ring_threshold = ring_threshold

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_dim(self) -> int:
        return self.d_model


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _rms(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + 1e-6)


def _decode_body(cfg: ModelConfig, params: Dict[str, torch.Tensor],
                 kpool: torch.Tensor, vpool: torch.Tensor,
                 tokens: torch.Tensor, positions: torch.Tensor,
                 slot_tables: torch.Tensor, B: int, L: int):
    """The decode math for one batch: every row's K/V is written into the
    pools (in place) before any row gathers its context.

    tokens (B,), positions (B,), slot_tables (B, L) int64: flat pool slot
    for every context position (pads -> scratch block 0)."""
    H, hd, D = cfg.n_heads, cfg.head_dim, cfg.d_model
    rows = torch.arange(B, device=tokens.device)
    x = params["embed"][tokens]                         # (B, D)
    write = slot_tables[rows, positions]                # (B,)
    mask = (torch.arange(L, device=tokens.device)[None, :]
            <= positions[:, None])                      # (B, L)
    for l in range(cfg.n_layers):
        h = _rms(x)
        q, k, vv = (h @ params[f"wqkv{l}"]).split(D, dim=-1)
        kpool[l, write] = k
        vpool[l, write] = vv
        kh = kpool[l][slot_tables].view(B, L, H, hd)
        vh = vpool[l][slot_tables].view(B, L, H, hd)
        s = torch.einsum("bhd,blhd->bhl", q.reshape(B, H, hd), kh) \
            / np.sqrt(hd)
        s = torch.where(mask[:, None, :], s,
                        torch.full_like(s, pallas_ops.NEG_INF))
        attn = torch.einsum("bhl,blhd->bhd", torch.softmax(s, dim=-1), vh)
        x = x + attn.reshape(B, -1) @ params[f"wo{l}"]
        h2 = _rms(x)
        x = x + torch.relu(h2 @ params[f"w1{l}"]) @ params[f"w2{l}"]
    logits = _rms(x) @ params["embed"].T                # (B, V)
    return kpool, vpool, torch.argmax(logits, dim=-1)


class TinyTransformer(nn.Module):
    """Weights + prefill/decode over a PagedKVCache, on the KV store's
    device."""

    # the step-dispatch contract the engine asserts under an armed ledger:
    # decode_step is ONE logical launch + ONE host materialization
    FUSED_STEP = True

    def __init__(self, config: ModelConfig, kv: PagedKVCache, store=None):
        super().__init__()
        self.config = config
        self.kv = kv
        self.store = store if store is not None else kv.store
        self.device = self.store.device

        # ---- weights: pack host-side once, stage onto the device by handle
        flat, self._offsets = self._init_weights(config)
        self.param_handle, self.param_nbytes = self.store.put(
            flat.tobytes())
        f32 = self.store.lookup(self.param_handle).view(torch.float32)
        for name, pos, shape in self._offsets:
            view = f32[pos:pos + int(np.prod(shape))].view(shape)
            self.register_parameter(name,
                                    nn.Parameter(view, requires_grad=False))
        self._params = {name: getattr(self, name)
                        for name, _, _ in self._offsets}

    # ------------------------------------------------------------- weights
    @staticmethod
    def _init_weights(cfg: ModelConfig):
        rng = np.random.RandomState(cfg.seed)
        d, v = cfg.d_model, cfg.vocab
        shapes = [("embed", (v, d))]
        for l in range(cfg.n_layers):
            shapes += [(f"wqkv{l}", (d, 3 * d)), (f"wo{l}", (d, d)),
                       (f"w1{l}", (d, 2 * d)), (f"w2{l}", (2 * d, d))]
        offsets = []
        pos = 0
        parts = []
        for name, shape in shapes:
            n = int(np.prod(shape))
            offsets.append((name, pos, shape))
            parts.append((rng.standard_normal(n) *
                          (0.5 / np.sqrt(shape[0]))).astype(np.float32))
            pos += n
        return np.concatenate(parts), offsets

    @torch.no_grad()
    def load_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Install weights (e.g. from :func:`weights.params_from_jax`) by
        copying them into the staged buffer's views, so the model keeps
        holding its weights by handle."""
        missing = set(self._params) ^ set(params)
        if missing:
            raise KeyError(f"parameter names differ: {sorted(missing)}")
        for name, dst in self._params.items():
            src = params[name]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)

    # ----------------------------------------------------------- attention
    def _use_flash(self) -> bool:
        if self.config.attn == "flash":
            return True
        if self.config.attn == "reference":
            return False
        return self.device.type == "cuda"

    # ------------------------------------------------------------- prefill
    def _slots_for(self, table: Sequence[int], upto: int,
                   pad_to: int) -> np.ndarray:
        """Flat pool slot per token position (host-side); padded positions
        point at scratch block 0."""
        bs = self.kv.block_size
        t = np.arange(pad_to, dtype=np.int64)
        tab = np.asarray(table, dtype=np.int64)
        blocks = np.where(t < upto, tab[np.minimum(t // bs,
                                                   len(tab) - 1)], 0)
        live = (t < upto).astype(np.int64)
        return (blocks * bs + (t % bs)) * live

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    @torch.no_grad()
    def _prefill_impl(self, toks: torch.Tensor, slots: torch.Tensor,
                      length: int, use_flash: bool) -> torch.Tensor:
        cfg = self.config
        p = self._params
        S = toks.shape[0]
        H, hd, D = cfg.n_heads, cfg.head_dim, cfg.d_model
        attend = (pallas_ops.flash_attention if use_flash
                  else pallas_ops.attention_reference)
        kpool, vpool = self.kv.k_pool, self.kv.v_pool
        x = p["embed"][toks]                            # (S, D)
        for l in range(cfg.n_layers):
            h = _rms(x)
            q, k, vv = (h @ p[f"wqkv{l}"]).split(D, dim=-1)
            kpool[l, slots] = k
            vpool[l, slots] = vv
            # (S, H, hd) views of the fused QKV product; the kernel reads
            # their strides, no copy
            attn = attend(q.view(S, H, hd), k.view(S, H, hd),
                          vv.view(S, H, hd), causal=True)
            x = x + attn.reshape(S, -1) @ p[f"wo{l}"]
            h2 = _rms(x)
            x = x + torch.relu(h2 @ p[f"w1{l}"]) @ p[f"w2{l}"]
        self.kv.update_pools(kpool, vpool)
        logits = _rms(x[length - 1]) @ p["embed"].T
        return torch.argmax(logits)

    def prefill(self, tokens: np.ndarray, table: Sequence[int]) -> int:
        """Run prompt prefill for ONE sequence: scatter its K/V pages into
        the pool and return the first generated token (greedy)."""
        cfg = self.config
        s = len(tokens)
        if s >= cfg.ring_threshold:
            raise NotImplementedError(
                f"prompt of {s} tokens needs ring attention (ring_threshold "
                f"{cfg.ring_threshold}), which the torch port lacks")
        self.kv.assert_writable(table, 0, s)
        bucket = max(16, _next_pow2(s))
        if bucket > 128:
            bucket = ((s + 127) // 128) * 128  # flash wants S % 128 == 0
        toks = np.zeros(bucket, dtype=np.int64)
        toks[:s] = tokens
        slots = self._slots_for(table, s, bucket)
        step_dispatch.note_launch(1)
        nxt = self._prefill_impl(self._to_dev(toks), self._to_dev(slots), s,
                                 self._use_flash())
        first = int(nxt.item())
        step_dispatch.note_host_sync()
        return first

    # -------------------------------------------------------------- decode
    def decode_step(self, tokens: np.ndarray, positions: np.ndarray,
                    tables: List[Sequence[int]]) -> np.ndarray:
        """ONE logical launch for the whole decode batch: append each
        sequence's token at its position, gather paged context, and return
        the next token per sequence (host-materialized once, here)."""
        bs = self.kv.block_size
        B = len(tokens)
        self.kv.assert_writable_batch(tables, positions)
        b_bucket = max(2, _next_pow2(B))
        max_blocks = max(len(t) for t in tables)
        l_bucket = max(2, _next_pow2(max_blocks)) * bs
        toks = np.zeros(b_bucket, dtype=np.int64)
        toks[:B] = tokens
        pos = np.zeros(b_bucket, dtype=np.int64)
        pos[:B] = positions
        slot_tables = np.zeros((b_bucket, l_bucket), dtype=np.int64)
        for i, table in enumerate(tables):
            slot_tables[i] = self._slots_for(table, positions[i] + 1,
                                             l_bucket)
        step_dispatch.note_launch(1)
        with torch.no_grad():
            kpool, vpool, nxt = _decode_body(
                self.config, self._params, self.kv.k_pool, self.kv.v_pool,
                self._to_dev(toks), self._to_dev(pos),
                self._to_dev(slot_tables), b_bucket, l_bucket)
        self.kv.update_pools(kpool, vpool)
        out = nxt[:B].to(torch.int32).cpu().numpy()
        step_dispatch.note_host_sync()
        return out

    # ------------------------------------------------------------- helpers
    def close(self) -> None:
        self.store.free(self.param_handle)

    def synth_prompt(self, length: int) -> np.ndarray:
        """Deterministic prompt for bench/replay traffic (keyed only by
        length, as in the JAX model)."""
        v = self.config.vocab
        return ((np.arange(length, dtype=np.int64) * 31 + 7)
                % (v - 1)).astype(np.int32) + 1
