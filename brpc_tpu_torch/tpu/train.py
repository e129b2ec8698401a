"""The flagship transformer LM's single-device training step, in PyTorch.

The port of ``brpc_tpu/tpu/train.py`` on one device: the same model
(pre-norm blocks of causal multi-head attention and a GELU MLP), the
same parameter names and shapes, the same loss and the same
SGD step. With ``use_flash_attention`` (the default) attention is
:func:`~brpc_tpu_torch.tpu.pallas_ops.flash_attention_mha`, whose forward
and backward are CUDA kernels on the card; with ``use_pallas_norm`` every
norm is :func:`~brpc_tpu_torch.tpu.pallas_ops.rmsnorm`; with
``use_fused_xent`` the loss is
:func:`~brpc_tpu_torch.tpu.pallas_ops.softmax_xent`, whose forward is a
CUDA kernel on the card. The QKV, output, MLP and head products stay
``torch.matmul``, as the JAX package leaves them to XLA.

Not ported yet, and refused with ``NotImplementedError``: a mesh (the
sharded step with ring attention).

Entry points: :class:`TrainLM` (``forward``), :func:`loss_fn`,
:func:`value_and_grad`, :func:`sgd_train_step` and :func:`demo_batch`;
:func:`params_from_jax` and :meth:`TrainLM.load_params` carry the JAX
package's parameters across.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from brpc_tpu_torch.tpu import pallas_ops
from brpc_tpu_torch.tpu.device_lane import resolve_device

_MESH_SLICE = ("a mesh (the sharded train step with ring attention) is not "
               "ported yet: it comes with the port's mesh and sharded "
               "training slice (ROADMAP.md, slice 9)")


@dataclass(frozen=True)
class ModelConfig:
    vocab: int = 1024
    d_model: int = 256
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 1024
    max_seq: int = 512
    dtype: Any = torch.float32
    use_pallas_norm: bool = False
    use_flash_attention: bool = True
    use_fused_xent: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


class _Layer(nn.Module):
    def __init__(self, cfg: ModelConfig, dense):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.ln1 = nn.Parameter(torch.ones(d, dtype=cfg.dtype))
        self.wqkv = nn.Parameter(dense((d, 3 * d)))
        self.wo = nn.Parameter(dense((d, d)))
        self.ln2 = nn.Parameter(torch.ones(d, dtype=cfg.dtype))
        self.w1 = nn.Parameter(dense((d, f)))
        self.w2 = nn.Parameter(dense((f, d)))


_LAYER_KEYS = ("ln1", "wqkv", "wo", "ln2", "w1", "w2")


class TrainLM(nn.Module):
    """The JAX pytree's parameters as an ``nn.Module``: ``embed [V,D]``,
    ``head [D,V]``, ``ln_f [D]`` and ``layers[i].{ln1, wqkv [D,3D], wo
    [D,D], ln2, w1 [D,F], w2 [F,D]}``. Dense weights are standard normal
    times ``d_model ** -0.5`` drawn from ``generator`` (a CPU
    ``torch.Generator``; its bits differ from ``jax.random``'s, so tests
    load the JAX parameters with :meth:`load_params`), norms are ones.
    Runs on ``cuda`` unless ``device="cpu"``."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.config = cfg
        scale = cfg.d_model ** -0.5

        def dense(shape):
            return (torch.randn(shape, generator=generator) * scale).to(
                cfg.dtype)

        self.embed = nn.Parameter(dense((cfg.vocab, cfg.d_model)))
        self.head = nn.Parameter(dense((cfg.d_model, cfg.vocab)))
        self.ln_f = nn.Parameter(torch.ones(cfg.d_model, dtype=cfg.dtype))
        self.layers = nn.ModuleList(_Layer(cfg, dense)
                                    for _ in range(cfg.n_layers))
        self.to(dev)

    def params_tree(self) -> dict:
        """The parameters in the JAX pytree's structure."""
        return {"embed": self.embed, "head": self.head, "ln_f": self.ln_f,
                "layers": [{key: getattr(layer, key) for key in _LAYER_KEYS}
                           for layer in self.layers]}

    @torch.no_grad()
    def load_params(self, tree) -> None:
        """Copy a pytree of arrays (numpy, or tensors from
        :func:`params_from_jax`) into the parameters; names and shapes
        must match exactly."""
        mine, theirs = _leaves(self.params_tree()), _leaves(tree)
        if len(mine) != len(theirs):
            raise ValueError(f"{len(theirs)} arrays for {len(mine)} "
                             f"parameters")
        for p, a in zip(mine, theirs):
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(np.array(a, dtype=np.float32))
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"shape {tuple(a.shape)} for parameter of "
                                 f"shape {tuple(p.shape)}")
            p.copy_(a.to(device=p.device, dtype=p.dtype))

    def _norm(self, x, w):
        if self.config.use_pallas_norm:
            return pallas_ops.rmsnorm(x, w)
        return pallas_ops.rmsnorm_reference(x, w)

    def forward(self, tokens, mesh=None, causal: bool = True):
        """tokens [B, S] -> logits [B, S, V]."""
        if mesh is not None:
            raise NotImplementedError(_MESH_SLICE)
        cfg = self.config
        B, S = tokens.shape
        H, Dh = cfg.n_heads, cfg.head_dim
        x = self.embed[tokens].to(cfg.dtype)                  # [B,S,D]
        for layer in self.layers:
            h = self._norm(x, layer.ln1)
            qkv = (h @ layer.wqkv).reshape(B, S, 3, H, Dh)    # [B,S,3D]
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            if cfg.use_flash_attention:
                # [B,S,H,Dh] -> [B,H,S,Dh] for the per-head kernel
                att = pallas_ops.flash_attention_mha(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    causal=causal).transpose(1, 2).to(cfg.dtype)
            else:
                att = pallas_ops.attention_reference(q, k, v, causal=causal)
            x = x + att.reshape(B, S, cfg.d_model) @ layer.wo
            h = self._norm(x, layer.ln2)
            x = x + F.gelu(h @ layer.w1, approximate="tanh") @ layer.w2
        return self._norm(x, self.ln_f) @ self.head


def loss_fn(model: TrainLM, batch, mesh=None):
    """Mean next-token cross-entropy in fp32; with ``use_fused_xent`` the
    fused kernel over the [B*S, V] logits."""
    tokens, targets = batch
    logits = model(tokens, mesh).float()
    if model.config.use_fused_xent and mesh is None:
        b, s, v = logits.shape
        return pallas_ops.softmax_xent(logits.reshape(b * s, v),
                                       targets.reshape(-1))
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None]).mean()


def value_and_grad(model: TrainLM, batch, mesh=None):
    """(loss, grads in the structure of ``model.params_tree()``)."""
    tree = model.params_tree()
    loss = loss_fn(model, batch, mesh)
    grads = iter(torch.autograd.grad(loss, _leaves(tree)))
    return loss.detach(), _map_tree(lambda _: next(grads), tree)


def sgd_train_step(model: TrainLM, batch, lr: float = 1e-3, mesh=None):
    """One full training step (forward, backward, update); returns the
    loss. Unlike the JAX step, which returns new parameters, this one
    updates the model's parameters in place, each as ``p - lr * g`` in
    the parameter's dtype (the JAX order of casts)."""
    loss, grads = value_and_grad(model, batch, mesh)
    with torch.no_grad():
        for p, g in zip(_leaves(model.params_tree()), _leaves(grads)):
            p.copy_(p - lr * g.to(p.dtype))
    return loss


def demo_batch(generator: torch.Generator, cfg: ModelConfig, batch: int,
               seq: int, device=None):
    """(tokens, targets) [batch, seq] int64: uniform tokens from
    ``generator`` (CPU), targets the tokens rolled by -1 along the
    sequence. On ``cuda`` unless ``device="cpu"``."""
    dev = resolve_device(device)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=generator)
    targets = torch.roll(tokens, -1, dims=1)
    return tokens.to(dev), targets.to(dev)


def params_from_jax(tree, device, dtype=torch.float32):
    """The JAX parameter pytree, as numpy arrays (nested dicts and lists),
    -> the same structure of ``dtype`` tensors on ``device``."""
    dev = resolve_device(device)
    return _map_tree(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=dev, dtype=dtype), tree)


def _map_tree(fn, tree):
    """fn over the leaves of nested dicts and lists; dict keys in sorted
    order, as jax.tree_util walks them."""
    if isinstance(tree, dict):
        return {key: _map_tree(fn, tree[key]) for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, t) for t in tree]
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _map_tree(out.append, tree)
    return out
