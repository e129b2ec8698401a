"""The flagship transformer LM's training step, in PyTorch.

The port of ``brpc_tpu/tpu/train.py``: the same model (pre-norm blocks
of causal multi-head attention and a GELU MLP), the same parameter names
and shapes, the same loss and the same SGD step, on one device or over a
dp x sp x tp mesh. With ``use_flash_attention`` (the default) attention is
:func:`~brpc_tpu_torch.tpu.pallas_ops.flash_attention_mha`, whose forward
and backward are CUDA kernels on the card; with ``use_pallas_norm`` every
norm is :func:`~brpc_tpu_torch.tpu.pallas_ops.rmsnorm`; with
``use_fused_xent`` the loss is
:func:`~brpc_tpu_torch.tpu.pallas_ops.softmax_xent`, whose forward is a
CUDA kernel on the card. The QKV, output, MLP and head products stay
``torch.matmul``, as the JAX package leaves them to XLA.

**The sharded step.** With a mesh (``tpu/mesh.py``: axes dp, sp, tp),
attention is the ring over sp in its mesh form,
``ring.ring_attention(q, k, v, mesh, "sp", batch_axis="dp",
head_axis="tp", use_flash=use_flash_attention)``: B splits over dp, H
over tp, and each (dp, tp) slice runs its own ring of sp positions, whose
hops are the carry kernel forward and the dQ and dK/dV kernels backward
on the card. The loss is the plain log-softmax (the JAX step takes the
fused loss only without a mesh). In the JAX step the rest of the program
is placed, not split: ``with_sharding_constraint`` lays activations over
(dp, sp) and the parameters over tp (:func:`param_shardings`), and GSPMD
inserts the dp gradient sums and the tp sums of the row-parallel
products. On a replayed mesh (every position in one process on one
device) placement has no observable effect: the forward places nothing,
and the shardings are records of the JAX step's layout.

**Over ranks** (a mesh with a rank per position, ``tpu/launch.py``) the
step is that layout made explicit. Each rank owns its tp slice of every
parameter as :func:`param_shardings` lays it out (:func:`shard_tree`:
``wqkv``'s slice is its heads' columns of each of q, k and v, not the
contiguous block GSPMD would reshard), and its (dp, sp) block of the
batch. ``embed``'s tp columns are gathered before the first norm; each
column-parallel product is preceded by Megatron's f (identity forward, a
tp all-reduce backward) and each row-parallel product followed by its g
(a tp all-reduce forward, identity backward), written as autograd
functions so a gradient is summed once; the loss is a tp-parallel
log-softmax (max and sum all-reduced over tp); attention is the ring
over the sp ranks (``ring.ring_attention_local``); every gradient is
all-reduced over dp x sp in one fp32 buffer, and SGD updates each rank's
own shards in place. All of these go through ``tpu/launch.py``'s
collectives. :func:`make_train_step`'s step scatters a model's
parameters to the ranks at its first call and leaves them there;
``step.gather(model)`` brings them back to rank 0. ``TrainLM.forward``
over ranks runs the loss's first half alone (:func:`_rank_logits`): each
tp rank's ``[b, s, V/tp]`` logits are gathered over tp on the block's tp
rank 0, and rank 0 puts the (dp, sp) blocks back together.

Entry points: :class:`TrainLM` (``forward``), :func:`loss_fn`,
:func:`value_and_grad`, :func:`sgd_train_step`, :func:`make_train_step`,
:func:`param_shardings` and :func:`demo_batch`; :func:`params_from_jax`
and :meth:`TrainLM.load_params` carry the JAX package's parameters
across.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from brpc_tpu_torch.tpu import launch, pallas_ops, ring
from brpc_tpu_torch.tpu.device_lane import resolve_device
from brpc_tpu_torch.tpu.mesh import Mesh, named_sharding


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

    def forward(self, tokens, mesh: Mesh = None, causal: bool = True):
        """tokens [B, S] -> logits [B, S, V]. With a mesh, attention is
        ring attention over sp, B split over dp and H over tp. Over a mesh
        with a rank per position the forward is one program over the
        ranks and the logits come back to rank 0 (no graph)."""
        cfg = self.config
        if mesh is not None and mesh.ranked:
            return self._forward_on_ranks(tokens, mesh, causal)
        if mesh is not None and \
                resolve_device(mesh.device) != self.embed.device:
            raise ValueError(f"mesh on {mesh.device}, parameters on "
                             f"{self.embed.device}")
        B, S = tokens.shape
        H, Dh = cfg.n_heads, cfg.head_dim
        x = self.embed[tokens].to(cfg.dtype)                  # [B,S,D]
        for layer in self.layers:
            h = self._norm(x, layer.ln1)
            qkv = (h @ layer.wqkv).reshape(B, S, 3, H, Dh)    # [B,S,3D]
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            if mesh is not None:
                att = ring.ring_attention(
                    q, k, v, mesh, axis="sp", causal=causal,
                    batch_axis="dp", head_axis="tp",
                    use_flash=cfg.use_flash_attention)
            elif cfg.use_flash_attention:
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

    def _forward_on_ranks(self, tokens, mesh, causal: bool):
        """forward over a mesh with a rank per position: one program with
        the model's tp slices scattered; each (dp, sp) block's logits
        come back from one rank and are put back where ``mesh.block``
        took the block's tokens. The logits carry no graph (train over
        ranks with loss_fn, value_and_grad or make_train_step)."""
        _need_axes(mesh)
        got = mesh.run(_rank_forward, self.config, tokens.detach().cpu(),
                       causal, scatter=_scatter_of(self, mesh))
        return mesh.assemble(got, ("dp", "sp")).to(self.embed.device)


def param_shardings(cfg: ModelConfig, mesh: Mesh) -> dict:
    """tp shards model width; everything is replicated over dp/sp. The
    records of the JAX step's layout, in the parameters' tree."""
    def ns(*spec):
        return named_sharding(mesh, *spec)

    layer = {
        "ln1": ns(), "ln2": ns(),
        "wqkv": ns(None, "tp"),   # column-parallel: heads split over tp
        "wo": ns("tp", None),     # row-parallel: a tp sum after the product
        "w1": ns(None, "tp"),
        "w2": ns("tp", None),
    }
    return {
        "embed": ns(None, "tp"),
        "head": ns(None, "tp"),
        "ln_f": ns(),
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
    }


def loss_fn(model: TrainLM, batch, mesh: Mesh = None):
    """Mean next-token cross-entropy in fp32; with ``use_fused_xent`` and
    no mesh the fused kernel over the [B*S, V] logits."""
    if mesh is not None and mesh.ranked:
        return _on_ranks(model, batch, mesh, grad=False)[0]
    tokens, targets = batch
    logits = model(tokens, mesh).float()
    if model.config.use_fused_xent and mesh is None:
        b, s, v = logits.shape
        return pallas_ops.softmax_xent(logits.reshape(b * s, v),
                                       targets.reshape(-1))
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None]).mean()


def value_and_grad(model: TrainLM, batch, mesh: Mesh = None):
    """(loss, grads in the structure of ``model.params_tree()``)."""
    if mesh is not None and mesh.ranked:
        return _on_ranks(model, batch, mesh, grad=True)
    tree = model.params_tree()
    loss = loss_fn(model, batch, mesh)
    grads = iter(torch.autograd.grad(loss, _leaves(tree)))
    return loss.detach(), _map_tree(lambda _: next(grads), tree)


def sgd_train_step(model: TrainLM, batch, lr: float = 1e-3,
                   mesh: Mesh = None):
    """One full training step (forward, backward, update); returns the
    loss. Unlike the JAX step, which returns new parameters, this one
    updates the model's parameters in place, each as ``p - lr * g`` in
    the parameter's dtype (the JAX order of casts)."""
    loss, grads = value_and_grad(model, batch, mesh)
    with torch.no_grad():
        for p, g in zip(_leaves(model.params_tree()), _leaves(grads)):
            p.copy_(p - lr * g.to(p.dtype))
    return loss


def make_train_step(cfg: ModelConfig, mesh: Mesh, lr: float = 1e-3):
    """(step, pshard, batch_shard): ``step(model, batch)`` is one sharded
    :func:`sgd_train_step` over ``mesh``, returning the loss; ``pshard``
    (:func:`param_shardings`) and ``batch_shard`` (tokens and targets
    over (dp, sp)) record the JAX step's layout. On a replayed mesh the
    step updates the model in place. Over ranks it updates each rank's
    shards, and ``step.gather(model)`` copies them back into the model;
    the model is scattered to the ranks at the step's first call with
    it, and again whenever its parameters were written in place since
    (``load_params``, an optimizer's update), so a step never starts
    from shards the caller has since replaced."""
    pshard = param_shardings(cfg, mesh)
    batch_shard = (named_sharding(mesh, "dp", "sp"),
                   named_sharding(mesh, "dp", "sp"))
    if mesh.ranked:
        return _RankStep(cfg, mesh, lr), pshard, batch_shard

    def step(model: TrainLM, batch):
        if model.config != cfg:
            raise ValueError("the model's config is not the step's")
        return sgd_train_step(model, batch, lr=lr, mesh=mesh)

    return step, pshard, batch_shard


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


# ------------------------------------------------ a rank per position
def _tp_slices(cfg: ModelConfig, tp: int, t: int) -> dict:
    """Where tp rank ``t``'s slice of each sharded parameter lies: (dim,
    index) of its rows or columns in the full array."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    for name, n in (("n_heads", cfg.n_heads), ("d_ff", f), ("vocab", v)):
        if n % tp:
            raise ValueError(f"{name}={n} does not split over tp={tp}")
    def span(n):
        return torch.arange(t * (n // tp), (t + 1) * (n // tp))

    # wqkv's columns are [3, H, Dh]: this rank's heads' columns of each of
    # q, k and v (GSPMD's contiguous block of 3D/tp columns is another set)
    qkv = torch.cat([j * d + span(d) for j in range(3)])
    return {"embed": (1, span(d)), "head": (1, span(v)), "wqkv": (1, qkv),
            "wo": (0, span(d)), "w1": (1, span(f)), "w2": (0, span(f))}


def shard_tree(tree, cfg: ModelConfig, tp: int, t: int):
    """tp rank ``t``'s slice of a full parameter tree (tensors), as
    :func:`param_shardings` lays it out; norms are whole."""
    cut = _tp_slices(cfg, tp, t)

    def one(name, a):
        if name not in cut:
            return a.clone()
        dim, idx = cut[name]
        return a.index_select(dim, idx.to(a.device)).contiguous()

    return {"embed": one("embed", tree["embed"]),
            "head": one("head", tree["head"]),
            "ln_f": one("ln_f", tree["ln_f"]),
            "layers": [{k: one(k, layer[k]) for k in sorted(layer)}
                       for layer in tree["layers"]]}


def unshard_trees(trees, cfg: ModelConfig):
    """The full parameter tree from tp ranks' slices (``trees[t]``): the
    inverse of :func:`shard_tree`."""
    tp = len(trees)
    cuts = [_tp_slices(cfg, tp, t) for t in range(tp)]

    def one(name, parts):
        if name not in cuts[0]:
            return parts[0]
        dim = cuts[0][name][0]
        shape = list(parts[0].shape)
        shape[dim] *= tp
        out = torch.empty(shape, dtype=parts[0].dtype)
        for cut, part in zip(cuts, parts):
            out.index_copy_(dim, cut[name][1], part)
        return out

    return {"embed": one("embed", [t["embed"] for t in trees]),
            "head": one("head", [t["head"] for t in trees]),
            "ln_f": trees[0]["ln_f"],
            "layers": [{k: one(k, [t["layers"][i][k] for t in trees])
                        for k in sorted(trees[0]["layers"][i])}
                       for i in range(len(trees[0]["layers"]))]}


class _TpCopy(torch.autograd.Function):
    """Megatron's f before a column-parallel product: identity forward,
    the tp all-reduce of the input's gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return launch.all_reduce(g, ctx.group), None


class _TpSum(torch.autograd.Function):
    """Megatron's g after a row-parallel product (and the tp-parallel
    log-softmax's sums): the tp all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return launch.all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _TpGather(torch.autograd.Function):
    """The tp ranks' last-dim slices concatenated forward (``embed``'s
    columns); this rank's slice of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group, t):
        ctx.cut = (t, x.shape[-1])
        return torch.cat(launch.all_gather(x, group), dim=-1)

    @staticmethod
    def backward(ctx, g):
        t, w = ctx.cut
        return g[..., t * w:(t + 1) * w], None, None


def _tp_ops(mesh):
    """Megatron's f and g over this rank's tp group (identities at tp 1)."""
    tp, g = mesh.shape["tp"], mesh.group("tp")

    def f(x):
        return _TpCopy.apply(x, g) if tp > 1 else x

    def gsum(x):
        return _TpSum.apply(x, g) if tp > 1 else x

    return f, gsum


def _rank_logits(cfg: ModelConfig, p: dict, tokens, mesh,
                 causal: bool = True):
    """This rank's logits: its (dp, sp) block of tokens through its tp
    slices, ``[b, s, V/tp]`` in ``cfg.dtype`` (the vocabulary columns of
    its ``head`` slice). Every rank of the mesh calls it at once."""
    tp, t = mesh.shape["tp"], mesh.coord("tp")
    f, gsum = _tp_ops(mesh)

    def norm(x, w):
        if cfg.use_pallas_norm:
            return pallas_ops.rmsnorm(x, w)
        return pallas_ops.rmsnorm_reference(x, w)

    b, s = tokens.shape
    hl, dh = cfg.n_heads // tp, cfg.head_dim
    x = p["embed"][tokens].to(cfg.dtype)
    if tp > 1:
        x = _TpGather.apply(x, mesh.group("tp"), t)         # [b,s,D]
    for layer in p["layers"]:
        qkv = (f(norm(x, layer["ln1"])) @ layer["wqkv"]).reshape(
            b, s, 3, hl, dh)
        att = ring.ring_attention_local(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mesh, "sp",
            causal=causal, use_flash=cfg.use_flash_attention)
        x = x + gsum(att.reshape(b, s, hl * dh) @ layer["wo"])
        h = f(norm(x, layer["ln2"]))
        x = x + gsum(F.gelu(h @ layer["w1"], approximate="tanh")
                     @ layer["w2"])
    return f(norm(x, p["ln_f"])) @ p["head"]                # [b,s,V/tp]


def _rank_loss(cfg: ModelConfig, p: dict, tokens, targets, mesh,
               n_tokens: int):
    """This rank's share of the mean loss: its logits (:func:`_rank_logits`)
    through a tp-parallel log-softmax; every tp rank of the block returns
    the same value, and the dp x sp shares sum to the loss."""
    tp, t = mesh.shape["tp"], mesh.coord("tp")
    g = mesh.group("tp")
    _, gsum = _tp_ops(mesh)
    logits = _rank_logits(cfg, p, tokens, mesh).float()    # [b,s,V/tp]
    vl = logits.shape[-1]
    mx = logits.detach().amax(dim=-1)
    if tp > 1:
        mx = launch.all_reduce(mx, g, op="max")
    sumexp = gsum(torch.exp(logits - mx[..., None]).sum(dim=-1))
    local = targets - t * vl
    mine = (local >= 0) & (local < vl)
    picked = torch.gather(logits, -1, local.clamp(0, vl - 1)[..., None])
    picked = gsum(torch.where(mine, picked[..., 0], 0.0))
    return (torch.log(sumexp) + mx - picked).sum() / n_tokens


def _local_params(tree, device, grad: bool):
    return _map_tree(lambda a: a.to(device).requires_grad_(grad), tree)


def _reduce_grads(grads, mesh):
    """Every gradient summed over dp x sp, in one fp32 buffer."""
    flat = torch.cat([gr.float().reshape(-1) for gr in grads])
    if mesh.shape["dp"] * mesh.shape["sp"] > 1:
        flat = launch.all_reduce(flat, mesh.group("dp", "sp"))
    return [piece.view(gr.shape) for piece, gr in
            zip(flat.split([gr.numel() for gr in grads]), grads)]


def _loss_and_grads(mesh, cfg, params, tokens, targets, grad: bool):
    tok = mesh.block(tokens, ("dp", "sp")).to(mesh.device)
    tgt = mesh.block(targets, ("dp", "sp")).to(mesh.device)
    leaves = _leaves(params)
    with torch.set_grad_enabled(grad):
        loss = _rank_loss(cfg, params, tok, tgt, mesh, tokens.numel())
    grads = _reduce_grads(torch.autograd.grad(loss, leaves), mesh) \
        if grad else None
    if mesh.shape["dp"] * mesh.shape["sp"] > 1:
        loss = launch.all_reduce(loss.detach(), mesh.group("dp", "sp"))
    return loss.detach(), grads


def _rank_forward(mesh, cfg, tokens, causal, scattered):
    """TrainLM.forward's body over ranks: this rank's logits, gathered
    over tp in tp order on the block's tp rank 0, which alone returns
    its (dp, sp) block's ``[b, s, V]``."""
    params = _local_params(scattered, mesh.device, False)
    tok = mesh.block(tokens, ("dp", "sp")).to(mesh.device)
    with torch.no_grad():
        logits = _rank_logits(cfg, params, tok, mesh, causal)
        if mesh.shape["tp"] > 1:
            logits = torch.cat(launch.all_gather(logits, mesh.group("tp")),
                               dim=-1)
    return logits if mesh.coord("tp") == 0 else None


def _tp_root(mesh) -> bool:
    # the ranks at dp 0, sp 0 return their tp slices
    c = mesh.coords()
    return c["dp"] == 0 and c["sp"] == 0


def _rank_value_and_grad(mesh, cfg, tokens, targets, grad, scattered):
    params = _local_params(scattered, mesh.device, grad)
    loss, grads = _loss_and_grads(mesh, cfg, params, tokens, targets, grad)
    if grads is None or not _tp_root(mesh):
        return loss, None
    it = iter(grads)
    return loss, _map_tree(lambda p: next(it).to(p.dtype), params)


def _scatter_of(model: TrainLM, mesh) -> list:
    """Rank r's tp slice of the model's parameters, for every rank."""
    cfg, tp = model.config, mesh.shape["tp"]
    tree = _map_tree(lambda a: a.detach().cpu(), model.params_tree())
    slices = [shard_tree(tree, cfg, tp, t) for t in range(tp)]
    return [slices[mesh.coords(r)["tp"]] for r in range(mesh.devices.size)]


def _tree_of(mesh, cfg, results, device):
    tp = mesh.shape["tp"]
    trees = [None] * tp
    for r, tree in enumerate(results):
        if tree is not None:
            trees[mesh.coords(r)["tp"]] = tree
    return _map_tree(lambda a: a.to(device), unshard_trees(trees, cfg))


def _need_axes(mesh) -> None:
    for ax in ("dp", "sp", "tp"):
        if ax not in mesh.shape:
            raise ValueError(f"the sharded step needs a {ax!r} axis, got "
                             f"{mesh.axis_names}")


def _on_ranks(model: TrainLM, batch, mesh, grad: bool):
    """loss_fn / value_and_grad over ranks: the model's slices scattered,
    one program, the full gradient tree back on rank 0."""
    _need_axes(mesh)
    tokens, targets = (t.detach().cpu() for t in batch)
    got = mesh.run(_rank_value_and_grad, model.config, tokens, targets,
                   grad, scatter=_scatter_of(model, mesh))
    loss = got[0][0].to(model.embed.device)
    if not grad:
        return loss, None
    return loss, _tree_of(mesh, model.config, [g for _, g in got],
                          model.embed.device)


class _RankStep:
    """:func:`make_train_step`'s step over ranks: the parameters stay on
    the ranks between steps, each rank updating its own slices. The
    model's parameters' version counters, read when they were last
    scattered or gathered, tell whether the caller has written them
    since."""

    def __init__(self, cfg: ModelConfig, mesh, lr: float):
        _need_axes(mesh)
        self.cfg, self.mesh, self.lr = cfg, mesh, lr
        self.key = f"train-{next(_step_keys)}"
        self._model = None
        self._versions = None

    def load(self, model: TrainLM) -> None:
        """Scatters the model's parameters to the ranks."""
        if model.config != self.cfg:
            raise ValueError("the model's config is not the step's")
        self.mesh.run(_rank_step_load, self.key, self.cfg, self.lr,
                      scatter=_scatter_of(model, self.mesh))
        self._model, self._versions = model, _versions(model)

    def __call__(self, model: TrainLM, batch):
        if model is not self._model or _versions(model) != self._versions:
            self.load(model)
        tokens, targets = (t.detach().cpu() for t in batch)
        got = self.mesh.run(_rank_step, self.key, tokens, targets)
        return got[0].to(model.embed.device)

    def gather(self, model: TrainLM = None) -> dict:
        """The full parameter tree from the ranks, on rank 0 (copied into
        ``model`` when given)."""
        got = self.mesh.run(_rank_step_gather, self.key)
        dev = model.embed.device if model is not None else \
            self.mesh.device
        tree = _tree_of(self.mesh, self.cfg, got, dev)
        if model is not None:
            model.load_params(tree)
            if model is self._model:
                self._versions = _versions(model)
        return tree


_step_keys = itertools.count()


def _versions(model: TrainLM) -> list:
    """The version counters of the model's parameters: each in-place
    write (``copy_``, an optimizer's update) moves its tensor's on."""
    return [p._version for p in _leaves(model.params_tree())]


def _rank_step_load(mesh, key, cfg, lr, scattered):
    launch.state()[key] = (cfg, lr, _local_params(scattered, mesh.device,
                                                  True))


def _rank_step(mesh, key, tokens, targets):
    cfg, lr, params = launch.state()[key]
    loss, grads = _loss_and_grads(mesh, cfg, params, tokens, targets, True)
    with torch.no_grad():
        for p, g in zip(_leaves(params), grads):
            p.copy_(p - lr * g.to(p.dtype))
    return loss


def _rank_step_gather(mesh, key):
    _, _, params = launch.state()[key]
    if not _tp_root(mesh):
        return None
    return _map_tree(lambda a: a.detach(), params)
