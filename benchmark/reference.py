"""The plain reference of the training step the cells time.

``TrainLM``'s equations (``brpc_tpu_torch/tpu/train.py``) in plain PyTorch,
computed in fp32 with TF32 off: the embedding gather; per layer a pre-norm
RMSNorm (eps 1e-6, a weight), the QKV product, causal softmax attention
at 1/sqrt(head_dim), the output product and a residual add, a second
RMSNorm, the MLP (GELU's tanh form between two products) and a residual
add; a final RMSNorm and the head; the mean next-token cross-entropy; the
gradients; and SGD, ``p - lr * g``. The parameters are kept in the dtype
the configuration states for them: each update is computed in fp32 and
stored rounded to that dtype, as the configuration's parameters are
stored. This module imports nothing of the program.

The batch runs in blocks of sequences, each layer under activation
checkpointing, so that a step at the cells' sizes fits on one card beside
the fp32 parameters and gradients.

``quant="fp8"`` is the control, the step in fp8 as fp8 training runs it:
every product's operands in e4m3 forward and its incoming gradient in
e5m2 backward, each at a scale per tensor, products accumulated in fp32.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LAYER_KEYS = ("ln1", "wqkv", "wo", "ln2", "w1", "w2")
EPS = 1e-6
BLOCK_TOKENS = 8192     # tokens a block of sequences holds at most


def leaf_names(n_layers: int) -> list:
    """Every parameter's name: ``embed [V, D]``, ``head [D, V]``, ``ln_f
    [D]`` and ``layers.<i>.<key>`` for each key of LAYER_KEYS."""
    return ["embed", "head", "ln_f"] + [f"layers.{i}.{k}"
                                        for i in range(n_layers)
                                        for k in LAYER_KEYS]


def leaf_shapes(m: dict) -> dict:
    """Each parameter's shape; ``m`` holds ModelConfig's fields."""
    d, f, v = m["d_model"], m["d_ff"], m["vocab"]
    layer = {"ln1": (d,), "wqkv": (d, 3 * d), "wo": (d, d), "ln2": (d,),
             "w1": (d, f), "w2": (f, d)}
    shapes = {"embed": (v, d), "head": (d, v), "ln_f": (d,)}
    for i in range(m["n_layers"]):
        shapes.update({f"layers.{i}.{k}": s for k, s in layer.items()})
    return shapes


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for fp32 products while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def _round_fp8(t, dtype):
    """t rounded to an fp8 format at a per-tensor scale that maps its
    largest magnitude to the format's largest finite value."""
    top = torch.finfo(dtype).max
    scale = top / t.abs().amax().clamp_min(1e-30)
    return (t * scale).to(dtype).float() / scale


class _Fp8Product(torch.autograd.Function):
    """a @ b as fp8 training computes it: both operands in e4m3 forward;
    backward, the incoming gradient in e5m2 against the saved e4m3
    operands, products accumulated in fp32."""

    @staticmethod
    def forward(ctx, a, b):
        qa = _round_fp8(a, torch.float8_e4m3fn)
        qb = _round_fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _round_fp8(g, torch.float8_e5m2)
        da = qg @ qb.transpose(-1, -2)
        db = qa.transpose(-1, -2) @ qg
        # broadcast batch dims of a 2-D operand are summed away
        while db.dim() > qb.dim():
            db = db.sum(0)
        return da, db


def _rmsnorm(x, w):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * w


def _gelu(x):
    return F.gelu(x, approximate="tanh")


class Step:
    """One configuration's step in fp32. ``m`` holds ModelConfig's fields;
    ``params`` maps :func:`leaf_names` to the initial parameters, in the
    dtype they are stored in (``state_dtype``)."""

    def __init__(self, m: dict, params: dict, lr: float, quant: str = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"quant {quant!r}: None or 'fp8'")
        self.m, self.lr = m, lr
        self.fp8 = quant == "fp8"
        self.state_dtype = params["embed"].dtype
        self.w = {k: p.detach().float() for k, p in params.items()}

    def _mm(self, a, b):
        return _Fp8Product.apply(a, b) if self.fp8 else a @ b

    def _attention(self, q, k, v):
        """Causal softmax attention over [B, H, S, Dh] in fp32."""
        s = self._mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        n = s.shape[-1]
        live = torch.ones(n, n, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~live, float("-inf"))
        return self._mm(torch.softmax(s, dim=-1), v)

    def _layer(self, x, i):
        w = self.w
        b, s, d = x.shape
        h_, dh = self.m["n_heads"], d // self.m["n_heads"]
        p = {k: w[f"layers.{i}.{k}"] for k in LAYER_KEYS}
        qkv = self._mm(_rmsnorm(x, p["ln1"]), p["wqkv"]).reshape(
            b, s, 3, h_, dh)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        att = self._attention(q, k, v).transpose(1, 2).reshape(b, s, d)
        x = x + self._mm(att, p["wo"])
        h = _rmsnorm(x, p["ln2"])
        return x + self._mm(_gelu(self._mm(h, p["w1"])), p["w2"])

    def _block_loss(self, tokens, targets, n_total: int):
        """The block's share of the batch's mean loss: its summed NLL over
        all of the batch's tokens."""
        x = self.w["embed"][tokens]
        for i in range(self.m["n_layers"]):
            x = checkpoint(self._layer, x, i, use_reentrant=False)
        logits = self._mm(_rmsnorm(x, self.w["ln_f"]), self.w["head"])
        nll = torch.logsumexp(logits, -1) - torch.gather(
            logits, -1, targets[..., None])[..., 0]
        return nll.sum() / n_total

    def grads(self, tokens, targets):
        """(loss, {name: fp32 gradient}) at the current parameters."""
        for p in self.w.values():
            p.requires_grad_(True)
            p.grad = None
        b, s = tokens.shape
        rows = max(1, BLOCK_TOKENS // s)
        loss = 0.0
        with fp32_exact():
            for r in range(0, b, rows):
                part = self._block_loss(tokens[r:r + rows],
                                        targets[r:r + rows], b * s)
                part.backward()
                loss += part.item()
        grads = {k: p.grad for k, p in self.w.items()}
        for p in self.w.values():
            p.requires_grad_(False)
            p.grad = None
        return loss, grads

    @torch.no_grad()
    def update(self, grads) -> None:
        """SGD as the configuration states it: ``p - lr * g`` with the
        gradient cast to the parameter's dtype and the product and the
        difference taken in that dtype."""
        for k, g in grads.items():
            p = self.w[k].to(self.state_dtype)
            self.w[k] = (p - self.lr * g.to(self.state_dtype)).float()


def readings(step: Step, batches, initial: dict) -> dict:
    """What the check compares, from ``len(batches)`` steps of ``step``
    (see :func:`benchmark.check.compare`): each step's loss, each
    parameter's first gradient as SGD applied it (the change after one
    step over lr), the state after one step (on the host), the change
    after the last step, the norms of the true first gradient, by which
    near-zero leaves are left out, and how many elements of each
    parameter the first step moved and the last left moved, by which
    leaves of a few moved elements are left out of the norm gaps."""
    losses, first, true_grad, state, first_moved = [], {}, {}, {}, {}
    for n, (tokens, targets) in enumerate(batches):
        loss, grads = step.grads(tokens, targets)
        losses.append(loss)
        if n == 0:
            true_grad = {k: float(g.norm()) for k, g in grads.items()}
        step.update(grads)
        del grads
        if n == 0:
            first = change_norms(step.w, initial, 1.0 / step.lr)
            first_moved = moved_counts(step.w, initial)
            state = host_copy(step.w, step.state_dtype)
    return {"losses": losses, "first_grad": first, "first_state": state,
            "lr": step.lr, "change": change_norms(step.w, initial),
            "true_grad": true_grad, "first_moved": first_moved,
            "moved": moved_counts(step.w, initial)}


@torch.no_grad()
def moved_counts(now: dict, initial: dict) -> dict:
    """{name: how many of the parameter's elements differ from
    ``initial``}."""
    return {k: int((now[k].float() != initial[k].float()).sum())
            for k in initial}


@torch.no_grad()
def change_norms(now: dict, initial: dict, scale: float = 1.0) -> dict:
    """{name: ||now - initial|| * scale} in fp32."""
    return {k: float((now[k].float() - initial[k].float()).norm()) * scale
            for k in initial}


@torch.no_grad()
def host_copy(params: dict, dtype) -> dict:
    """{name: the parameter in ``dtype`` on the host} (exact: the state's
    values are ``dtype``'s)."""
    return {k: p.detach().to(dtype).to("cpu", copy=True)
            for k, p in params.items()}
