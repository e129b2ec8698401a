"""``TrainLM.forward`` over a mesh with a rank per position
(brpc_tpu_torch.tpu.train) against the JAX package's sharded ``forward``
on the CPU.

The port side runs as 8 gloo ranks on the CPU (dp2 x sp2 x tp2, this
process rank 0), launched ONCE for the module by the ``ranked`` fixture,
which runs every case's port side and keeps numpy results; each test
compares its own case. The JAX side is ``brpc_tpu.tpu.train.forward`` on
the conftest's 8 virtual CPU devices over the same axes (its ring's
Pallas kernels in interpret mode); the port's single-controller replay is
``TrainLM.forward`` over ``use_cpu(8)``'s positions. Widths are
``tests/test_torch_sharded_train.py``'s, and ``params_from_jax`` carries
the JAX parameters across.

What is held:

- the ranked forward's ``[B, S, V]`` logits on rank 0, in every lane
  (both attention lanes, and the RMSNorm kernel's), causal and not,
  within 1e-4 of the JAX forward and of the replay;
- the ranked loss, its gradients and one ``make_train_step`` step are
  bit for bit what the loss gave before its logits half was shared with
  the forward: ``_loss_before_refactor`` below is that loss as it stood,
  run as a rank program of this module on the same ranks.

Tolerances: logits 1e-4 absolute (float32 on every side; XLA and PyTorch
sum in other orders); the loss, its gradients and a step's parameters
exact.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax

from brpc_tpu.tpu import mesh as jax_mesh
from brpc_tpu.tpu import train as jax_train
from brpc_tpu_torch.tpu import launch, pallas_ops, ring, train
from brpc_tpu_torch.tpu import mesh as port_mesh
from tests.test_torch_tracemalloc_guard import (  # noqa: F401
    no_leaked_tracemalloc, no_leaked_tracemalloc_in_module)

AXES = {"dp": 2, "sp": 2, "tp": 2}
WIDTHS = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_seq=16)
B, S = 4, 16
LANES = {"flash": dict(use_flash_attention=True),
         "plain": dict(use_flash_attention=False),
         "norm": dict(use_flash_attention=True, use_pallas_norm=True)}
LOGIT_TOL = 1e-4
LR = 1e-2


def _loss_before_refactor(cfg, p, tokens, targets, mesh, n_tokens):
    """``train._rank_loss`` as it stood before ``_rank_logits`` was
    taken out of it, kept verbatim as the oracle of that refactor."""
    tp, t = mesh.shape["tp"], mesh.coord("tp")
    g = mesh.group("tp")

    def f(x):
        return train._TpCopy.apply(x, g) if tp > 1 else x

    def gsum(x):
        return train._TpSum.apply(x, g) if tp > 1 else x

    def norm(x, w):
        if cfg.use_pallas_norm:
            return pallas_ops.rmsnorm(x, w)
        return pallas_ops.rmsnorm_reference(x, w)

    b, s = tokens.shape
    hl, dh = cfg.n_heads // tp, cfg.head_dim
    x = p["embed"][tokens].to(cfg.dtype)
    if tp > 1:
        x = train._TpGather.apply(x, g, t)
    for layer in p["layers"]:
        qkv = (f(norm(x, layer["ln1"])) @ layer["wqkv"]).reshape(
            b, s, 3, hl, dh)
        att = ring.ring_attention_local(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mesh, "sp",
            causal=True, use_flash=cfg.use_flash_attention)
        x = x + gsum(att.reshape(b, s, hl * dh) @ layer["wo"])
        h = f(norm(x, layer["ln2"]))
        x = x + gsum(F.gelu(h @ layer["w1"], approximate="tanh")
                     @ layer["w2"])
    logits = (f(norm(x, p["ln_f"])) @ p["head"]).float()
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


def _rank_value_and_grad_before(mesh, cfg, tokens, targets, scattered):
    """``train._rank_value_and_grad`` over ``_loss_before_refactor``."""
    params = train._local_params(scattered, mesh.device, True)
    tok = mesh.block(tokens, ("dp", "sp")).to(mesh.device)
    tgt = mesh.block(targets, ("dp", "sp")).to(mesh.device)
    leaves = train._leaves(params)
    loss = _loss_before_refactor(cfg, params, tok, tgt, mesh,
                                 tokens.numel())
    grads = train._reduce_grads(torch.autograd.grad(loss, leaves), mesh)
    loss = launch.all_reduce(loss.detach(), mesh.group("dp", "sp"))
    if not train._tp_root(mesh):
        return loss, None
    it = iter(grads)
    return loss, train._map_tree(lambda p: next(it).to(p.dtype), params)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_setup():
    cfg = jax_train.ModelConfig(**WIDTHS)
    params = jax_train.init_params(jax.random.PRNGKey(0), cfg)
    batch = jax_train.demo_batch(jax.random.PRNGKey(1), cfg, B, S)
    return _np_tree(params), tuple(np.asarray(a) for a in batch)


def _model(params, lane):
    cfg = train.ModelConfig(**WIDTHS, **LANES[lane])
    model = train.TrainLM(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    model.load_params(train.params_from_jax(params, "cpu"))
    return model


def _batch(batch):
    return tuple(torch.from_numpy(a.astype(np.int64)) for a in batch)


def _leaves_np(tree):
    return [t.detach().numpy() for t in train._leaves(tree)]


@pytest.fixture(scope="module")
def ranked(jax_setup):
    """Every case's port side over one launch of 8 CPU ranks."""
    params, batch = jax_setup
    tokens, targets = _batch(batch)
    out = {"forward": {}, "loss": {}}
    group = launch.launch(AXES, device="cpu")
    try:
        m = group.mesh
        for lane in sorted(LANES):
            model = _model(params, lane)
            for causal in (True, False):
                logits = model(tokens, m, causal=causal)
                out["forward"][lane, causal] = (logits.numpy(),
                                                logits.requires_grad)
        for lane in LANES:
            model = _model(params, lane)
            loss_fn = train.loss_fn(model, (tokens, targets), m)
            loss, grads = train.value_and_grad(model, (tokens, targets), m)
            got = m.run(_rank_value_and_grad_before, model.config, tokens,
                        targets, scatter=train._scatter_of(model, m))
            before = (got[0][0], train._tree_of(
                m, model.config, [g for _, g in got], torch.device("cpu")))
            step, _, _ = train.make_train_step(model.config, m, lr=LR)
            step_loss = step(model, (tokens, targets))
            stepped = step.gather()
            out["loss"][lane] = {
                "loss_fn": loss_fn.numpy(), "loss": loss.numpy(),
                "grads": _leaves_np(grads), "before_loss": before[0].numpy(),
                "before_grads": _leaves_np(before[1]),
                "step_loss": step_loss.numpy(),
                "stepped": _leaves_np(stepped),
                "start": _leaves_np(train._map_tree(
                    lambda a: a.detach(), model.params_tree()))}
    finally:
        group.close()
    return out


@pytest.fixture
def cpu8():
    port_mesh.use_cpu(8)
    yield port_mesh.make_mesh(AXES)
    port_mesh.use_cpu(0)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("lane", sorted(LANES))
def test_ranked_forward_equals_the_jax_forward(ranked, jax_setup, lane,
                                               causal):
    params, batch = jax_setup
    m = jax_mesh.make_mesh(AXES)
    cfg = jax_train.ModelConfig(**WIDTHS, **LANES[lane])
    with m:
        want = jax.jit(lambda p, t: jax_train.forward(
            p, t, cfg, mesh=m, causal=causal))(params, batch[0])
    got, has_graph = ranked["forward"][lane, causal]
    assert got.shape == (B, S, WIDTHS["vocab"]) and got.dtype == np.float32
    assert not has_graph
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=LOGIT_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("lane", sorted(LANES))
def test_ranked_forward_equals_the_single_controller_replay(
        ranked, jax_setup, cpu8, lane, causal):
    params, batch = jax_setup
    model = _model(params, lane)
    with torch.no_grad():
        want = model(_batch(batch)[0], cpu8, causal=causal)
    got, _ = ranked["forward"][lane, causal]
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=LOGIT_TOL)


def test_causal_and_full_ranked_forwards_differ(ranked):
    # the flag reaches the ranks' ring: a full forward is another function
    for lane in sorted(LANES):
        a, _ = ranked["forward"][lane, True]
        b, _ = ranked["forward"][lane, False]
        assert np.abs(a - b).max() > 1e-3


@pytest.mark.parametrize("lane", sorted(LANES))
def test_ranked_loss_and_grads_are_the_loss_before_the_refactor(ranked,
                                                                 lane):
    r = ranked["loss"][lane]
    np.testing.assert_array_equal(r["loss"], r["before_loss"])
    np.testing.assert_array_equal(r["loss_fn"], r["before_loss"])
    assert len(r["grads"]) == len(r["before_grads"])
    for a, b in zip(r["grads"], r["before_grads"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("lane", sorted(LANES))
def test_a_ranked_step_is_the_step_before_the_refactor(ranked, lane):
    """make_train_step over ranks: the step's loss is the old loss and
    its parameters are each ``p - lr * g`` of the old gradients."""
    r = ranked["loss"][lane]
    np.testing.assert_array_equal(r["step_loss"], r["before_loss"])
    for p, g, got in zip(r["start"], r["before_grads"], r["stepped"]):
        want = (torch.from_numpy(p) - LR * torch.from_numpy(g)).numpy()
        np.testing.assert_array_equal(got, want)


def test_forward_over_ranks_needs_the_three_axes(jax_setup):
    model = _model(jax_setup[0], "plain")

    class _Flat:
        ranked = True
        shape = {"x": 8}
        axis_names = ("x",)

    with pytest.raises(ValueError, match="needs a 'dp' axis"):
        model(torch.zeros(2, 8, dtype=torch.int64), _Flat())
