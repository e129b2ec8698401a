"""Port training step (brpc_tpu_torch.tpu.train) against the JAX package's
``brpc_tpu/tpu/train.py`` on the CPU.

The JAX side makes the parameters (``init_params(PRNGKey(0))``) and the
batch; ``params_from_jax`` carries them across, so both sides start from
the same numbers. The JAX side runs its Pallas kernels in interpret mode
(its default off a TPU); the port runs its plain versions, which
``chip_smoke.py`` holds its CUDA kernels to on the card.

The shipping configuration (``tools/kernel_bench.py:397-398``) adds
``use_fused_xent``: the loss through ``softmax_xent`` on both sides.

Tolerances (float32 on both sides; XLA and PyTorch sum in other orders):
logits atol 1e-4, loss rtol 1e-5, gradients rtol 1e-4 atol 1e-5,
parameters after three SGD steps atol 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from brpc_tpu.tpu import train as jax_train
from brpc_tpu_torch.tpu import pallas_ops
from brpc_tpu_torch.tpu import train

WIDTHS = dict(vocab=64, d_model=64, n_heads=2, n_layers=2, d_ff=128,
              max_seq=128)
B, S = 2, 128
KERNELS = {"on": dict(use_flash_attention=True, use_pallas_norm=True),
           "off": dict(use_flash_attention=False, use_pallas_norm=False),
           "shipping": dict(use_flash_attention=True, use_pallas_norm=True,
                            use_fused_xent=True)}


@pytest.fixture(scope="module")
def jax_setup():
    cfg = jax_train.ModelConfig(**WIDTHS)
    params = jax_train.init_params(jax.random.PRNGKey(0), cfg)
    batch = jax_train.demo_batch(jax.random.PRNGKey(1), cfg, B, S)
    return params, batch


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(params, kernels="on", **extra):
    cfg = train.ModelConfig(**WIDTHS, **KERNELS[kernels], **extra)
    model = train.TrainLM(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    model.load_params(train.params_from_jax(_np_tree(params), "cpu"))
    return model


def _torch_batch(batch):
    return tuple(torch.from_numpy(np.asarray(a).astype(np.int64))
                 for a in batch)


def _jax_cfg(kernels):
    return jax_train.ModelConfig(**WIDTHS, **KERNELS[kernels])


def test_config_fields_and_defaults_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(train.ModelConfig)}
    theirs = {f.name: f.default
              for f in dataclasses.fields(jax_train.ModelConfig)}
    assert ours.keys() == theirs.keys()
    assert ours.pop("dtype") == torch.float32
    theirs.pop("dtype")
    assert ours == theirs
    assert train.ModelConfig(d_model=1024, n_heads=8).head_dim == 128


def test_params_from_jax_round_trips(jax_setup):
    params, _ = jax_setup
    model = _port(params)
    ours = model.params_tree()
    flat_j = jax.tree_util.tree_leaves(_np_tree(params))
    flat_t = train._leaves(ours)
    assert len(flat_j) == len(flat_t) == len(list(model.parameters()))
    for a, p in zip(flat_j, flat_t):
        assert p.dtype == torch.float32
        np.testing.assert_array_equal(p.detach().numpy(), a)
    assert ours["layers"][1]["wqkv"].shape == (64, 192)
    assert ours["head"].shape == ours["embed"].shape == (64, 64)


def test_params_from_jax_casts_to_dtype(jax_setup):
    params, _ = jax_setup
    tree = train.params_from_jax(_np_tree(params), "cpu", torch.bfloat16)
    assert tree["layers"][0]["w2"].dtype == torch.bfloat16
    assert tree["layers"][0]["w2"].shape == (128, 64)


def test_load_params_refuses_wrong_shapes(jax_setup):
    params, _ = jax_setup
    model = _port(params)
    tree = _np_tree(params)
    tree["layers"][0]["w1"] = np.zeros((64, 64), np.float32)
    with pytest.raises(ValueError, match="shape"):
        model.load_params(tree)


def test_init_scale_and_structure():
    cfg = train.ModelConfig(**WIDTHS)
    model = train.TrainLM(cfg, torch.Generator().manual_seed(3),
                          device="cpu")
    tree = model.params_tree()
    assert len(tree["layers"]) == 2
    assert torch.equal(tree["ln_f"], torch.ones(64))
    std = float(tree["layers"][0]["w1"].detach().std())
    assert abs(std - 64 ** -0.5) < 0.1 * 64 ** -0.5
    same = train.TrainLM(cfg, torch.Generator().manual_seed(3),
                         device="cpu")
    assert torch.equal(same.embed, model.embed)


@pytest.mark.parametrize("kernels", ["on", "off"])
def test_logits_match_jax_forward(jax_setup, kernels):
    params, batch = jax_setup
    want = jax_train.forward(params, batch[0], _jax_cfg(kernels))
    got = _port(params, kernels)(_torch_batch(batch)[0])
    assert got.shape == (B, S, 64)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("kernels", ["on", "off", "shipping"])
def test_loss_and_grads_match_jax(jax_setup, kernels):
    params, batch = jax_setup
    loss_j, grads_j = jax.value_and_grad(jax_train.loss_fn)(
        params, batch, _jax_cfg(kernels))
    loss, grads = train.value_and_grad(_port(params, kernels),
                                       _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    flat_j = jax.tree_util.tree_leaves(grads_j)
    flat_t = train._leaves(grads)
    assert len(flat_j) == len(flat_t) == 15
    for a, g in zip(flat_j, flat_t):
        np.testing.assert_allclose(g.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-5)


def test_three_sgd_steps_track_jax(jax_setup):
    _three_sgd_steps(*jax_setup, "on")


def test_three_sgd_steps_with_fused_xent_track_jax(jax_setup):
    _three_sgd_steps(*jax_setup, "shipping")


def _three_sgd_steps(params, batch, kernels):
    cfg_j = _jax_cfg(kernels)
    model = _port(params, kernels)
    tb = _torch_batch(batch)
    losses_j, losses = [], []
    for _ in range(3):
        params, loss_j = jax_train.sgd_train_step(params, batch, cfg_j,
                                                  lr=1e-2)
        losses_j.append(float(loss_j))
        losses.append(float(train.sgd_train_step(model, tb, lr=1e-2)))
    np.testing.assert_allclose(losses, losses_j, rtol=1e-5)
    assert losses[-1] < losses[0]
    for a, p in zip(jax.tree_util.tree_leaves(_np_tree(params)),
                    train._leaves(model.params_tree())):
        np.testing.assert_allclose(p.detach().numpy(), a, atol=1e-5, rtol=0)


def test_sgd_step_updates_in_place_in_param_dtype(jax_setup):
    params, batch = jax_setup
    cfg = train.ModelConfig(**WIDTHS, dtype=torch.bfloat16)
    model = train.TrainLM(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    model.load_params(_np_tree(params))
    before = model.head.detach().clone()
    ptr = model.head.data_ptr()
    loss = train.sgd_train_step(model, _torch_batch(batch), lr=1e-2)
    assert torch.isfinite(loss) and loss.dtype == torch.float32
    assert model.head.dtype == torch.bfloat16
    assert model.head.data_ptr() == ptr
    assert not torch.equal(model.head, before)


def test_demo_batch_targets_are_rolled_tokens():
    cfg = train.ModelConfig(**WIDTHS)
    tokens, targets = train.demo_batch(torch.Generator().manual_seed(1),
                                       cfg, 3, 16, device="cpu")
    assert tokens.shape == targets.shape == (3, 16)
    assert tokens.dtype == torch.int64
    assert int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab
    assert torch.equal(targets, torch.roll(tokens, -1, dims=1))


def test_cpu_training_launches_no_kernel(jax_setup):
    params, batch = jax_setup
    before = pallas_ops.launches.snapshot()
    train.value_and_grad(_port(params), _torch_batch(batch))
    assert pallas_ops.launches.snapshot() == before


def test_mesh_is_not_ported(jax_setup):
    params, batch = jax_setup
    model = _port(params)
    with pytest.raises(NotImplementedError, match="mesh"):
        model(_torch_batch(batch)[0], mesh=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        train.sgd_train_step(model, _torch_batch(batch), mesh=object())


def test_fused_xent_loss_equals_the_plain_loss(jax_setup):
    params, batch = jax_setup
    model = _port(params, "shipping")
    fused = train.loss_fn(model, _torch_batch(batch))
    model.config = _port(params).config
    plain = train.loss_fn(model, _torch_batch(batch))
    np.testing.assert_allclose(float(fused.detach()), float(plain.detach()),
                               rtol=1e-6)


def test_fused_xent_loss_goes_through_softmax_xent(jax_setup, monkeypatch):
    params, batch = jax_setup
    calls = []
    xent = pallas_ops.softmax_xent

    def spy(logits, targets, *a):
        calls.append((tuple(logits.shape), logits.dtype, tuple(targets.shape)))
        return xent(logits, targets, *a)

    monkeypatch.setattr(pallas_ops, "softmax_xent", spy)
    train.value_and_grad(_port(params, "shipping"), _torch_batch(batch))
    assert calls == [((B * S, 64), torch.float32, (B * S,))]


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = train.ModelConfig(**WIDTHS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.TrainLM(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.demo_batch(torch.Generator(), cfg, 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.params_from_jax({"ln_f": np.ones(4, np.float32)}, None)
