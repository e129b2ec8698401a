"""The port's sharded training step (brpc_tpu_torch.tpu.train with a mesh)
against the JAX package's on the CPU.

The JAX side runs on the conftest's 8 virtual CPU devices over dp2 x sp2 x
tp2, at ``tests/test_tpu.py:296-323``'s shapes (vocab 64, d_model 32, 4
heads, 2 layers, d_ff 64, S 16, B 4); its ring attention's Pallas kernels
run in interpret mode. The port lays the same mesh on ``use_cpu(8)``'s
positions and runs its plain versions. ``params_from_jax`` carries the
JAX parameters across, so both sides start from the same numbers.

Tolerances (float32 on both sides; XLA and PyTorch sum in other orders):
the sharded forward within rtol 5e-4 / atol 5e-5 of the JAX sharded
forward (the JAX package's own sharded-vs-unsharded tolerance); five
steps' losses and the parameters after one step within 1e-4; the port's
sharded loss within rtol 1e-5 of its own single-device loss.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from brpc_tpu.tpu import mesh as jax_mesh
from brpc_tpu.tpu import train as jax_train
from brpc_tpu_torch.tpu import mesh as port_mesh
from brpc_tpu_torch.tpu import train

WIDTHS = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_seq=16)
B, S = 4, 16
AXES = {"dp": 2, "sp": 2, "tp": 2}
LANES = {"flash": dict(use_flash_attention=True),
         "plain": dict(use_flash_attention=False),
         "norm": dict(use_flash_attention=True, use_pallas_norm=True)}


@pytest.fixture
def cpu8():
    port_mesh.use_cpu(8)
    yield port_mesh.make_mesh(AXES)
    port_mesh.use_cpu(0)


@pytest.fixture(scope="module")
def jax_setup():
    cfg = jax_train.ModelConfig(**WIDTHS)
    params = jax_train.init_params(jax.random.PRNGKey(0), cfg)
    batch = jax_train.demo_batch(jax.random.PRNGKey(1), cfg, B, S)
    return params, batch


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(params, lane):
    cfg = train.ModelConfig(**WIDTHS, **LANES[lane])
    model = train.TrainLM(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    model.load_params(train.params_from_jax(_np_tree(params), "cpu"))
    return model


def _torch_batch(batch):
    return tuple(torch.from_numpy(np.asarray(a).astype(np.int64))
                 for a in batch)


def _jax_step(lane):
    m = jax_mesh.make_mesh(AXES)
    cfg = jax_train.ModelConfig(**WIDTHS, **LANES[lane])
    step, pshard, bshard = jax_train.make_train_step(cfg, m, lr=1e-2)
    return m, cfg, step, pshard, bshard


@pytest.mark.parametrize("lane", sorted(LANES))
def test_sharded_forward_matches_the_jax_sharded_forward(jax_setup, cpu8,
                                                         lane):
    params, batch = jax_setup
    m, cfg, _, _, _ = _jax_step(lane)
    with m:
        ref = jax.jit(lambda p, t: jax_train.forward(p, t, cfg, mesh=m))(
            params, batch[0])
    model = _port(params, lane)
    with torch.no_grad():
        got = model(_torch_batch(batch)[0], cpu8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-4,
                               atol=5e-5)


@pytest.mark.parametrize("lane", sorted(LANES))
def test_five_sharded_steps_match_the_jax_step(jax_setup, cpu8, lane):
    params, batch = jax_setup
    _, _, jstep, pshard, bshard = _jax_step(lane)
    # from host copies: the JAX step donates its parameters
    jparams = jax.device_put(_np_tree(params), pshard)
    jbatch = jax.device_put(batch, bshard)
    model = _port(params, lane)
    step, _, _ = train.make_train_step(model.config, cpu8, lr=1e-2)
    tbatch = _torch_batch(batch)
    jlosses, losses = [], []
    for i in range(5):
        jparams, jloss = jstep(jparams, jbatch)
        jlosses.append(float(jloss))
        losses.append(float(step(model, tbatch)))
        if i == 0:
            want = jax.tree_util.tree_leaves(_np_tree(jparams))
            got = train._leaves(model.params_tree())
            assert len(want) == len(got)
            for w, g in zip(want, got):
                np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                           atol=1e-4)
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-4)
    assert losses[-1] < losses[0]  # actually learning


@pytest.mark.parametrize("lane", sorted(LANES))
def test_sharded_loss_equals_the_single_device_loss(jax_setup, cpu8, lane):
    params, batch = jax_setup
    model = _port(params, lane)
    tbatch = _torch_batch(batch)
    with torch.no_grad():
        sharded = float(train.loss_fn(model, tbatch, cpu8))
        single = float(train.loss_fn(model, tbatch))
    np.testing.assert_allclose(sharded, single, rtol=1e-5)


def test_sharded_gradients_equal_the_single_device_gradients(jax_setup,
                                                             cpu8):
    params, batch = jax_setup
    model = _port(params, "flash")
    tbatch = _torch_batch(batch)
    _, sharded = train.value_and_grad(model, tbatch, cpu8)
    _, single = train.value_and_grad(model, tbatch)
    for a, b in zip(train._leaves(sharded), train._leaves(single)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)


def _strip(spec):
    """A spec without its trailing Nones (replicated trailing dims)."""
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def test_param_shardings_record_the_jax_layout(cpu8):
    m = jax_mesh.make_mesh(AXES)
    jcfg = jax_train.ModelConfig(**WIDTHS)
    want = [tuple(s.spec) for s in
            jax.tree_util.tree_leaves(jax_train.param_shardings(jcfg, m))]
    _, pshard, bshard = train.make_train_step(train.ModelConfig(**WIDTHS),
                                              cpu8)
    got = train._leaves(pshard)
    assert [_strip(s.spec) for s in got] == [_strip(s) for s in want]
    assert all(s.mesh is cpu8 for s in got)
    assert [s.spec for s in bshard] == [("dp", "sp"), ("dp", "sp")]


def test_the_step_refuses_another_config_and_a_mesh_elsewhere(jax_setup,
                                                             cpu8):
    params, batch = jax_setup
    model = _port(params, "flash")
    step, _, _ = train.make_train_step(
        dataclasses.replace(model.config, use_pallas_norm=True), cpu8)
    with pytest.raises(ValueError, match="config"):
        step(model, _torch_batch(batch))
    meta = port_mesh.Mesh(np.array([torch.device("meta")] * 8,
                                   dtype=object).reshape(2, 2, 2),
                          ("dp", "sp", "tp"))
    with pytest.raises(ValueError, match="mesh on meta"):
        model(_torch_batch(batch)[0], meta)
