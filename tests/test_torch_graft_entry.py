"""brpc_tpu_torch.graft_entry.entry() against the JAX package's
``__graft_entry__.entry()``: the same flagship widths, and at fp32, with
the JAX entry's parameters carried across by ``train.params_from_jax``,
logits equal to the JAX forward's within the trainer's 1e-4 (the JAX
flash forward in interpret mode, the port's plain version on the CPU).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as jax_entry
from brpc_tpu.tpu import train as jax_train
from brpc_tpu_torch import graft_entry
from brpc_tpu_torch.tpu import train


@pytest.fixture(scope="module")
def jax_side():
    fn, (params, tokens) = jax_entry.entry()
    return params, np.asarray(tokens)


def test_widths_and_dtype_match_the_jax_entry(jax_side):
    params, tokens = jax_side
    fn, (model, toks) = graft_entry.entry(device="cpu")
    assert toks.shape == tokens.shape == (graft_entry.BATCH,
                                          graft_entry.SEQ)
    assert model.embed.dtype == torch.bfloat16
    assert str(params["embed"].dtype) == "bfloat16"
    shapes = [tuple(a.shape) for a in train._leaves(model.params_tree())]
    assert shapes == [tuple(a.shape)
                      for a in jax.tree_util.tree_leaves(params)]
    cfg = model.config
    assert (cfg.use_flash_attention, cfg.use_pallas_norm,
            cfg.use_fused_xent) == (True, False, False)


def test_fp32_logits_match_the_jax_forward(jax_side):
    params, tokens = jax_side
    params32 = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), params)
    cfg32 = jax_train.ModelConfig(**graft_entry.FLAGSHIP,
                                  dtype=jnp.float32)
    want = np.asarray(jax_train.forward(params32, jnp.asarray(tokens),
                                        cfg32))
    fn, (model, _) = graft_entry.entry(device="cpu", dtype=torch.float32)
    model.load_params(train.params_from_jax(params32, "cpu"))
    got = fn(model, torch.from_numpy(tokens.astype(np.int64)))
    assert got.shape == want.shape == (4, 256, 2048)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
