"""brpc_tpu_torch.graft_entry against the JAX package's ``__graft_entry__``.

``entry()``: the same flagship widths, and at fp32, with the JAX entry's
parameters carried across by ``train.params_from_jax``, logits equal to
the JAX forward's within the trainer's 1e-4 (the JAX flash forward in
interpret mode, the port's plain version on the CPU).

``dryrun_multichip(n)``: on ``use_cpu(n)``'s positions it prints the
reference's three OK lines (the sharded step, the collective fan-out
equal to its RPC fallback, the 256 KB ``tpu://`` echo) and restores the
caller's CPU count; its step's loss equals the JAX sharded step's
(``make_train_step`` over ``mesh_factors(n)`` of the conftest's virtual
devices) on the same weights and batch within 1e-4, plus the 5e-5 of
the printed loss's rounding to four decimals.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as jax_entry
from brpc_tpu.tpu import train as jax_train
from brpc_tpu_torch import graft_entry
from brpc_tpu_torch.tpu import mesh as port_mesh
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


def test_dryrun_multichip_prints_the_reference_ok_lines(capsys):
    port_mesh.use_cpu(0)
    graft_entry.dryrun_multichip(8)
    assert port_mesh.use_cpu(0) == 0   # the caller's count, restored
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"dryrun_multichip: mesh dp=2 sp=2 tp=2 "
                        r"loss=\d+\.\d{4} OK", lines[0]), lines
    assert lines[1] == ("dryrun fanout: collective == rpc OK "
                        "(merges=gather,sum over 8-dev mesh)")
    assert re.fullmatch(r"dryrun rpc: tpu://127\.0\.0\.1:\d+/7 256KB "
                        r"block-pool echo OK", lines[2]), lines
    assert lines[3] == "dryrun rpc: native shm-tunnel lane echo OK"


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_loss_equals_the_jax_sharded_step(capsys, n):
    from brpc_tpu.tpu import mesh as jax_mesh

    graft_entry.dryrun_multichip(n)
    loss = float(re.search(r"loss=(\S+) OK", capsys.readouterr().out)[1])
    # the dryrun's step, rebuilt: the reference's tiny shapes, seeds 0, 1
    dp, sp, tp = port_mesh.mesh_factors(n)
    heads, seq, batch = max(4, tp), 8 * sp, max(2, dp)
    widths = dict(vocab=128, d_model=16 * heads, n_heads=heads,
                  n_layers=2, d_ff=32 * heads, max_seq=seq)
    model = train.TrainLM(train.ModelConfig(**widths),
                          torch.Generator().manual_seed(0), device="cpu")
    tokens, targets = train.demo_batch(torch.Generator().manual_seed(1),
                                       model.config, batch, seq,
                                       device="cpu")
    m = jax_mesh.make_mesh({"dp": dp, "sp": sp, "tp": tp},
                           devices_list=jax.devices()[:n])
    step, pshard, bshard = jax_train.make_train_step(
        jax_train.ModelConfig(**widths), m, lr=1e-2)
    params = jax.device_put(
        train._map_tree(lambda p: p.detach().numpy(), model.params_tree()),
        pshard)
    batch_j = jax.device_put((tokens.numpy().astype(np.int32),
                              targets.numpy().astype(np.int32)), bshard)
    _, want = step(params, batch_j)
    np.testing.assert_allclose(loss, float(want), rtol=0, atol=1e-4 + 5e-5)
