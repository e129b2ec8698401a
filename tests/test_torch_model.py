"""Port TinyTransformer (brpc_tpu_torch.serving.model) against the JAX
package's model on the same seed: weights byte-equal, prefill and decode
pools equal and greedy tokens equal.

Two configurations: a tiny one (vocab 64, d_model 16, 2 heads, 2 layers)
and the serving corpus's (vocab 256, d_model 32, 2 heads, 2 layers,
block 16; ``tools/record_serving_corpus.py``).

Tolerance for pools: atol 1e-5 — float32 on both sides, the same
products summed in another order by XLA and by torch. Block 0 is left
out of every pool comparison: padded positions of both programs scatter
there with duplicate indices, and which write wins is unspecified.
Tokens must be equal.
"""

import numpy as np
import pytest
import torch

from brpc_tpu.serving.kv_cache import KVCacheConfig as JaxKVConfig
from brpc_tpu.serving.kv_cache import PagedKVCache as JaxKV
from brpc_tpu.serving.model import ModelConfig as JaxModelConfig
from brpc_tpu.serving.model import TinyTransformer as JaxModel
from brpc_tpu_torch.serving.kv_cache import KVCacheConfig, PagedKVCache
from brpc_tpu_torch.serving.model import ModelConfig, TinyTransformer
from brpc_tpu_torch.serving.weights import params_from_jax
from brpc_tpu_torch.tpu import pallas_ops
from brpc_tpu_torch.tpu.device_lane import step_dispatch

ATOL = 1e-5

CONFIGS = {
    "tiny": dict(vocab=64, d_model=16, n_heads=2, n_layers=2),
    "corpus": dict(vocab=256, d_model=32, n_heads=2, n_layers=2),
}
BLOCK = 16
NUM_BLOCKS = 24


def _pair(name, jax_attn="reference", torch_attn="reference", seed=0):
    kw = CONFIGS[name]
    jcfg = JaxModelConfig(attn=jax_attn, seed=seed, **kw)
    tcfg = ModelConfig(attn=torch_attn, seed=seed, **kw)
    jkv = JaxKV(JaxKVConfig(BLOCK, NUM_BLOCKS), jcfg.n_layers, jcfg.kv_dim)
    tkv = PagedKVCache(KVCacheConfig(BLOCK, NUM_BLOCKS), tcfg.n_layers,
                       tcfg.kv_dim, device="cpu")
    jkv._check = tkv._check = True
    return JaxModel(jcfg, jkv), TinyTransformer(tcfg, tkv)


def _pools_close(jm, tm):
    for jp, tp in ((jm.kv.k_pool, tm.kv.k_pool), (jm.kv.v_pool,
                                                   tm.kv.v_pool)):
        np.testing.assert_allclose(tp[:, BLOCK:].numpy(),
                                   np.asarray(jp)[:, BLOCK:],
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_weights_byte_equal(name):
    jm, tm = _pair(name)
    assert tm.param_nbytes == jm.param_nbytes
    assert tm.store.get(tm.param_handle) == jm.store.get(jm.param_handle)
    assert set(tm._params) == set(jm._params)
    for k, v in jm._params.items():
        assert tm._params[k].shape == tuple(v.shape)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_params_from_jax_round_trip(name):
    jm, _ = _pair(name)
    _, other = _pair(name, seed=5)  # different weights to overwrite
    np_params = {k: np.asarray(v) for k, v in jm._params.items()}
    other.load_params(params_from_jax(np_params, "cpu"))
    # installed through the staged buffer's views: the handle's bytes
    # are now the JAX model's bytes
    assert other.store.get(other.param_handle) == \
        jm.store.get(jm.param_handle)
    for k, v in np_params.items():
        np.testing.assert_array_equal(other._params[k].numpy(), v)


def test_load_params_rejects_wrong_names_and_shapes():
    _, tm = _pair("tiny")
    params = {k: v.clone() for k, v in tm._params.items()}
    with pytest.raises(KeyError):
        tm.load_params({k: v for k, v in params.items() if k != "embed"})
    params["embed"] = params["embed"][:-1]
    with pytest.raises(ValueError, match="embed"):
        tm.load_params(params)


def _prefill_both(jm, tm, seq_id, length):
    prompt = jm.synth_prompt(length)
    np.testing.assert_array_equal(prompt, tm.synth_prompt(length))
    jt = jm.kv.alloc_sequence(seq_id, length)
    tt = tm.kv.alloc_sequence(seq_id, length)
    assert jt == tt
    return jm.prefill(prompt, jt), tm.prefill(prompt, tt)


@pytest.mark.parametrize("length", [5, 16, 40])
@pytest.mark.parametrize("attn", ["reference", "flash"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_pools_and_first_token(name, attn, length):
    """JAX ``attn="flash"`` runs the Pallas kernel in interpret mode
    (prompts bucket to S <= 64 here); the port's ``"flash"`` on the CPU
    goes through the same wrapper the card's kernel path uses."""
    jm, tm = _pair(name, jax_attn=attn, torch_attn=attn)
    jf, tf = _prefill_both(jm, tm, 1, length)
    assert jf == tf
    _pools_close(jm, tm)
    assert pallas_ops.launches["flash_attention"] == 0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_batch_of_three(name):
    jm, tm = _pair(name)
    lengths = [3, 17, 30]
    last = {}
    for sid, n in enumerate(lengths, start=1):
        jf, tf = _prefill_both(jm, tm, sid, n)
        assert jf == tf
        last[sid] = (n, jf)
    for _ in range(4):
        sids = sorted(last)
        tokens = np.array([last[s][1] for s in sids], np.int32)
        positions = np.array([last[s][0] for s in sids], np.int32)
        jtabs = [jm.kv.extend_sequence(s, last[s][0] + 1) for s in sids]
        ttabs = [tm.kv.extend_sequence(s, last[s][0] + 1) for s in sids]
        assert jtabs == ttabs
        jn = jm.decode_step(tokens, positions, jtabs)
        before = step_dispatch.snapshot()
        tn = tm.decode_step(tokens, positions, ttabs)
        launches, _, syncs = step_dispatch.delta(before,
                                                 step_dispatch.snapshot())
        assert (launches, syncs) == (1, 1)
        assert tn.dtype == np.int32 and tn.shape == (3,)
        np.testing.assert_array_equal(tn, np.asarray(jn))
        _pools_close(jm, tm)
        for s, tok in zip(sids, tn):
            last[s] = (last[s][0] + 1, int(tok))


def test_ring_threshold_prompt_raises():
    kw = dict(CONFIGS["tiny"], ring_threshold=32)
    cfg = ModelConfig(**kw)
    kv = PagedKVCache(KVCacheConfig(BLOCK, NUM_BLOCKS), cfg.n_layers,
                      cfg.kv_dim, device="cpu")
    tm = TinyTransformer(cfg, kv)
    table = kv.alloc_sequence(1, 40)
    with pytest.raises(NotImplementedError, match="ring attention"):
        tm.prefill(tm.synth_prompt(40), table)


def test_use_flash_follows_attn_and_device():
    _, tm = _pair("tiny", torch_attn="auto")
    assert not tm._use_flash()  # auto on the CPU: the plain version
    tm.config.attn = "flash"
    assert tm._use_flash()
    with pytest.raises(ValueError, match="unknown attn"):
        ModelConfig(attn="ring")


def test_close_frees_the_weight_handle():
    _, tm = _pair("tiny")
    h = tm.param_handle
    assert tm.store.lookup(h) is not None
    tm.close()
    assert tm.store.lookup(h) is None
    assert isinstance(tm, torch.nn.Module)
