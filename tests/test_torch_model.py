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

Long prompts (``ring_threshold`` 32 at the tiny config): the JAX
``_prefill_ring`` runs the lax ring over a one-device ``sp`` mesh (its
model's ``mesh``; "single-device meshes degenerate to one hop"), the
port's ring has one position (sp 1): greedy tokens equal, pools within
1e-5 outside block 0. Over the default mesh of the conftest's 8 CPU
devices the JAX ring prefill raises before it computes anything (its
inputs live on device 0, its shard_map on all 8); that fault of the
reference is held as it is, beside the port serving the same prompt.
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


def _pair(name, jax_attn="reference", torch_attn="reference", seed=0,
          **extra):
    kw = dict(CONFIGS[name], **extra)
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


def _ring_pair():
    """The tiny pair at ``ring_threshold`` 32, the JAX model on a
    one-device ``sp`` mesh (its single-device case: one hop)."""
    import jax

    from brpc_tpu.tpu.mesh import make_mesh

    jm, tm = _pair("tiny", ring_threshold=32)
    jm.mesh = make_mesh({"sp": 1}, jax.devices()[:1])
    return jm, tm


def test_ring_threshold_prompt_raises():
    """A prompt at ``ring_threshold`` takes the ring path, which refuses a
    table with a shared block before it writes anything, as the JAX
    ``_prefill_ring`` does (the armed ledger's copy-on-write guard)."""
    jm, tm = _pair("tiny", ring_threshold=32)
    for m in (jm, tm):
        m.kv.alloc_sequence(1, 40)
        table = m.kv.fork_sequence(1, 2)
        with pytest.raises(AssertionError, match="cow violation"):
            m.prefill(m.synth_prompt(40), table)
    assert not tm.kv.k_pool.any() and not tm.kv.v_pool.any()
    assert not np.asarray(jm.kv.k_pool).any()


@pytest.mark.parametrize("length", [32, 40, 77])
def test_ring_prefill_matches_jax(length):
    """Prompts at and past ``ring_threshold`` (32, 40: block-aligned and
    not; 77: off every block and the JAX ring's 8-way split): the first
    token and three decode steps after it equal the JAX model's, the
    pools agree outside scratch block 0, and the port's ring prefill
    notes one launch per layer and one host sync."""
    jm, tm = _ring_pair()
    prompt = tm.synth_prompt(length)
    jt = jm.kv.alloc_sequence(1, length)
    tt = tm.kv.alloc_sequence(1, length)
    jf = jm.prefill(prompt, jt)
    before = step_dispatch.snapshot()
    tf = tm.prefill(prompt, tt)
    launches, _, syncs = step_dispatch.delta(before,
                                             step_dispatch.snapshot())
    assert (launches, syncs) == (tm.config.n_layers, 1)
    assert tf == jf
    _pools_close(jm, tm)
    tok, pos = tf, length
    for _ in range(3):
        jt = jm.kv.extend_sequence(1, pos + 1)
        assert tm.kv.extend_sequence(1, pos + 1) == jt
        want = np.asarray(jm.decode_step(np.array([tok], np.int32),
                                         np.array([pos], np.int32), [jt]))
        got = tm.decode_step(np.array([tok], np.int32),
                             np.array([pos], np.int32), [jt])
        np.testing.assert_array_equal(got, want)
        _pools_close(jm, tm)
        tok, pos = int(got[0]), pos + 1


def test_ring_prefill_through_the_engine():
    """One engine request past ``ring_threshold`` on each package: the
    same greedy tokens, and the port's pool idle afterwards."""
    import threading

    from brpc_tpu.serving import EngineConfig as JaxEngineConfig
    from brpc_tpu.serving import ServingEngine as JaxEngine
    from brpc_tpu_torch.serving import EngineConfig, ServingEngine

    jm, tm = _ring_pair()
    out = []
    for m, engine_cls, cfg_cls in ((jm, JaxEngine, JaxEngineConfig),
                                   (tm, ServingEngine, EngineConfig)):
        m.kv._check = True
        engine = engine_cls(m, m.kv, cfg_cls(max_batch=4, token_budget=256,
                                             idle_wait_s=0.002),
                            prefix_cache=False).start()
        ev = threading.Event()
        try:
            code, seq = engine.submit(m.synth_prompt(77), 6,
                                      done=lambda r, ev=ev: ev.set())
            assert code == 0 and ev.wait(120)
            out.append([int(t) for t in seq.out_tokens])
        finally:
            engine.stop()
        m.kv.assert_idle()
    assert out[0] == out[1] and len(out[1]) == 6


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


def test_jax_ring_prefill_on_the_default_mesh_fails_port_serves():
    """The reference's fault (ROADMAP Queue 3): on the default ``sp`` mesh
    of the conftest's 8 CPU devices the JAX ring prefill raises (its
    inputs are committed to device 0, its shard_map spans all 8), while
    the port serves the same prompt and writes its K/V."""
    jm, tm = _pair("tiny", ring_threshold=32)
    assert jm.mesh is None
    jt = jm.kv.alloc_sequence(1, 40)
    with pytest.raises(ValueError, match="incompatible devices"):
        jm.prefill(jm.synth_prompt(40), jt)
    tt = tm.kv.alloc_sequence(1, 40)
    first = tm.prefill(tm.synth_prompt(40), tt)
    assert 0 <= first < tm.config.vocab
    assert tm.kv.k_pool[:, BLOCK:].abs().sum() > 0
