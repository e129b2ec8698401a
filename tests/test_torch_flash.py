"""Port flash attention (brpc_tpu_torch.tpu.pallas_ops) against the JAX
package's Pallas kernel, run in interpret mode, and its reference.

On the CPU the port's ``flash_attention`` computes through its plain
version, so these tests hold that plain version (and the wrapper's shape
handling, block checks and launch counter) to the TPU kernel's numerics.
The CUDA kernel itself is held to the same plain version on the card by
``chip_smoke.py``.

Tolerance: atol 1e-5 — float32 on both sides, inputs of unit scale, only
the order of the sums differs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brpc_tpu.tpu import pallas_ops as jax_ops
from brpc_tpu_torch.tpu import pallas_ops as torch_ops

ATOL = 1e-5


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _jax_flash(q, k, v, causal, block):
    fn = lambda a, b, c: jax_ops.flash_attention(  # noqa: E731
        a, b, c, causal=causal, block_q=block, block_k=block,
        interpret=True)
    if q.ndim == 3:
        fn = jax.vmap(fn, in_axes=1, out_axes=1)
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


def _jax_reference(q, k, v, causal):
    fn = lambda a, b, c: jax_ops.attention_reference(  # noqa: E731
        a, b, c, causal=causal)
    if q.ndim == 3:
        fn = jax.vmap(fn, in_axes=1, out_axes=1)
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", [0, 2])
@pytest.mark.parametrize("S", [16, 64, 128])
def test_flash_matches_jax_kernel(S, heads, causal):
    D = 16
    shape = (S, heads, D) if heads else (S, D)
    q, k, v = _inputs(shape, seed=S + heads)
    block = 64 if S == 128 else 128
    want_kernel = _jax_flash(q, k, v, causal, block)
    want_ref = _jax_reference(q, k, v, causal)
    got = torch_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal,
                                    block_q=block, block_k=block)
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want_kernel, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_reference_matches_jax_on_strided_heads_view(causal):
    """The serving model passes (S, H, hd) views of its fused QKV product
    (row stride 3 * d_model); the result must not depend on the layout."""
    S, H, hd = 32, 4, 16
    rng = np.random.RandomState(7)
    qkv = rng.standard_normal((S, 3 * H * hd)).astype(np.float32)
    t = torch.from_numpy(qkv)
    q, k, v = (x.view(S, H, hd) for x in t.split(H * hd, dim=-1))
    assert not q.is_contiguous()
    got = torch_ops.flash_attention(q, k, v, causal=causal)
    qn, kn, vn = (np.ascontiguousarray(x.numpy()) for x in (q, k, v))
    np.testing.assert_allclose(got.numpy(),
                               _jax_reference(qn, kn, vn, causal),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("sq,sk,block", [(96, 96, 64), (128, 80, 64),
                                         (48, 128, 32)])
def test_misaligned_lengths_raise_like_jax(sq, sk, block):
    q = np.zeros((sq, 16), np.float32)
    k = np.zeros((sk, 16), np.float32)
    with pytest.raises(ValueError):
        jax_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(k), block_q=block,
                                block_k=block, interpret=True)
    with pytest.raises(ValueError, match="must divide blocks"):
        torch_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(k), block_q=block,
                                  block_k=block)


def test_rank_mismatch_raises():
    with pytest.raises(ValueError, match=r"\(S, D\) or \(S, H, D\)"):
        torch_ops.flash_attention(torch.zeros(16, 2, 16), torch.zeros(16, 16),
                                  torch.zeros(16, 16))


def test_cpu_path_never_counts_a_launch():
    before = torch_ops.launches["flash_attention"]
    q, k, v = (torch.from_numpy(x) for x in _inputs((64, 4, 16), seed=3))
    torch_ops.flash_attention(q, k, v, causal=True)
    torch_ops.attention_reference(q, k, v, causal=True)
    assert torch_ops.launches["flash_attention"] == before == 0


def test_causal_row_zero_attends_only_key_zero():
    q, k, v = (torch.from_numpy(x) for x in _inputs((16, 16), seed=5))
    out = torch_ops.flash_attention(q, k, v, causal=True)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out[0].numpy(), v[0].numpy(), atol=ATOL)
