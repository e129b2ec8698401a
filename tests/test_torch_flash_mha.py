"""Port training flash attention (brpc_tpu_torch.tpu.pallas_ops) against
the JAX package's Pallas kernels, run in interpret mode.

On the CPU the port's wrappers compute through their plain versions
(``flash_fwd_reference``, ``flash_bwd_reference``), so these tests hold
those plain versions, the wrappers' dispatch and shape checks, the
autograd function and the launch counters to the TPU kernels' numerics.
The CUDA kernels are held to the same plain versions on the card by
``chip_smoke.py``.

Tolerances: atol 1e-5 on (o, lse) and (dq, dk, dv) — float32 on both
sides, inputs of unit scale, only the order of the sums differs; rtol
5e-4, atol 5e-5 on autograd gradients, the JAX package's own tolerance
for its flash backward against AD through the reference
(tests/test_tpu.py:403-405).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brpc_tpu.tpu import pallas_ops as jax_ops
from brpc_tpu_torch.tpu import pallas_ops as torch_ops

ATOL = 1e-5
N, D, BLOCK = 6, 32, 64


def _inputs(shape, seed, count=3):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for _ in range(count)]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, atol=ATOL, rtol=0.0):
    for g, w in zip(got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=rtol)


@pytest.mark.parametrize("S", [64, 128])
def test_folded_forward_matches_jax(S):
    q, k, v = _inputs((N, S, D), seed=S)
    want = jax_ops._flash_fwd_folded(*_j(q, k, v), BLOCK, True)
    got = torch_ops._flash_fwd_folded(*_t(q, k, v), BLOCK)
    assert got[0].shape == (N, S, D) and got[1].shape == (N, S, 1)
    assert got[1].dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [64, 128])
def test_rectangular_forward_matches_jax(S, causal):
    q, k, v = _inputs((N, S, D), seed=S + 1)
    want = jax_ops._flash_fwd_bhsd(*_j(q, k, v), causal, BLOCK, BLOCK, True)
    got = torch_ops._flash_fwd_bhsd(*_t(q, k, v), causal, BLOCK, BLOCK)
    _close(got, want)


def test_rectangular_forward_with_longer_keys_matches_jax():
    q, = _inputs((N, 64, D), seed=11, count=1)
    k, v = _inputs((N, 128, D), seed=12, count=2)
    want = jax_ops._flash_fwd_bhsd(*_j(q, k, v), False, BLOCK, BLOCK, True)
    got = torch_ops._flash_fwd_bhsd(*_t(q, k, v), False, BLOCK, BLOCK)
    _close(got, want)


def _bwd_case(S, k_start, causal, seed):
    """q, k, v, do, and the lse / delta a forward over these blocks at
    these offsets leaves (lse = NEG_INF on rows that see no key)."""
    q, k, v, do = _inputs((N, S, D), seed=seed, count=4)
    o, lse = torch_ops.flash_fwd_reference(*_t(q, k, v), causal, 0, k_start)
    delta = torch_ops._flash_delta(o, torch.from_numpy(do))
    return q, k, v, do, lse.numpy(), delta.numpy()


@pytest.mark.parametrize("k_start_of", [lambda s: 0, lambda s: s,
                                        lambda s: s // 2],
                         ids=["aligned", "future", "half"])
@pytest.mark.parametrize("S", [64, 128])
def test_backward_matches_jax_with_offsets(S, k_start_of):
    k_start = k_start_of(S)
    q, k, v, do, lse, delta = _bwd_case(S, k_start, True, seed=S + k_start)
    want = jax_ops._flash_bwd_bhsd(*_j(q, k, v, lse, do, delta), 0, k_start,
                                   True, BLOCK, BLOCK, True)
    got = torch_ops._flash_bwd_bhsd(*_t(q, k, v, lse, do, delta), 0,
                                    k_start, True, BLOCK, BLOCK)
    _close(got, want)
    if k_start == S:  # the whole key block lies in the future
        assert (lse == torch_ops.NEG_INF).all()
        for g in got:
            assert not g.any()


def test_backward_non_causal_matches_jax():
    q, k, v, do, lse, delta = _bwd_case(128, 0, False, seed=21)
    want = jax_ops._flash_bwd_bhsd(*_j(q, k, v, lse, do, delta), 0, 0,
                                   False, BLOCK, BLOCK, True)
    got = torch_ops._flash_bwd_bhsd(*_t(q, k, v, lse, do, delta), 0, 0,
                                    False, BLOCK, BLOCK)
    _close(got, want)


def test_forward_reference_rows_with_no_key():
    q, k, v = _inputs((N, 64, D), seed=4)
    o, lse = torch_ops.flash_fwd_reference(*_t(q, k, v), True, 0, 32)
    assert (lse[:, :32] == torch_ops.NEG_INF).all()
    assert not o[:, :32].any()
    assert torch.isfinite(o).all() and (lse[:, 32:] > -100).all()


@pytest.mark.parametrize("block", [64, None], ids=["block64", "default"])
@pytest.mark.parametrize("causal", [True, False])
def test_mha_autograd_matches_jax_grad(causal, block):
    B, H, S = 2, 3, 128
    q, k, v = _inputs((B, H, S, D), seed=5)

    def loss_j(q, k, v):
        return jnp.sum(jnp.sin(jax_ops.flash_attention_mha(
            q, k, v, causal=causal, block_q=block, block_k=block,
            interpret=True)))

    out_j = jax_ops.flash_attention_mha(*_j(q, k, v), causal=causal,
                                        block_q=block, block_k=block,
                                        interpret=True)
    grads_j = jax.grad(loss_j, argnums=(0, 1, 2))(*_j(q, k, v))
    qt, kt, vt = (t.requires_grad_() for t in _t(q, k, v))
    out = torch_ops.flash_attention_mha(qt, kt, vt, causal=causal,
                                        block_q=block, block_k=block)
    torch.sin(out).sum().backward()
    assert out.shape == (B, H, S, D)
    _close([out], [out_j])
    _close([qt.grad, kt.grad, vt.grad], grads_j, atol=5e-5, rtol=5e-4)


def test_mha_grads_match_autograd_through_reference():
    B, H, S = 2, 2, 64
    q, k, v = _inputs((B, H, S, D), seed=6)
    qt, kt, vt = (t.requires_grad_() for t in _t(q, k, v))
    torch.sin(torch_ops.flash_attention_mha(qt, kt, vt, causal=True)
              ).sum().backward()
    qr, kr, vr = (t.requires_grad_() for t in _t(q, k, v))
    ref = torch_ops.attention_reference(qr.transpose(1, 2),
                                        kr.transpose(1, 2),
                                        vr.transpose(1, 2), causal=True)
    torch.sin(ref.transpose(1, 2)).sum().backward()
    _close([qt.grad, kt.grad, vt.grad], [qr.grad, kr.grad, vr.grad],
           atol=5e-5, rtol=5e-4)


@pytest.mark.parametrize("sq,sk,bq,bk", [(96, 96, None, None),
                                         (100, 100, None, None),
                                         (128, 64, None, None),
                                         (256, 256, 64, 128),
                                         (64, 64, 256, 256)])
def test_pick_blocks_matches_jax(sq, sk, bq, bk):
    want = jax_ops._pick_blocks(sq, sk, bq, bk, interpret=True)
    assert torch_ops._pick_blocks(sq, sk, bq, bk) == want


@pytest.mark.parametrize("sq,sk,block", [(96, 96, 64), (128, 80, 64),
                                         (48, 128, 32)])
def test_block_misalignment_raises_like_jax(sq, sk, block):
    q = np.zeros((1, 1, sq, D), np.float32)
    k = np.zeros((1, 1, sk, D), np.float32)
    with pytest.raises(ValueError):
        jax_ops.flash_attention_mha(*_j(q, k, k), block_q=block,
                                    block_k=block, interpret=True)
    with pytest.raises(ValueError, match="must divide blocks"):
        torch_ops.flash_attention_mha(*_t(q, k, k), block_q=block,
                                      block_k=block)


def test_folded_refuses_what_jax_refuses():
    q, k, v = _t(*_inputs((N, 64, D), seed=7))
    with pytest.raises(ValueError, match="sq == sk"):
        torch_ops._flash_fwd_folded(q, k[:, :32], v[:, :32], 32)
    with pytest.raises(ValueError):
        torch_ops._flash_fwd_folded(q, k, v, 48)


def test_best_dispatch_folds_only_causal_square_blocks(monkeypatch):
    calls = []
    monkeypatch.setattr(torch_ops, "_flash_fwd_folded",
                        lambda *a: calls.append("folded") or (None, None))
    monkeypatch.setattr(torch_ops, "_flash_fwd_bhsd",
                        lambda *a: calls.append("bhsd") or (None, None))
    q = torch.zeros(1, 128, D)
    torch_ops._flash_fwd_best(q, q, q, True, 64, 64)
    torch_ops._flash_fwd_best(q, q, q, True, 64, 128)
    torch_ops._flash_fwd_best(q, q, q, False, 64, 64)
    assert calls == ["folded", "bhsd", "bhsd"]


def test_cpu_path_never_counts_a_launch():
    q, k, v = _t(*_inputs((1, 2, 64, D), seed=8))
    for t in (q, k, v):
        t.requires_grad_()
    torch_ops.flash_attention_mha(q, k, v, causal=True).sum().backward()
    counts = torch_ops.launches.snapshot()
    assert counts["flash_fwd"] == counts["flash_bwd_dq"] == \
        counts["flash_bwd_dkv"] == 0


def test_bf16_forward_close_to_fp32():
    """The plain version in bf16 computes in fp32 and rounds P and o:
    within the JAX package's bf16 tolerance of its fp32 self."""
    q, k, v = _t(*_inputs((N, 64, D), seed=9))
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    o, lse = torch_ops._flash_fwd_folded(qb, kb, vb, 64)
    o32, lse32 = torch_ops._flash_fwd_folded(qb.float(), kb.float(),
                                             vb.float(), 64)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert float((o.float() - o32).abs().max()) < 2e-2
    assert float((lse - lse32).abs().max()) < 1e-5


@pytest.mark.parametrize("bn", [1, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_qgrid_forward_matches_jax(causal, bn):
    q, k, v = _inputs((N, 128, D), seed=30 + bn)
    want = jax_ops._flash_fwd_qgrid(*_j(q, k, v), causal, 64, 32, True, bn)
    got = torch_ops._flash_fwd_qgrid(*_t(q, k, v), causal, 64, 32, bn)
    assert got[0].shape == (N, 128, D) and got[1].shape == (N, 128, 1)
    _close(got, want)


def test_qgrid_forward_with_longer_keys_matches_jax():
    q, = _inputs((N, 64, D), seed=33, count=1)
    k, v = _inputs((N, 128, D), seed=34, count=2)
    want = jax_ops._flash_fwd_qgrid(*_j(q, k, v), False, 32, 64, True, 3)
    got = torch_ops._flash_fwd_qgrid(*_t(q, k, v), False, 32, 64, 3)
    _close(got, want)


@pytest.mark.parametrize("bq,bkc,bn", [(48, 32, 1), (64, 48, 1), (64, 32, 4),
                                       (128, 32, 1)],
                         ids=["bq", "bkc", "bn", "bq_past_sq"])
def test_qgrid_refuses_what_jax_refuses(bq, bkc, bn):
    q, k, v = _inputs((N, 64, D), seed=35)
    with pytest.raises(ValueError):
        jax_ops._flash_fwd_qgrid(*_j(q, k, v), True, bq, bkc, True, bn)
    with pytest.raises(ValueError, match="vs blocks"):
        torch_ops._flash_fwd_qgrid(*_t(q, k, v), True, bq, bkc, bn)


def test_qgrid_cpu_path_never_counts_a_launch():
    q, k, v = _t(*_inputs((N, 64, D), seed=36))
    torch_ops._flash_fwd_qgrid(q, k, v, True, 32, 32)
    assert torch_ops.launches["flash_fwd_qgrid"] == 0
