"""Port ring attention (brpc_tpu_torch.tpu.ring) and its carry kernel's
entry (pallas_ops.flash_attention_carry) against the JAX package.

The JAX ring runs on the test conftest's 8-device CPU mesh, its Pallas
kernels in interpret mode; the port replays the same ``sp`` ring positions
on one device, through its plain versions on the CPU. ``chip_smoke.py``
holds the CUDA carry kernel to ``flash_carry_reference`` and the flash
lane to the plain lane on the card.

Tolerances (float32 on both sides, inputs of unit scale, only the order of
the sums differs): outputs and carry state within atol 1e-5; ring
gradients within rtol 5e-4, atol 5e-5, the JAX package's own tolerance
for its ring gradients (tests/test_tpu.py:151-177).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brpc_tpu.tpu import mesh as meshlib
from brpc_tpu.tpu import pallas_ops as jax_ops
from brpc_tpu.tpu import ring as jax_ring
from brpc_tpu_torch.tpu import pallas_ops as torch_ops
from brpc_tpu_torch.tpu import ring

ATOL = 1e-5
NEG_INF = torch_ops.NEG_INF


def _inputs(shape, seed, count=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(count)]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.fixture(scope="module")
def mesh8():
    return meshlib.make_mesh({"x": -1})


@pytest.mark.parametrize("use_flash", [False, True], ids=["lax", "flash"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax_ring_sp8(mesh8, causal, use_flash):
    q, k, v = _inputs((2, 32, 4, 16), seed=1)
    want = jax_ring.ring_attention(*_j(q, k, v), mesh8, "x", causal=causal,
                                   use_flash=use_flash)
    got = ring.ring_attention(*_t(q, k, v), 8, causal=causal,
                              use_flash=use_flash)
    assert got.shape == (2, 32, 4, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_full_reference_matches_jax(causal):
    q, k, v = _inputs((2, 32, 4, 16), seed=2)
    want = jax_ring.full_attention_reference(*_j(q, k, v), causal=causal)
    got = ring.full_attention_reference(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_gradients_match_jax_sp2(causal):
    m = meshlib.make_mesh({"dp": 2, "sp": 2, "tp": 2})
    q, k, v = _inputs((2, 32, 4, 16), seed=7)

    def loss_j(q, k, v):
        return jnp.sum(jnp.sin(jax_ring.ring_attention(
            q, k, v, m, "sp", causal=causal, batch_axis="dp",
            head_axis="tp", use_flash=True, block_q=16, block_k=16)))

    want = jax.grad(loss_j, argnums=(0, 1, 2))(*_j(q, k, v))
    for use_flash in (True, False):
        ins = [t.requires_grad_() for t in _t(q, k, v)]
        out = ring.ring_attention(*ins, 2, causal=causal,
                                  use_flash=use_flash, block_q=16,
                                  block_k=16)
        torch.sin(out).sum().backward()
        for t, w in zip(ins, want):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                       rtol=5e-4, atol=5e-5)


def _carry_state(shape, d, seed):
    """A state as a real earlier pass leaves it: (m, l, acc) with finite m,
    positive l and acc of matching scale."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=shape + (1,)).astype(np.float32)
    l = rng.uniform(1.0, 4.0, size=shape + (1,)).astype(np.float32)
    acc = rng.normal(size=shape + (d,)).astype(np.float32)
    return m, l, acc


def _identity_state(shape, d):
    return (np.full(shape + (1,), NEG_INF, np.float32),
            np.zeros(shape + (1,), np.float32),
            np.zeros(shape + (d,), np.float32))


@pytest.mark.parametrize("q_start,k_start", [(0, 0), (64, 0), (64, 32),
                                             (0, 32)],
                         ids=["diagonal", "past", "band", "partly_future"])
@pytest.mark.parametrize("fresh", [True, False], ids=["identity", "carried"])
@pytest.mark.parametrize("causal", [True, False])
def test_carry_matches_jax_with_offsets(causal, fresh, q_start, k_start):
    q, = _inputs((64, 32), seed=10, count=1)
    k, v = _inputs((64, 32), seed=11, count=2)
    state = (_identity_state((64,), 32) if fresh
             else _carry_state((64,), 32, seed=12))
    want = jax_ops.flash_attention_carry(
        *_j(q, k, v, *state), q_start, k_start, causal=causal, block_q=32,
        block_k=32, interpret=True)
    got = torch_ops.flash_attention_carry(
        *_t(q, k, v, *state), q_start, k_start, causal=causal, block_q=32,
        block_k=32)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


def test_carry_takes_leading_axes_like_jax_vmap():
    q, k, v = _inputs((2, 3, 32, 32), seed=13)
    state = _carry_state((2, 3, 32), 32, seed=14)

    def one(q1, k1, v1, m1, l1, a1):
        return jax_ops.flash_attention_carry(q1, k1, v1, m1, l1, a1, 32, 0,
                                             causal=True, block_q=16,
                                             block_k=16, interpret=True)

    want = jax.vmap(jax.vmap(one))(*_j(q, k, v, *state))
    got = torch_ops.flash_attention_carry(*_t(q, k, v, *state), 32, 0,
                                          causal=True, block_q=16,
                                          block_k=16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("fresh", [True, False], ids=["identity", "carried"])
def test_carry_future_block_leaves_the_state_exactly(fresh):
    q, k, v = _inputs((64, 32), seed=15)
    state = (_identity_state((64,), 32) if fresh
             else _carry_state((64,), 32, seed=16))
    got = torch_ops.flash_attention_carry(*_t(q, k, v, *state), 0, 64,
                                          causal=True, block_q=32,
                                          block_k=32)
    want = jax_ops.flash_attention_carry(*_j(q, k, v, *state), 0, 64,
                                         causal=True, block_q=32,
                                         block_k=32, interpret=True)
    for g, w, s in zip(got, want, state):
        assert torch.equal(g, torch.from_numpy(s))
        np.testing.assert_array_equal(np.asarray(w), s)


def test_carry_split_kv_equals_whole_kv():
    """Two passes over the halves of K/V equal one pass over all of it,
    after normalising: the ring-hop contract."""
    q, k, v = _t(*_inputs((64, 32), seed=17))
    m0, l0, a0 = _t(*_identity_state((64,), 32))
    m1, l1, a1 = torch_ops.flash_attention_carry(q, k[:32], v[:32], m0, l0,
                                                 a0, 0, 0, causal=True)
    m2, l2, a2 = torch_ops.flash_attention_carry(q, k[32:], v[32:], m1, l1,
                                                 a1, 0, 32, causal=True)
    mw, lw, aw = torch_ops.flash_attention_carry(q, k, v, m0, l0, a0, 0, 0,
                                                 causal=True)
    np.testing.assert_allclose((a2 / l2).numpy(), (aw / lw).numpy(),
                               atol=ATOL, rtol=0)
    o, lse = torch_ops.flash_fwd_reference(q[None], k[None], v[None], True)
    np.testing.assert_allclose((aw / lw).numpy(), o[0].numpy(), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose((mw + torch.log(lw)).numpy(), lse[0].numpy(),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("sq,sk,block", [(64, 48, 32), (48, 64, 32)])
def test_carry_refuses_blocks_that_do_not_divide_like_jax(sq, sk, block):
    q, = _inputs((sq, 32), seed=18, count=1)
    k, v = _inputs((sk, 32), seed=19, count=2)
    state = _identity_state((sq,), 32)
    with pytest.raises(ValueError):
        jax_ops.flash_attention_carry(*_j(q, k, v, *state), 0, 0,
                                      block_q=block, block_k=block,
                                      interpret=True)
    with pytest.raises(ValueError, match="must divide blocks"):
        torch_ops.flash_attention_carry(*_t(q, k, v, *state), 0, 0,
                                        block_q=block, block_k=block)


def test_carry_refuses_mismatched_state():
    q, k, v = _t(*_inputs((64, 32), seed=20))
    m, l, acc = _t(*_identity_state((64,), 32))
    with pytest.raises(ValueError, match="do not fit"):
        torch_ops.flash_attention_carry(q, k, v, m[:32], l, acc, 0, 0)
    with pytest.raises(ValueError, match="do not fit"):
        torch_ops.flash_attention_carry(q, k[:, :16], v, m, l, acc, 0, 0)


@pytest.mark.parametrize("causal,hops", [(True, 10), (False, 16)])
def test_flash_ring_runs_one_kernel_per_live_hop(monkeypatch, causal, hops):
    """sp = 4: sp (sp + 1) / 2 live hops when causal (wholly future blocks
    skipped, as the JAX lax.cond skips them), sp^2 otherwise; one carry
    call per hop forward, one backward call per hop, each at the hop's
    absolute offsets and in the ring's order."""
    calls = {"carry": [], "bwd": []}
    carry, bwd = torch_ops.flash_attention_carry, torch_ops._flash_bwd_bhsd

    def count_carry(*a, **kw):
        calls["carry"].append((a[6], a[7]))
        return carry(*a, **kw)

    def count_bwd(*a, **kw):
        calls["bwd"].append((a[6], a[7]))
        return bwd(*a, **kw)

    monkeypatch.setattr(torch_ops, "flash_attention_carry", count_carry)
    monkeypatch.setattr(torch_ops, "_flash_bwd_bhsd", count_bwd)
    ins = [t.requires_grad_() for t in _t(*_inputs((1, 64, 2, 32), 21))]
    ring.ring_attention(*ins, 4, causal=causal, use_flash=True).sum() \
        .backward()
    assert len(calls["carry"]) == len(calls["bwd"]) == hops
    assert calls["carry"] == calls["bwd"]
    want = [(my * 16, ((my - i) % 4) * 16) for i in range(4)
            for my in range(4)
            if not causal or (my - i) % 4 <= my]
    assert calls["carry"] == want
    assert torch_ops.launches["flash_carry"] == 0  # the CPU path


def test_longer_keys_non_causal():
    q, = _inputs((2, 32, 2, 32), seed=22, count=1)
    k, v = _inputs((2, 64, 2, 32), seed=23, count=2)
    want = ring.full_attention_reference(*_t(q, k, v))
    for use_flash in (False, True):
        got = ring.ring_attention(*_t(q, k, v), 4, use_flash=use_flash)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                   rtol=0)


def test_bf16_flash_ring_close_to_fp32():
    q, k, v = _t(*_inputs((1, 64, 2, 32), seed=24))
    qb, kb, vb = (t.bfloat16().requires_grad_() for t in (q, k, v))
    out = ring.ring_attention(qb, kb, vb, 4, causal=True, use_flash=True)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 for t in (qb, kb, vb))
    want = ring.ring_attention(qb.detach().float(), kb.detach().float(),
                               vb.detach().float(), 4, causal=True)
    assert float((out.detach().float() - want).abs().max()) < 2e-2


@pytest.mark.parametrize("sp", [3, 0])
def test_ring_refuses_a_ring_that_does_not_divide(sp):
    q, k, v = _t(*_inputs((1, 32, 2, 16), seed=25))
    with pytest.raises(ValueError, match="divide"):
        ring.ring_attention(q, k, v, sp)
