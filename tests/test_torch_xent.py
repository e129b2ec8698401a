"""Port fused cross-entropy (brpc_tpu_torch.tpu.pallas_ops.softmax_xent)
against the JAX package's ``softmax_xent``, whose Pallas kernel runs in
interpret mode on the CPU.

On the CPU the port computes through its plain per-row version, so these
tests hold that version, the autograd function and the wrapper's checks
to the TPU kernel's numerics; ``chip_smoke.py`` holds the CUDA kernel
(``csrc/xent.cu``) to the same plain version on the card.

Tolerances: per-row NLL and the mean within atol 1e-5 (float32 on both
sides, logits of scale 2-3, only the order of the sums differs);
gradients within atol 1e-6, rtol 1e-5 (entries are softmax / N, ~1e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brpc_tpu.tpu import pallas_ops as jax_ops
from brpc_tpu_torch.tpu import pallas_ops as torch_ops

ATOL = 1e-5


def _case(n, v, seed, scale=3.0):
    rng = np.random.RandomState(seed)
    logits = (rng.standard_normal((n, v)) * scale).astype(np.float32)
    targets = rng.randint(0, v, size=n).astype(np.int32)
    return logits, targets


def _jax_rows(logits, targets, block_rows=256):
    return np.asarray(jax_ops._xent_forward_rows(
        jnp.asarray(logits), jnp.asarray(targets), block_rows, True))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rows_and_mean_match_jax(seed):
    logits, targets = _case(512, 1024, seed)
    want_rows = _jax_rows(logits, targets)
    want = jax_ops.softmax_xent(jnp.asarray(logits), jnp.asarray(targets))
    x, t = torch.from_numpy(logits), torch.from_numpy(targets)
    rows = torch_ops._xent_forward_rows(x, t)
    assert rows.shape == (512,) and rows.dtype == torch.float32
    np.testing.assert_allclose(rows.numpy(), want_rows, atol=ATOL, rtol=0)
    got = torch_ops.softmax_xent(x, t)
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), atol=ATOL, rtol=0)


def test_odd_row_count_with_a_small_block_matches_jax():
    logits, targets = _case(100, 64, seed=3, scale=2.0)
    want_rows = _jax_rows(logits, targets, block_rows=64)
    want = jax_ops.softmax_xent(jnp.asarray(logits), jnp.asarray(targets),
                                block_rows=64, interpret=True)
    x, t = torch.from_numpy(logits), torch.from_numpy(targets)
    np.testing.assert_allclose(
        torch_ops._xent_forward_rows(x, t, 64).numpy(), want_rows,
        atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(torch_ops.softmax_xent(x, t, 64)),
                               float(want), atol=ATOL, rtol=0)


def test_target_out_of_range_picks_zero_like_the_tpu_kernel():
    logits, targets = _case(64, 128, seed=4)
    targets[[0, 5, 9]] = [128, -1, 1000]
    want_rows = _jax_rows(logits, targets, block_rows=64)
    rows = torch_ops._xent_forward_rows(torch.from_numpy(logits),
                                        torch.from_numpy(targets))
    np.testing.assert_allclose(rows.numpy(), want_rows, atol=ATOL, rtol=0)
    lse = torch.logsumexp(torch.from_numpy(logits), dim=-1)
    np.testing.assert_allclose(rows[[0, 5, 9]].numpy(),
                               lse[[0, 5, 9]].numpy(), atol=ATOL, rtol=0)


def test_reference_matches_jax_reference():
    logits, targets = _case(256, 512, seed=5)
    want = jax_ops.softmax_xent_reference(jnp.asarray(logits),
                                          jnp.asarray(targets))
    got = torch_ops.softmax_xent_reference(torch.from_numpy(logits),
                                           torch.from_numpy(targets))
    np.testing.assert_allclose(float(got), float(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("out_of_range", [False, True],
                         ids=["in_range", "out_of_range"])
def test_gradient_matches_jax(out_of_range):
    logits, targets = _case(64, 128, seed=6, scale=2.0)
    if out_of_range:
        targets[[1, 2]] = [-3, 128]
    want = jax.grad(lambda x: jax_ops.softmax_xent(
        x, jnp.asarray(targets)))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    torch_ops.softmax_xent(x, torch.from_numpy(targets)).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-5)


def test_gradient_scales_with_the_upstream_gradient():
    logits, targets = _case(32, 64, seed=7)
    x = torch.from_numpy(logits).requires_grad_()
    (3.0 * torch_ops.softmax_xent(x, torch.from_numpy(targets))).backward()
    x2 = torch.from_numpy(logits).requires_grad_()
    torch_ops.softmax_xent_reference(
        x2, torch.from_numpy(targets)).mul(3.0).backward()
    np.testing.assert_allclose(x.grad.numpy(), x2.grad.numpy(), atol=1e-6,
                               rtol=1e-5)


def test_empty_batch_is_zero_like_jax():
    want = jax_ops.softmax_xent(jnp.zeros((0, 16)),
                                jnp.zeros((0,), jnp.int32))
    x = torch.zeros(0, 16, requires_grad=True)
    got = torch_ops.softmax_xent(x, torch.zeros(0, dtype=torch.int64))
    assert float(got.detach()) == float(want) == 0.0
    got.backward()
    assert x.grad.shape == (0, 16)


def test_bf16_logits_and_int32_targets():
    """bf16 logits are widened to fp32 (the kernel's contract): rows equal
    the fp32 rows of the same values; the gradient comes back in bf16."""
    logits, targets = _case(64, 256, seed=8)
    xb = torch.from_numpy(logits).bfloat16()
    t32 = torch.from_numpy(targets)
    assert t32.dtype == torch.int32
    rows = torch_ops._xent_forward_rows(xb, t32)
    assert torch.equal(rows, torch_ops._xent_forward_rows(xb.float(),
                                                          t32.long()))
    xb.requires_grad_()
    torch_ops.softmax_xent(xb, t32).backward()
    assert xb.grad.dtype == torch.bfloat16


def test_wrapper_refuses_bad_shapes():
    x = torch.zeros(8, 16)
    with pytest.raises(ValueError, match="logits"):
        torch_ops.softmax_xent(x, torch.zeros(7, dtype=torch.int64))
    with pytest.raises(ValueError, match="logits"):
        torch_ops.softmax_xent(x.reshape(2, 4, 16),
                               torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="block_rows"):
        torch_ops.softmax_xent(x, torch.zeros(8, dtype=torch.int64), 0)


def test_cpu_path_never_counts_a_launch():
    logits, targets = _case(16, 32, seed=9)
    before = torch_ops.launches["softmax_xent"]
    x = torch.from_numpy(logits).requires_grad_()
    torch_ops.softmax_xent(x, torch.from_numpy(targets)).backward()
    assert torch_ops.launches["softmax_xent"] == before == 0
