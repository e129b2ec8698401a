"""Port RMSNorm (brpc_tpu_torch.tpu.pallas_ops.rmsnorm) against the JAX
package's Pallas kernel, run in interpret mode, and its custom VJP.

On the CPU the port's forward is its plain version
(``rmsnorm_reference``); ``chip_smoke.py`` holds the CUDA kernel to that
same plain version on the card. The backward is plain PyTorch on both
devices, as it is XLA in the JAX package.

Tolerance: atol 1e-5 in float32 — both sides compute in fp32 from the
same inputs, only rsqrt and the order of the sums differ. bf16 outputs
agree within one bf16 rounding step (rtol 2 ** -7).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brpc_tpu.tpu import pallas_ops as jax_ops
from brpc_tpu_torch.tpu import pallas_ops as torch_ops

ATOL = 1e-5


def _xw(shape, seed):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, w


@pytest.mark.parametrize("shape", [(8, 64), (300, 64), (256, 32),
                                   (2, 3, 32), (1, 50)])
def test_forward_matches_jax_kernel(shape):
    x, w = _xw(shape, seed=sum(shape))
    want = jax_ops.rmsnorm(jnp.asarray(x), jnp.asarray(w), interpret=True)
    got = torch_ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("shape", [(300, 64), (2, 5, 32)])
def test_reference_matches_jax_reference(shape):
    x, w = _xw(shape, seed=3)
    want = jax_ops.rmsnorm_reference(jnp.asarray(x), jnp.asarray(w))
    got = torch_ops.rmsnorm_reference(torch.from_numpy(x),
                                      torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_bf16_forward_matches_jax_within_one_rounding():
    x, w = _xw((64, 64), seed=4)
    xb, wb = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (x, w))
    want = np.asarray(jax_ops.rmsnorm(xb, wb, interpret=True),
                      dtype=np.float32)
    got = torch_ops.rmsnorm(torch.from_numpy(x).bfloat16(),
                            torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 16, 64), (3, 7, 32)])
def test_backward_matches_jax_custom_vjp(shape):
    x, w = _xw(shape, seed=5)
    g = np.random.RandomState(6).standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jax_ops.rmsnorm(a, b, interpret=True),
                     jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    torch_ops.rmsnorm(xt, wt).backward(torch.from_numpy(g))
    assert wt.grad.shape == (shape[-1],)  # summed over every row
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_j), atol=ATOL,
                               rtol=0)


def test_backward_matches_autograd_through_reference():
    x, w = _xw((4, 8, 32), seed=7)
    g = torch.from_numpy(
        np.random.RandomState(8).standard_normal(x.shape).astype(np.float32))
    grads = []
    for fn in (torch_ops.rmsnorm, torch_ops.rmsnorm_reference):
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        fn(xt, wt).backward(g)
        grads.append((xt.grad, wt.grad))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0)


def test_weight_shape_mismatch_raises():
    with pytest.raises(ValueError, match="does not match"):
        torch_ops.rmsnorm(torch.zeros(4, 32), torch.ones(16))


def test_cpu_path_never_counts_a_launch():
    x, w = (torch.from_numpy(a) for a in _xw((16, 32), seed=9))
    torch_ops.rmsnorm(x, w)
    assert torch_ops.launches["rmsnorm"] == 0
