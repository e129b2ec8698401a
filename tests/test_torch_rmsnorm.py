"""Port RMSNorm (brpc_tpu_torch.tpu.pallas_ops.rmsnorm) against the JAX
package's Pallas kernel, run in interpret mode, and its custom VJP.

On the CPU the port's forward and backward are their plain versions
(``rmsnorm_reference``, ``_rmsnorm_bwd``); ``chip_smoke.py`` holds the
CUDA kernels (``csrc/rmsnorm.cu``) to those same plain versions on the
card. The backward kernel's partition of the work (row chunks per block,
per-lane column partials of dw, the fixed-order finish) is emulated in
numpy here and held against the JAX custom VJP.

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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(300, 64), (5, 50), (2, 7, 50),
                                   (3, 100, 64)])
def test_plain_backward_matches_jax_vjp_by_dtype(shape, dtype):
    """The plain backward (what a CPU tensor runs, and what the kernel is
    held to on the card) against the JAX custom VJP: ragged rows (300 is
    not a multiple of the TPU kernel's 256-row block), D = 50, 3-D inputs,
    dw summed over every row."""
    x, w = _xw(shape, seed=11)
    g = np.random.RandomState(12).standard_normal(shape).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    _, vjp = jax.vjp(lambda a, b: jax_ops.rmsnorm(a, b, interpret=True),
                     jnp.asarray(x, dtype=jdt), jnp.asarray(w, dtype=jdt))
    dx_j, dw_j = vjp(jnp.asarray(g, dtype=jdt))
    xt, wt, gt = (torch.from_numpy(a).to(tdt) for a in (x, w, g))
    dx, dw = torch_ops._rmsnorm_bwd_call(xt, wt, gt)
    assert dx.dtype == tdt and dw.dtype == tdt
    assert dx.shape == shape and dw.shape == (shape[-1],)
    rtol = 0 if dtype == "float32" else 2 ** -7
    for got, want in ((dx, dx_j), (dw, dw_j)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, dtype=np.float32),
                                   atol=ATOL, rtol=rtol)
    # through autograd too: rmsnorm's backward is the same call
    xr, wr = xt.clone().requires_grad_(), wt.clone().requires_grad_()
    torch_ops.rmsnorm(xr, wr).backward(gt)
    assert torch.equal(xr.grad, dx) and torch.equal(wr.grad, dw)


def _emulate_bwd_kernel(x, w, g, eps, blocks, groups=64):
    """csrc/rmsnorm.cu's backward as it partitions the work, in numpy fp32:
    block b takes rows [b * chunk, (b + 1) * chunk), chunk = ceil(rows /
    blocks); its warp k takes the chunk's rows k, k + 8, ...; each warp
    keeps fp32 partials of g x r for every column across its rows; the
    block adds its warps' partials in warp order into its row of partials
    [blocks, D]; the finish (``groups``: its kFinishGroups) sums rows
    b = t, t + groups, ... for each t, then the groups' sums meet in a
    fixed tree (t += t + stride for stride = groups / 2, ..., 1)."""
    rows, d = x.shape
    warps = torch_ops._RMS_WARPS
    chunk = -(-rows // blocks)
    dx = np.empty_like(x)
    partials = np.zeros((blocks, d), np.float32)
    for b in range(blocks):
        per_warp = np.zeros((warps, d), np.float32)
        for row in range(b * chunk, min(rows, (b + 1) * chunk)):
            xr, gr = x[row], g[row]
            ss = np.sum(xr * xr, dtype=np.float32)
            sgwx = np.sum(gr * w * xr, dtype=np.float32)
            r = np.float32(1.0) / np.sqrt(ss / np.float32(d) +
                                          np.float32(eps))
            c = r * r * r / np.float32(d) * sgwx
            dx[row] = gr * w * r - xr * c
            per_warp[(row - b * chunk) % warps] += gr * xr * r
        for k in range(warps):
            partials[b] += per_warp[k]
    sums = np.zeros((groups, d), np.float32)
    for b in range(blocks):
        sums[b % groups] += partials[b]
    stride = groups // 2
    while stride:
        sums[:stride] += sums[stride:2 * stride]
        stride //= 2
    return dx, sums[0]


@pytest.mark.parametrize("rows,sms", [(300, 16), (300, 4), (301, 132),
                                      (7, 132)])
def test_backward_kernel_partition_matches_jax_vjp(rows, sms):
    """The kernel's partition at the grid the wrapper picks: 300 rows over
    32 blocks of 10 (the last two blocks empty), over 8 blocks of 38 (a
    last chunk of 34), 301 rows over 38 blocks of 8 (a last chunk of 5),
    and 7 rows in one block."""
    blocks = torch_ops._rmsnorm_bwd_blocks(rows, sms)
    assert blocks == min(-(-rows // 8), 2 * sms)
    x, w = _xw((rows, 64), seed=13)
    g = np.random.RandomState(14).standard_normal((rows, 64)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda a, b: jax_ops.rmsnorm(a, b, interpret=True),
                     jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(g))
    dx, dw = _emulate_bwd_kernel(x, w, g, torch_ops.EPS, blocks)
    np.testing.assert_allclose(dx, np.asarray(dx_j), atol=ATOL, rtol=0)
    # dw (|dw| up to ~20) sums the rows in another order than XLA: a few
    # fp32 ulps of it on top of ATOL
    np.testing.assert_allclose(dw, np.asarray(dw_j), atol=ATOL,
                               rtol=2 ** -20)


def test_cpu_backward_never_counts_a_launch():
    x, w = (torch.from_numpy(a) for a in _xw((16, 32), seed=15))
    xr = x.requires_grad_()
    torch_ops.rmsnorm(xr, w).sum().backward()
    assert torch_ops.launches["rmsnorm_bwd"] == 0
