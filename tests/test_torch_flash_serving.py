"""The serving prefill's fp32 attention kernel at head dim 16
(``fwd_f32_mma_kernel`` of ``brpc_tpu_torch/csrc/flash_fwd.cu``) against
the JAX package's ``_flash_kernel``.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
to its plain version at every bucket the serving run launches. These CPU
tests hold its arithmetic and its call:

- An emulation of the kernel in numpy, with the tiling the kernel's
  source sets: ROWS-row query tiles, each split over WARPS stripes of
  KEYS-key tiles (stripe w takes tiles w, w + WARPS, ...), an online
  softmax per stripe in base 2 with the scale folded into the exponent,
  every product in 3xTF32 (hi = tf32(x), rounded on the int32 view of the
  bits: to nearest, ties away from zero, the 13 low bits cleared, as
  ``cvt.rna.tf32.f32`` and the kernel's integer rounding do; lo = x - hi
  as the product reads it, its 13 low bits dropped), and the stripes'
  (m, l, acc) merged at the end. It is held to
  ``brpc_tpu.tpu.pallas_ops.flash_attention`` in interpret mode, vmapped
  over heads as ``brpc_tpu/serving/model.py`` calls it, at every prefill
  bucket (interpret mode is fast enough here at S up to 1024, so no
  bucket falls back to ``attention_reference``), causal and not, and at
  S_q != S_k. The same emulation with one tf32 pass
  is printed beside it as a record: it keeps about three digits and is
  why the kernel takes three passes.
- The emulation in place of the port's ``flash_attention`` inside the
  serving model at the llm_server example's widths: greedy tokens equal
  to the JAX model's with its Pallas kernel.
- The C call, through a stubbed ``pallas_ops._call``: pointers, N = H,
  head dim 16, dtype 0, the (head, row) strides of the fused-QKV views,
  the function bound once across calls, and every refusal (bf16, a
  non-contiguous last dim, misaligned rows) raised before any call.

Tolerance: FLASH_TOL = 1e-4 x max(1, max |ref|), chip_smoke.py's limit
for this kernel. Both sides compute in fp32 and differ in the order of
the sums and in 3xTF32's dropped terms (~2^-21 of each product), some
1e-6 of the output here. Pools in the model test: the same 1e-4, since
the second layer's K and V come from the first layer's attention.
"""

import math
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke

from brpc_tpu.serving.kv_cache import KVCacheConfig as JaxKVConfig
from brpc_tpu.serving.kv_cache import PagedKVCache as JaxKV
from brpc_tpu.serving.model import ModelConfig as JaxModelConfig
from brpc_tpu.serving.model import TinyTransformer as JaxModel
from brpc_tpu.tpu import pallas_ops as jax_ops
from brpc_tpu_torch.serving.kv_cache import KVCacheConfig, PagedKVCache
from brpc_tpu_torch.serving.model import ModelConfig, TinyTransformer
from brpc_tpu_torch.tpu import _build
from brpc_tpu_torch.tpu import pallas_ops as torch_ops

FLASH_TOL = 1e-4
H, D = 4, 16


def _kernel_const(name):
    with open(os.path.join(_build.CSRC, "flash_fwd.cu")) as fh:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             fh.read()).group(1))


# the kernel's tiling, as csrc/flash_fwd.cu sets it: query rows per block,
# key stripes (warps) per block, keys per tile
ROWS, WARPS, KEYS = (_kernel_const(n) for n in ("kSRows", "kSWarps",
                                                "kSKeys"))
LOG2E = np.float32(1.4426950408889634)
# the serving buckets (serving/model.py: 16, 32, 128, then multiples of
# 128 to 1024) that chip_smoke.py's run launches, and a ragged S <= 128
BUCKETS = (16, 32, 100, 128, 384, 768, 1024)


def _tf32(x):
    """x rounded to tf32 as cvt.rna.tf32.f32: to nearest, ties away from
    zero, on the int32 view of the bits, the 13 low mantissa bits
    cleared."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.int32)
    return ((b + np.int32(0x1000)) & np.int32(~0x1FFF)).view(np.float32)


def _tf32_operand(x):
    """The tf32 value a product reads from an fp32 register: its 13 low
    mantissa bits ignored, that is truncated."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.int32)
    return (b & np.int32(~0x1FFF)).view(np.float32)


def _mm_3xtf32(a, b):
    """a @ b with fp32 sums of a_lo b_hi + a_hi b_lo + a_hi b_hi, hi the
    rounded tf32 and lo = x - hi as the product reads it."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32_operand(a - ah), _tf32_operand(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _mm_tf32(a, b):
    """a @ b in one tf32 pass: the record of what 3xTF32 buys."""
    return _tf32(a) @ _tf32(b)


def emulate(q, k, v, causal, mm=_mm_3xtf32):
    """The kernel's arithmetic on q (Sq, H, D), k and v (Sk, H, D) fp32:
    o (Sq, H, D) fp32, causal aligned at 0, o = 0 for a row with no key."""
    sq, h, d = q.shape
    sk = k.shape[0]
    scale = np.float32(1.0 / math.sqrt(d))
    scale_log2 = np.float32(scale * LOG2E)
    nq, nk = -(-sq // ROWS), -(-sk // KEYS)
    qt = np.zeros((h, nq * ROWS, d), np.float32)
    qt[:, :sq] = q.transpose(1, 0, 2)
    qt = qt.reshape(h, nq, ROWS, d)
    kt, vt = (np.zeros((h, nk * KEYS, d), np.float32) for _ in range(2))
    kt[:, :sk], vt[:, :sk] = k.transpose(1, 0, 2), v.transpose(1, 0, 2)
    q0 = np.arange(nq) * ROWS
    rows = q0[:, None] + np.arange(ROWS)                        # [nq, 16]
    # the tiles a q-tile runs: up to its last live key
    k_end = np.minimum(sk, q0 + ROWS) if causal else np.full(nq, sk)
    runs = -(-k_end // KEYS)                                    # [nq]
    parts = []
    with np.errstate(invalid="ignore", over="ignore"):
        for w in range(WARPS):
            m = np.full((h, nq, ROWS), -np.inf, np.float32)
            l = np.zeros((h, nq, ROWS), np.float32)
            acc = np.zeros((h, nq, ROWS, d), np.float32)
            for tile in range(w, nk, WARPS):
                keys = tile * KEYS + np.arange(KEYS)
                kk = kt[:, None, tile * KEYS:(tile + 1) * KEYS]
                vv = vt[:, None, tile * KEYS:(tile + 1) * KEYS]
                s = mm(qt, kk.swapaxes(-1, -2))              # [h, nq, 16, 32]
                live = (keys < sk) & (tile < runs)[:, None, None]
                if causal:
                    live = live & (rows[:, :, None] >= keys)
                s = np.where(live, s, np.float32(-np.inf))
                m_new = np.maximum(m, s.max(-1) * scale)
                mb = np.where(m_new == -np.inf, np.float32(0),
                              m_new * LOG2E)
                alpha = np.where(m_new == m, np.float32(1),
                                 np.exp2(m * LOG2E - mb))
                p = np.exp2(s * scale_log2 - mb[..., None])
                l = l * alpha + p.sum(-1, dtype=np.float32)
                acc = acc * alpha[..., None] + mm(p, vv)
                m = m_new
            parts.append((m, l, acc))
        mmax = np.max([pm for pm, _, _ in parts], axis=0)
        big_l = np.zeros_like(mmax)
        big_acc = np.zeros_like(parts[0][2])
        for pm, pl, pacc in parts:
            wt = np.where(pm == -np.inf, np.float32(0),
                          np.exp2((pm - mmax) * LOG2E))
            big_l = big_l + pl * wt
            big_acc = big_acc + pacc * wt[..., None]
    inv = np.where(big_l == 0, np.float32(0),
                   np.float32(1) / np.where(big_l == 0, 1, big_l))
    o = (big_acc * inv[..., None]).reshape(h, nq * ROWS, d)[:, :sq]
    return np.ascontiguousarray(o.transpose(1, 0, 2), dtype=np.float32)


def _inputs(sq, sk, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((sq, H, D)).astype(np.float32)
    k = rng.standard_normal((sk, H, D)).astype(np.float32)
    v = rng.standard_normal((sk, H, D)).astype(np.float32)
    return q, k, v


def _jax_flash(q, k, v, causal):
    """The JAX kernel in interpret mode, vmapped over heads as the JAX
    serving model calls it (its default blocks of 128)."""
    fn = jax.vmap(lambda a, b, c: jax_ops.flash_attention(
        a, b, c, causal=causal, interpret=True), in_axes=1, out_axes=1)
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


def _held(got, want):
    err = float(np.abs(got - want).max())
    limit = FLASH_TOL * max(1.0, float(np.abs(want).max()))
    assert math.isfinite(err) and err <= limit, (err, limit)
    return err


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", BUCKETS)
def test_emulated_kernel_matches_jax_kernel(s, causal):
    q, k, v = _inputs(s, s, seed=s)
    want = _jax_flash(q, k, v, causal)
    got = emulate(q, k, v, causal)
    assert got.shape == (s, H, D)
    err = _held(got, want)
    one_pass = float(np.abs(emulate(q, k, v, causal, _mm_tf32)
                            - want).max())
    print(f"S={s} causal={causal}: 3xTF32 max err {err:.3g}, "
          f"one tf32 pass {one_pass:.3g}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(64, 128), (128, 64)])
def test_emulated_kernel_unequal_lengths(sq, sk, causal):
    """S_q != S_k, the mask aligned at position 0 (row r sees key c iff
    r >= c): the JAX kernel with blocks that divide both."""
    q, k, v = _inputs(sq, sk, seed=sq + 3 * sk)
    fn = jax.vmap(lambda a, b, c: jax_ops.flash_attention(
        a, b, c, causal=causal, block_q=64, block_k=64, interpret=True),
        in_axes=1, out_axes=1)
    want = np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    _held(emulate(q, k, v, causal), want)


def test_emulated_kernel_row_with_no_key_is_zero():
    """A row with no live key (no keys at all) gets o = 0, not NaN."""
    q, k, v = _inputs(16, 1, seed=5)
    o = emulate(q, k[:0], v[:0], causal=True)
    assert o.shape == (16, H, D) and not np.any(o)


# the llm_server example's widths (examples/llm_server/server.py:44-55)
SERVER = dict(vocab=512, d_model=64, n_heads=4, n_layers=2, seed=0)


def _emulated_flash(calls):
    def flash(q, k, v, causal=False, block_q=128, block_k=128):
        calls.append(tuple(q.shape))
        o = emulate(q.numpy(), k.numpy(), v.numpy(), causal)
        return torch.from_numpy(o)
    return flash


@pytest.mark.parametrize("length", [17, 100, 300])
def test_serving_model_with_emulated_kernel_matches_jax(monkeypatch,
                                                        length):
    """The slice as a whole: the port's serving model with the emulated
    kernel in place of flash_attention against the JAX model with its
    Pallas kernel (interpret mode) at the llm_server example's widths:
    first tokens equal, pools within FLASH_TOL (block 0 left out, as in
    test_torch_model.py)."""
    block, blocks = 16, 64
    jcfg = JaxModelConfig(attn="flash", **SERVER)
    jm = JaxModel(jcfg, JaxKV(JaxKVConfig(block, blocks), jcfg.n_layers,
                              jcfg.kv_dim))
    tcfg = ModelConfig(attn="flash", **SERVER)
    tm = TinyTransformer(tcfg, PagedKVCache(KVCacheConfig(block, blocks),
                                            tcfg.n_layers, tcfg.kv_dim,
                                            device="cpu"))
    calls = []
    monkeypatch.setattr(torch_ops, "flash_attention", _emulated_flash(calls))
    prompt = jm.synth_prompt(length)
    jt = jm.kv.alloc_sequence(1, length)
    tt = tm.kv.alloc_sequence(1, length)
    assert jt == tt
    assert jm.prefill(prompt, jt) == tm.prefill(prompt, tt)
    bucket = chip_smoke.prefill_bucket(length)
    assert calls == [(bucket, SERVER["n_heads"], D)] * SERVER["n_layers"]
    for jp, tp in ((jm.kv.k_pool, tm.kv.k_pool),
                   (jm.kv.v_pool, tm.kv.v_pool)):
        _held(tp[:, block:].numpy(), np.asarray(jp)[:, block:])


# ---------------------------------------------------------------------------
# The C call
# ---------------------------------------------------------------------------
FWD_ARGTYPES = ([torch_ops._ptr] * 5 + [torch_ops._i32] * 6
                + [torch_ops._i64] * 8 + [torch_ops._ptr])


@pytest.fixture
def recorder(monkeypatch):
    """Replaces the launch: each C call is recorded as (symbol, args) and
    returns 0, each bind as (source, symbol, argtypes); the plain version
    on the kernel path fails the test; fresh counters and no bound
    function, so the module's own stay untouched."""
    calls, binds = [], []

    def bind(source, symbol, argtypes):
        binds.append((source, symbol, list(argtypes)))
        return symbol

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on the kernel path")

    monkeypatch.setattr(torch_ops, "launches", torch_ops.LaunchCounts())
    monkeypatch.setattr(torch_ops, "_serving_fn", None)
    monkeypatch.setattr(torch_ops, "_bind", bind)
    monkeypatch.setattr(torch_ops, "_call",
                        lambda fn, t, *args: calls.append((fn, args)) or 0)
    monkeypatch.setattr(torch_ops, "attention_reference", refuse)
    return calls, binds


def _fused_qkv(s, seed=0):
    """The serving model's (S, H, 16) views of its fused (S, 3 H 16) QKV
    product: row stride 192 floats, head stride 16."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((s, 3 * H * D)).astype(
        np.float32))
    return tuple(x.view(s, H, D) for x in qkv.split(H * D, dim=-1))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [16, 1024])
def test_serving_call_sends_pointers_dims_and_fused_strides(recorder, s,
                                                            causal):
    calls, binds = recorder
    q, k, v = _fused_qkv(s)
    assert not q.is_contiguous()
    o = torch_ops._flash_cuda(q, k, v, causal)
    assert o.shape == (s, H, D) and o.dtype == torch.float32
    assert o.is_contiguous()
    (symbol, args), = calls
    assert symbol == "brpc_flash_fwd"
    assert args[:5] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), None)
    # n = H, sq, sk, head dim 16, dtype 0 (fp32), causal
    assert args[5:11] == (H, s, s, D, 0, int(causal))
    # (head, row) element strides of q, k, v, then of the contiguous o
    assert args[11:] == (D, 3 * H * D) * 3 + (D, H * D)
    assert torch_ops.launches["flash_attention"] == 1
    assert binds == [("flash_fwd", "brpc_flash_fwd", FWD_ARGTYPES)]


def test_serving_call_two_dims_is_one_head(recorder):
    calls, _ = recorder
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((48, D)).astype(
        np.float32)) for _ in range(3))
    o = torch_ops._flash_cuda(q, k, v, True)
    assert o.shape == (48, D)
    (_, args), = calls
    assert args[5:11] == (1, 48, 48, D, 0, 1)
    assert args[11:] == (D, D) * 4


def test_serving_function_is_bound_once(recorder):
    calls, binds = recorder
    q, k, v = _fused_qkv(128)
    for causal in (True, False, True):
        torch_ops._flash_cuda(q, k, v, causal)
    assert len(calls) == 3 and len(binds) == 1
    assert torch_ops.launches["flash_attention"] == 3


def _bf16(s):
    return tuple(t.to(torch.bfloat16) for t in _fused_qkv(s))


def _strided_last(s):
    rng = np.random.default_rng(2)
    base = torch.from_numpy(rng.standard_normal((s, H, 2 * D)).astype(
        np.float32))
    return (base[..., ::2],) + _fused_qkv(s)[1:]


def _misaligned_base(s):
    flat = torch.zeros(s * H * D + 1)
    return (flat[1:].view(s, H, D),) + _fused_qkv(s)[1:]


def _odd_row_stride(s):
    flat = torch.zeros(s * (H * D + 1))
    return (flat.as_strided((s, H, D), (H * D + 1, D, 1)),) + \
        _fused_qkv(s)[1:]


@pytest.mark.parametrize("make,exc", [
    (_bf16, TypeError), (_strided_last, ValueError),
    (_misaligned_base, ValueError), (_odd_row_stride, ValueError)],
    ids=["bf16", "last_dim_strided", "base_misaligned", "row_misaligned"])
def test_serving_call_refused_before_any_call(recorder, make, exc):
    calls, binds = recorder
    q, k, v = make(32)
    with pytest.raises(exc):
        torch_ops._flash_cuda(q, k, v, True)
    assert calls == [] and binds == []
    assert torch_ops.launches["flash_attention"] == 0


def test_mixed_devices_refused():
    q, k, v = _fused_qkv(16)
    with pytest.raises(ValueError, match="several devices"):
        torch_ops.flash_attention(q, k.to("meta"), v, causal=True)
