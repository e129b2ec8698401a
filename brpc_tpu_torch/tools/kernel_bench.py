#!/usr/bin/env python
"""kernel_bench — the port's kernel numbers on the card, one line per metric.

The port of ``tools/kernel_bench.py``. Run it standalone (it owns the
card):

    python -m brpc_tpu_torch.tools.kernel_bench

It needs a CUDA device: without one it says so and returns 1, and it
never runs its shapes on the CPU. The first line names the card and its
power limit as ``nvidia-smi --query-gpu=name,power.limit`` prints them;
every rate is stated against the NVIDIA H100 SXM's dense peaks (989
TFLOP/s in bf16, 3.35 TB/s of HBM3), at the power limit that line shows.

Timing: :func:`event_ms`, CUDA events around a run of back-to-back calls
on the current stream after a warm-up, the mean of one call. Attention's
q, k and v are 16 MiB each, so most of its working set stays in the 50 MB
L2 between calls: its rates are warm-cache rates. The memory-bound row
chains the op (``x_{i+1} = f(x_i)``) over a 256 MiB input, past the L2,
so every call moves its real bytes.

- :func:`bench_flash_attention` — forward and forward + backward at the
  flagship shape (B 4, H 8, S 2048, D 128, bf16), causal and not, through
  :func:`~brpc_tpu_torch.tpu.pallas_ops.flash_attention_mha`; then a
  library control line, PyTorch's ``scaled_dot_product_attention`` on the
  same causal shape.
- :func:`bench_ring_path` — ring attention's flash lane
  (:func:`~brpc_tpu_torch.tpu.ring.ring_attention`, sp 4, blocks 512)
  forward and backward on one card: the carry kernel per live hop, the
  dQ and dK/dV kernels per hop at absolute offsets (:func:`ring_pass`).
- :func:`bench_rmsnorm` — the chained RMSNorm kernel at 65536 x 2048 bf16
  against the copy kernel's ceiling (``hbm_copy2d``) and an eager
  ``xc + 1``.
- :func:`bench_train_step_mfu` — the flagship's training step with the
  kernels on, the same config in plain PyTorch, and the at-scale config
  (d_model 2048, 12 layers, vocab 32768, B 4), each the median of three
  measures.
"""

from __future__ import annotations

import math
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from brpc_tpu_torch.tpu import (  # noqa: E402
    bench_kernels, pallas_ops, ring, train)
from brpc_tpu_torch.tpu.device_lane import resolve_device  # noqa: E402

# NVIDIA H100 SXM, dense (data sheet): the MFU and bandwidth denominators
H100_PEAK_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12

WARMUP = 3          # calls before each timed run
FWD_ITERS = 100     # attention forward calls a timed run
BWD_ITERS = 50      # forward + backward calls a timed run
RING_ITERS = 20     # ring fwd + bwd passes a timed run
RMS_ITERS = 50      # chained calls a timed run
TRAIN_STEPS = 10    # steps a measure, flagship configs
BIG_STEPS = 5       # steps a measure, at-scale config
TRAIN_REPS = 3      # measures; the median is reported
LR = 1e-4           # the benchmark loop's SGD rate
# the ring's dO = O x 1e-3, the factor rounded to bf16 as the reference's
# jnp.bfloat16(1e-3) is (a host float: no copy to the card a position)
DO_SCALE = float(torch.tensor(1e-3, dtype=torch.bfloat16))

ATTN_SHAPE = (4, 8, 2048, 128)   # B, H, S, D
RING_SP, RING_BLOCK = 4, 512
RMS_SHAPE = (65536, 2048)        # 256 MiB of bf16: past any cache
TRAIN_B, TRAIN_S = 8, 1024
FLAGSHIP = dict(vocab=16384, d_model=1024, n_heads=8, n_layers=8,
                d_ff=4096, max_seq=1024, dtype=torch.bfloat16)
AT_SCALE = dict(vocab=32768, d_model=2048, n_heads=16, n_layers=12,
                d_ff=8192, max_seq=1024, dtype=torch.bfloat16)
AT_SCALE_B = 4
KERNELS_ON = dict(use_flash_attention=True, use_pallas_norm=True,
                  use_fused_xent=True)
KERNELS_OFF = dict(use_flash_attention=False, use_pallas_norm=False,
                   use_fused_xent=False)


def card_line(dev) -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "-i", str(dev.index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def event_ms(fn, iters: int, warmup: int = WARMUP) -> float:
    """Mean ms of one ``fn()`` over ``iters`` back-to-back calls, between
    CUDA events on the current stream, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _normal(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
        device=dev, dtype=dtype)


def _pct(tflops: float) -> float:
    return tflops * 1e12 / H100_PEAK_FLOPS * 100


def attention_flops(shape, causal: bool) -> float:
    """FLOPs of one attention forward over (B, H, S, D): QK^T and PV, 2
    a MAC; causal counts the lower triangle's useful MACs only."""
    B, H, S, D = shape
    if causal:
        return 2.0 * B * H * S * (S + 1) * D
    return 4.0 * B * H * S * S * D


def fwd_bwd_flops(shape, causal: bool) -> float:
    """Forward (2 matmuls) and backward (5 matmuls) per (q, k) tile pair:
    3.5 forwards."""
    return 3.5 * attention_flops(shape, causal)


def bench_flash_attention(fwd_iters: int = FWD_ITERS,
                          bwd_iters: int = BWD_ITERS) -> dict:
    """Forward and forward + backward at the flagship shape, causal (the
    shape the flagship LM trains) and not; causal rows use the causal
    (lower-triangular) flop count. The forward is the bf16 forward kernel
    (``_flash_fwd_folded`` when causal, ``_flash_fwd_bhsd`` when not); the
    backward is the dQ and dK/dV kernels. Launches: per causal flag,
    ``WARMUP + fwd_iters`` forwards, then ``WARMUP + bwd_iters`` of each
    of forward, dQ and dK/dV. Returns the TFLOP/s of each row."""
    dev = resolve_device()
    B, H, S, D = ATTN_SHAPE
    rng = np.random.default_rng(0)
    q, k, v = (_normal(rng, ATTN_SHAPE, torch.bfloat16, dev)
               for _ in range(3))
    out = {}
    for causal in (True, False):
        flops = attention_flops(ATTN_SHAPE, causal)
        tag = "CAUSAL (flagship shape)" if causal else "non-causal"
        with torch.no_grad():
            ms = event_ms(lambda: pallas_ops.flash_attention_mha(
                q, k, v, causal=causal), fwd_iters)
        tf = flops / ms / 1e9
        print(f"# kernel flash_attention fwd {tag} B={B} H={H} S={S} "
              f"D={D}: {tf:7.2f} TFLOP/s ({_pct(tf):.1f}% of H100 bf16 "
              f"peak)", flush=True)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        do = torch.full_like(q, 1e-3)  # d/do of sum(o * 1e-3)

        def fwd_bwd():
            o = pallas_ops.flash_attention_mha(qg, kg, vg, causal=causal)
            return torch.autograd.grad(o, (qg, kg, vg), do)

        ms_b = event_ms(fwd_bwd, bwd_iters)
        tf_b = fwd_bwd_flops(ATTN_SHAPE, causal) / ms_b / 1e9
        print(f"# kernel flash_attention fwd+bwd {tag} (autograd backward "
              f"kernels dQ, dK/dV): {tf_b:7.2f} TFLOP/s ({_pct(tf_b):.1f}% "
              f"of H100 bf16 peak)", flush=True)
        key = "causal" if causal else "full"
        out[f"fwd_{key}"], out[f"fwd_bwd_{key}"] = tf, tf_b
    out["sdpa_causal"] = _bench_sdpa_control(
        q, k, v, attention_flops(ATTN_SHAPE, True), fwd_iters)
    return out


def _bench_sdpa_control(q, k, v, causal_fwd_flops, iters):
    """Library control: PyTorch's ``scaled_dot_product_attention`` on the
    same causal shape, what the framework's own fused attention does on
    this card. A yardstick only: the port never calls it."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    with torch.no_grad():
        ms = event_ms(lambda: sdpa(q, k, v, is_causal=True), iters)
    tf = causal_fwd_flops / ms / 1e9
    print(f"# control: library torch scaled_dot_product_attention fwd "
          f"causal, same shape: {tf:7.2f} TFLOP/s ({_pct(tf):.1f}% of "
          f"peak)", flush=True)
    return tf


def ring_pass(q, k, v, sp: int, block: int):
    """One causal fwd + bwd of ring attention's flash lane over q, k, v
    [B, S, H, D] (leaves that require grad), through the user's call:
    :func:`~brpc_tpu_torch.tpu.ring.ring_attention` with ``sp`` ring
    positions replayed on the card, then ``torch.autograd.grad`` with dO
    = O x 1e-3 (in O's dtype, as the reference's replay takes it).
    Launches per call: sp (sp + 1) / 2 each of the carry, dQ and dK/dV
    kernels (a hop wholly in a position's future is skipped). Returns
    (o, dq, dk, dv)."""
    o = ring.ring_attention(q, k, v, sp, causal=True, use_flash=True,
                            block_q=block, block_k=block)
    do = (o.detach() * DO_SCALE).to(o.dtype)
    return (o, *torch.autograd.grad(o, (q, k, v), do))


def bench_ring_path(iters: int = RING_ITERS) -> float:
    """Ring attention's data path on the card: the kernels the sp > 1 ring
    runs (the carry-form forward per KV hop with absolute-position causal
    masking, the per-hop backward kernels with dK/dV summed per source
    block), every ring position replayed on one card at the flagship
    shape, so the rate is the ring lane's single-card compute rate (no
    communication). Launches: ``WARMUP + iters`` calls of
    :func:`ring_pass`. Returns TFLOP/s."""
    dev = resolve_device()
    B, H, S, D = ATTN_SHAPE
    rng = np.random.default_rng(0)
    # [B, H, S, D] as the reference draws them, laid out [B, S, H, D]
    # once, outside the timed loop
    q, k, v = (_normal(rng, ATTN_SHAPE, torch.bfloat16, dev)
               .transpose(1, 2).contiguous().requires_grad_()
               for _ in range(3))
    ms = event_ms(lambda: ring_pass(q, k, v, RING_SP, RING_BLOCK), iters)
    tf = fwd_bwd_flops(ATTN_SHAPE, True) / ms / 1e9
    print(f"# ring-attention path fwd+bwd CAUSAL sp={RING_SP} (carry-kernel "
          f"hops + per-hop backward kernels) B={B} H={H} S={S} D={D}: "
          f"{tf:7.2f} TFLOP/s ({_pct(tf):.1f}% of H100 bf16 peak)",
          flush=True)
    return tf


def bench_rmsnorm(iters: int = RMS_ITERS) -> dict:
    """Chained bandwidth of the RMSNorm kernel, against the copy kernel's
    ceiling (``bench_kernels.hbm_copy2d``, the port of the TPU copy) and an
    eager ``xc + 1`` (the elementwise wire). Launches: ``WARMUP + iters``
    each of the RMSNorm and copy kernels. Returns GB/s of each."""
    dev = resolve_device()
    N, D = RMS_SHAPE
    rng = np.random.default_rng(1)
    x = _normal(rng, RMS_SHAPE, torch.bfloat16, dev)
    w = _normal(rng, (D,), torch.bfloat16, dev)

    def chained(call):
        cur = [x]

        def step():
            cur[0] = call(cur[0])

        ms = event_ms(step, iters)
        return 2.0 * N * D * 2 / ms / 1e6  # bf16 read + write, GB/s

    with torch.no_grad():
        gbps = chained(lambda xc: pallas_ops.rmsnorm(xc, w))
        ceil = chained(bench_kernels.hbm_copy2d)
        wire = chained(lambda xc: xc + 1)
    hbm = gbps * 1e9 / H100_HBM_BYTES_PER_S * 100
    print(f"# kernel rmsnorm {N}x{D}: {gbps:7.1f} GB/s HBM ({gbps/ceil*100:.0f}"
          f"% of the {ceil:.0f} GB/s CUDA copy-kernel ceiling; eager "
          f"elementwise wire (xc + 1) = {wire:.0f} GB/s; {hbm:.0f}% of the "
          f"H100's 3.35 TB/s)", flush=True)
    return {"rmsnorm": gbps, "copy_ceiling": ceil, "xc_plus_1": wire}


def step_flops(cfg, batch: int, seq: int) -> float:
    """FLOPs of one training step: 6 x the matmul parameters x tokens,
    plus attention's score and value products (the reference's formula).
    The attention term counts the full S x S square, although the step's
    attention is causal and does about half of it: the MFU printed from
    this count reads that much higher than the useful work's."""
    matmul_params = (cfg.n_layers * (cfg.d_model * 3 * cfg.d_model
                                     + cfg.d_model * cfg.d_model
                                     + 2 * cfg.d_model * cfg.d_ff)
                     + cfg.vocab * cfg.d_model)
    attn_flops = cfg.n_layers * 12 * seq * seq * cfg.d_model
    return 6.0 * matmul_params * batch * seq + attn_flops * batch


def train_steps(model, batch, n: int, lr: float = LR):
    """n SGD steps of ``model`` on ``batch`` (``p - lr * g``, in place);
    the last step's loss."""
    loss = None
    for _ in range(n):
        loss = train.sgd_train_step(model, batch, lr=lr)
    return loss


def measure(cfg, batch: int = TRAIN_B, steps: int = TRAIN_STEPS,
            reps: int = TRAIN_REPS) -> dict:
    """One config's step: a model from seed 0 and a batch of uniform
    tokens and targets, one warm-up step, then ``reps`` measures of
    ``steps`` steps (the median ms/step). Raises if the loss is not
    finite. Returns ms/step, TFLOP/s, MFU, the last loss and the peak
    device memory."""
    dev = resolve_device()
    model = train.TrainLM(cfg, torch.Generator().manual_seed(0), device=dev)
    gen = torch.Generator().manual_seed(1)
    tokens, targets = (torch.randint(0, cfg.vocab, (batch, TRAIN_S),
                                     generator=gen).to(dev)
                       for _ in range(2))
    torch.cuda.reset_peak_memory_stats(dev)
    last = [train_steps(model, (tokens, targets), 1)]

    def step():
        last[0] = train_steps(model, (tokens, targets), 1)

    ms = statistics.median(event_ms(step, steps, warmup=0)
                           for _ in range(reps))
    loss = float(last[0])
    peak = torch.cuda.max_memory_allocated(dev)
    del model, last
    torch.cuda.empty_cache()
    if not math.isfinite(loss):
        raise RuntimeError(f"train step d_model={cfg.d_model}: loss {loss}")
    tf = step_flops(cfg, batch, TRAIN_S) / ms / 1e9
    return {"ms": ms, "tflops": tf, "mfu": tf * 1e12 / H100_PEAK_FLOPS,
            "loss": loss, "peak_bytes": peak}


def bench_train_step_mfu(steps: int = TRAIN_STEPS,
                         big_steps: int = BIG_STEPS,
                         reps: int = TRAIN_REPS) -> dict:
    """The flagship LM's training step on one card, kernels on (flash
    forward and backward, the RMSNorm kernels, the fused cross-entropy:
    the shipping config) and the same config in plain PyTorch; then the
    at-scale point (d_model 2048, 12 layers, vocab 32768, B 4). n_heads
    keeps the head dim at 128. Launches, per kernels-on config: ``1 +
    reps x steps`` steps, each n_layers forwards, dQ and dK/dV, 2 n_layers
    + 1 RMSNorm forwards and backwards, one cross-entropy; the plain
    config none."""
    out = {}
    rows = (("flagship", FLAGSHIP, KERNELS_ON, TRAIN_B, steps,
             "KERNELS-ON (flash+norm+xent)"),
            ("plain", FLAGSHIP, KERNELS_OFF, TRAIN_B, steps,
             "plain-PyTorch baseline"),
            ("at_scale", AT_SCALE, KERNELS_ON, AT_SCALE_B, big_steps,
             "KERNELS-ON (at-scale)"))
    for key, widths, kernels, batch, n, label in rows:
        cfg = train.ModelConfig(**widths, **kernels)
        r = measure(cfg, batch, n, reps)
        print(f"# train step d_model={cfg.d_model} L={cfg.n_layers} "
              f"B={batch} S={TRAIN_S} {label}: {r['ms']:.1f} ms/step, "
              f"{r['tflops']:7.2f} TFLOP/s, MFU={r['mfu']*100:.1f}% (H100 "
              f"bf16 peak), loss {r['loss']:.4f}, peak memory "
              f"{r['peak_bytes'] / 2**30:.2f} GiB", flush=True)
        out[key] = r
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("# kernel bench skipped: no CUDA device (cpu)", flush=True)
        return 1
    dev = resolve_device()
    print(f"# kernel bench on {dev}: {card_line(dev)}", flush=True)
    bench_flash_attention()
    bench_ring_path()
    bench_rmsnorm()
    bench_train_step_mfu()
    return 0


if __name__ == "__main__":
    sys.exit(main())
