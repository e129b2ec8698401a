"""The benchmark's own yardstick: peaks, operation and byte counts, the
kernel names it groups by, and the merge of device intervals.

These are copies, frozen here so that a change to the program cannot move
the measure it is judged by. Each names what it was copied from and how
its count differs. Nothing here imports the program.
"""

from __future__ import annotations

import math
import re

# NVIDIA H100 SXM, dense rates without sparsity (NVIDIA's data sheet), as
# brpc_tpu_torch/tools/kernel_bench.py:60-61 has them.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

BF16 = 2
FP32 = 4
INT64 = 8

# The __global__ kernels of the port's five training sources, by symbol
# (csrc/flash_fwd.cu, flash_bwd.cu, rmsnorm.cu, xent.cu; hopper.cuh holds
# the wgmma kernels' bodies).
FLASH_FWD_KERNELS = ("fwd_wgmma_kernel", "flash_fwd_kernel",
                     "fwd_f32_mma_kernel")
FLASH_BWD_KERNELS = ("dq_wgmma_kernel", "dkv_wgmma_kernel",
                     "flash_dq_kernel", "flash_dkv_kernel")
RMSNORM_KERNELS = ("rmsnorm_fwd_regs", "rmsnorm_fwd_loop",
                   "rmsnorm_bwd_regs", "rmsnorm_bwd_loop",
                   "rmsnorm_bwd_finish")
XENT_KERNELS = ("xent_kernel",)
PORT_KERNELS = (FLASH_FWD_KERNELS + FLASH_BWD_KERNELS + RMSNORM_KERNELS
                + XENT_KERNELS)
# cuBLAS and CUTLASS matrix products, as the profiler names them on Hopper
MATMUL_PATTERN = re.compile(r"gemm|xmma|cutlass|nvjet|cublas", re.I)


def is_kernel_of(name: str, kernels) -> bool:
    """True when the profiler's kernel name holds one of ``kernels`` as a
    whole symbol (a template's arguments and the signature follow it)."""
    return any(re.search(rf"(?<![A-Za-z0-9_]){k}(?![A-Za-z0-9_])", name)
               for k in kernels)


def is_matmul(name: str) -> bool:
    return bool(MATMUL_PATTERN.search(name))


def attention_flops(batch: int, heads: int, seq: int, head_dim: int,
                    causal: bool = True) -> float:
    """FLOPs of one attention forward over (B, H, S, D): QK^T and PV, two
    a multiply-add. Causal counts the S(S+1)/2 live pairs only. Copied
    from brpc_tpu_torch/tools/kernel_bench.py:126 ``attention_flops``,
    unchanged."""
    if causal:
        return 2.0 * batch * heads * seq * (seq + 1) * head_dim
    return 4.0 * batch * heads * seq * seq * head_dim


def attention_bwd_flops(batch: int, heads: int, seq: int, head_dim: int,
                        causal: bool = True) -> float:
    """FLOPs of one attention backward: the dP, dQ, dK and dV products, 2 x
    the forward. kernel_bench.py:135 ``fwd_bwd_flops`` counts 3.5 x the
    forward for forward and backward together, which takes in the
    kernels' recompute of S; this count does not, so a backward that
    keeps P reads the same work."""
    return 2.0 * attention_flops(batch, heads, seq, head_dim, causal)


def matmul_params(m: dict) -> int:
    """Parameters in the step's matrix products: QKV, output and the two
    MLP matrices of every layer, and the head (the embedding is a
    gather). ``m`` holds ModelConfig's fields."""
    d, f = m["d_model"], m["d_ff"]
    return m["n_layers"] * (3 * d * d + d * d + 2 * d * f) + d * m["vocab"]


def step_flops(m: dict, batch: int, seq: int) -> float:
    """FLOPs of one training step: 6 x the matrix-product parameters x the
    tokens, plus every layer's causal attention products at 3 x the
    forward (forward and a backward of 2 x). Copied from
    kernel_bench.py:272 ``step_flops``, which counts attention's full
    S x S square though the step is causal; this counts the causal
    pairs S(S+1)/2."""
    heads, head_dim = m["n_heads"], m["d_model"] // m["n_heads"]
    attn = attention_flops(batch, heads, seq, head_dim, causal=True)
    return (6.0 * matmul_params(m) * batch * seq
            + 3.0 * m["n_layers"] * attn)


def flash_fwd_work(m: dict, batch: int, seq: int):
    """(FLOPs, bytes) of a step's flash forward calls, one a layer: q, k
    and v read, o written in bf16, the fp32 log-sum-exp written."""
    h, dh = m["n_heads"], m["d_model"] // m["n_heads"]
    n = batch * h * seq
    flops = attention_flops(batch, h, seq, dh, causal=True)
    nbytes = 4 * n * dh * BF16 + n * FP32
    return m["n_layers"] * flops, m["n_layers"] * nbytes


def flash_bwd_work(m: dict, batch: int, seq: int):
    """(FLOPs, bytes) of a step's dQ and dK/dV calls, one pair a layer: q,
    k, v and dO read, dQ, dK and dV written in bf16, the fp32 lse and
    delta read."""
    h, dh = m["n_heads"], m["d_model"] // m["n_heads"]
    n = batch * h * seq
    flops = attention_bwd_flops(batch, h, seq, dh, causal=True)
    nbytes = 7 * n * dh * BF16 + 2 * n * FP32
    return m["n_layers"] * flops, m["n_layers"] * nbytes


def rmsnorm_work(m: dict, batch: int, seq: int):
    """(FLOPs, bytes) of a step's RMSNorm kernels, forward and backward,
    2L + 1 norms of each: forward reads x and w and writes out; backward
    reads x, w and g and writes dx and dw, all bf16. The backward's fp32
    partial sums are the kernel's own scratch and not counted. FLOPs are
    a few a element and never bound it: counted as 0."""
    rows, d = batch * seq, m["d_model"]
    norms = 2 * m["n_layers"] + 1
    fwd = (2 * rows * d + d) * BF16
    bwd = (3 * rows * d + 2 * d) * BF16
    return 0.0, norms * (fwd + bwd)


def xent_work(m: dict, batch: int, seq: int):
    """(FLOPs, bytes) of a step's fused cross-entropy forward: the fp32
    logits [B*S, V] and the int64 targets read, the fp32 per-row loss
    written. FLOPs counted as 0, as for RMSNorm."""
    rows = batch * seq
    return 0.0, rows * m["vocab"] * FP32 + rows * INT64 + rows * FP32


def roofline_share(flops: float, nbytes: float, seconds: float):
    """(% of the roofline, which bound): the least time the chip could
    take, the larger of FLOPs over the bf16 peak and bytes over HBM
    bandwidth, over the measured time."""
    t_flops = flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_HBM_BYTES_PER_S
    bound = "flops" if t_flops >= t_bytes else "bytes"
    return 100.0 * max(t_flops, t_bytes) / seconds, bound


def merged_busy(spans) -> float:
    """Total length of the union of (start, end) intervals: device time
    with overlapping kernels counted once. Copied from chip_smoke.py:3376
    ``device_time``'s merge, unchanged."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def idle_gaps(spans, start: float, stop: float):
    """The gaps in [start, stop] that no interval covers, as (start, end)
    pairs, in time order."""
    gaps, end = [], start
    for a, b in sorted(spans):
        if a > end:
            gaps.append((end, min(a, stop)))
        end = max(end, b)
        if end >= stop:
            break
    if end < stop:
        gaps.append((end, stop))
    return [g for g in gaps if g[1] > g[0]]
