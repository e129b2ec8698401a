#!/usr/bin/env python
"""causal_sweep — the flash forward across block configs, on the card.

The port of ``tools/causal_sweep.py``: the bf16 forward at the flagship
shape (B 4, H 8, S 2048, D 128) through ``_flash_fwd_bhsd`` for each
``(causal, block_q, block_k, bn)`` config of the reference; causal rows
use the CAUSAL flop count (lower-triangular useful MACs), every rate is
against the NVIDIA H100 SXM's dense bf16 peak (989 TFLOP/s).

    python -m brpc_tpu_torch.tools.causal_sweep

The CUDA forward tiles on its own, so every config launches the same
kernel and, within one causal flag, gives bit-equal outputs; the blocks
and ``bn`` only decide which configs the TPU wrapper's shape rules
refuse (such a config prints ``cfg=...: FAIL``). The header line says so.
``bn`` (the TPU kernel's heads per grid step) is checked and ignored:
``_flash_fwd_bhsd`` refuses a ``bn`` that does not divide N = B x H, as
the TPU wrapper does, and passes nothing of it to the card.

Methodology: every accepted config is called once, then timed once per
outer pass, 3 passes round-robin over the whole list; each timing is
:func:`~brpc_tpu_torch.tools.kernel_bench.event_ms` over ``ITERS``
back-to-back launches (q, k and v are 16 MiB each: warm in the 50 MB L2).
The report is each config's median over the passes, and its best. Needs
a CUDA device: without one it says so and returns 1.
"""

from __future__ import annotations

import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from brpc_tpu_torch.tools.kernel_bench import (  # noqa: E402
    H100_PEAK_FLOPS, _normal, attention_flops, card_line, event_ms)
from brpc_tpu_torch.tpu import pallas_ops  # noqa: E402
from brpc_tpu_torch.tpu.device_lane import resolve_device  # noqa: E402

SHAPE = (4, 8, 2048, 128)   # B, H, S, D
PASSES = 3
ITERS = 100

# (causal, bq, bk, bn)
CONFIGS = [
    (False, 512, 2048, 1),   # the reference's shipping default (sentinel)
    (False, 512, 2048, 2),
    (False, 512, 2048, 4),
    (False, 1024, 1024, 1),  # drift probe
    (True, 1024, 1024, 1),
    (True, 1024, 1024, 2),
    (True, 1024, 1024, 4),
    (True, 512, 1024, 1),
    (True, 512, 1024, 2),
    (True, 512, 1024, 4),
    (True, 512, 512, 2),
    (True, 512, 512, 4),
    (True, 256, 512, 4),
    (True, 256, 512, 8),
    (True, 256, 256, 4),
    (True, 256, 256, 8),
    (True, 128, 128, 8),
]


def flops(causal: bool) -> float:
    return attention_flops(SHAPE, causal)


def sweep_inputs(dev):
    """q, k, v [B*H, S, D] bf16 from seed 0."""
    B, H, S, D = SHAPE
    rng = np.random.default_rng(0)
    return tuple(_normal(rng, (B * H, S, D), torch.bfloat16, dev)
                 for _ in range(3))


def run_sweep(title, cfgs, call, row, fail, passes=PASSES, iters=ITERS):
    """The sweep: the card and ``title`` as the first two lines; each
    config's first ``call(q, k, v, cfg)`` (a ValueError, the wrapper's
    refusal, prints ``fail(cfg, e)`` and drops the config); ``passes``
    round-robin passes of one :func:`event_ms` each; then ``row(cfg,
    median_ms, best_ms)`` per config. Launches per accepted config: ``1 +
    passes x (WARMUP + iters)``. Returns the inputs, each accepted
    config's first (o, lse) and its ms per pass."""
    dev = resolve_device()
    print(f"# {card_line(dev)}", flush=True)
    print(f"# {title}", flush=True)
    q, k, v = sweep_inputs(dev)
    first = {}
    for cfg in cfgs:
        try:
            first[cfg] = call(q, k, v, cfg)
        except ValueError as e:
            print(fail(cfg, e), flush=True)
    ms = {cfg: [] for cfg in first}
    for p in range(passes):
        for cfg in first:
            ms[cfg].append(event_ms(lambda: call(q, k, v, cfg), iters))
        print(f"# pass {p} done", flush=True)
    for cfg, runs in ms.items():
        print(row(cfg, statistics.median(runs), min(runs)), flush=True)
    return {"inputs": (q, k, v), "first": first, "ms": ms}


def rates(causal: bool, med_ms: float, best_ms: float) -> str:
    """``median X TF/s (P%)  best Y (Q%)`` against the H100 bf16 peak."""
    tfm = flops(causal) / med_ms / 1e9
    tfb = flops(causal) / best_ms / 1e9
    return (f"median {tfm:7.2f} TF/s ({tfm*1e12/H100_PEAK_FLOPS*100:5.1f}%)"
            f"  best {tfb:7.2f} ({tfb*1e12/H100_PEAK_FLOPS*100:5.1f}%)")


def header(entry: str, blocks: str, iters: int) -> str:
    B, H, S, D = SHAPE
    return (f"{entry} at B={B} H={H} S={S} D={D} bf16: the CUDA forward "
            f"tiles on its own, so every config launches one kernel "
            f"(fwd_wgmma_kernel) with bit-equal outputs within a causal "
            f"flag, and {blocks} only decide which configs the TPU "
            f"wrapper's shape rules refuse; each time is CUDA events over "
            f"{iters} launches, q/k/v warm in the 50 MB L2")


def sweep(passes: int = PASSES, iters: int = ITERS) -> dict:
    def call(q, k, v, cfg):
        causal, bq, bk, bn = cfg
        return pallas_ops._flash_fwd_bhsd(q, k, v, causal, bq, bk, bn)

    def row(cfg, med, best):
        causal, bq, bk, bn = cfg
        return (f"causal={int(causal)} bq={bq:5d} bk={bk:5d} bn={bn:2d}: "
                f"{rates(causal, med, best)}")

    def fail(cfg, e):
        return f"cfg={cfg}: FAIL {type(e).__name__}: {e}"

    return run_sweep(header("_flash_fwd_bhsd", "bq, bk and bn", iters),
                     CONFIGS, call, row, fail, passes, iters)


def main() -> int:
    if not torch.cuda.is_available():
        print("# causal sweep skipped: no CUDA device (cpu)", flush=True)
        return 1
    sweep()
    return 0


if __name__ == "__main__":
    sys.exit(main())
