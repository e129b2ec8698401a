#!/usr/bin/env python
"""qgrid_sweep — the q-grid flash forward's configs, on the card.

The port of ``tools/qgrid_sweep.py``: ``_flash_fwd_qgrid`` (the TPU
kernel kept K/V resident and looped over k-chunks of ``bkc``; on the card
the same CUDA forward kernel, whose key loop already stops at the
diagonal) at the flagship shape for each ``(causal, bq, bkc, bn)`` config
of the reference, with causal_sweep's interleaved-median methodology and
report, against the NVIDIA H100 SXM's dense bf16 peak (989 TFLOP/s).

    python -m brpc_tpu_torch.tools.qgrid_sweep

As in causal_sweep, the blocks only decide which configs the TPU
wrapper's shape rules refuse; every accepted config launches the same
kernel, bit-equal within a causal flag. Needs a CUDA device: without one
it says so and returns 1.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from brpc_tpu_torch.tools.causal_sweep import (  # noqa: E402
    ITERS, PASSES, header, rates, run_sweep)
from brpc_tpu_torch.tpu import pallas_ops  # noqa: E402

# (causal, bq, bkc, bn)
CONFIGS = [
    (True, 1024, 512, 1),
    (True, 1024, 512, 2),
    (True, 1024, 1024, 1),
    (True, 1024, 1024, 2),
    (True, 512, 512, 1),
    (True, 512, 512, 2),
    (True, 512, 512, 4),
    (True, 512, 1024, 2),
    (True, 2048, 512, 1),
    (True, 2048, 1024, 1),
    (False, 1024, 1024, 1),
    (False, 1024, 1024, 2),
    (False, 512, 2048, 2),
    (False, 2048, 1024, 1),
]


def sweep(passes: int = PASSES, iters: int = ITERS) -> dict:
    def call(q, k, v, cfg):
        causal, bq, bkc, bn = cfg
        return pallas_ops._flash_fwd_qgrid(q, k, v, causal, bq, bkc, bn)

    def row(cfg, med, best):
        causal, bq, bkc, bn = cfg
        return (f"qgrid causal={int(causal)} bq={bq:5d} bkc={bkc:5d} "
                f"bn={bn}: {rates(causal, med, best)}")

    def fail(cfg, e):
        return (f"cfg={cfg}: FAIL {type(e).__name__}: "
                f"{str(e).splitlines()[0][:120]}")

    return run_sweep(header("_flash_fwd_qgrid", "bq, bkc and bn", iters),
                     CONFIGS, call, row, fail, passes, iters)


def main() -> int:
    if not torch.cuda.is_available():
        print("# qgrid sweep skipped: no CUDA device (cpu)", flush=True)
        return 1
    sweep()
    return 0


if __name__ == "__main__":
    sys.exit(main())
