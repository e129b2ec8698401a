"""Per-call cost of the RMSNorm and cross-entropy wrappers of one checkout
on a card, for comparing two commits in one call:

    python3 brpc_tpu_torch/bench/wrappers.py [CHECKOUT]

CHECKOUT (default: this one) is the root of a checkout, for example a
parent commit unpacked with ``git archive`` into a git-ignored directory.
Builds that checkout's kernels and times, on the same inputs for any
checkout (seed 0; the shapes of its ``chip_smoke.py``: RMSNorm at
RMS_MAIN in bf16, each call reading x from HBM as the trainer does, and
the cross-entropy at XENT_MAIN in fp32), ``_rmsnorm_fwd_call`` and
``_xent_cuda`` per call as a caller pays it (three runs of 1000 calls back
to back, host cost included) and in device time (CUDA-graph replay),
beside ``F.rms_norm`` and ``F.cross_entropy(reduction="none")``. Prints
the card's name and power limit, then one JSON line. Run parent, change,
change, parent in one call.
"""

import itertools
import json
import math
import os
import subprocess
import sys

import torch
import torch.nn.functional as F


def main(argv):
    root = os.path.abspath(argv[1] if len(argv) > 1 else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from brpc_tpu_torch.tpu import _build, pallas_ops

    if not torch.cuda.is_available():
        print("wrappers: no CUDA device", file=sys.stderr)
        return 2
    _build.build_all()
    dev = torch.device("cuda", 0)
    print(f"{root}: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    gen = torch.Generator().manual_seed(0)
    rows, cols = cs.RMS_MAIN
    x_bytes = 2 * rows * cols
    xs = [torch.randn(cs.RMS_MAIN, generator=gen).to(
        device=dev, dtype=torch.bfloat16)
        for _ in range(math.ceil(2 * cs.L2_BYTES / x_bytes))]
    nxt = itertools.cycle(xs).__next__
    w = torch.ones(cols, device=dev, dtype=torch.bfloat16)
    n, v = cs.XENT_MAIN
    logits = (3 * torch.randn(n, v, generator=gen)).to(dev)
    targets = torch.randint(0, v, (n,), generator=gen).to(dev)
    calls = {
        "rmsnorm": lambda: pallas_ops._rmsnorm_fwd_call(nxt(), w),
        "rms_norm_library": lambda: F.rms_norm(nxt(), (cols,), w,
                                               eps=pallas_ops.EPS),
        "xent": lambda: pallas_ops._xent_cuda(logits, targets),
        "cross_entropy_library": lambda: F.cross_entropy(
            logits, targets, reduction="none"),
    }
    out = {name: {"call_ms": [cs.time_ms(fn, 1000) for _ in range(3)],
                  "graph_ms": cs.graph_ms(fn)}
           for name, fn in calls.items()}
    print(json.dumps({"root": root, "wrappers": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
