"""The main paths of one checkout on a card, for comparing two commits in
one call:

    python3 brpc_tpu_torch/bench/main_paths.py [CHECKOUT]

CHECKOUT (default: this one) is the root of a checkout, for example a
parent commit unpacked with ``git archive`` into a git-ignored directory.
Builds that checkout's kernels and runs its ``chip_smoke.py`` phases of the
main paths, each printing its JSON line: the trainer (ms/step and the
profiled step), the ring lane, the data plane's probe, the copy ceiling's
chain and the copy timings. Run parent, change, change, parent in one
call: two calls may land on two cards.
"""

import os
import subprocess
import sys

import torch


def main(argv):
    root = os.path.abspath(argv[1] if len(argv) > 1 else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke
    from brpc_tpu_torch.tpu import _build

    if not torch.cuda.is_available():
        print("main_paths: no CUDA device", file=sys.stderr)
        return 2
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"{root}: {smi}", flush=True)
    chip_smoke.run_trainer(dev, smi)
    chip_smoke.run_ring(dev)
    chip_smoke.run_probe(dev)
    chip_smoke.run_ceiling(dev)
    chip_smoke.time_copies(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
