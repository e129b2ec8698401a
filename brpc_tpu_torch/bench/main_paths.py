"""The main paths of one checkout on a card, for comparing two commits in
one call:

    python3 brpc_tpu_torch/bench/main_paths.py [CHECKOUT]

CHECKOUT (default: this one) is the root of a checkout, for example a
parent commit unpacked with ``git archive`` into a git-ignored directory.
Builds that checkout's kernels and runs its ``chip_smoke.py`` phases of the
main paths, each printing its JSON line: serving (the flash kernel held
and timed at every prefill bucket, the same buckets for any checkout; the
serving flash call timed on identical fused-QKV inputs, per call as a
caller pays it and in device time; the engine three times; the profiled
engine run), the trainer (ms/step and the profiled step), the ring lane,
the data plane's probe, the copy ceiling's chain and the copy timings. Run
parent, change, change, parent in one call: two calls may land on two
cards.
"""

import json
import os
import subprocess
import sys

import torch

# the serving run's prefill buckets and a ragged S <= 128, as
# chip_smoke.SERVING_BUCKETS: kept here, since a parent checkout's
# chip_smoke.py may predate that name
SERVING_BUCKETS = (16, 32, 100, 128, 384, 768, 1024)
HEADS, HEAD_DIM = 4, 16  # the llm_server example's
ENGINE_RUNS = 3


def time_serving_flash(chip_smoke, dev):
    """flash_attention, causal, at each serving bucket on (S, 4, 16) views
    of one fused QKV product from seed 0, as the serving model passes
    them: the same inputs and timers for any checkout. ``call_ms``: three
    runs of 1000 calls back to back (per call as a caller pays it, host
    cost included); ``graph_ms``: device time, CUDA-graph replay."""
    gen = torch.Generator().manual_seed(0)
    width = HEADS * HEAD_DIM
    rows = {}
    for s in SERVING_BUCKETS:
        qkv = torch.randn((s, 3 * width), generator=gen).to(dev)
        q, k, v = (x.view(s, HEADS, HEAD_DIM)
                   for x in qkv.split(width, dim=-1))

        def call():
            return chip_smoke.pallas_ops.flash_attention(q, k, v,
                                                         causal=True)

        rows[s] = {"call_ms": [chip_smoke.time_ms(call, 1000)
                               for _ in range(3)],
                   "graph_ms": chip_smoke.graph_ms(call)}
    print(json.dumps({"serving_flash_times": rows}), flush=True)


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
    chip_smoke.FLASH_SHAPES = [((s, HEADS, HEAD_DIM), causal)
                               for s in SERVING_BUCKETS
                               for causal in (True, False)]
    chip_smoke.check_flash(dev)
    time_serving_flash(chip_smoke, dev)
    for _ in range(ENGINE_RUNS):
        chip_smoke.run_engine(dev, "auto")
    chip_smoke.profile_engine(dev)
    chip_smoke.run_trainer(dev, smi)
    chip_smoke.run_ring(dev)
    chip_smoke.run_probe(dev)
    chip_smoke.run_ceiling(dev)
    chip_smoke.time_copies(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
