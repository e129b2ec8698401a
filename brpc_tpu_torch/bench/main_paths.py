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
engine run), RMSNorm (the checkout's phase 8, then its forward,
backward and both through autograd timed alike beside F.rms_norm's), the
trainer (ms/step and the profiled step), one more
profiled trainer step with the RMSNorm backward in a ``rmsnorm_bwd``
range (``profile_train_step``: the same for any checkout), the ring lane,
the data plane's probe, the copy ceiling's chain and the copy timings. Run
parent, change, change, parent in one call: two calls may land on two
cards.
"""

import contextlib
import importlib.util
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


@contextlib.contextmanager
def labelled_rmsnorm_bwd(ops, name="rmsnorm_bwd"):
    """``ops._RMSNorm.backward`` inside a ``torch.profiler.record_function``
    range ``name`` while the block runs (autograd reads the backward when
    it calls it), so a profile can say what the backward cost."""
    saved = ops._RMSNorm.__dict__["backward"]
    inner = saved.__func__

    def backward(ctx, g):
        with torch.profiler.record_function(name):
            return inner(ctx, g)

    ops._RMSNorm.backward = staticmethod(backward)
    try:
        yield
    finally:
        ops._RMSNorm.backward = saved


def range_kernels(prof, name):
    """The device work launched inside the CPU ranges ``name`` of a
    torch.profiler run: each range's subtree of host events holds the
    runtime calls that launched it (``cudaLaunchKernel`` and the like,
    under an ATen op or, for a ctypes launch, straight under the range),
    and each runtime call's event id is the correlation id of its kernel
    or memset. Returns {"ranges",
    "launch_calls", "kernels", "device_us", "names": {kernel: [count,
    device µs]}}."""
    from torch.autograd import DeviceType

    device = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            device.setdefault(e.id, []).append(e)
    out = {"ranges": 0, "launch_calls": 0, "kernels": 0, "device_us": 0.0,
           "names": {}}

    def walk(event):
        if event.name.startswith("cu"):  # a CUDA runtime or driver call
            out["launch_calls"] += 1
            for k in device.get(event.id, ()):
                us = k.time_range.elapsed_us()
                row = out["names"].setdefault(k.name[:80], [0, 0.0])
                row[0] += 1
                row[1] += us
                out["kernels"] += 1
                out["device_us"] += us
        for child in event.cpu_children:
            walk(child)

    for e in prof.events():
        if e.name == name and e.device_type == DeviceType.CPU:
            out["ranges"] += 1
            walk(e)
    return out


def profile_train_step(chip_smoke, dev):
    """One profiled step of phase 10's trainer (the checkout's flagship,
    batch and lr; two unprofiled steps first) with the RMSNorm backward in
    a ``rmsnorm_bwd`` range: the step's device kernels and busy time and
    the range's kernels and device time, the same for any checkout."""
    from torch.profiler import ProfilerActivity, profile

    cs, train = chip_smoke, chip_smoke.train
    cfg = train.ModelConfig(**cs.FLAGSHIP, n_layers=cs.TRAIN_LAYERS,
                            dtype=torch.bfloat16, use_flash_attention=True,
                            use_pallas_norm=True, use_fused_xent=True)
    model = train.TrainLM(cfg, torch.Generator().manual_seed(0), device=dev)
    batch = train.demo_batch(torch.Generator().manual_seed(1), cfg,
                             cs.TRAIN_B, cs.TRAIN_S, device=dev)
    for _ in range(2):
        train.sgd_train_step(model, batch, lr=cs.TRAIN_LR)
    torch.cuda.synchronize()
    with labelled_rmsnorm_bwd(cs.pallas_ops), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train.sgd_train_step(model, batch, lr=cs.TRAIN_LR)
        torch.cuda.synchronize()
    kernels, busy, top = cs.device_time(prof)
    row = {"device_kernels": kernels, "device_busy_us": busy,
           "top_device_us": top,
           "rmsnorm_bwd": range_kernels(prof, "rmsnorm_bwd")}
    print(json.dumps({"train_profile": row}), flush=True)
    del model
    torch.cuda.empty_cache()
    return row


def time_rmsnorm(chip_smoke, dev):
    """The checkout's phase 8 (its RMSNorm kernels held and timed), then
    RMSNorm's forward, backward and forward + backward per call and in
    device time beside F.rms_norm's, timed alike for any checkout
    (``rmsnorm_calls`` of this file's ``wrappers.py``)."""
    chip_smoke.check_rmsnorm(dev)
    spec = importlib.util.spec_from_file_location(
        "bench_wrappers", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "wrappers.py"))
    wrappers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(wrappers)
    row = wrappers.rmsnorm_calls(chip_smoke, chip_smoke.pallas_ops, dev,
                                 torch.Generator().manual_seed(0), iters=200)
    print(json.dumps({"rmsnorm_calls": row}), flush=True)


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
    time_rmsnorm(chip_smoke, dev)
    chip_smoke.run_trainer(dev, smi)
    profile_train_step(chip_smoke, dev)
    chip_smoke.run_ring(dev)
    chip_smoke.run_probe(dev)
    chip_smoke.run_ceiling(dev)
    chip_smoke.time_copies(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
