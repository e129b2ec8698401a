"""chip_smoke — drive the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every kernel of ``brpc_tpu_torch`` from ``brpc_tpu_torch/csrc``
(nvcc, sm_90a), holds each kernel against its plain PyTorch version at
the shapes the serving path gives it, then drives the serving engine at
the full width of ``examples/llm_server`` through ``submit(..., done=)``
and checks that the path really launched the kernels and that its tokens
equal a run with plain attention; a last, profiled run of the same
requests shows where the time goes. Exits non-zero, with no result line,
on any failure, without a card, or without the package beside it.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists every kernel with its launches on the main path,
error, time, plain and library times and its bound.
"""

import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from brpc_tpu_torch.serving import (EngineConfig, KVCacheConfig,  # noqa: E402
                                    ModelConfig, PagedKVCache,
                                    ServingEngine, TinyTransformer)
from brpc_tpu_torch.tpu import _build, pallas_ops  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 outside the
# tensor cores in FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# kernel vs plain: fp32 on both sides, only the summation order differs
FLASH_TOL = 1e-4
FLASH_SHAPES = [((s, 4, 16), causal) for s in (16, 128, 384, 1024)
                for causal in (True, False)] + [
    ((256, 64), True), ((256, 64), False),
    ((256, 2, 32), True), ((256, 128), True)]  # the other head dims
MAIN_SHAPE = ((1024, 4, 16), True)  # the largest prefill the path runs

# the llm_server example's widths (examples/llm_server/server.py:44-55)
PROMPT_LENS = [5, 16, 17, 100, 128, 300, 700, 960]
MAX_NEW = [8, 12, 16, 20, 24, 28, 32, 32]
# the example's token_budget (512) never admits a prompt longer than the
# budget, in the JAX engine as in the port; 1024 admits every prompt here
TOKEN_BUDGET = 1024


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def time_ms(fn, iters):
    """Mean device time of one call, from CUDA events around ``iters``
    back-to-back calls after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=20):
    """Device time of one call without the host's launch cost: ``iters``
    calls captured in a CUDA graph, the replay timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def flash_bound(shape, causal):
    """Least time for the work: each input read once and the output
    written once, against the 4 * D multiply-adds of the live (q, k)
    pairs (QK^T and PV), whichever is larger."""
    s, d = shape[0], shape[-1]
    h = shape[1] if len(shape) == 3 else 1
    nbytes = 4 * s * h * d * 4
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * pairs * d * h
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_flash(dev):
    """Phase 3: the kernel against attention_reference on the card."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    gen = torch.Generator(device="cpu").manual_seed(0)
    rows = {}
    for shape, causal in FLASH_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen).to(dev)
                   for _ in range(3))
        out = pallas_ops.flash_attention(q, k, v, causal=causal)
        ref = pallas_ops.attention_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not math.isfinite(err) or err > FLASH_TOL:
            raise AssertionError(f"flash_attention {shape} causal={causal}:"
                                 f" max |kernel - plain| {err} > "
                                 f"{FLASH_TOL}")
        # SDPA as the yardstick only: (1, H, S, D) views of the same data
        qh, kh, vh = (t.unsqueeze(1) if t.dim() == 2 else t
                      for t in (q, k, v))
        qh, kh, vh = (t.permute(1, 0, 2).unsqueeze(0) for t in (qh, kh, vh))
        iters = 200 if shape[0] <= 384 else 50
        bound_ms, bound_by = flash_bound(shape, causal)
        calls = {
            "kernel": lambda: pallas_ops.flash_attention(q, k, v,
                                                         causal=causal),
            "plain": lambda: pallas_ops.attention_reference(q, k, v,
                                                            causal=causal),
            "library": lambda: sdpa(qh, kh, vh, is_causal=causal),
        }
        # *_ms: per call as a caller pays it, host launch cost included;
        # *_graph_ms: device time alone, replayed from a CUDA graph
        row = {"shape": list(shape), "causal": causal, "max_err": err}
        for name, fn in calls.items():
            row[f"{name}_ms"] = time_ms(fn, iters)
            row[f"{name}_graph_ms"] = graph_ms(fn)
        row.update(bound_ms=bound_ms, bound_by=bound_by)
        rows[(tuple(shape), causal)] = row
        print(json.dumps({"flash_attention": row}), flush=True)
    return rows


# card vs CPU: the same model in fp32 (TF32 off) on both; cuBLAS and the
# CPU's BLAS sum in another order
CPU_TOL = 1e-4


def check_against_cpu(dev):
    """The model on the card (flash kernel) against the same model on the
    CPU (plain attention) on a small input: three prefills and two decode
    steps; K/V pools within CPU_TOL (block 0, the scratch target of
    padded lanes, left out) and greedy tokens equal."""
    models = []
    for d in (dev, torch.device("cpu")):
        cfg = ModelConfig(attn="auto")
        kv = PagedKVCache(KVCacheConfig(block_size=16, num_blocks=64),
                          cfg.n_layers, cfg.kv_dim, device=d)
        models.append(TinyTransformer(cfg, kv))
    toks, errs = [], []
    for m in models:
        seqs = dict(enumerate((17, 100, 300), start=1))
        last = {i: m.prefill(m.synth_prompt(n),
                             m.kv.alloc_sequence(i, n))
                for i, n in seqs.items()}
        out = [list(last.values())]
        for _ in range(2):
            ids = sorted(seqs)
            tables = [m.kv.extend_sequence(i, seqs[i] + 1) for i in ids]
            nxt = m.decode_step(np.array([last[i] for i in ids], np.int32),
                                np.array([seqs[i] for i in ids], np.int32),
                                tables)
            out.append([int(t) for t in nxt])
            for i, t in zip(ids, nxt):
                seqs[i] += 1
                last[i] = int(t)
        toks.append(out)
    bs = 16
    for a, b in ((models[0].kv.k_pool, models[1].kv.k_pool),
                 (models[0].kv.v_pool, models[1].kv.v_pool)):
        errs.append(float((a[:, bs:].cpu() - b[:, bs:]).abs().max()))
    if toks[0] != toks[1] or max(errs) > CPU_TOL:
        raise AssertionError(f"card vs CPU: tokens {toks[0]} vs {toks[1]}, "
                             f"pool max err {max(errs)} (tol {CPU_TOL})")
    print(json.dumps({"card_vs_cpu": {"tokens": toks[0],
                                      "pool_max_err": max(errs)}}),
          flush=True)


def build_engine(dev, attn):
    cfg = ModelConfig(vocab=512, d_model=64, n_heads=4, n_layers=2,
                      max_context=1024, seed=0, attn=attn)
    kv = PagedKVCache(KVCacheConfig(block_size=16, num_blocks=256,
                                    watermark=0.90),
                      cfg.n_layers, cfg.kv_dim, device=dev)
    kv._check = True  # audit the ledger and the (1, 1) step contract
    model = TinyTransformer(cfg, kv)
    engine = ServingEngine(model, kv, EngineConfig(
        max_batch=8, token_budget=TOKEN_BUDGET, idle_wait_s=0.001))
    return engine.start()


def serve(engine, requests, timeout=600.0):
    """Submit (prompt_len, max_new) requests together; wait for every
    ``done``. Returns (results in request order, wall seconds)."""
    results = {}
    lock = threading.Lock()
    ev = threading.Event()

    def done_for(i):
        def done(res):
            with lock:
                results[i] = res
                if len(results) == len(requests):
                    ev.set()
        return done

    t0 = time.perf_counter()
    for i, (plen, max_new) in enumerate(requests):
        code, _ = engine.submit(engine.model.synth_prompt(plen), max_new,
                                done=done_for(i))
        if code != 0:
            raise AssertionError(f"submit({plen}, {max_new}) refused: "
                                 f"{code}")
    if not ev.wait(timeout):
        raise AssertionError(f"only {len(results)}/{len(requests)} "
                             f"requests completed in {timeout}s")
    wall = time.perf_counter() - t0
    out = [results[i] for i in range(len(requests))]
    for (plen, max_new), res in zip(requests, out):
        if (res.error_code, res.finish_reason, len(res.tokens)) != \
                (0, "length", max_new):
            raise AssertionError(f"request ({plen}, {max_new}) ended "
                                 f"{res}")
        if not all(0 <= t < engine.model.config.vocab for t in res.tokens):
            raise AssertionError(f"token out of vocab in {res.tokens}")
    return out, wall


def run_engine(dev, attn):
    """Phase 4: the serving engine at full width. The flash launch count
    is reset just before the requests are submitted and read right after
    the last completes (a warm-up request runs first, uncounted)."""
    engine = build_engine(dev, attn)
    try:
        serve(engine, [(16, 2)])
        pallas_ops.launches.reset()
        requests = list(zip(PROMPT_LENS, MAX_NEW))
        results, wall = serve(engine, requests)
        engine.kv.store.fence()
        launches = pallas_ops.launches["flash_attention"]
        snap = engine.snapshot()
    finally:
        engine.stop()
    engine.kv.assert_idle(f"after stop ({attn})")
    engine.model.close()
    engine.kv.close()
    ttft = sorted(r.ttft_us for r in results)
    tokens = sum(len(r.tokens) for r in results)
    stats = {
        "attn": attn, "requests": len(results), "tokens": tokens,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "ttft_us_p50": float(np.percentile(ttft, 50)),
        "ttft_us_max": ttft[-1],
        "step_us_p50": snap["step_us_p50"],
        "steps": snap["steps"], "flash_launches": launches,
    }
    print(json.dumps({"engine": stats}), flush=True)
    return results, launches, engine.model.config.n_layers


def profile_engine(dev):
    """Phase 5: where the main path's time goes. The same requests under
    torch.profiler: device busy share (kernel intervals merged, over the
    wall time of the run), kernel launches per engine step, and the
    kernels that take the most device time. The profiler slows the host,
    so the share is a lower bound for an unprofiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine = build_engine(dev, "auto")
    try:
        serve(engine, [(16, 2)])
        steps0 = engine.steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            serve(engine, list(zip(PROMPT_LENS, MAX_NEW)))
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        steps = engine.steps - steps0
    finally:
        engine.stop()
    engine.model.close()
    engine.kv.close()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(((e.key, e.self_device_time_total, e.count)
                  for e in prof.key_averages()
                  if e.self_device_time_total > 0),
                 key=lambda r: -r[1])[:8]
    stats = {
        "wall_us": wall_us, "steps": steps,
        "device_kernels": len(spans),
        "kernels_per_step": len(spans) / steps if steps else None,
        "device_busy_us": busy if spans else None,
        "device_busy_share": busy / wall_us if spans else None,
        "top_device_us": [{"name": k[:60], "us": t, "calls": c}
                          for k, t, c in top],
    }
    print(json.dumps({"profile": stats}), flush=True)


def main():
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; the port's smoke run needs a card")
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.1f}s")
    for name, out in built.items():
        log(f"--- nvcc {name}.cu\n{out.strip()}")

    flash = check_flash(dev)
    check_against_cpu(dev)
    auto, launches, n_layers = run_engine(dev, "auto")
    prefills = len(PROMPT_LENS)
    if launches != n_layers * prefills:
        raise AssertionError(f"flash_attention launched {launches} times "
                             f"on the main path, want {n_layers} layers x "
                             f"{prefills} prefills")
    plain, _, _ = run_engine(dev, "reference")
    for plen, a, p in zip(PROMPT_LENS, auto, plain):
        if a.tokens != p.tokens:
            raise AssertionError(f"prompt {plen}: flash tokens {a.tokens} "
                                 f"!= plain tokens {p.tokens}")

    profile_engine(dev)

    main_row = flash[MAIN_SHAPE]
    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "brpc_tpu_torch/csrc/flash_attention.cu",
        "replaces": "brpc_tpu/tpu/pallas_ops.py:174",
        "shape": main_row["shape"], "causal": main_row["causal"],
        "launches": launches,
        "max_abs_err": max(r["max_err"] for r in flash.values()),
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "graph_ms": main_row["kernel_graph_ms"],
        "plain_graph_ms": main_row["plain_graph_ms"],
        "library_graph_ms": main_row["library_graph_ms"],
    }]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
