"""chip_smoke — drive the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every kernel of ``brpc_tpu_torch`` from ``brpc_tpu_torch/csrc``
(nvcc, sm_90a, one process per source, all at once). Then two paths:

- Serving: holds the flash forward kernel, as the serving path calls it
  (strided (S, H, D) fp32, no lse), against its plain PyTorch version
  at the shapes that path gives it, then drives the
  serving engine at the full width of ``examples/llm_server`` through
  ``submit(..., done=)`` and checks that the path really launched the
  kernel and that its tokens equal a run with plain attention; a last,
  profiled run of the same requests shows where the time goes.
- Training: holds the flash forward, the dQ and dK/dV kernels and the
  RMSNorm kernel against their plain versions in fp32 and bf16, checks
  one fp32 training step with the kernels against one without them, then
  takes five SGD steps of the flagship LM at full width in bf16 and
  checks that the loss falls and that every step launched each kernel
  the expected number of times; one more, profiled step shows where the
  time goes.

Exits non-zero, with no result line, on any failure, without a card, or
without the package beside it.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists every kernel with its launches on the main path,
error, time, plain and library times and its bound.
"""

import dataclasses
import itertools
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
from brpc_tpu_torch.tpu import _build, pallas_ops, train  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, and FLOP/s of
# the inputs' type: fp32 outside the tensor cores, bf16 on them
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
L2_BYTES = 50 * 2 ** 20

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
        # each input read once and o written once, against the 4 D FLOPs
        # (QK^T and PV) of each live (q, k) pair
        s, d = shape[0], shape[-1]
        h = shape[1] if len(shape) == 3 else 1
        pairs = s * (s + 1) // 2 if causal else s * s
        bound_ms, bound_by = bound(4 * s * h * d * 4, 4 * pairs * d * h,
                                   torch.float32)
        row = {"shape": list(shape), "causal": causal, "max_err": err}
        row.update(timings({
            "kernel": lambda: pallas_ops.flash_attention(q, k, v,
                                                         causal=causal),
            "plain": lambda: pallas_ops.attention_reference(q, k, v,
                                                            causal=causal),
            "library": lambda: sdpa(qh, kh, vh, is_causal=causal),
        }, iters=200 if shape[0] <= 384 else 50))
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


def device_time(prof):
    """(device kernels, device busy µs with overlapping kernels merged,
    the 10 kernels with the most device time) of a torch.profiler run."""
    from torch.autograd import DeviceType

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
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0),
                 key=lambda r: -r[1])[:10]
    return len(spans), busy, [{"name": k[:80], "us": t, "calls": c}
                              for k, t, c in top]


def profile_engine(dev):
    """Phase 5: where the main path's time goes. The same requests under
    torch.profiler: device busy share (kernel intervals merged, over the
    wall time of the run), kernel launches per engine step, and the
    kernels that take the most device time. The profiler slows the host,
    so the share is a lower bound for an unprofiled run."""
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
    kernels, busy, top = device_time(prof)
    stats = {
        "wall_us": wall_us, "steps": steps,
        "device_kernels": kernels,
        "kernels_per_step": kernels / steps if steps else None,
        "device_busy_us": busy,
        "device_busy_share": busy / wall_us if kernels else None,
        "top_device_us": top,
    }
    print(json.dumps({"profile": stats}), flush=True)


# ---------------------------------------------------------------------------
# Training slice: flash forward with lse, the backward pair, RMSNorm, and
# the single-device trainer at the flagship's widths
# ---------------------------------------------------------------------------
# kernel vs plain, relative to max(1, max |plain|): fp32 on both sides
# differs only in the order of the sums; a bf16 kernel against the fp32
# plain version on the same bf16-rounded inputs is held to the JAX
# package's own bf16 tolerance for this kernel (tests/test_tpu.py:407-424)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# that bf16 limit is set by the largest values (the first rows and keys of
# a causal tensor), so bf16 is also held row by row: each row's error
# against the row's own max |plain| (see row_rel_err). bf16 rounds P, dS
# and the outputs to 8 bits of mantissa (2^-9 relative); a tile that is
# wrong is off by the order of its values. The limit is twice the worst
# reading on an H100 (7.6e-3, PERF.md).
ROW_TOL = 1.5e-2
# [N, S, D] and the causal flags each is checked at: the flagship
# (B 8 x H 8, S 1024, head_dim 128), __graft_entry__'s (B 4 x H 8, S 256,
# head_dim 32), a long non-causal one, and small ones both ways
MHA_SHAPES = [((64, 1024, 128), (True,)), ((32, 256, 32), (True,)),
              ((8, 1024, 128), (False,)), ((6, 128, 32), (True, False)),
              ((6, 100, 64), (True, False))]  # ragged: 100 % 32 != 0
MHA_MAIN = (64, 1024, 128)  # what the trainer gives the kernels, causal
RMS_SHAPES = [(8192, 1024), (1000, 1024), (256, 32),
              (7, 50)]  # ragged: fewer rows than a block, odd width
RMS_MAIN = (8192, 1024)     # B 8 x S 1024 rows of d_model 1024
# the flagship of tools/kernel_bench.py:395-398, kernels on, plain loss
FLAGSHIP = dict(vocab=16384, d_model=1024, n_heads=8, d_ff=4096,
                max_seq=1024)
TRAIN_B, TRAIN_S, TRAIN_LAYERS, TRAIN_STEPS, TRAIN_LR = 8, 1024, 8, 5, 1e-2
# fp32 kernels on vs off differ only in the order of the sums
GRAD_REL_TOL = 1e-4


def row_rel_err(got, want):
    """Max over rows (the last axis) of max |got - want| over the row's
    max |want|; the row scale is floored at 1e-3 of the tensor's max
    |want|, for rows that cancel to ~0 (dq of a query that sees one key)."""
    w = want.abs()
    floor = max(1e-3 * float(w.max()), 1e-30)
    return float(((got - want).abs().amax(-1)
                  / w.amax(-1).clamp_min(floor)).max())


def held(name, got, want, dtype, worst, rows=True):
    """Holds a kernel's output against its plain version: max |got - want|
    within TOL[dtype] * max(1, max |want|), and in bf16 (with ``rows``)
    row_rel_err within ROW_TOL. Keeps the worst readings in ``worst``
    (dtype -> max abs error, "bf16_row_rel" -> row-relative error) and
    raises past a limit."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    limit = TOL[dtype] * max(1.0, float(want.abs().max()))
    if not math.isfinite(err) or err > limit:
        raise AssertionError(f"{name}: max |kernel - plain| {err} > "
                             f"{limit}")
    worst[dtype] = max(worst[dtype], err)
    if dtype == torch.bfloat16 and rows:
        rel = row_rel_err(got, want)
        if not math.isfinite(rel) or rel > ROW_TOL:
            raise AssertionError(f"{name}: row-relative error {rel} > "
                                 f"{ROW_TOL}")
        worst["bf16_row_rel"] = max(worst["bf16_row_rel"], rel)


def new_worst():
    return {torch.float32: 0.0, torch.bfloat16: 0.0, "bf16_row_rel": 0.0}


def readings(worst):
    return {"max_err_fp32": worst[torch.float32],
            "max_err_bf16": worst[torch.bfloat16],
            "max_row_rel_err_bf16": worst["bf16_row_rel"]}


def bound(nbytes, flops, dtype):
    """(bound_ms, bound_by): the larger of the bytes over HBM's rate and
    the FLOPs over the card's peak for the inputs' type (bf16 on the
    tensor cores, fp32 outside them)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def mha_bounds(n, s, d, causal, dtype):
    """Bounds of the three attention kernels at [n, s, d]: every input
    read once and every output written once; FLOPs of the live (q, k)
    pairs: 4 D (QK^T, PV) forward, 6 D dQ (QK^T, dO V^T, dS K), 8 D
    dK/dV (QK^T, dO V^T, P^T dO, dS^T Q)."""
    pairs = n * (s * (s + 1) // 2 if causal else s * s)
    tile = n * s * d * torch.empty((), dtype=dtype).element_size()
    row = n * s * 4
    return {"flash_fwd": bound(4 * tile + row, 4 * d * pairs, dtype),
            "flash_bwd_dq": bound(5 * tile + 2 * row, 6 * d * pairs, dtype),
            "flash_bwd_dkv": bound(6 * tile + 2 * row, 8 * d * pairs,
                                   dtype)}


def timings(calls, iters, graph=True):
    """{name_ms, name_graph_ms} for each call: per call as a caller pays
    it, host launch cost included, and device time alone from a CUDA-graph
    replay of up to 20 calls."""
    out = {}
    for name, fn in calls.items():
        out[f"{name}_ms"] = time_ms(fn, iters)
        out[f"{name}_graph_ms"] = (graph_ms(fn, min(iters, 20)) if graph
                                   else None)
    return out


def randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen).to(device=dev, dtype=dtype)


def check_flash_fwd(dev):
    """Phase 6: the forward kernel through both wrappers against
    flash_fwd_reference, fp32 and bf16, then timed at the trainer's
    shape in bf16 beside the plain version and SDPA's forward."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    gen = torch.Generator().manual_seed(1)
    worst = new_worst()
    for shape, flags in MHA_SHAPES:
        n, s, d = shape
        for causal in flags:
            for dtype in TOL:
                q, k, v = (randn(gen, shape, dtype, dev) for _ in range(3))
                ro, rl = pallas_ops.flash_fwd_reference(
                    q.float(), k.float(), v.float(), causal)
                runs = [pallas_ops._flash_fwd_bhsd(q, k, v, causal, s, s)]
                if causal:
                    runs.append(pallas_ops._flash_fwd_folded(q, k, v, s))
                for o, lse in runs:
                    torch.cuda.synchronize()
                    if o.dtype != dtype or lse.shape != (n, s, 1):
                        raise AssertionError(f"flash_fwd {shape}: o "
                                             f"{o.dtype}, lse {lse.shape}")
                    tag = f"flash_fwd {shape} causal={causal} {dtype}"
                    held(tag + " o", o, ro, dtype, worst)
                    held(tag + " lse", lse, rl, dtype, worst)
    n, s, d = MHA_MAIN
    q, k, v = (randn(gen, MHA_MAIN, torch.bfloat16, dev) for _ in range(3))
    qh, kh, vh = (t.view(TRAIN_B, n // TRAIN_B, s, d) for t in (q, k, v))
    row = timings({
        "kernel": lambda: pallas_ops._flash_fwd_folded(q, k, v, s),
        "plain": lambda: pallas_ops.flash_fwd_reference(q, k, v, True),
        "library": lambda: sdpa(qh, kh, vh, is_causal=True),
    }, iters=20)
    row.update(readings(worst))
    print(json.dumps({"flash_fwd": row}), flush=True)
    return row


def check_flash_bwd(dev):
    """Phase 7: the dQ and dK/dV kernels against flash_bwd_reference at
    the forward's shapes plus two ring-hop cases on every causal shape
    (the key block wholly in the future: lse = NEG_INF and every gradient
    exactly 0; and k_start = S/2); then flash_attention_mha's autograd
    against autograd through attention_reference (in bf16 against fp32
    arithmetic, so held to TOL only: its delta comes from the bf16 o, and
    dq, whose dS sums to zero over each row, cancels far below its
    terms); then each kernel timed
    at the trainer's shape in bf16 beside the plain version and SDPA's
    backward (one call that computes dq, dk and dv)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    gen = torch.Generator().manual_seed(2)
    worst, worst_mha = new_worst(), new_worst()
    for shape, flags in MHA_SHAPES:
        s = shape[1]
        for causal in flags:
            for k_start in ((0, s, s // 2) if causal else (0,)):
                for dtype in TOL:
                    q, k, v, do = (randn(gen, shape, dtype, dev)
                                   for _ in range(4))
                    f32 = [t.float() for t in (q, k, v, do)]
                    o, lse = pallas_ops.flash_fwd_reference(
                        *f32[:3], causal, 0, k_start)
                    delta = pallas_ops._flash_delta(o, f32[3])
                    got = pallas_ops._flash_bwd_bhsd(
                        q, k, v, lse, do, delta, 0, k_start, causal, s, s)
                    want = pallas_ops.flash_bwd_reference(
                        *f32[:3], lse, f32[3], delta, 0, k_start, causal)
                    torch.cuda.synchronize()
                    tag = (f"flash_bwd {shape} causal={causal} "
                           f"k_start={k_start} {dtype}")
                    if k_start == s and (
                            bool((lse != pallas_ops.NEG_INF).any())
                            or any(bool(g.any()) for g in got)):
                        raise AssertionError(f"{tag}: a key block wholly "
                                             f"in the future must give "
                                             f"lse NEG_INF and zero grads")
                    for name, g, w in zip(("dq", "dk", "dv"), got, want):
                        held(f"{tag} {name}", g, w, dtype, worst)
    for (n, s, d), flags in MHA_SHAPES[1:]:
        for causal in flags:
            for dtype in TOL:
                shape = (2, n // 2, s, d)
                q, k, v, g = (randn(gen, shape, dtype, dev)
                              for _ in range(4))
                grads = []
                for kernel in (True, False):
                    ins = [(t if kernel else t.float()).detach()
                           .requires_grad_() for t in (q, k, v)]
                    if kernel:
                        out = pallas_ops.flash_attention_mha(
                            *ins, causal=causal)
                    else:
                        out = pallas_ops.attention_reference(
                            *(t.transpose(1, 2) for t in ins),
                            causal=causal).transpose(1, 2)
                    grads.append(torch.autograd.grad(
                        (out.float() * g.float()).sum(), ins))
                tag = f"flash_attention_mha grads {shape} causal={causal}"
                for name, a, b in zip("qkv", *grads):
                    held(f"{tag} d{name} {dtype}", a, b, dtype, worst_mha,
                         rows=False)
    n, s, d = MHA_MAIN
    q, k, v, do = (randn(gen, MHA_MAIN, torch.bfloat16, dev)
                   for _ in range(4))
    o, lse = pallas_ops._flash_fwd_folded(q, k, v, s)
    delta = pallas_ops._flash_delta(o, do)
    args = (q, k, v, lse, do, delta, 0, 0, True)
    qh, kh, vh = (t.view(TRAIN_B, n // TRAIN_B, s, d).detach()
                  .requires_grad_() for t in (q, k, v))
    out = sdpa(qh, kh, vh, is_causal=True)
    dout = do.view_as(out)
    row = timings({
        "dq": lambda: pallas_ops._flash_bwd_dq_cuda(*args),
        "dkv": lambda: pallas_ops._flash_bwd_dkv_cuda(*args),
        "plain": lambda: pallas_ops.flash_bwd_reference(*args),
    }, iters=10)
    row.update(timings({"library": lambda: torch.autograd.grad(
        out, (qh, kh, vh), dout, retain_graph=True)}, iters=10,
        graph=False))
    row["autograd"] = {"max_err_fp32": worst_mha[torch.float32],
                       "max_err_bf16": worst_mha[torch.bfloat16]}
    for dtype in TOL:
        worst[dtype] = max(worst[dtype], worst_mha[dtype])
    row.update(readings(worst))
    print(json.dumps({"flash_bwd": row}), flush=True)
    return row


def check_rmsnorm(dev):
    """Phase 8: the RMSNorm kernel against rmsnorm_reference, fp32 and
    bf16, then timed at the trainer's shape in bf16 beside the plain
    version and F.rms_norm."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(3)
    worst = new_worst()
    for shape in RMS_SHAPES:
        for dtype in TOL:
            x = randn(gen, shape, dtype, dev)
            w = (1 + 0.1 * torch.randn(shape[1], generator=gen)).to(
                device=dev, dtype=dtype)
            y = pallas_ops._rmsnorm_fwd_call(x, w)
            want = pallas_ops.rmsnorm_reference(x.float(), w.float())
            torch.cuda.synchronize()
            if y.dtype != dtype:
                raise AssertionError(f"rmsnorm {shape}: out {y.dtype}")
            held(f"rmsnorm {shape} {dtype}", y, want, dtype, worst)
    # bound by bytes, and x (16 MB) fits the L2: back-to-back calls take
    # x in turn from copies twice the L2's size, so each reads it from HBM
    x_bytes = 2 * RMS_MAIN[0] * RMS_MAIN[1]
    nxt = itertools.cycle([randn(gen, RMS_MAIN, torch.bfloat16, dev) for _
                           in range(math.ceil(2 * L2_BYTES / x_bytes))]
                          ).__next__
    w = torch.ones(RMS_MAIN[1], device=dev, dtype=torch.bfloat16)
    row = timings({
        "kernel": lambda: pallas_ops._rmsnorm_fwd_call(nxt(), w),
        "plain": lambda: pallas_ops.rmsnorm_reference(nxt(), w),
        "library": lambda: F.rms_norm(nxt(), (RMS_MAIN[1],), w,
                                      eps=pallas_ops.EPS),
    }, iters=50)
    row.update(readings(worst))
    print(json.dumps({"rmsnorm": row}), flush=True)
    return row


def train_parity(dev):
    """Phase 9: one value_and_grad with the kernels on and one with them
    off, on the same parameters: the flagship's widths at 2 layers, B 2,
    S 1024, fp32 with TF32 off. Loss within rtol 1e-4 and every gradient
    within rtol 5e-3, atol 5e-4: the JAX package's own flash-vs-XLA
    tolerances (tests/test_tpu.py:464-469). Those were set at small widths;
    at these, a gradient's entries are about as small as that atol, so
    each gradient is also held by its relative norm, ||on - off|| /
    ||off|| <= GRAD_REL_TOL, which a swapped or wrong gradient breaks."""
    on = train.ModelConfig(**FLAGSHIP, n_layers=2, use_flash_attention=True,
                           use_pallas_norm=True)
    off = dataclasses.replace(on, use_flash_attention=False,
                              use_pallas_norm=False)
    model = train.TrainLM(on, torch.Generator().manual_seed(0), device=dev)
    batch = train.demo_batch(torch.Generator().manual_seed(1), on, 2, 1024,
                             device=dev)
    pallas_ops.launches.reset()
    loss_on, grads_on = train.value_and_grad(model, batch)
    counts = pallas_ops.launches.snapshot()
    model.config = off
    loss_off, grads_off = train.value_and_grad(model, batch)
    worst, worst_rel = 0.0, 0.0
    if abs(float(loss_on) - float(loss_off)) > 1e-4 * abs(float(loss_off)):
        raise AssertionError(f"loss kernels on {float(loss_on)} vs off "
                             f"{float(loss_off)}")
    for a, b in zip(train._leaves(grads_on), train._leaves(grads_off)):
        excess = float(((a - b).abs() - 5e-3 * b.abs()).max())
        rel = float((a - b).norm() / b.norm())
        worst, worst_rel = max(worst, excess), max(worst_rel, rel)
        if not math.isfinite(excess) or excess > 5e-4:
            raise AssertionError(f"gradient {tuple(a.shape)}: |on - off| "
                                 f"exceeds 5e-4 + 5e-3 |off| by {excess}")
        if not rel <= GRAD_REL_TOL:
            raise AssertionError(f"gradient {tuple(a.shape)}: ||on - off||"
                                 f" / ||off|| {rel} > {GRAD_REL_TOL}")
    stats = {"loss_on": float(loss_on), "loss_off": float(loss_off),
             "grad_excess_over_rtol_max": worst,
             "grad_rel_norm_max": worst_rel, "launches": counts}
    print(json.dumps({"train_parity": stats}), flush=True)
    del model, grads_on, grads_off
    torch.cuda.empty_cache()


def run_trainer(dev, smi):
    """Phase 10, the slice's main path: the flagship at full width in bf16
    (8 layers, B 8, S 1024, flash attention and the RMSNorm kernel on,
    plain loss), TRAIN_STEPS sgd_train_steps on one demo_batch from seed
    1. The counts are reset just before the steps and read just after;
    then one more step runs under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    cfg = train.ModelConfig(**FLAGSHIP, n_layers=TRAIN_LAYERS,
                            dtype=torch.bfloat16, use_flash_attention=True,
                            use_pallas_norm=True, use_fused_xent=False)
    model = train.TrainLM(cfg, torch.Generator().manual_seed(0), device=dev)
    batch = train.demo_batch(torch.Generator().manual_seed(1), cfg, TRAIN_B,
                             TRAIN_S, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pallas_ops.launches.reset()
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = train.sgd_train_step(model, batch, lr=TRAIN_LR)
        losses.append(float(loss))  # waits for the step
        step_s.append(time.perf_counter() - t0)
    counts = pallas_ops.launches.snapshot()
    want = {"flash_fwd": TRAIN_LAYERS, "flash_bwd_dq": TRAIN_LAYERS,
            "flash_bwd_dkv": TRAIN_LAYERS, "rmsnorm": 2 * TRAIN_LAYERS + 1}
    per_step = {name: counts[name] / TRAIN_STEPS for name in want}
    if per_step != want or counts["flash_attention"]:
        raise AssertionError(f"launches per step {per_step}, want {want}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"losses {losses}: not finite or not falling")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train.sgd_train_step(model, batch, lr=TRAIN_LR)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, busy, top = device_time(prof)
    step = sorted(step_s[1:])[len(step_s[1:]) // 2]  # median after the 1st
    # the FLOP count of tools/kernel_bench.py:386-391
    d, f, s = cfg.d_model, cfg.d_ff, TRAIN_S
    matmul_params = (cfg.n_layers * (d * 3 * d + d * d + 2 * d * f)
                     + cfg.vocab * d)
    flops = (6.0 * matmul_params * TRAIN_B * s
             + cfg.n_layers * 12 * s * s * d * TRAIN_B)
    stats = {
        "card": smi, "losses": losses, "step_s": step_s,
        "ms_per_step_median": step * 1e3,
        "tokens_per_s": TRAIN_B * s / step,
        "tflop_per_s": flops / step / 1e12,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": counts, "launches_per_step": per_step,
        "profiled_step": {"wall_us": wall_us, "device_kernels": kernels,
                          "device_busy_us": busy,
                          "device_busy_share": busy / wall_us,
                          "top_device_us": top},
    }
    print(json.dumps({"trainer": stats}), flush=True)
    del model
    torch.cuda.empty_cache()
    return counts


def kernel_rows(fwd, bwd, rms, counts):
    """The kernels line's entries of the training kernels, timed at the
    trainer's shapes in bf16."""
    n, s, d = MHA_MAIN
    bounds = mha_bounds(n, s, d, True, torch.bfloat16)
    rows_, cols = RMS_MAIN
    bounds["rmsnorm"] = bound(2 * (2 * rows_ * cols + cols),
                              4 * rows_ * cols, torch.bfloat16)
    pallas = "brpc_tpu/tpu/pallas_ops.py"
    spec = [
        ("flash_fwd", "flash_fwd.cu", f"{pallas}:535 (and :282)", fwd,
         "kernel", MHA_MAIN),
        ("flash_bwd_dq", "flash_bwd.cu", f"{pallas}:340", bwd, "dq",
         MHA_MAIN),
        ("flash_bwd_dkv", "flash_bwd.cu", f"{pallas}:387", bwd, "dkv",
         MHA_MAIN),
        ("rmsnorm", "rmsnorm.cu", f"{pallas}:43", rms, "kernel", RMS_MAIN),
    ]
    out = []
    for name, src, replaces, row, key, shape in spec:
        out.append({
            "name": name, "route": "cuda",
            "source": f"brpc_tpu_torch/csrc/{src}", "replaces": replaces,
            "shape": list(shape), "dtype": "bfloat16",
            "launches": counts[name],
            "max_abs_err": max(row["max_err_fp32"], row["max_err_bf16"]),
            "max_abs_err_fp32": row["max_err_fp32"],
            "max_row_rel_err_bf16": row["max_row_rel_err_bf16"],
            "ms": row[f"{key}_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "library_ms": row["library_ms"],
            "graph_ms": row[f"{key}_graph_ms"],
            "plain_graph_ms": row["plain_graph_ms"],
            "library_graph_ms": row["library_graph_ms"],
        })
    return out


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

    fwd = check_flash_fwd(dev)
    bwd = check_flash_bwd(dev)
    rms = check_rmsnorm(dev)
    train_parity(dev)
    counts = run_trainer(dev, smi)

    main_row = flash[MAIN_SHAPE]
    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "brpc_tpu_torch/csrc/flash_fwd.cu",
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
    }] + kernel_rows(fwd, bwd, rms, counts)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
