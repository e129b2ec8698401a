"""Per-call cost of the RMSNorm and cross-entropy wrappers of one checkout
on a card, for comparing two commits in one call:

    python3 brpc_tpu_torch/bench/wrappers.py [CHECKOUT]

CHECKOUT (default: this one) is the root of a checkout, for example a
parent commit unpacked with ``git archive`` into a git-ignored directory.
Builds that checkout's kernels and times, on the same inputs for any
checkout (seed 0; the shapes of its ``chip_smoke.py``: RMSNorm at
RMS_MAIN in bf16, each call reading x and g from HBM as the trainer does,
and the cross-entropy at XENT_MAIN in fp32), RMSNorm's forward, backward
and forward + backward through autograd (``rmsnorm_calls``) and
``_xent_cuda``, per call as a caller pays it (three runs of 1000 calls
back to back, host cost included) and in device time (CUDA-graph replay,
or queued behind a sleep kernel where autograd runs), beside
``F.rms_norm`` (forward, backward, both) and
``F.cross_entropy(reduction="none")``; then the RMSNorm forward
wrapper's host cost step by step (``host_steps``). Prints the card's name
and power limit, then two JSON lines. Run parent, change, change, parent
in one call.
"""

import itertools
import json
import math
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F


def host_us(fn, iters=5000):
    """Mean host time of one call in µs (the host clock; nothing waits
    for the card)."""
    for _ in range(100):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e6


def host_steps(ops, dev):
    """The RMSNorm forward wrapper's host cost step by step, each step
    timed alone on a small input (8 x 1024 bf16, so a launch never waits
    for the card): the module's helpers where the checkout has them, the
    torch and ctypes calls each takes, and the whole call beside
    ``F.rms_norm``."""
    x = torch.randn(8, 1024, device=dev).to(torch.bfloat16)
    w = torch.ones(1024, device=dev, dtype=torch.bfloat16)
    out = torch.empty_like(x)
    steps = {
        "reshape_contiguous": lambda: x.reshape(-1, 1024).contiguous(),
        "empty_like": lambda: torch.empty_like(x),
        "data_ptrs": lambda: (x.data_ptr(), w.data_ptr(), out.data_ptr()),
        "is_cuda_get_device": lambda: (x.is_cuda, x.get_device(),
                                       w.is_cuda, w.get_device()),
        "current_device": torch.cuda.current_device,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "whole_call": lambda: ops._rmsnorm_fwd_call(x, w),
        "library": lambda: F.rms_norm(x, (1024,), w, eps=ops.EPS),
    }
    if hasattr(ops, "_on_cpu"):
        steps["on_cpu"] = lambda: ops._on_cpu("rmsnorm", x, w)
    if hasattr(ops, "_check_kernel_inputs"):
        steps["check_kernel_inputs"] = lambda: ops._check_kernel_inputs(
            "rmsnorm", x.dtype, x=x, w=w)
    if hasattr(ops, "_bind"):
        fn = ops._bind("rmsnorm", "brpc_rmsnorm", ops._RMSNORM_ARGTYPES)
        steps["bind"] = lambda: ops._bind("rmsnorm", "brpc_rmsnorm",
                                          ops._RMSNORM_ARGTYPES)
        args = (x.data_ptr(), w.data_ptr(), out.data_ptr(), 8, 1024, 1,
                ops.EPS)
        steps["ctypes_launch"] = lambda: fn(
            *args, torch._C._cuda_getCurrentRawStream(0))
        if hasattr(ops, "_call"):
            steps["call_helper"] = lambda: ops._call(fn, x, *args)
    steps["launches_add"] = lambda: ops.launches.add("rmsnorm")
    out_us = {}
    for name, fn_ in steps.items():
        out_us[name] = host_us(fn_)
        torch.cuda.synchronize()
    return out_us


def rmsnorm_calls(cs, ops, dev, gen, iters):
    """RMSNorm at ``cs.RMS_MAIN`` in bf16, each call taking x and g in
    turn from copies twice the L2's size, for any checkout: the forward
    wrapper, the backward as the checkout runs it on the card
    (``_rmsnorm_bwd_call``, or before the backward kernel the plain
    ``_rmsnorm_bwd``), ``rmsnorm``'s backward through autograd (retained
    graphs) and its forward + backward, and ``F.rms_norm``'s forward,
    backward (retained graphs) and forward + backward. ``call_ms``: three runs of ``iters`` calls back to back
    (host cost included); ``graph_ms``: device time from a CUDA-graph
    replay, or ``queued_ms`` (behind a sleep kernel) where autograd runs,
    which a graph does not capture here; None, with the error, where the
    host fell behind the sleep kernel."""
    rows, cols = cs.RMS_MAIN
    copies = math.ceil(2 * cs.L2_BYTES / (2 * rows * cols))
    xs = [torch.randn(cs.RMS_MAIN, generator=gen).to(
        device=dev, dtype=torch.bfloat16).requires_grad_()
        for _ in range(copies)]
    gs = [torch.randn(cs.RMS_MAIN, generator=gen).to(
        device=dev, dtype=torch.bfloat16) for _ in range(copies)]
    xd = [x.detach() for x in xs]
    w = torch.ones(cols, device=dev, dtype=torch.bfloat16,
                   requires_grad=True)
    wd = w.detach()
    nxt = itertools.cycle(range(copies)).__next__
    eps = ops.EPS
    bwd = getattr(ops, "_rmsnorm_bwd_call", ops._rmsnorm_bwd)
    lib_outs = [F.rms_norm(x, (cols,), w, eps=eps) for x in xs]

    def fwd_bwd(fwd):
        def call():
            i = nxt()
            return torch.autograd.grad(fwd(xs[i], w), (xs[i], w), gs[i])
        return call

    def lib_bwd():
        i = nxt()
        return torch.autograd.grad(lib_outs[i], (xs[i], w), gs[i],
                                   retain_graph=True)

    def kernel_bwd():
        i = nxt()
        return bwd(xd[i], wd, gs[i], eps)

    graphed = {
        "rmsnorm": lambda: ops._rmsnorm_fwd_call(xd[nxt()], wd),
        "rms_norm_library": lambda: F.rms_norm(xd[nxt()], (cols,), wd,
                                               eps=eps),
        "rmsnorm_bwd": kernel_bwd,
    }
    outs = [ops.rmsnorm(x, w, eps) for x in xs]

    def autograd_bwd():
        i = nxt()
        return torch.autograd.grad(outs[i], (xs[i], w), gs[i],
                                   retain_graph=True)

    queued = {
        "rmsnorm_autograd_bwd": autograd_bwd,
        "rms_norm_library_bwd": lib_bwd,
        "rmsnorm_autograd": fwd_bwd(ops.rmsnorm),
        "rms_norm_library_autograd": fwd_bwd(
            lambda x, w_: F.rms_norm(x, (cols,), w_, eps=eps)),
    }
    out = {name: {"call_ms": [cs.time_ms(fn, iters) for _ in range(3)],
                  "graph_ms": cs.graph_ms(fn)}
           for name, fn in graphed.items()}
    for name, fn in queued.items():
        out[name] = {"call_ms": [cs.time_ms(fn, iters) for _ in range(3)]}
        try:
            out[name]["queued_ms"] = cs.queued_ms(fn, 50)
        except AssertionError as err:  # the host could not stay ahead
            out[name]["queued_ms"] = None
            out[name]["queued_error"] = str(err)
    return out


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
    out = rmsnorm_calls(cs, pallas_ops, dev, gen, iters=1000)
    n, v = cs.XENT_MAIN
    logits = (3 * torch.randn(n, v, generator=gen)).to(dev)
    targets = torch.randint(0, v, (n,), generator=gen).to(dev)
    calls = {
        "xent": lambda: pallas_ops._xent_cuda(logits, targets),
        "cross_entropy_library": lambda: F.cross_entropy(
            logits, targets, reduction="none"),
    }
    out.update({name: {"call_ms": [cs.time_ms(fn, 1000) for _ in range(3)],
                       "graph_ms": cs.graph_ms(fn)}
                for name, fn in calls.items()})
    print(json.dumps({"root": root, "wrappers": out}), flush=True)
    print(json.dumps({"root": root, "rmsnorm_host_steps_us": host_steps(
        pallas_ops, dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
