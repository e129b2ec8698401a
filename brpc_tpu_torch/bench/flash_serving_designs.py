"""Designs of the serving kernel (``fwd_f32_mma_kernel``, fp32 at head
dim 16, in csrc/flash_fwd.cu) against each other on a card:

    python3 brpc_tpu_torch/bench/flash_serving_designs.py [PARENT_CHECKOUT]

Builds flash_fwd.cu as it is and with other constants (warps per block,
that is key stripes; keys per tile; stages of each warp's ring); with a
parent checkout, that checkout's flash_fwd.cu too. Holds each against
``attention_reference`` within chip_smoke.FLASH_TOL at every serving
bucket, causal and not, on (S, 4, 16) views of a fused QKV product, and
at a ragged S_q != S_k; then times each as CUDA-graph replay at every
bucket, causal, and at 1024 not causal, in three rounds. Prints one JSON
line per result (registers and spills from ``-Xptxas -v`` too) and the
card's name and power limit.
"""

import concurrent.futures
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from brpc_tpu_torch.tpu import _build, pallas_ops  # noqa: E402

# (warps, keys per tile, stages) besides flash_fwd.cu's own
CONSTANTS = [(2, 32, 2), (4, 32, 2), (8, 32, 2), (4, 64, 2), (4, 32, 3),
             (8, 16, 3), (2, 64, 2), (8, 64, 2), (4, 16, 2)]
HEADS, HEAD_DIM = 4, 16
TIMED = [(s, True) for s in chip_smoke.SERVING_BUCKETS] + [(1024, False)]
CHECKED = [((s, s), c) for s in chip_smoke.SERVING_BUCKETS
           for c in (True, False)] + [((100, 1000), True),
                                      ((1000, 100), True)]


def with_constants(src, warps, keys, stages):
    for pat, val in ((r"kSWarps = \d+;", f"kSWarps = {warps};"),
                     (r"kSKeys = \d+;", f"kSKeys = {keys};"),
                     (r"kSStages = \d+;", f"kSStages = {stages};")):
        src, n = re.subn(pat, val, src)
        if n != 1:
            raise ValueError(f"flash_fwd.cu has no single {pat}")
    return src


def designs(parent):
    with open(os.path.join(_build.CSRC, "flash_fwd.cu")) as fh:
        base = fh.read()
    out = {"this": base}
    for c in CONSTANTS:
        out["w{}_k{}_s{}".format(*c)] = with_constants(base, *c)
    if parent:
        with open(os.path.join(parent, "brpc_tpu_torch", "csrc",
                               "flash_fwd.cu")) as fh:
            out["parent"] = fh.read()
    return out


def build(name, src, tmp, csrc):
    cu, so = os.path.join(tmp, f"{name}.cu"), os.path.join(tmp, f"{name}.so")
    with open(cu, "w") as fh:
        fh.write(src)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                        "-I", csrc, "-o", so, cu], capture_output=True,
                       text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(so)
    lib.brpc_flash_fwd.argtypes = pallas_ops._FWD_ARGTYPES
    # a design that spills is reported, not refused
    return lib, chip_smoke.ptxas_rows({name: r.stdout + r.stderr},
                                      (chip_smoke.SERVING_KERNEL,))


def fused(gen, s, dev):
    width = HEADS * HEAD_DIM
    qkv = torch.randn((s, 3 * width), generator=gen).to(dev)
    return tuple(x.view(s, HEADS, HEAD_DIM) for x in qkv.split(width, -1))


def launch(lib, q, k, v, o, causal):
    sq, h, d = q.shape
    rc = lib.brpc_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, h, sq,
        k.shape[0], d, 0, int(causal), q.stride(1), q.stride(0),
        k.stride(1), k.stride(0), v.stride(1), v.stride(0), o.stride(1),
        o.stride(0), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"brpc_flash_fwd returned {rc}")


def main(argv):
    if not torch.cuda.is_available():
        print("flash_serving_designs: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    parent = os.path.abspath(argv[1]) if len(argv) > 1 else None
    srcs = designs(parent)
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(8) as ex:
        futures = {n: ex.submit(build, n, s, tmp, os.path.join(
            parent, "brpc_tpu_torch", "csrc") if n == "parent"
            else _build.CSRC) for n, s in srcs.items()}
        libs = {}
        for n, f in futures.items():
            libs[n], report = f.result()
            print(json.dumps({"ptxas": {n: report}}), flush=True)
        gen = torch.Generator().manual_seed(0)
        worst = {n: 0.0 for n in libs}
        for (sq, sk), causal in CHECKED:
            q = fused(gen, sq, dev)[0]
            _, k, v = fused(gen, sk, dev)
            want = pallas_ops.attention_reference(q, k, v, causal=causal)
            for name, lib in libs.items():
                o = torch.full_like(want, float("nan"))
                launch(lib, q, k, v, o, causal)
                torch.cuda.synchronize()
                err = float((o - want).abs().max())
                if not err <= chip_smoke.FLASH_TOL:
                    raise AssertionError(f"{name} ({sq}, {sk}) causal="
                                         f"{causal}: {err}")
                worst[name] = max(worst[name], err)
        print(json.dumps({"checked": [list(c) for c in CHECKED],
                          "max_abs_err": worst}), flush=True)
        inputs = {s: fused(gen, s, dev) for s in chip_smoke.SERVING_BUCKETS}
        res = {f"{s}{'' if c else '_noncausal'}": {} for s, c in TIMED}
        for _ in range(3):
            for s, causal in TIMED:
                q, k, v = inputs[s]
                o = torch.empty((s, HEADS, HEAD_DIM), device=dev)
                key = f"{s}{'' if causal else '_noncausal'}"
                for name, lib in libs.items():
                    res[key].setdefault(name, []).append(chip_smoke.graph_ms(
                        lambda: launch(lib, q, k, v, o, causal)))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"flash_serving_designs_graph_ms": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
