"""Designs of the RMSNorm kernels (csrc/rmsnorm.cu) against each other and
``F.rms_norm`` on a card:

    python3 brpc_tpu_torch/bench/rmsnorm_designs.py [PARENT_CHECKOUT]

Builds rmsnorm.cu as it is, with other backward blocks per SM (so other
register caps and rows of dw partials) and other shapes of the finishing
sum (columns per block x row groups); with a parent checkout, that
checkout's rmsnorm.cu too (its forward; its backward, if it has one).
Holds each backward against the plain version (``pallas_ops._rmsnorm_bwd``
on the inputs upcast, ``chip_smoke.held``) at RMS_MAIN and RMS_EDGES in
fp32 and bf16, then times the forward and the backward as CUDA-graph
replay at RMS_MAIN in bf16, x and g taken in turn from copies twice the
L2's size, in three rounds beside F.rms_norm's forward. Prints the card's
name and power limit and one JSON line of results.
"""

import concurrent.futures
import ctypes
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile

import torch
import torch.nn.functional as F

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from brpc_tpu_torch.tpu import _build, pallas_ops  # noqa: E402

# (backward blocks per SM, finish columns per block, finish row groups)
# besides rmsnorm.cu's own
CONSTANTS = [(1, 8, 64), (3, 8, 64), (4, 8, 64), (2, 32, 16)]


def with_constants(src, per_sm, cols, groups):
    for pat, val in ((r"kBwdBlocksPerSm = \d+;", f"kBwdBlocksPerSm = {per_sm};"),
                     (r"kFinishCols = \d+;", f"kFinishCols = {cols};"),
                     (r"kFinishGroups = \d+;", f"kFinishGroups = {groups};")):
        src, n = re.subn(pat, val, src)
        if n != 1:
            raise ValueError(f"rmsnorm.cu has no single {pat}")
    return src


def per_sm_of(src):
    m = re.search(r"kBwdBlocksPerSm = (\d+);", src)
    return int(m.group(1)) if m else None


def designs(parent):
    with open(os.path.join(_build.CSRC, "rmsnorm.cu")) as fh:
        base = fh.read()
    out = {"this": base}
    for c in CONSTANTS:
        out["b{}_f{}x{}".format(*c)] = with_constants(base, *c)
    if parent:
        with open(os.path.join(parent, "brpc_tpu_torch", "csrc",
                               "rmsnorm.cu")) as fh:
            out["parent"] = fh.read()
    return out


def build(name, src, tmp, csrc):
    cu, so = os.path.join(tmp, f"{name}.cu"), os.path.join(tmp, f"{name}.so")
    with open(cu, "w") as fh:
        fh.write(src)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc,
                        "-o", so, cu], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(so)
    lib.brpc_rmsnorm.argtypes = pallas_ops._RMSNORM_ARGTYPES
    if hasattr(lib, "brpc_rmsnorm_bwd"):
        lib.brpc_rmsnorm_bwd.argtypes = pallas_ops._RMSNORM_BWD_ARGTYPES
    return lib


class Backward:
    """One design's backward on [rows, d] inputs: its grid and partials as
    the wrapper would pick them for the design's blocks per SM."""

    def __init__(self, lib, per_sm, sms, rows, d, dtype, dev):
        self.fn = lib.brpc_rmsnorm_bwd
        self.blocks = min(-(-rows // pallas_ops._RMS_WARPS), per_sm * sms)
        self.partials = torch.empty((self.blocks, d), device=dev)
        self.dx = torch.empty((rows, d), dtype=dtype, device=dev)
        self.dw = torch.empty(d, dtype=dtype, device=dev)
        self.code = pallas_ops._DTYPES[dtype]

    def __call__(self, x, w, g):
        rows, d = x.shape
        rc = self.fn(x.data_ptr(), w.data_ptr(), g.data_ptr(),
                     self.dx.data_ptr(), self.dw.data_ptr(),
                     self.partials.data_ptr(), rows, d, self.blocks,
                     self.code, pallas_ops.EPS,
                     torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"brpc_rmsnorm_bwd returned {rc}")
        return self.dx, self.dw


def forward(lib, x, w, out):
    rows, d = x.shape
    rc = lib.brpc_rmsnorm(x.data_ptr(), w.data_ptr(), out.data_ptr(), rows,
                          d, pallas_ops._DTYPES[x.dtype], pallas_ops.EPS,
                          torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"brpc_rmsnorm returned {rc}")
    return out


def check(name, lib, per_sm, sms, dev):
    gen = torch.Generator().manual_seed(3)
    worst = chip_smoke.new_worst()
    for shape in [chip_smoke.RMS_MAIN] + chip_smoke.RMS_EDGES:
        for dtype in chip_smoke.TOL:
            x, g = (chip_smoke.randn(gen, shape, dtype, dev) for _ in "xg")
            w = (1 + 0.1 * torch.randn(shape[1], generator=gen)).to(
                device=dev, dtype=dtype)
            dx, dw = Backward(lib, per_sm, sms, *shape, dtype, dev)(x, w, g)
            want_dx, want_dw = pallas_ops._rmsnorm_bwd(
                x.float(), w.float(), g.float(), pallas_ops.EPS)
            torch.cuda.synchronize()
            chip_smoke.held(f"{name} dx {shape}", dx, want_dx, dtype, worst)
            chip_smoke.held(f"{name} dw {shape}", dw, want_dw, dtype, worst)
    return chip_smoke.readings(worst)


def main(argv):
    if not torch.cuda.is_available():
        print("rmsnorm_designs: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    parent = os.path.abspath(argv[1]) if len(argv) > 1 else None
    srcs = designs(parent)
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(8) as ex:
        futures = {n: ex.submit(build, n, s, tmp, os.path.join(
            parent, "brpc_tpu_torch", "csrc") if n == "parent" else
            _build.CSRC) for n, s in srcs.items()}
        libs = {n: f.result() for n, f in futures.items()}
        per_sm = {n: per_sm_of(s) for n, s in srcs.items()}
        bwd_libs = {n: lib for n, lib in libs.items()
                    if hasattr(lib, "brpc_rmsnorm_bwd") and per_sm[n]}
        checked = {n: check(n, lib, per_sm[n], sms, dev)
                   for n, lib in bwd_libs.items()}
        print(json.dumps({"checked": checked}), flush=True)
        rows, d = chip_smoke.RMS_MAIN
        gen = torch.Generator().manual_seed(0)
        copies = math.ceil(2 * chip_smoke.L2_BYTES / (2 * rows * d))
        xs = [chip_smoke.randn(gen, (rows, d), torch.bfloat16, dev)
              for _ in range(2 * copies)]
        w = torch.ones(d, device=dev, dtype=torch.bfloat16)
        out = torch.empty_like(xs[0])
        nxt = itertools.cycle(range(copies)).__next__
        bwds = {n: Backward(lib, per_sm[n], sms, rows, d, torch.bfloat16,
                            dev) for n, lib in bwd_libs.items()}
        res = {"fwd": {}, "bwd": {}}
        for _ in range(3):
            res["fwd"].setdefault("F.rms_norm", []).append(
                chip_smoke.graph_ms(lambda: F.rms_norm(
                    xs[nxt()], (d,), w, eps=pallas_ops.EPS)))
            for name, lib in libs.items():
                res["fwd"].setdefault(name, []).append(chip_smoke.graph_ms(
                    lambda: forward(lib, xs[nxt()], w, out)))
            for name, b in bwds.items():
                def call(b=b):
                    i = nxt()
                    return b(xs[i], w, xs[copies + i])
                res["bwd"].setdefault(name, []).append(
                    chip_smoke.graph_ms(call))
        res["bwd_blocks"] = {n: b.blocks for n, b in bwds.items()}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"rmsnorm_designs_graph_ms": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
