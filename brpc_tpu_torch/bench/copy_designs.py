"""Designs of the copy kernel (csrc/copy.cu) against each other and
``dst.copy_(src)`` on a card:

    python3 brpc_tpu_torch/bench/copy_designs.py [PARENT_CHECKOUT]

Builds copy.cu as it is, with other stage sizes, ring depths and blocks
per SM, and with one contiguous span of chunks per block in place of the
round-robin deal; with a parent checkout, that checkout's copy.cu too.
Checks each bit for bit (lengths across stages and spans, offsets 0/1/8
and a mismatched pair), then times each as CUDA-graph replay at 64 MiB,
256 MiB, the pump's L2-resident 8 MiB and 32 x 1 KiB batched, in three
rounds beside the library copies. Prints one JSON line per result and the
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
from brpc_tpu_torch.tpu import _build  # noqa: E402

# (stages, KiB per stage, blocks per SM) besides copy.cu's own
CONSTANTS = [(4, 32, 1), (3, 32, 2), (4, 24, 2), (8, 8, 2), (4, 8, 4)]
ROUND_ROBIN = """  const int64_t chunks =
      total > block ? (total - block + blocks - 1) / blocks : 0;"""
ROUND_ROBIN_OFF = ("auto off = [&](int64_t j) { return (block + j * blocks)"
                   " * kStageBytes; };")
CONTIGUOUS = """  const int64_t per = (total + blocks - 1) / blocks;
  const int64_t first = block * per < total ? block * per : total;
  const int64_t chunks = (first + per < total ? first + per : total) - first;"""
CONTIGUOUS_OFF = ("auto off = [&](int64_t j) { return (first + j)"
                  " * kStageBytes; };")


def with_constants(src, stages, kib, per_sm):
    for pat, val in ((r"kStages = \d+;", f"kStages = {stages};"),
                     (r"kStageBytes = \d+ << 10;",
                      f"kStageBytes = {kib} << 10;"),
                     (r"kBlocksPerSM = \d+;", f"kBlocksPerSM = {per_sm};")):
        src, n = re.subn(pat, val, src)
        if n != 1:
            raise ValueError(f"copy.cu has no single {pat}")
    return src


def contiguous(src):
    if ROUND_ROBIN not in src or ROUND_ROBIN_OFF not in src:
        raise ValueError("copy.cu's round-robin deal not found")
    return src.replace(ROUND_ROBIN, CONTIGUOUS).replace(ROUND_ROBIN_OFF,
                                                        CONTIGUOUS_OFF)


def designs(parent):
    with open(os.path.join(_build.CSRC, "copy.cu")) as fh:
        base = fh.read()
    out = {"this": base, "contiguous": contiguous(base)}
    for c in CONSTANTS:
        out["s{}_k{}_b{}".format(*c)] = with_constants(base, *c)
        out["contiguous_s{}_k{}_b{}".format(*c)] = contiguous(
            with_constants(base, *c))
    if parent:
        with open(os.path.join(parent, "brpc_tpu_torch", "csrc",
                               "copy.cu")) as fh:
            out["parent"] = fh.read()
    return out


def build(name, src, tmp):
    cu, so = os.path.join(tmp, f"{name}.cu"), os.path.join(tmp, f"{name}.so")
    with open(cu, "w") as fh:
        fh.write(src)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                        _build.CSRC, "-o", so, cu], capture_output=True,
                       text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(so)
    lib.brpc_copy.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64,
                                                      ctypes.c_void_p]
    lib.brpc_copy_batched.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_void_p]
    return lib


class Item(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
                ("nbytes", ctypes.c_int64)]


def copy(lib, s, d):
    rc = lib.brpc_copy(s.data_ptr(), d.data_ptr(), s.numel(),
                       torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"brpc_copy returned {rc}")


def batched(lib, xs, outs):
    items = (Item * len(xs))(*[Item(x.data_ptr(), o.data_ptr(), x.numel())
                               for x, o in zip(xs, outs)])
    rc = lib.brpc_copy_batched(items, len(xs),
                               torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"brpc_copy_batched returned {rc}")


def check(name, lib, big, out, lengths):
    for n in lengths:
        for so, do in ((0, 0), (1, 1), (8, 8), (1, 3)):
            out.fill_(0xA5)
            copy(lib, big[so:so + n], out[do:do + n])
            torch.cuda.synchronize()
            if not (torch.equal(out[do:do + n], big[so:so + n])
                    and bool((out[:do] == 0xA5).all())
                    and bool((out[do + n:] == 0xA5).all())):
                raise AssertionError(f"{name}: {n} B src+{so} dst+{do}")


def main(argv):
    if not torch.cuda.is_available():
        print("copy_designs: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    srcs = designs(os.path.abspath(argv[1]) if len(argv) > 1 else None)
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(8) as ex:
        futures = {n: ex.submit(build, n, s, tmp) for n, s in srcs.items()}
        libs = {n: f.result() for n, f in futures.items()}
        gen = torch.Generator(device=dev).manual_seed(0)
        big = torch.randint(0, 256, ((64 << 20) + 64,), dtype=torch.uint8,
                            device=dev, generator=gen)
        out = torch.empty_like(big)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        lengths = [1, 1000, 64 << 20, (64 << 20) + 4] + \
            chip_smoke.copy_edge_lengths(sms)
        for name, lib in libs.items():
            check(name, lib, big, out, lengths)
        print(json.dumps({"checked": sorted(libs), "lengths": lengths}),
              flush=True)
        del big, out
        bufs = {key: (torch.randint(0, 256, (n,), dtype=torch.uint8,
                                    device=dev, generator=gen),
                      torch.empty(n, dtype=torch.uint8, device=dev))
                for key, n in (("64MiB", 64 << 20), ("256MiB", 256 << 20),
                               ("pump_8MiB_l2", 8 << 20))}
        xs = [torch.randint(0, 256, (1024,), dtype=torch.uint8, device=dev,
                            generator=gen) for _ in range(32)]
        outs = [torch.empty_like(x) for x in xs]
        res = {key: {} for key in [*bufs, "batched_32x1KiB"]}
        for _ in range(3):
            for key, (x, o) in bufs.items():
                res[key].setdefault("dst.copy_", []).append(
                    chip_smoke.graph_ms(lambda: o.copy_(x)))
                for name, lib in libs.items():
                    res[key].setdefault(name, []).append(
                        chip_smoke.graph_ms(lambda: copy(lib, x, o)))
            res["batched_32x1KiB"].setdefault("_foreach_copy_", []).append(
                chip_smoke.graph_ms(lambda: torch._foreach_copy_(outs, xs)))
            for name, lib in libs.items():
                res["batched_32x1KiB"].setdefault(name, []).append(
                    chip_smoke.graph_ms(lambda: batched(lib, xs, outs)))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"copy_designs_graph_ms": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
