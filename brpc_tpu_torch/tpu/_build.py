"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use into
``build/brpc_tpu_torch/lib<name>-<hash>.so`` at the root of the checkout:
a shared library with a plain C interface, so the build takes seconds
(no PyTorch headers). The file name carries a hash of the source and the
flags, so an edited source is rebuilt and a stale library is never
loaded. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "brpc_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Names of every kernel source under csrc/."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build brpc_tpu_torch's kernels")
    return path


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as fh:
        digest = hashlib.sha256(fh.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str, out: str) -> subprocess.Popen:
    # each build writes a private temp file, renamed into place when done,
    # so a concurrent loader never sees a half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    return subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
         os.path.join(CSRC, name + ".cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: str, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    tmp = f"{out}.{os.getpid()}.tmp"
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> Dict[str, str]:
    """Compile every source not built yet, one nvcc per source, all
    started together. Returns nvcc's output (register and shared-memory
    use from ``-Xptxas -v``) per source it built."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with _lock:
        todo = {n: _lib_path(n) for n in sources()}
        todo = {n: p for n, p in todo.items() if not os.path.exists(p)}
        procs = {n: _start(n, p) for n, p in todo.items()}
        return {n: _finish(n, todo[n], proc) for n, proc in procs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        out = _lib_path(name)
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            _finish(name, out, _start(name, out))
        lib = _libs[name] = ctypes.CDLL(out)
        return lib
