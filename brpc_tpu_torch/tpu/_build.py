"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use into
``build/brpc_tpu_torch/lib<name>-<hash>.so`` at the root of the checkout:
a shared library with a plain C interface, so the build takes seconds
(no PyTorch headers). The file name carries a hash of the source, of the
shared headers (``csrc/*.cuh``) and of the flags, so an edited source or
header is rebuilt and a stale library is never loaded. A build holds an
``fcntl`` lock on ``build/brpc_tpu_torch/lock`` (beside the thread lock),
so processes that start together (the ranks of a mesh, ``tpu/launch.py``)
build each library once and load it whole; the kernel closes the lock
with its holder, so a process killed mid-build leaves nothing to clear.
Nothing here runs at import time.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
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
    # every header under csrc/ enters every source's hash: an edited
    # header rebuilds each library that may include it
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    digest = hashlib.sha256()
    for f in [name + ".cu", *headers]:
        with open(os.path.join(CSRC, f), "rb") as fh:
            digest.update(fh.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


@contextlib.contextmanager
def _build_lock():
    """This process's threads, then every process, one at a time."""
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, "lock"), "a") as fh:
            fcntl.flock(fh, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(fh, fcntl.LOCK_UN)


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
    with open(out + ".log", "w") as fh:
        fh.write(log)
    return log


def build_all() -> Dict[str, str]:
    """Compile every source not built yet, one nvcc per source, all
    started together. Returns nvcc's output (register, shared-memory and
    spill use per kernel from ``-Xptxas -v``) per source, kept beside each
    library, so a library built earlier reports its build too."""
    with _build_lock():
        libs = {n: _lib_path(n) for n in sources()}
        todo = {n: p for n, p in libs.items() if not os.path.exists(p)}
        procs = {n: _start(n, p) for n, p in todo.items()}
        for n, proc in procs.items():
            _finish(n, todo[n], proc)
        logs = {}
        for n, p in libs.items():
            if os.path.exists(p + ".log"):
                with open(p + ".log") as fh:
                    logs[n] = fh.read()
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
    with _build_lock():
        lib = _libs.get(name)
        if lib is None:
            out = _lib_path(name)
            if not os.path.exists(out):
                _finish(name, out, _start(name, out))
            lib = _libs[name] = ctypes.CDLL(out)
        return lib
