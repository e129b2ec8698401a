"""Attention kernels of the serving path, written in CUDA for Hopper.

The module keeps the name of its JAX counterpart,
``brpc_tpu/tpu/pallas_ops.py``, so each function's original is easy to
find; the kernels here are not Pallas but CUDA C++ under ``csrc/``,
built with nvcc and called through ctypes (``tpu/_build.py``).

- :func:`attention_reference` is the plain PyTorch version: the CPU
  tests use it and ``chip_smoke.py`` holds the kernel against it.
- :func:`flash_attention` is the wrapper. A CPU tensor goes to the plain
  version; a CUDA tensor launches ``csrc/flash_attention.cu`` or raises.
- ``launches`` counts kernel launches per wrapper, so a run can show that
  its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

NEG_INF = -1e30

_HEAD_DIMS = (16, 32, 64, 128)


class LaunchCounts:
    """Per-kernel launch counts, bumped by each wrapper right where it
    launches its kernel and nowhere else."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = {"flash_attention": 0}

    def add(self, name: str) -> None:
        with self._lock:
            self._n[name] += 1

    def __getitem__(self, name: str) -> int:
        with self._lock:
            return self._n[name]

    def reset(self) -> None:
        with self._lock:
            for name in self._n:
                self._n[name] = 0


launches = LaunchCounts()


def attention_reference(q, k, v, causal: bool = False):
    """O(S^2)-memory plain attention: q (Sq, D) and k, v (Sk, D), or the
    same with heads on axis 1, (S, H, D)."""
    heads = q.dim() == 3
    qf, kf, vf = (t.float() if heads else t.float().unsqueeze(1)
                  for t in (q, k, v))
    s = torch.einsum("qhd,khd->hqk", qf, kf) / math.sqrt(q.shape[-1])
    if causal:
        mask = torch.ones(s.shape[-2:], dtype=torch.bool,
                          device=s.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("hqk,khd->qhd", p, vf).to(q.dtype)
    return out if heads else out.squeeze(1)


def _check_blocks(sq: int, sk: int, block_q: int, block_k: int) -> None:
    bq = min(block_q, sq)
    bk = min(block_k, sk)
    if sq % bq or sk % bk:
        raise ValueError(f"seq lengths ({sq},{sk}) must divide blocks "
                         f"({bq},{bk})")


def flash_attention(q, k, v, causal: bool = False, block_q: int = 128,
                    block_k: int = 128):
    """Flash attention over (S, D) tensors, or (S, H, D) with heads on
    axis 1 (one launch for all heads). Sequence lengths must divide the
    block sizes, as for the TPU kernel. A CPU tensor is computed by
    :func:`attention_reference`; a CUDA tensor launches the kernel."""
    if q.dim() not in (2, 3) or k.dim() != q.dim() or v.dim() != q.dim():
        raise ValueError(f"flash_attention takes (S, D) or (S, H, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    _check_blocks(q.shape[0], k.shape[0], block_q, block_k)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _flash_cuda(q, k, v, causal)


def _flash_cuda(q, k, v, causal: bool):
    heads = q.dim() == 3
    q3, k3, v3 = (t if heads else t.unsqueeze(1) for t in (q, k, v))
    sq, h, d = q3.shape
    sk = k3.shape[0]
    for name, t in (("q", q3), ("k", k3), ("v", v3)):
        if t.device != q3.device:
            raise ValueError(f"{name} on {t.device}, q on {q3.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"flash_attention kernel takes float32, "
                            f"{name} is {t.dtype}")
        if t.stride(2) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
    if k3.shape != (sk, h, d) or v3.shape != (sk, h, d):
        raise ValueError(f"k/v shapes {tuple(k3.shape)}, {tuple(v3.shape)} "
                         f"do not match q {tuple(q3.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_HEAD_DIMS}")
    o = torch.empty((sq, h, d), dtype=torch.float32, device=q3.device)
    fn = _kernel()
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream(q3.device).cuda_stream
        rc = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(),
                sq, sk, h, d, q3.stride(0), q3.stride(1), k3.stride(0),
                k3.stride(1), v3.stride(0), v3.stride(1), o.stride(0),
                o.stride(1), int(causal), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{_error_string(rc)} ({rc})")
    launches.add("flash_attention")
    return o if heads else o.squeeze(1)


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from brpc_tpu_torch.tpu import _build

        lib = _build.load("flash_attention")
        fn = lib.brpc_flash_attention_f32
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                       i64, i64, i64, i64, i64, i64, i64, i64, i32, ptr]
        fn.restype = i32
        lib.brpc_cuda_error_string.argtypes = [i32]
        lib.brpc_cuda_error_string.restype = ctypes.c_char_p
        _fn = fn
    return _fn


def _error_string(rc: int) -> str:
    from brpc_tpu_torch.tpu import _build

    return _build.load("flash_attention").brpc_cuda_error_string(rc) \
        .decode()
