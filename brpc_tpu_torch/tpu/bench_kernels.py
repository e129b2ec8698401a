"""Benchmark kernels: the device-resident echo datapath, on the card.

The port of ``brpc_tpu/tpu/bench_kernels.py``. One "echo" is a payload
copied from the client-side buffer to the server-side buffer and back:
two full passes through device memory. The TPU wrote each copy as a
Pallas kernel; here every copy is ``csrc/copy.cu``, a byte copy written
by hand (``brpc_copy``, and ``brpc_copy_batched`` for up to 32 copies in
one launch), so nothing can fuse the movement away.

- :func:`hbm_copy` (1-D), :func:`hbm_copy2d` ([rows, lanes]),
  :func:`echo_loop` and :func:`echo_loop_probe` keep the JAX names and
  argument checks. The TPU grids leave a tail unwritten past a whole
  number of blocks (ROADMAP Queue 3); these copy every byte.
- :func:`hbm_copy_batched` copies k tensors in one launch; the device
  store's dispatcher runs it.
- :func:`copy_bytes` copies into a given tensor at any byte offset.
- :func:`hbm_copy_reference` is the plain version, ``clone()``.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. Launches are counted in ``pallas_ops.launches`` under
``hbm_copy`` and ``hbm_copy_batched``: a probe of r rounds is 2r
``hbm_copy`` launches.
"""

from __future__ import annotations

import ctypes

import torch

from brpc_tpu_torch.tpu import pallas_ops
from brpc_tpu_torch.tpu.pallas_ops import _i32, _i64, _ptr

MAX_BATCH = 32  # csrc/copy.cu kMaxBatch


class _CopyItem(ctypes.Structure):
    """csrc/copy.cu's CopyItem."""

    _fields_ = [("src", _ptr), ("dst", _ptr), ("nbytes", _i64)]


def hbm_copy_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of every copy here."""
    return x.clone()


def _flat_bytes(name: str, t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a flat uint8 view."""
    if not t.is_contiguous():
        raise ValueError(f"{name} takes contiguous tensors")
    return t.reshape(-1).view(torch.uint8)


def _launch(src: torch.Tensor, dst: torch.Tensor) -> None:
    """One brpc_copy of src's bytes into dst's (flat uint8, one card)."""
    n = src.numel()
    if n == 0:
        return
    s, d = src.data_ptr(), dst.data_ptr()
    if s < d + n and d < s + n:
        raise ValueError("hbm_copy: source and destination overlap")
    fn = pallas_ops._bind("copy", "brpc_copy", [_ptr, _ptr, _i64, _ptr])
    with torch.cuda.device(src.device):
        rc = fn(s, d, n, pallas_ops._stream(src))
    pallas_ops._raise_on(rc, "copy", "hbm_copy")
    pallas_ops.launches.add("hbm_copy")


def copy_bytes(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Copy src's bytes into dst (contiguous, the same byte count, one
    device; any dtypes and offsets); returns dst."""
    s, d = _flat_bytes("copy_bytes", src), _flat_bytes("copy_bytes", dst)
    if s.numel() != d.numel():
        raise ValueError(f"copy_bytes: {s.numel()} bytes into "
                         f"{d.numel()}")
    if pallas_ops._on_cpu("copy_bytes", s, d):
        d.copy_(s)
    else:
        _launch(s, d)
    return dst


def _copy(name: str, x: torch.Tensor) -> torch.Tensor:
    src = _flat_bytes(name, x)
    if pallas_ops._on_cpu(name, x):
        return hbm_copy_reference(x)
    out = torch.empty_like(x)
    _launch(src, _flat_bytes(name, out))
    return out


def hbm_copy(x: torch.Tensor) -> torch.Tensor:
    """Device memory -> device memory copy of a 1-D tensor (one full read
    and write)."""
    if x.dim() != 1:
        raise ValueError(f"hbm_copy takes a 1-D array, got shape "
                         f"{tuple(x.shape)}")
    return _copy("hbm_copy", x)


def hbm_copy2d(x: torch.Tensor) -> torch.Tensor:
    """Device memory -> device memory copy of a [rows, lanes] tensor."""
    if x.dim() != 2:
        raise ValueError(f"hbm_copy2d takes a [rows, lanes] array, got "
                         f"shape {tuple(x.shape)}")
    return _copy("hbm_copy2d", x)


def echo_loop(x: torch.Tensor, rounds: int = 8) -> torch.Tensor:
    """``rounds`` echo round trips: client buf -> server buf -> client buf.

    Returns the final client buffer (equal to x, so correctness is
    checkable); 4 full passes through device memory per round (2 copies,
    read + write). The two buffers are allocated once and the copies
    ping-pong between them; x is never written. ``rounds`` <= 0 returns x,
    as the JAX loop does."""
    if x.dim() != 2:
        raise ValueError(f"echo_loop takes a [rows, lanes] array, got shape "
                         f"{tuple(x.shape)}")
    if rounds <= 0:
        return x
    server, client = torch.empty_like(x), torch.empty_like(x)
    # the checks of copy_bytes once, not per copy: the loop is host-bound
    src, sb, cb = (_flat_bytes("echo_loop", t) for t in (x, server, client))
    if pallas_ops._on_cpu("echo_loop", src):
        def copy(s, d):
            d.copy_(s)
    else:
        copy = _launch
    for _ in range(rounds):
        copy(src, sb)
        copy(sb, cb)
        src = cb
    return client


def echo_loop_probe(x: torch.Tensor, rounds: int) -> torch.Tensor:
    """:func:`echo_loop` plus a dependent scalar, ``out[0, 0] + out[-1,
    -1]`` in x's dtype (an int32 sum wraps, as in JAX): reading it on the
    host waits for the last copy."""
    if x.dim() != 2:
        raise ValueError("probe expects a 2-D payload")
    out = echo_loop(x, rounds)
    return out[0, 0] + out[-1, -1]


def hbm_copy_batched(xs) -> list:
    """Copies of up to MAX_BATCH contiguous tensors of one device, any
    shapes and dtypes, in one launch; returns them in order."""
    xs = list(xs)
    if not 1 <= len(xs) <= MAX_BATCH:
        raise ValueError(f"hbm_copy_batched takes 1..{MAX_BATCH} tensors, "
                         f"got {len(xs)}")
    srcs = [_flat_bytes("hbm_copy_batched", x) for x in xs]
    if pallas_ops._on_cpu("hbm_copy_batched", *xs):
        return [hbm_copy_reference(x) for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    items = [(s.data_ptr(), o.data_ptr(), s.numel())
             for s, o in zip(srcs, outs) if s.numel()]
    if items:
        fn = pallas_ops._bind("copy", "brpc_copy_batched",
                              [ctypes.POINTER(_CopyItem), _i32, _ptr])
        arr = (_CopyItem * len(items))(*items)
        with torch.cuda.device(xs[0].device):
            rc = fn(arr, len(items), pallas_ops._stream(xs[0]))
        pallas_ops._raise_on(rc, "copy", "hbm_copy_batched")
        pallas_ops.launches.add("hbm_copy_batched")
    return outs
