"""Attention and normalisation kernels, written in CUDA for Hopper.

The module keeps the name of its JAX counterpart,
``brpc_tpu/tpu/pallas_ops.py``, so each function's original is easy to
find; the kernels here are not Pallas but CUDA C++ under ``csrc/``,
built with nvcc and called through ctypes (``tpu/_build.py``).

- Each kernel has a plain PyTorch version beside it
  (:func:`attention_reference`, :func:`flash_fwd_reference`,
  :func:`flash_bwd_reference`, :func:`rmsnorm_reference`,
  :func:`flash_carry_reference`, :func:`softmax_xent_reference`): the CPU
  tests use them and ``chip_smoke.py`` holds each kernel against its own.
- The wrappers take the plain version for a CPU tensor only; a CUDA
  tensor launches the kernel or raises.
- ``launches`` counts kernel launches per kernel, so a run can show that
  its main path went through the kernels.

Serving prefill uses :func:`flash_attention`, whose kernel is the
forward of ``csrc/flash_fwd.cu`` without lse (at the serving head dim 16,
``fwd_f32_mma_kernel`` on the tf32 tensor cores in 3xTF32). Training uses
:func:`flash_attention_mha`, an autograd function whose forward is the
same kernel and whose backward is the dQ and dK/dV kernels of
``csrc/flash_bwd.cu``, and :func:`rmsnorm`, whose forward and backward
are ``csrc/rmsnorm.cu`` (the backward is XLA in the JAX package, which
fuses it; PyTorch eager does not), and :func:`softmax_xent`, the fused cross-entropy of
``csrc/xent.cu`` with a plain backward likewise. Ring attention
(``tpu/ring.py``) runs :func:`flash_attention_carry`, the carry form of
the forward kernel, and the backward kernels at absolute offsets;
:func:`_flash_fwd_qgrid` is the q-grid forward's entry, on the card the
same forward kernel.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

EPS = 1e-6
NEG_INF = -1e30

_HEAD_DIMS = (16, 32, 64, 128)     # csrc/flash_fwd.cu
_MHA_HEAD_DIMS = (32, 64, 128)     # csrc/flash_bwd.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh codes
_MAX_GRID_Y = 65535                # batch * heads ride the grid's y axis


class LaunchCounts:
    """Per-kernel launch counts, bumped by each wrapper right where it
    launches its kernel and nowhere else; also kept per launching thread,
    so two engines in one process (each stepping on its own thread) can
    each read their own."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_thread: dict = {}
        self._n = {name: 0 for name in ("flash_attention", "flash_fwd",
                                        "flash_fwd_qgrid", "flash_carry",
                                        "flash_bwd_dq", "flash_bwd_dkv",
                                        "rmsnorm", "rmsnorm_bwd",
                                        "softmax_xent",
                                        # csrc/copy.cu (tpu/bench_kernels.py)
                                        "hbm_copy", "hbm_copy_batched")}

    def add(self, name: str) -> None:
        ident = threading.get_ident()
        with self._lock:
            self._n[name] += 1
            mine = self._by_thread.setdefault(ident, {})
            mine[name] = mine.get(name, 0) + 1

    def __getitem__(self, name: str) -> int:
        with self._lock:
            return self._n[name]

    def of_thread(self, ident: int, name: str) -> int:
        """``name``'s launches made on thread ``ident`` since the last
        reset."""
        with self._lock:
            return self._by_thread.get(ident, {}).get(name, 0)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._n)

    def reset(self) -> None:
        with self._lock:
            for name in self._n:
                self._n[name] = 0
            self._by_thread.clear()


launches = LaunchCounts()


# ---------------------------------------------------------------------------
# Binding and launch checks shared by every kernel
# ---------------------------------------------------------------------------
_ptr, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_fns = {}


def _bind(source: str, symbol: str, argtypes):
    """The C function ``symbol`` of ``csrc/<source>.cu``, built and loaded
    at first use."""
    fn = _fns.get((source, symbol))
    if fn is None:
        from brpc_tpu_torch.tpu import _build

        lib = _build.load(source)
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = _i32
        lib.brpc_cuda_error_string.argtypes = [_i32]
        lib.brpc_cuda_error_string.restype = ctypes.c_char_p
        _fns[(source, symbol)] = fn
    return fn


def _raise_on(rc: int, source: str, what: str) -> None:
    if rc != 0:
        from brpc_tpu_torch.tpu import _build

        text = _build.load(source).brpc_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {text} ({rc})")


def _on_cpu(name: str, *tensors) -> bool:
    """True when every tensor lies on the CPU (the plain version runs),
    False when all lie on one CUDA device (the kernel runs); raises on
    anything else. The two answers are read from flags and device indices,
    without building a device object per tensor (a launch's host cost)."""
    first = tensors[0]
    if first.is_cuda:
        dev = first.get_device()
        if all(t.is_cuda and t.get_device() == dev for t in tensors):
            return False
    elif all(t.is_cpu for t in tensors):
        return True
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {devs}")
    raise ValueError(f"{name} runs on cuda or cpu, not {devs.pop()}")


def _check_kernel_inputs(name: str, dtype, **tensors) -> None:
    """What every training kernel takes: one dtype of _DTYPES, contiguous,
    16-byte aligned."""
    if dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, not "
                        f"{dtype}")
    for tname, t in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {tname} is {t.dtype}, want {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must be 16-byte aligned")


def _cuda_ready(name: str, **tensors) -> bool:
    """One check before a launch, of a wrapper's tensors all at once:
    True when all lie on one CUDA device in one dtype of _DTYPES,
    contiguous and 16-byte aligned (the kernel takes them as they are);
    False when all lie on the CPU (the plain version runs); anything else
    raises what :func:`_on_cpu` or :func:`_check_kernel_inputs` raise.
    The common answer costs one pass over flags, without the two
    helpers' generic loops (a launch's host cost)."""
    ts = tuple(tensors.values())
    first = ts[0]
    if first.is_cuda and first.dtype in _DTYPES:
        dev, dt = first.get_device(), first.dtype
        for t in ts:
            if not (t.is_cuda and t.dtype is dt and t.get_device() == dev
                    and t.is_contiguous() and not t.data_ptr() % 16):
                break
        else:
            return True
    if _on_cpu(name, *ts):
        return False
    _check_kernel_inputs(name, first.dtype, **tensors)
    return True


def _stream(t):
    """The raw handle of the current stream of ``t``'s CUDA device (no
    Stream object is built)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _call(fn, t, *args):
    """``fn(*args, stream)`` on ``t``'s device and current stream: one
    launch through a C entry point; returns its error code. The device is
    switched only when ``t`` is not on the current one."""
    dev = t.get_device()
    if dev == torch._C._cuda_getDevice():  # torch.cuda.current_device()
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    with torch.cuda.device(dev):
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev))


# What a TMA tensor map takes (csrc/hopper.cuh), checked before a bf16
# tensor reaches the tensor-core kernels: a 16-byte aligned base, the last
# dim contiguous, every other stride a multiple of 16 bytes below 2^40, and
# every row of every head addressable by a 32-bit TMA coordinate.
_TMA_STRIDE_ALIGN = 16
_TMA_STRIDE_MAX = 1 << 40
_TMA_COORD_MAX = 1 << 31


def _check_tma(name: str, **tensors) -> None:
    for tname, t in tensors.items():
        size = t.element_size()
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {tname}'s last dim must be contiguous "
                             f"for TMA")
        if t.data_ptr() % _TMA_STRIDE_ALIGN:
            raise ValueError(f"{name}: {tname} must be 16-byte aligned for "
                             f"TMA")
        for ax in range(t.dim() - 1):
            nbytes = t.stride(ax) * size
            if nbytes % _TMA_STRIDE_ALIGN or not 0 < nbytes < _TMA_STRIDE_MAX:
                raise ValueError(f"{name}: {tname}'s stride {t.stride(ax)} "
                                 f"on axis {ax} ({nbytes} bytes) is not a "
                                 f"positive multiple of 16 bytes below 2^40,"
                                 f" which TMA needs")
        if t.numel() // t.shape[-1] >= _TMA_COORD_MAX:
            raise ValueError(f"{name}: {tname} has {t.numel() // t.shape[-1]}"
                             f" rows, past TMA's 32-bit coordinates")


# ---------------------------------------------------------------------------
# Serving prefill: flash attention over (S, D) or (S, H, D)
# ---------------------------------------------------------------------------
def attention_reference(q, k, v, causal: bool = False):
    """O(S^2)-memory plain attention in fp32, cast back to q's dtype:
    q (Sq, D) and k, v (Sk, D), or the same with heads on the next-to-last
    axis, (S, H, D) or (B, S, H, D). Causal is aligned at position 0."""
    heads = q.dim() >= 3
    qf, kf, vf = (t.float() if heads else t.float().unsqueeze(1)
                  for t in (q, k, v))
    s = torch.einsum("...qhd,...khd->...hqk", qf, kf) / math.sqrt(
        q.shape[-1])
    if causal:
        mask = torch.ones(s.shape[-2:], dtype=torch.bool,
                          device=s.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("...hqk,...khd->...qhd", p, vf).to(q.dtype)
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
    if _on_cpu("flash_attention", q, k, v):
        return attention_reference(q, k, v, causal=causal)
    return _flash_cuda(q, k, v, causal)


# csrc/flash_fwd.cu's brpc_flash_fwd: q, k, v, o, lse; n, sq, sk, head dim,
# dtype, causal; the (N, row) strides of q, k, v and o; the stream
_FWD_ARGTYPES = [_ptr] * 5 + [_i32] * 6 + [_i64] * 8 + [_ptr]
_serving_fn = None  # brpc_flash_fwd, bound at flash_attention's first launch


def _flash_cuda(q, k, v, causal: bool):
    """One launch of csrc/flash_fwd.cu for flash_attention: fp32 (S, H, D)
    views read through their strides, o only; at head dim 16 the kernel is
    ``fwd_f32_mma_kernel``. Every check runs before the launch; per call it
    reads each tensor's strides and pointer once, and binds nothing."""
    global _serving_fn
    heads = q.dim() == 3
    q3, k3, v3 = (q, k, v) if heads else (q.unsqueeze(1), k.unsqueeze(1),
                                          v.unsqueeze(1))
    sq, h, d = q3.shape
    sk = k3.shape[0]
    if k3.shape != (sk, h, d) or v3.shape != (sk, h, d):
        raise ValueError(f"k/v shapes {tuple(k3.shape)}, {tuple(v3.shape)} "
                         f"do not match q {tuple(q3.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_HEAD_DIMS}")
    ptrs, strides = [], []
    for name, t in (("q", q3), ("k", k3), ("v", v3)):
        if t.dtype != torch.float32:
            raise TypeError(f"flash_attention kernel takes float32, "
                            f"{name} is {t.dtype}")
        row, head, last = t.stride()
        if last != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
        ptr = t.data_ptr()
        if ptr % 16 or row % 4 or head % 4:
            raise ValueError(f"{name}'s rows must be 16-byte aligned")
        ptrs.append(ptr)
        strides += (head, row)
    o = q3.new_empty((sq, h, d))
    fn = _serving_fn
    if fn is None:
        fn = _serving_fn = _bind("flash_fwd", "brpc_flash_fwd",
                                 _FWD_ARGTYPES)
    # heads are the kernel's N axis; o is contiguous: (d, h * d)
    rc = _call(fn, q3, *ptrs, o.data_ptr(), None, h, sq, sk, d, 0,
               int(causal), *strides, d, h * d)
    if rc:
        _raise_on(rc, "flash_fwd", "flash_attention")
    launches.add("flash_attention")
    return o if heads else o.squeeze(1)


def _fwd_launch(q, k, v, o, lse, n, sq, sk, causal, strides):
    """One launch of csrc/flash_fwd.cu; ``strides`` holds the (N, row)
    element strides of q, k, v and o; ``lse`` None writes o only."""
    fn = _bind("flash_fwd", "brpc_flash_fwd", _FWD_ARGTYPES)
    rc = _call(fn, q, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               None if lse is None else lse.data_ptr(), n, sq, sk,
               q.shape[-1], _DTYPES[q.dtype], int(causal),
               *(x for pair in strides for x in pair))
    _raise_on(rc, "flash_fwd", "flash_fwd")


# ---------------------------------------------------------------------------
# Training: flash attention over [N, S, D] with lse, and its backward
# ---------------------------------------------------------------------------
def _causal_mask(sq: int, sk: int, q_start: int, k_start: int, device):
    """[sq, sk] bool, True where q_start + row >= k_start + col."""
    rows = torch.arange(sq, device=device)[:, None] + q_start
    cols = torch.arange(sk, device=device)[None, :] + k_start
    return rows >= cols


def _scores(q, k, causal, q_start, k_start):
    """q k^T / sqrt(D) in fp32 with the causal mask (absolute positions)
    as NEG_INF; and the mask itself (None when not causal)."""
    s = torch.einsum("nqd,nkd->nqk", q.float(), k.float()) / math.sqrt(
        q.shape[-1])
    if not causal:
        return s, None
    live = _causal_mask(q.shape[1], k.shape[1], q_start, k_start, q.device)
    return torch.where(live, s, torch.full_like(s, NEG_INF)), live


def flash_fwd_reference(q, k, v, causal: bool, q_start: int = 0,
                        k_start: int = 0):
    """Plain version of the forward kernel: q [N, Sq, D], k, v [N, Sk, D]
    -> (o [N, Sq, D] in q's dtype, lse [N, Sq, 1] fp32). Products in fp32,
    P rounded to v's dtype before P V as the TPU kernel does; a row that
    sees no key gets o = 0 and lse = NEG_INF. The offsets place the
    blocks for a causal mask at absolute positions (the kernel's are 0)."""
    s, live = _scores(q, k, causal, q_start, k_start)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if live is not None:
        p = torch.where(live, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    seen = l > 0
    safe = torch.where(seen, l, torch.ones_like(l))
    o = torch.einsum("nqk,nkd->nqd", p.to(v.dtype).float(), v.float()) / safe
    lse = torch.where(seen, m + torch.log(safe), torch.full_like(l, NEG_INF))
    return o.to(q.dtype), lse


def flash_bwd_reference(q, k, v, lse, do, delta, q_start: int, k_start: int,
                        causal: bool):
    """Plain version of the dQ and dK/dV kernels: (dq, dk, dv) in the
    inputs' dtypes. P = exp(s - lse), 0 where lse <= NEG_INF / 2 (a row
    that attended to nothing); P and dS rounded to the operand dtype
    before their products, as the TPU kernels do."""
    s, _ = _scores(q, k, causal, q_start, k_start)
    # masked scores are NEG_INF, so exp(s - lse) is 0 there already
    p = torch.where(lse > NEG_INF / 2, torch.exp(s - lse),
                    torch.zeros_like(s))
    scale = 1.0 / math.sqrt(q.shape[-1])
    dv = torch.einsum("nqk,nqd->nkd", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("nqd,nkd->nqk", do.float(), v.float())
    ds = p * (dp - delta)
    dq = torch.einsum("nqk,nkd->nqd", ds.to(k.dtype).float(),
                      k.float()) * scale
    dk = torch.einsum("nqk,nqd->nkd", ds.to(q.dtype).float(),
                      q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _flash_delta(o, do):
    """delta = rowsum(dO * O) in fp32, [N, Sq, 1]: plain PyTorch, as it is
    plain jnp in the JAX package, computed once by the caller."""
    return torch.sum(do.float() * o.float(), dim=-1, keepdim=True)


def _fit_block(s: int, want: int) -> int:
    """Largest divisor of s that is <= want."""
    b = min(want, s)
    while s % b:
        b -= 1
    return b


# The CUDA kernels tile on their own (common.cuh); the blocks of the TPU
# wrappers only decide which wrapper runs (causal with bq == bk folds) and
# which sequence lengths are refused. The defaults are those the JAX
# package picks off the TPU, so both refuse and dispatch alike.
_WANT_BLOCK = 128


def _pick_blocks(sq: int, sk: int, block_q: int = None, block_k: int = None):
    """Explicit block sizes are honoured exactly (and refused if they do
    not divide); defaults take the largest dividing block."""
    bq = min(block_q, sq) if block_q else _fit_block(sq, _WANT_BLOCK)
    bk = min(block_k, sk) if block_k else _fit_block(sk, _WANT_BLOCK)
    _check_blocks(sq, sk, bq, bk)
    return bq, bk


def _check_nsd(name: str, q, k, v):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"{name} takes [N, S, D] tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    n, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != n or k.shape[2] != d:
        raise ValueError(f"{name}: k/v shapes {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")


def _check_mha_kernel_shape(name: str, q, k) -> None:
    n, sq, d = q.shape
    if d not in _MHA_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {_MHA_HEAD_DIMS}")
    if n > _MAX_GRID_Y:
        raise ValueError(f"{name}: batch * heads {n} > {_MAX_GRID_Y}")
    if 0 in (n, sq, k.shape[1]):
        raise ValueError(f"{name}: empty input {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")


def _flash_fwd_cuda(q, k, v, causal: bool, counter: str = "flash_fwd"):
    """One launch of the forward kernel with lse, counted under
    ``counter`` (the TPU entry it stands for): fp32 takes the FMA kernel,
    bf16 the tensor-core kernel, whose loads are TMA's."""
    _check_mha_kernel_shape(counter, q, k)
    _check_kernel_inputs(counter, q.dtype, q=q, k=k, v=v)
    if q.dtype == torch.bfloat16:
        _check_tma(counter, q=q, k=k, v=v)
    n, sq, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((n, sq, 1), dtype=torch.float32, device=q.device)
    _fwd_launch(q, k, v, o, lse, n, sq, k.shape[1], causal,
                [(t.stride(0), t.stride(1)) for t in (q, k, v, o)])
    launches.add(counter)
    return o, lse


def _flash_fwd_bhsd(q, k, v, causal: bool, bq: int, bk: int, bn: int = 1):
    """Forward over [N, S, D] (N = B*H): returns (o [N,S,D], lse
    [N,S,1] fp32). Replaces the (q-tile, k-tile) grid kernel. ``bn``
    (heads per TPU grid step) means nothing on the card and is validated
    only, as the TPU wrapper does: it must divide N."""
    _check_nsd("_flash_fwd_bhsd", q, k, v)
    _check_blocks(q.shape[1], k.shape[1], bq, bk)
    if q.shape[0] % bn:
        raise ValueError(f"bn ({bn}) must divide batch*heads "
                         f"({q.shape[0]})")
    if _on_cpu("_flash_fwd_bhsd", q, k, v):
        return flash_fwd_reference(q, k, v, causal)
    return _flash_fwd_cuda(q, k, v, causal)


def _flash_fwd_folded(q, k, v, b: int):
    """Causal forward over [N, S, D] with bq = bk = b: returns (o, lse).
    Replaces the triangular-grid kernel; on the card it launches the same
    kernel as :func:`_flash_fwd_bhsd`, which skips the tiles above the
    diagonal itself."""
    _check_nsd("_flash_fwd_folded", q, k, v)
    n, sq, _ = q.shape
    if sq != k.shape[1]:
        raise ValueError("folded causal kernel requires sq == sk")
    if sq % b:
        raise ValueError(f"shape ({n},{sq}) vs blocks (b={b})")
    if _on_cpu("_flash_fwd_folded", q, k, v):
        return flash_fwd_reference(q, k, v, True)
    return _flash_fwd_cuda(q, k, v, True)


def _flash_fwd_qgrid(q, k, v, causal: bool, bq: int, bkc: int, bn: int = 1):
    """q-grid forward over [N, S, D]: returns (o, lse [N,S,1] fp32), the
    causal mask aligned at 0. Replaces the TPU kernel that keeps K/V
    resident and loops over k-chunks of ``bkc`` inside it; the CUDA
    forward kernel already has that schedule (a key loop inside each block,
    stopped at the diagonal), so on the card it launches that kernel.
    Refuses the shapes the TPU wrapper refuses; ``bn`` (heads per TPU grid
    step) means nothing on the card and is validated only."""
    _check_nsd("_flash_fwd_qgrid", q, k, v)
    n, sq, _ = q.shape
    sk = k.shape[1]
    if n % bn or sq % bq or sk % bkc:
        raise ValueError(f"shape ({n},{sq},{sk}) vs blocks "
                         f"({bn},{bq},{bkc})")
    if _on_cpu("_flash_fwd_qgrid", q, k, v):
        return flash_fwd_reference(q, k, v, causal)
    return _flash_fwd_cuda(q, k, v, causal, "flash_fwd_qgrid")


def _flash_fwd_best(q, k, v, causal: bool, bq: int, bk: int):
    """Forward dispatch: causal self-attention with bq == bk takes the
    folded wrapper, everything else the rectangular one."""
    if causal and bq == bk and q.shape[1] == k.shape[1]:
        return _flash_fwd_folded(q, k, v, bq)
    return _flash_fwd_bhsd(q, k, v, causal, bq, bk)


def _flash_bwd_bhsd(q, k, v, lse, do, delta, q_start: int, k_start: int,
                    causal: bool, bq: int, bk: int):
    """Backward over [N, S, D]: returns (dq, dk, dv). q_start / k_start
    are absolute sequence offsets, so a ring hop can reuse the kernels
    with its causal mask intact. On the card: the dQ kernel, then the
    dK/dV kernel."""
    _check_nsd("_flash_bwd_bhsd", q, k, v)
    n, sq, _ = q.shape
    _check_blocks(sq, k.shape[1], bq, bk)
    if do.shape != q.shape or lse.shape != (n, sq, 1) or \
            delta.shape != (n, sq, 1):
        raise ValueError(f"_flash_bwd_bhsd: do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)}, delta {tuple(delta.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if _on_cpu("_flash_bwd_bhsd", q, k, v, lse, do, delta):
        return flash_bwd_reference(q, k, v, lse, do, delta, q_start,
                                   k_start, causal)
    args = (q, k, v, lse, do, delta, q_start, k_start, causal)
    return (_flash_bwd_dq_cuda(*args), *_flash_bwd_dkv_cuda(*args))


def _bwd_launch_args(q, k, v, lse, do, delta, q_start, k_start, causal):
    """Checks the backward kernels' inputs; their leading pointers and
    trailing ints of the C interface."""
    _check_mha_kernel_shape("flash_bwd", q, k)
    _check_kernel_inputs("flash_bwd", q.dtype, q=q, k=k, v=v, do=do)
    _check_kernel_inputs("flash_bwd", torch.float32, lse=lse, delta=delta)
    if q.dtype == torch.bfloat16:
        # lse and delta are read as one flat vector: q's rows bound them
        _check_tma("flash_bwd", q=q, k=k, v=v, do=do)
    n, sq, d = q.shape
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    tail = (n, sq, k.shape[1], d, _DTYPES[q.dtype], int(q_start),
            int(k_start), int(causal))
    return ins, tail


def _flash_bwd_dq_cuda(q, k, v, lse, do, delta, q_start, k_start, causal):
    ins, tail = _bwd_launch_args(q, k, v, lse, do, delta, q_start, k_start,
                                 causal)
    dq = torch.empty_like(q)
    fn = _bind("flash_bwd", "brpc_flash_bwd_dq",
               [_ptr] * 7 + [_i32] * 8 + [_ptr])
    rc = _call(fn, q, *ins, dq.data_ptr(), *tail)
    _raise_on(rc, "flash_bwd", "flash_bwd_dq")
    launches.add("flash_bwd_dq")
    return dq


def _flash_bwd_dkv_cuda(q, k, v, lse, do, delta, q_start, k_start, causal):
    ins, tail = _bwd_launch_args(q, k, v, lse, do, delta, q_start, k_start,
                                 causal)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = _bind("flash_bwd", "brpc_flash_bwd_dkv",
               [_ptr] * 8 + [_i32] * 8 + [_ptr])
    rc = _call(fn, q, *ins, dk.data_ptr(), dv.data_ptr(), *tail)
    _raise_on(rc, "flash_bwd", "flash_bwd_dkv")
    launches.add("flash_bwd_dkv")
    return dk, dv


class _FlashMHA(torch.autograd.Function):
    """[N, S, D] flash attention: the forward kernel, and the dQ and dK/dV
    kernels for the backward (the JAX package's custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, bq, bk):
        o, lse = _flash_fwd_best(q, k, v, causal, bq, bk)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, bq, bk)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, bq, bk = ctx.args
        do = do.contiguous()
        dq, dk, dv = _flash_bwd_bhsd(q, k, v, lse, do, _flash_delta(o, do),
                                     0, 0, causal, bq, bk)
        return dq, dk, dv, None, None, None


def flash_attention_mha(q, k, v, causal: bool = False, block_q: int = None,
                        block_k: int = None):
    """(B, H, S, D) multi-head flash attention, differentiable: B*H fold
    into the kernels' N. A CPU tensor runs the plain versions; a CUDA
    tensor launches the forward kernel and, in the backward, the dQ and
    dK/dV kernels."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention_mha takes (B, H, S, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bq, bk = _pick_blocks(sq, sk, block_q, block_k)
    o = _FlashMHA.apply(q.reshape(b * h, sq, d).contiguous(),
                        k.reshape(b * h, sk, d).contiguous(),
                        v.reshape(b * h, sk, d).contiguous(), causal, bq, bk)
    return o.reshape(b, h, sq, d)


# ---------------------------------------------------------------------------
# Training: RMSNorm
# ---------------------------------------------------------------------------
def rmsnorm_reference(x, w, eps: float = EPS):
    """Plain RMSNorm over the last dim in fp32, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


# csrc/rmsnorm.cu's brpc_rmsnorm: x, w, out; rows, d, dtype, eps; the stream
_RMSNORM_ARGTYPES = [_ptr, _ptr, _ptr, _i64, _i32, _i32, ctypes.c_float,
                     _ptr]


def _rmsnorm_fwd_call(x, w, eps: float = EPS):
    """Fused RMSNorm over the last dim. x: [..., D], w: [D]. A CPU tensor
    runs :func:`rmsnorm_reference`; a CUDA tensor launches the kernel
    (the C function bound once by :func:`_bind`, launched through
    :func:`_call`) on x's rows as they lie, after one :func:`_cuda_ready`
    check."""
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"rmsnorm: w {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if x.is_cuda and not x.is_contiguous():
        x = x.contiguous()
    if not _cuda_ready("rmsnorm", x=x, w=w):
        return rmsnorm_reference(x, w, eps)
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows:
        fn = _bind("rmsnorm", "brpc_rmsnorm", _RMSNORM_ARGTYPES)
        rc = _call(fn, x, x.data_ptr(), w.data_ptr(), out.data_ptr(), rows,
                   d, _DTYPES[x.dtype], eps)
        if rc:
            _raise_on(rc, "rmsnorm", "rmsnorm")
        launches.add("rmsnorm")
    return out


def _rmsnorm_bwd(x, w, g, eps: float):
    """The JAX package's ``_rmsnorm_diff_bwd``: plain elementwise ops and
    reductions; dw sums over every row of an input of any rank."""
    xf, gf, wf = x.float(), g.float(), w.float()
    d = x.shape[-1]
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    gw = gf * wf
    dx = gw * r - xf * (r ** 3 / d) * torch.sum(gw * xf, dim=-1,
                                                keepdim=True)
    dw = torch.sum((gf * xf * r).reshape(-1, d), dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


# csrc/rmsnorm.cu's brpc_rmsnorm_bwd: x, w, g, dx, dw, partials; rows, d,
# blocks, dtype, eps; the stream
_RMSNORM_BWD_ARGTYPES = [_ptr] * 6 + [_i64, _i32, _i32, _i32,
                                      ctypes.c_float, _ptr]
_RMS_WARPS = 8              # csrc/rmsnorm.cu kWarps: a block's rows in flight
_RMS_BWD_BLOCKS_PER_SM = 2  # csrc/rmsnorm.cu kBwdBlocksPerSm
_sms = {}                   # device index -> SM count


def _rmsnorm_bwd_blocks(rows: int, sms: int) -> int:
    """The backward kernel's persistent grid: the blocks the card holds at
    once, at most one per _RMS_WARPS rows (each block takes a contiguous
    chunk of ceil(rows / blocks) rows)."""
    return min(-(-rows // _RMS_WARPS), _RMS_BWD_BLOCKS_PER_SM * sms)


def _rmsnorm_bwd_partials(x, rows: int, d: int):
    """The backward kernel's dw scratch for ``rows`` rows of width ``d`` on
    x's device: one fp32 row of partial sums per block, [blocks, d]."""
    dev = x.get_device()
    sms = _sms.get(dev)
    if sms is None:
        sms = _sms[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return x.new_empty((_rmsnorm_bwd_blocks(rows, sms), d),
                       dtype=torch.float32)


def _rmsnorm_bwd_call(x, w, g, eps: float = EPS):
    """RMSNorm's backward: (dx, dw) for the output gradient g, x and g
    [..., D], w [D]. A CPU tensor runs :func:`_rmsnorm_bwd`; a CUDA tensor
    launches ``brpc_rmsnorm_bwd`` (the row kernel, then the fixed-order sum
    of dw over the blocks' partials: one count) or raises."""
    d = x.shape[-1]
    if w.shape != (d,) or g.shape != x.shape:
        raise ValueError(f"rmsnorm_bwd: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, g {tuple(g.shape)} do not fit")
    if not x.is_contiguous():
        x = x.contiguous()
    if not g.is_contiguous():
        g = g.contiguous()
    if not _cuda_ready("rmsnorm_bwd", x=x, w=w, g=g):
        return _rmsnorm_bwd(x, w, g, eps)
    dx = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if not rows:
        return dx, torch.zeros_like(w)
    dw = torch.empty_like(w)
    partials = _rmsnorm_bwd_partials(x, rows, d)
    fn = _bind("rmsnorm", "brpc_rmsnorm_bwd", _RMSNORM_BWD_ARGTYPES)
    rc = _call(fn, x, x.data_ptr(), w.data_ptr(), g.data_ptr(),
               dx.data_ptr(), dw.data_ptr(), partials.data_ptr(), rows, d,
               partials.shape[0], _DTYPES[x.dtype], eps)
    if rc:
        _raise_on(rc, "rmsnorm", "rmsnorm_bwd")
    launches.add("rmsnorm_bwd")
    return dx, dw


class _RMSNorm(torch.autograd.Function):
    """The kernel forward and the kernel backward; the residuals are
    (x, w), as in the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rmsnorm_fwd_call(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = _rmsnorm_bwd_call(x, w, g, ctx.eps)
        return dx, dw, None


def rmsnorm(x, w, eps: float = EPS):
    """Fused RMSNorm over the last dim, differentiable: the kernel forward
    and the kernel backward. x: [..., D], w: [D]."""
    return _RMSNorm.apply(x, w, eps)


# ---------------------------------------------------------------------------
# Ring attention's inner kernel: the carry form of the flash forward
# ---------------------------------------------------------------------------
def flash_carry_reference(q, k, v, m, l, acc, q_start: int, k_start: int,
                          causal: bool = False):
    """Plain version of the carry kernel: one online-softmax pass of q
    [..., Sq, D] over k, v [..., Sk, D], continuing the state m, l
    [..., Sq, 1] and acc [..., Sq, D] (fp32) -> (m', l', acc'), not
    normalised. Causal at absolute positions (q_start + row >= k_start +
    col). As the TPU kernel: masked scores are NEG_INF, a row whose running
    max is still NEG_INF keeps p = 0 and rescales by 0, and P is rounded to
    v's dtype before P V. A row that sees no key keeps its state exactly."""
    sq, d = q.shape[-2:]
    q3, k3, v3 = (t.reshape(-1, t.shape[-2], d) for t in (q, k, v))
    s, _ = _scores(q3, k3, causal, q_start, k_start)
    m3 = m.reshape(-1, sq, 1).float()
    m_new = torch.maximum(m3, s.amax(dim=-1, keepdim=True))
    alive = m_new > NEG_INF / 2
    p = torch.where(alive, torch.exp(s - m_new), torch.zeros_like(s))
    alpha = torch.where(alive, torch.exp(m3 - m_new), torch.zeros_like(m3))
    l_new = l.reshape(-1, sq, 1).float() * alpha + p.sum(dim=-1,
                                                         keepdim=True)
    acc_new = acc.reshape(-1, sq, d).float() * alpha + torch.einsum(
        "nqk,nkd->nqd", p.to(v.dtype).float(), v3.float())
    return (m_new.reshape(m.shape), l_new.reshape(l.shape),
            acc_new.reshape(acc.shape))


def flash_attention_carry(q, k, v, m, l, acc, q_start: int, k_start: int,
                          causal: bool = False, block_q: int = 128,
                          block_k: int = 128):
    """One online-softmax accumulation pass over (k, v) for queries q,
    continuing the running state: q [..., Sq, D]; k, v [..., Sk, D]; m, l
    [..., Sq, 1] and acc [..., Sq, D] fp32; q_start / k_start absolute
    sequence offsets for the causal mask. Leading axes (a ring's batch and
    heads) ride one launch. Returns (m', l', acc'); normalise with acc / l
    after the last pass. Sequence lengths must divide the blocks, as for
    the TPU kernel. A CPU tensor runs :func:`flash_carry_reference`; a CUDA
    tensor launches the carry form of ``csrc/flash_fwd.cu``."""
    sq, d = q.shape[-2:]
    sk = k.shape[-2]
    lead = tuple(q.shape[:-2])
    if (tuple(k.shape) != lead + (sk, d) or v.shape != k.shape
            or tuple(m.shape) != lead + (sq, 1) or l.shape != m.shape
            or acc.shape != q.shape):
        raise ValueError(f"flash_attention_carry: shapes q {tuple(q.shape)},"
                         f" k {tuple(k.shape)}, v {tuple(v.shape)}, m "
                         f"{tuple(m.shape)}, l {tuple(l.shape)}, acc "
                         f"{tuple(acc.shape)} do not fit")
    _check_blocks(sq, sk, block_q, block_k)
    if _on_cpu("flash_attention_carry", q, k, v, m, l, acc):
        return flash_carry_reference(q, k, v, m, l, acc, q_start, k_start,
                                     causal)
    return _flash_carry_cuda(q, k, v, m, l, acc, q_start, k_start, causal)


def _flash_carry_cuda(q, k, v, m, l, acc, q_start, k_start, causal):
    _check_kernel_inputs("flash_carry", q.dtype, q=q, k=k, v=v)
    _check_kernel_inputs("flash_carry", torch.float32, m=m, l=l, acc=acc)
    sq, d = q.shape[-2:]
    q3, k3, v3 = (t.reshape(-1, t.shape[-2], d) for t in (q, k, v))
    _check_mha_kernel_shape("flash_carry", q3, k3)
    if q.dtype == torch.bfloat16:
        _check_tma("flash_carry", q=q3, k=k3, v=v3)
    m_out, l_out, acc_out = (torch.empty_like(t) for t in (m, l, acc))
    fn = _bind("flash_fwd", "brpc_flash_carry",
               [_ptr] * 9 + [_i32] * 8 + [_i64] * 6 + [_ptr])
    rc = _call(fn, q, q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
               m.data_ptr(), l.data_ptr(), acc.data_ptr(), m_out.data_ptr(),
               l_out.data_ptr(), acc_out.data_ptr(), q3.shape[0], sq,
               k3.shape[1], d, _DTYPES[q.dtype], int(causal), int(q_start),
               int(k_start), *(x for t in (q3, k3, v3)
                               for x in (t.stride(0), t.stride(1))))
    _raise_on(rc, "flash_fwd", "flash_carry")
    launches.add("flash_carry")
    return m_out, l_out, acc_out


# ---------------------------------------------------------------------------
# Training: fused softmax cross-entropy
# ---------------------------------------------------------------------------
def _xent_rows_reference(logits, targets):
    """Plain per-row NLL in fp32: logsumexp(x) - x[t], with x[t] taken as 0
    for a target outside [0, V), as the TPU kernel's masked sum gives."""
    x = logits.float()
    v = x.shape[-1]
    t = targets.long()
    picked = torch.gather(x, 1, t.clamp(0, v - 1)[:, None])[:, 0]
    picked = torch.where((t >= 0) & (t < v), picked, torch.zeros_like(picked))
    return torch.logsumexp(x, dim=-1) - picked


def softmax_xent_reference(logits, targets):
    """Mean negative log-likelihood; logits [N, V], targets [N] int."""
    return _xent_rows_reference(logits, targets).mean()


def _xent_forward_rows(logits, targets, block_rows: int = 256):
    """Per-row NLL [N] fp32 of logits [N, V] (fp32 or bf16) and targets [N]
    (int32 or int64). Any N: the TPU wrapper pads rows to ``block_rows``
    and slices the padding off; here each row is independent, so the block
    is validated only. A CPU tensor runs the plain version; a CUDA tensor
    launches ``csrc/xent.cu``."""
    if logits.dim() != 2 or tuple(targets.shape) != (logits.shape[0],):
        raise ValueError(f"softmax_xent takes logits [N, V] and targets "
                         f"[N], got {tuple(logits.shape)}, "
                         f"{tuple(targets.shape)}")
    if block_rows < 1:
        raise ValueError(f"block_rows {block_rows} < 1")
    if _on_cpu("softmax_xent", logits, targets):
        return _xent_rows_reference(logits, targets)
    return _xent_cuda(logits, targets)


# csrc/xent.cu's brpc_xent: logits, targets, nll; n, v, dtype, target bits;
# the stream
_XENT_ARGTYPES = [_ptr, _ptr, _ptr, _i64, _i32, _i32, _i32, _ptr]


def _xent_cuda(logits, targets):
    """One launch of csrc/xent.cu: the C function bound once by
    :func:`_bind`, launched through :func:`_call`; every check runs before
    the launch."""
    n, v = logits.shape
    _check_kernel_inputs("softmax_xent", logits.dtype, logits=logits)
    if targets.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"softmax_xent: targets are {targets.dtype}, want "
                        f"int32 or int64")
    if v == 0 or n >= 2 ** 31:
        raise ValueError(f"softmax_xent kernel: logits {tuple(logits.shape)}")
    targets = targets.contiguous()
    nll = torch.empty(n, dtype=torch.float32, device=logits.device)
    if n:
        fn = _bind("xent", "brpc_xent", _XENT_ARGTYPES)
        rc = _call(fn, logits, logits.data_ptr(), targets.data_ptr(),
                   nll.data_ptr(), n, v, _DTYPES[logits.dtype],
                   targets.element_size() * 8)
        if rc:
            _raise_on(rc, "xent", "softmax_xent")
        launches.add("softmax_xent")
    return nll


class _SoftmaxXent(torch.autograd.Function):
    """Mean NLL: the kernel forward; the plain backward (softmax - onehot)
    * g / N in the logits' dtype, which the JAX package leaves to XLA."""

    @staticmethod
    def forward(ctx, logits, targets, block_rows):
        ctx.save_for_backward(logits, targets)
        return _xent_forward_rows(logits, targets, block_rows).mean()

    @staticmethod
    def backward(ctx, g):
        logits, targets = ctx.saved_tensors
        n, v = logits.shape
        p = torch.softmax(logits.float(), dim=-1)
        # p - onehot(t) in place; a target outside [0, V) subtracts nothing,
        # as jax.nn.one_hot gives a zero row for it
        hit = ((targets >= 0) & (targets < v)).float()
        p.scatter_add_(1, targets.long().clamp(0, v - 1)[:, None],
                       -hit[:, None])
        return p.mul_(g).div_(n).to(logits.dtype), None, None


def softmax_xent(logits, targets, block_rows: int = 256):
    """Fused mean cross-entropy; logits [N, V], targets [N] int.
    Differentiable, so it drops into training losses; N == 0 gives 0.0."""
    if logits.shape[0] == 0:
        return logits.float().sum() * 0.0  # 0.0, with a zero gradient
    return _SoftmaxXent.apply(logits, targets, block_rows)
