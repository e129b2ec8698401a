"""The RMSNorm (forward and backward) and cross-entropy wrappers' C
calls, through a stubbed ``pallas_ops._call`` and library loader (no card
here): each binds its C function and argtypes once through ``_bind``'s
cache, then launches through ``_call`` with the pointers, row count,
width and dtype code the kernel takes (the backward also its partials
buffer and block count); every refusal comes before any call.
"""

import ctypes

import numpy as np
import pytest
import torch

from brpc_tpu_torch.tpu import pallas_ops as ops


class _FakeFn:
    """A C function of a fake library: ``_bind`` sets its argtypes."""

    def __init__(self, symbol):
        self.symbol = symbol
        self.argtypes = self.restype = None


@pytest.fixture
def recorder(monkeypatch):
    """Each C call is recorded as (symbol, tensor, args) and returns 0,
    each library load as (source, symbol fetched from it); ``_bind``
    runs as it is, on an empty cache and a fake ``_build.load``, so the
    module's own bound functions and counters stay untouched."""
    calls, binds = [], []

    class FakeLib:
        def __init__(self, source):
            self.source = source

        def __getattr__(self, symbol):
            fn = _FakeFn(symbol)
            if symbol != "brpc_cuda_error_string":
                binds.append((self.source, symbol, fn))
            setattr(self, symbol, fn)
            return fn

    from brpc_tpu_torch.tpu import _build

    monkeypatch.setattr(ops, "launches", ops.LaunchCounts())
    monkeypatch.setattr(ops, "_fns", {})
    monkeypatch.setattr(ops, "_sms", {-1: 132})  # a CPU tensor's device
    monkeypatch.setattr(_build, "load", FakeLib)
    monkeypatch.setattr(ops, "_on_cpu", lambda name, *ts: False)
    monkeypatch.setattr(
        ops, "_call",
        lambda fn, t, *args: calls.append((fn.symbol, t, args)) or 0)
    return calls, binds


def _x(shape, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype)


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0),
                                        (torch.bfloat16, 1)])
def test_rmsnorm_call_is_bound_once(recorder, dtype, code):
    calls, binds = recorder
    x, w = _x((4, 6, 64), dtype), _x((64,), dtype, 1)
    for _ in range(3):
        out = ops._rmsnorm_fwd_call(x, w, eps=1e-5)
        assert out.shape == x.shape and out.dtype == dtype
    assert [(src, sym) for src, sym, _ in binds] == [
        ("rmsnorm", "brpc_rmsnorm")]
    assert binds[0][2].argtypes == ops._RMSNORM_ARGTYPES
    assert ops._RMSNORM_ARGTYPES == [ops._ptr] * 3 + [
        ops._i64, ops._i32, ops._i32, ctypes.c_float, ops._ptr]
    assert len(calls) == 3 and ops.launches["rmsnorm"] == 3
    symbol, t, args = calls[0]
    assert symbol == "brpc_rmsnorm" and t is x  # rows as they lie
    assert args[0] == t.data_ptr() and args[1] == w.data_ptr()
    assert args[3:] == (24, 64, code, 1e-5)


def test_rmsnorm_refuses_before_any_call(recorder):
    calls, binds = recorder
    with pytest.raises(TypeError):
        ops._rmsnorm_fwd_call(_x((4, 64), torch.float16),
                              _x((64,), torch.float16))
    with pytest.raises(ValueError):
        ops._rmsnorm_fwd_call(_x((4, 64)), _x((32,)))
    assert calls == [] and binds == []


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0),
                                        (torch.bfloat16, 1)])
def test_rmsnorm_bwd_call_is_bound_once(recorder, monkeypatch, dtype, code):
    calls, binds = recorder
    made = []
    partials = ops._rmsnorm_bwd_partials
    monkeypatch.setattr(
        ops, "_rmsnorm_bwd_partials",
        lambda *args: made.append(partials(*args)) or made[-1])
    x, w = _x((4, 75, 64), dtype), _x((64,), dtype, 1)
    g = _x((64, 300), dtype, 2).t().reshape(4, 75, 64)  # not contiguous
    for _ in range(3):
        dx, dw = ops._rmsnorm_bwd_call(x, w, g, eps=1e-5)
        assert dx.shape == x.shape and dx.dtype == dtype
        assert dw.shape == (64,) and dw.dtype == dtype
    assert [(src, sym) for src, sym, _ in binds] == [
        ("rmsnorm", "brpc_rmsnorm_bwd")]
    assert binds[0][2].argtypes == ops._RMSNORM_BWD_ARGTYPES
    assert ops._RMSNORM_BWD_ARGTYPES == [ops._ptr] * 6 + [
        ops._i64, ops._i32, ops._i32, ops._i32, ctypes.c_float, ops._ptr]
    assert len(calls) == 3 and ops.launches["rmsnorm_bwd"] == 3
    assert ops.launches["rmsnorm"] == 0
    symbol, t, args = calls[0]
    # 300 rows: ceil(300 / 8) = 38 blocks, under 2 x 132
    assert symbol == "brpc_rmsnorm_bwd" and t is x
    assert made[0].shape == (38, 64) and made[0].dtype == torch.float32
    assert args[0] == t.data_ptr() and args[1] == w.data_ptr()
    assert args[2] != g.data_ptr()  # g was made contiguous
    assert args[5] == made[0].data_ptr()
    assert args[6:] == (300, 64, 38, code, 1e-5)


def test_rmsnorm_bwd_grid_is_capped_by_the_card(recorder):
    calls, _ = recorder
    x = _x((8192, 16), torch.bfloat16)
    ops._rmsnorm_bwd_call(x, _x((16,), torch.bfloat16), x)
    assert calls[0][2][6:9] == (8192, 16, 2 * 132)


def test_rmsnorm_autograd_launches_both_kernels(recorder):
    """A tensor off the CPU runs the forward kernel and, in the backward,
    the backward kernel: never the plain backward."""
    calls, _ = recorder
    x = _x((6, 32)).requires_grad_()
    w = _x((32,), seed=1).requires_grad_()
    ops.rmsnorm(x, w).backward(_x((6, 32), seed=2))
    assert [c[0] for c in calls] == ["brpc_rmsnorm", "brpc_rmsnorm_bwd"]
    assert x.grad.shape == x.shape and w.grad.shape == w.shape


def test_rmsnorm_bwd_refuses_before_any_call(recorder):
    calls, binds = recorder
    x, w = _x((4, 64)), _x((64,), seed=1)
    with pytest.raises(TypeError):  # no fp16 kernel
        ops._rmsnorm_bwd_call(x.half(), w.half(), x.half())
    with pytest.raises(TypeError):  # g in another dtype
        ops._rmsnorm_bwd_call(x, w, x.bfloat16())
    with pytest.raises(ValueError):
        ops._rmsnorm_bwd_call(x, _x((32,)), x)
    with pytest.raises(ValueError):
        ops._rmsnorm_bwd_call(x, w, _x((4, 32)))
    with pytest.raises(ValueError):  # not 16-byte aligned
        off = torch.zeros(4 * 64 + 1)[1:].view(4, 64)
        ops._rmsnorm_bwd_call(off, w, x)
    assert calls == [] and binds == []


def test_rmsnorm_bwd_refuses_several_devices():
    x = torch.zeros(4, 32)
    with pytest.raises(ValueError, match="several devices"):
        ops._rmsnorm_bwd_call(x, torch.zeros(32, device="meta"), x)


@pytest.mark.parametrize("tdtype,bits", [(torch.int32, 32),
                                         (torch.int64, 64)])
def test_xent_call_is_bound_once(recorder, tdtype, bits):
    calls, binds = recorder
    logits = _x((16, 100), torch.bfloat16)
    targets = torch.arange(16, dtype=tdtype)
    for _ in range(2):
        nll = ops._xent_cuda(logits, targets)
        assert nll.shape == (16,) and nll.dtype == torch.float32
    assert [(src, sym) for src, sym, _ in binds] == [("xent", "brpc_xent")]
    assert binds[0][2].argtypes == ops._XENT_ARGTYPES
    assert len(calls) == 2 and ops.launches["softmax_xent"] == 2
    symbol, t, args = calls[0]
    assert symbol == "brpc_xent" and t is logits
    assert args[0] == logits.data_ptr() and args[1] == targets.data_ptr()
    assert args[3:] == (16, 100, 1, bits)


def test_xent_refuses_before_any_call(recorder):
    calls, binds = recorder
    with pytest.raises(TypeError):
        ops._xent_cuda(_x((4, 8)), torch.zeros(4, dtype=torch.float32))
    with pytest.raises(ValueError):
        ops._xent_cuda(_x((4, 0)), torch.zeros(4, dtype=torch.int64))
    assert calls == [] and binds == []
