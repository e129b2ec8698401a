"""The Python side of the port's tensor-core attention kernels
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``, ``csrc/hopper.cuh``).

The kernels themselves run only on the card (``chip_smoke.py`` holds them
to their plain versions there). On the CPU these tests hold what the
wrappers send to the C entry points, with the launch itself replaced by a
recorder: the dtype code, head dim, shapes, offsets and strides; that a
bf16 request TMA cannot take is refused with ValueError before any launch
and never falls back to the plain version; that fp32 keeps its path; that
a CPU tensor still counts no launch. Plus the bf16 plain versions against
the JAX kernels at the new kernels' tile edges, the build's kept
``-Xptxas -v`` logs and ``chip_smoke.py``'s reading of them.

Tolerance of the bf16 parity: both sides take bf16 inputs and compute in
fp32, rounding P to bf16 before P V and o to bf16 at the end; the sums run
in another order, so a bf16 output may land one rounding step (2^-8 of
|o| <= ~4) apart: atol 2e-2 on o, 1e-4 on the fp32 lse. The same holds
for dq (dS rounded to bf16 before dS k on both sides, dq rounded at the
end): atol 2e-2 x max(1, max |dq|), chip_smoke.py's TOL for bf16.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from brpc_tpu.tpu import pallas_ops as jax_ops
from brpc_tpu_torch.tpu import _build
from brpc_tpu_torch.tpu import pallas_ops as torch_ops

HEAD_DIMS = (32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _randn(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dtype)


@pytest.fixture
def recorder(monkeypatch):
    """Replaces the launch: every C call is recorded as (symbol, args) and
    returns 0; a fresh counter keeps the module's own untouched."""
    calls = []
    monkeypatch.setattr(torch_ops, "launches", torch_ops.LaunchCounts())
    monkeypatch.setattr(torch_ops, "_bind",
                        lambda source, symbol, argtypes: symbol)
    monkeypatch.setattr(torch_ops, "_call",
                        lambda fn, t, *args: calls.append((fn, args)) or 0)
    return calls


@pytest.fixture
def no_plain(monkeypatch):
    """Any plain version reached on the kernel path fails the test."""
    def refuse(*a, **k):
        raise AssertionError("the plain version ran on the kernel path")
    for name in ("flash_fwd_reference", "flash_bwd_reference",
                 "flash_carry_reference"):
        monkeypatch.setattr(torch_ops, name, refuse)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=["fp32", "bf16"])
@pytest.mark.parametrize("counter", ["flash_fwd", "flash_fwd_qgrid"])
def test_forward_sends_dtype_head_dim_and_strides(recorder, no_plain, d,
                                                  dtype, counter):
    n, sq, sk = 3, 100, 200
    q = _randn((n, sq, d), dtype)
    k, v = _randn((n, sk, d), dtype, 1), _randn((n, sk, d), dtype, 2)
    o, lse = torch_ops._flash_fwd_cuda(q, k, v, True, counter)
    assert o.dtype == dtype and o.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (n, sq, 1)
    (symbol, args), = recorder
    assert symbol == "brpc_flash_fwd"
    assert args[:5] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), lse.data_ptr())
    assert args[5:11] == (n, sq, sk, d, DTYPES[dtype], 1)
    # (N, row) element strides of q, k, v and o
    assert args[11:] == (sq * d, d, sk * d, d, sk * d, d, sq * d, d)
    assert torch_ops.launches.snapshot()[counter] == 1


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=["fp32", "bf16"])
def test_carry_sends_offsets_head_dim_and_strides(recorder, no_plain, d,
                                                  dtype):
    b, h, s = 2, 3, 64
    q, k, v = (_randn((b, h, s, d), dtype, i) for i in range(3))
    m = torch.full((b, h, s, 1), torch_ops.NEG_INF)
    l, acc = torch.zeros(b, h, s, 1), torch.zeros(b, h, s, d)
    out = torch_ops._flash_carry_cuda(q, k, v, m, l, acc, s, s // 2, True)
    assert [t.shape for t in out] == [m.shape, l.shape, acc.shape]
    (symbol, args), = recorder
    assert symbol == "brpc_flash_carry"
    assert args[:6] == tuple(t.data_ptr() for t in (q, k, v, m, l, acc))
    assert args[6:9] == tuple(t.data_ptr() for t in out)
    assert args[9:17] == (b * h, s, s, d, DTYPES[dtype], 1, s, s // 2)
    assert args[17:] == (s * d, d) * 3
    assert torch_ops.launches.snapshot()["flash_carry"] == 1


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=["fp32", "bf16"])
def test_dkv_sends_offsets_head_dim_and_dtype(recorder, no_plain, d, dtype):
    n, s = 2, 1000
    q, k, v, do = (_randn((n, s, d), dtype, i) for i in range(4))
    lse, delta = torch.zeros(n, s, 1), torch.zeros(n, s, 1)
    dk, dv = torch_ops._flash_bwd_dkv_cuda(q, k, v, lse, do, delta, 0,
                                           s // 2, True)
    assert dk.dtype == dv.dtype == dtype and dk.shape == dv.shape == k.shape
    (symbol, args), = recorder
    assert symbol == "brpc_flash_bwd_dkv"
    assert args[:8] == tuple(t.data_ptr() for t in (q, k, v, do, lse, delta,
                                                    dk, dv))
    assert args[8:] == (n, s, s, d, DTYPES[dtype], 0, s // 2, 1)
    assert torch_ops.launches.snapshot()["flash_bwd_dkv"] == 1


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=["fp32", "bf16"])
def test_dq_sends_offsets_head_dim_and_dtype(recorder, no_plain, d, dtype):
    n, s = 2, 1000
    q, k, v, do = (_randn((n, s, d), dtype, i) for i in range(4))
    lse, delta = torch.zeros(n, s, 1), torch.zeros(n, s, 1)
    dq = torch_ops._flash_bwd_dq_cuda(q, k, v, lse, do, delta, 0, s // 2,
                                      True)
    assert dq.dtype == dtype and dq.shape == q.shape
    (symbol, args), = recorder
    assert symbol == "brpc_flash_bwd_dq"
    assert args[:7] == tuple(t.data_ptr() for t in (q, k, v, do, lse, delta,
                                                    dq))
    assert args[7:] == (n, s, s, d, DTYPES[dtype], 0, s // 2, 1)
    assert torch_ops.launches.snapshot()["flash_bwd_dq"] == 1


def _strided(d, dtype):
    """A [2, 64, d] view whose rows lie d + 4 elements apart."""
    return _randn((2, 64, d + 4), dtype)[..., :d]


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_check_tma_refuses_strides_tma_cannot_take(d):
    x = _strided(d, torch.bfloat16)   # rows (d + 4) * 2 bytes apart
    with pytest.raises(ValueError, match="16 bytes"):
        torch_ops._check_tma("probe", q=x)
    with pytest.raises(ValueError, match="contiguous"):
        torch_ops._check_tma("probe", q=_randn((2, d, 64), torch.bfloat16)
                             .transpose(1, 2))
    torch_ops._check_tma("probe", q=_randn((2, 64, d), torch.bfloat16))
    # an 8-element stride is 16 bytes of bf16: TMA takes it, view or not
    torch_ops._check_tma("probe", q=_randn((2, 64, d + 8),
                                           torch.bfloat16)[..., :d])


def test_check_tma_refuses_rows_past_32_bit_coordinates(monkeypatch):
    monkeypatch.setattr(torch_ops, "_TMA_COORD_MAX", 128)
    torch_ops._check_tma("probe", q=torch.zeros(2, 63, 32,
                                                dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="32-bit"):
        torch_ops._check_tma("probe", q=torch.zeros(2, 64, 32,
                                                    dtype=torch.bfloat16))


@pytest.mark.parametrize("entry", ["fwd", "carry", "dq", "dkv"])
def test_bf16_request_tma_cannot_take_raises_before_any_launch(
        recorder, no_plain, monkeypatch, entry):
    # contiguity is refused first; past it, the TMA check must refuse too
    monkeypatch.setattr(torch_ops, "_check_kernel_inputs",
                        lambda *a, **k: None)
    q = _strided(64, torch.bfloat16)
    k, v, do = (_randn((2, 64, 64), torch.bfloat16, i) for i in range(3))
    with pytest.raises(ValueError, match="TMA"):
        if entry == "fwd":
            torch_ops._flash_fwd_cuda(q, k, v, True)
        elif entry == "carry":
            m, l = torch.zeros(2, 64, 1), torch.zeros(2, 64, 1)
            torch_ops._flash_carry_cuda(q, k, v, m, l, torch.zeros(2, 64, 64),
                                        0, 0, True)
        elif entry == "dq":
            lse = torch.zeros(2, 64, 1)
            torch_ops._flash_bwd_dq_cuda(q, k, v, lse, do, lse, 0, 0, True)
        else:
            lse = torch.zeros(2, 64, 1)
            torch_ops._flash_bwd_dkv_cuda(q, k, v, lse, do, lse, 0, 0, True)
    assert recorder == []
    assert not any(torch_ops.launches.snapshot().values())


@pytest.mark.parametrize("dtype", list(DTYPES), ids=["fp32", "bf16"])
def test_non_contiguous_request_raises_before_any_launch(recorder, no_plain,
                                                         dtype):
    q = _strided(64, dtype)
    k = _randn((2, 64, 64), dtype)
    with pytest.raises(ValueError, match="contiguous"):
        torch_ops._flash_fwd_cuda(q, k, k, True)
    assert recorder == []


@pytest.mark.parametrize("d", [16, 96])
def test_unsupported_head_dim_raises_before_any_launch(recorder, no_plain,
                                                       d):
    q = _randn((2, 64, d), torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        torch_ops._flash_fwd_cuda(q, q, q, True)
    lse = torch.zeros(2, 64, 1)
    with pytest.raises(ValueError, match="head dim"):
        torch_ops._flash_bwd_dq_cuda(q, q, q, lse, q, lse, 0, 0, True)
    with pytest.raises(ValueError, match="head dim"):
        torch_ops._flash_bwd_dkv_cuda(q, q, q, lse, q, lse, 0, 0, True)
    assert recorder == []


def test_fp32_requests_never_take_the_tma_check(recorder, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("fp32 reached the TMA check")
    monkeypatch.setattr(torch_ops, "_check_tma", refuse)
    q = _randn((2, 64, 32), torch.float32)
    lse = torch.zeros(2, 64, 1)
    torch_ops._flash_fwd_cuda(q, q, q, True)
    torch_ops._flash_bwd_dq_cuda(q, q, q, lse, q, lse, 0, 0, True)
    torch_ops._flash_bwd_dkv_cuda(q, q, q, lse, q, lse, 0, 0, True)
    torch_ops._flash_carry_cuda(q, q, q, lse, lse, torch.zeros_like(q), 0, 0,
                                True)
    assert len(recorder) == 4


def test_bf16_cpu_path_never_counts_a_launch(monkeypatch):
    monkeypatch.setattr(torch_ops, "launches", torch_ops.LaunchCounts())
    q, k, v, do = (_randn((2, 100, 32), torch.bfloat16, i) for i in range(4))
    o, lse = torch_ops._flash_fwd_bhsd(q, k, v, True, 100, 100)
    torch_ops._flash_fwd_qgrid(q, k, v, True, 100, 100)
    torch_ops._flash_bwd_bhsd(q, k, v, lse, do, torch_ops._flash_delta(o, do),
                              0, 50, True, 100, 100)
    m = torch.full((2, 100, 1), torch_ops.NEG_INF)
    torch_ops.flash_attention_carry(q, k, v, m, torch.zeros(2, 100, 1),
                                    torch.zeros(2, 100, 32), 0, 0, True,
                                    block_q=100, block_k=100)
    assert not any(torch_ops.launches.snapshot().values())


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("s", [64, 100])
def test_bf16_forward_matches_jax_at_tile_edges(d, s):
    """S = 100 leaves a ragged 100 - 64 row tile and a ragged key tile."""
    q, k, v = (_randn((2, s, d), torch.bfloat16, i) for i in range(3))
    want_o, want_lse = jax_ops._flash_fwd_bhsd(
        *(jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
          for t in (q, k, v)), True, s, s, True)
    o, lse = torch_ops._flash_fwd_bhsd(q, k, v, True, s, s)
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(want_o, dtype=np.float32),
                               atol=2e-2, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("s", [64, 100])
def test_bf16_dq_matches_jax_at_tile_edges(d, s):
    """dq of the bf16 backward at one key tile of 64 and a ragged one (S =
    100: a ragged 64-key tile and fewer query rows than a block), causal,
    with lse and delta from the plain forward."""
    q, k, v, do = (_randn((2, s, d), torch.bfloat16, i) for i in range(4))
    o, lse = torch_ops.flash_fwd_reference(q, k, v, True)
    delta = torch_ops._flash_delta(o, do)
    want = jax_ops._flash_bwd_bhsd(
        *(jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
          for t in (q, k, v)), jnp.asarray(lse.numpy()),
        jnp.asarray(do.float().numpy(), dtype=jnp.bfloat16),
        jnp.asarray(delta.numpy()), 0, 0, True, s, s, True)[0]
    dq = torch_ops._flash_bwd_bhsd(q, k, v, lse, do, delta, 0, 0, True, s,
                                   s)[0]
    want = np.asarray(want, dtype=np.float32)
    assert dq.dtype == torch.bfloat16
    np.testing.assert_allclose(dq.float().numpy(), want,
                               atol=2e-2 * max(1.0, np.abs(want).max()),
                               rtol=0)


def test_build_all_reports_the_logs_of_libraries_built_earlier(
        monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_lib_path",
                        lambda name: str(tmp_path / f"lib{name}.so"))

    def never(*a):
        raise AssertionError("a library built earlier was rebuilt")
    monkeypatch.setattr(_build, "_start", never)
    for name in _build.sources():
        (tmp_path / f"lib{name}.so").write_bytes(b"")
        (tmp_path / f"lib{name}.so.log").write_text(f"ptxas of {name}")
    logs = _build.build_all()
    assert logs == {n: f"ptxas of {n}" for n in _build.sources()}
    assert {"flash_fwd", "flash_bwd"} <= set(logs)


PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116fwd_wgmma_kernelILi128ELb0EEEvv' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116fwd_wgmma_kernelILi128ELb0EEEvv
    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 416 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_dq_kernelILi32EfEEvv' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116flash_dq_kernelILi32EfEEvv
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 416 bytes cmem[0]
"""


def test_chip_smoke_reads_the_tensor_core_kernels_ptxas_report():
    report = chip_smoke.ptxas_report({"flash_fwd": PTXAS.format(spill=0)})
    assert report == {
        "_ZN12_GLOBAL__N_116fwd_wgmma_kernelILi128ELb0EEEvv": {
            "stack": 0, "spill_stores": 0, "spill_loads": 0,
            "registers": 168}}
    with pytest.raises(AssertionError, match="spills"):
        chip_smoke.ptxas_report({"flash_fwd": PTXAS.format(spill=16)})
    with pytest.raises(AssertionError, match="no -Xptxas"):
        chip_smoke.ptxas_report({"flash_fwd": ""})


def _source(name):
    with open(os.path.join(_build.CSRC, name)) as fh:
        return fh.read()


def test_bf16_attention_has_no_fma_kernel_instantiation():
    """bf16 forward, dQ and dK/dV reach only the tensor-core kernels: the
    FMA kernels are instantiated for fp32 alone, and the building blocks
    are wgmma on mbarrier-fed TMA tiles."""
    fwd, bwd = _source("flash_fwd.cu"), _source("flash_bwd.cu")
    assert "flash_fwd_kernel<D, float, kCarry>" in fwd
    assert "flash_dq_kernel<D, float>" in bwd
    assert "flash_dkv_kernel<D, float>" in bwd
    for src, fma in ((fwd, "flash_fwd_kernel<"), (bwd, "flash_dq_kernel<"),
                     (bwd, "flash_dkv_kernel<")):
        for line in src.splitlines():
            if fma in line and "<<<" in line:
                assert "float" in line, line
    assert "__nv_bfloat16>" not in "".join(
        line for line in bwd.splitlines() if "flash_dq_kernel<" in line)
    assert "fwd_wgmma_kernel<D, kCarry>" in fwd
    assert "dq_wgmma_kernel<D>" in bwd
    assert "dkv_wgmma_kernel<D>" in bwd
    hopper = _source("hopper.cuh")
    for op in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait",
               "cuTensorMapEncodeTiled"):
        assert op in hopper
