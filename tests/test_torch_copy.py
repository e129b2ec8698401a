"""Port copies (brpc_tpu_torch.tpu.bench_kernels) against the JAX
package's Pallas copy kernels, run in interpret mode.

On the CPU every copy is its plain version (``hbm_copy_reference``, or
a plain ``copy_`` into a given tensor); ``chip_smoke.py`` holds the CUDA
kernel of ``csrc/copy.cu`` to the same plain version on the card, bit for
bit. Tolerance 0: a copy is exact, so outputs are compared as bytes.

The JAX copies are compared only at shapes where they are defined: 1-D
up to one 2^20-element block, rows up to 512 or a multiple of 512. Past
that the JAX grids leave a tail unwritten (ROADMAP Queue 3), which the
last tests show.

The kernel moves the aligned body of a copy on Hopper's bulk asynchronous
copies through a ring of shared-memory stages, one contiguous span per
block; lengths at its stages' and spans' edges (``chip_smoke``'s
``copy_edge_lengths``) are held here on the plain path and on the card by
``chip_smoke.py``.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from brpc_tpu.tpu import bench_kernels as jax_bk
from brpc_tpu.tpu import device_lane as jax_dl
from brpc_tpu_torch.tpu import _build
from brpc_tpu_torch.tpu import bench_kernels as bk
from brpc_tpu_torch.tpu import pallas_ops

H100_SMS = 132  # the card chip_smoke.py runs on

DTYPES = {"uint8": (np.uint8, jnp.uint8, torch.uint8),
          "int32": (np.int32, jnp.int32, torch.int32),
          "bfloat16": (np.uint16, jnp.bfloat16, torch.bfloat16)}


def _pair(shape, dtype, seed):
    """The same random bytes as a JAX array and a torch tensor (bf16 from
    random 16-bit patterns, NaNs included)."""
    np_t, jax_t, torch_t = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 256, size=int(np.prod(shape)) *
                        np.dtype(np_t).itemsize, dtype=np.uint8)
    host = bits.view(np_t).reshape(shape)
    x_j = jnp.asarray(host)
    if dtype == "bfloat16":
        x_j = x_j.view(jnp.bfloat16)
    x_t = torch.from_numpy(host.copy()).view(torch_t)
    return x_j, x_t


def _bytes(a) -> bytes:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().tobytes()
    return np.asarray(a).tobytes()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", [1, 1000, 4096, 1 << 20])
def test_hbm_copy_matches_jax(n, dtype):
    x_j, x_t = _pair((n,), dtype, seed=n)
    want = jax_bk.hbm_copy(x_j, interpret=True)
    got = bk.hbm_copy(x_t)
    assert got.dtype == x_t.dtype and got.shape == (n,)
    assert got.data_ptr() != x_t.data_ptr()
    assert _bytes(got) == _bytes(want) == _bytes(x_t)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("nbytes", [chip_smoke.COPY_STAGE_BYTES - 16,
                                    chip_smoke.COPY_STAGE_BYTES + 16],
                         ids=["stage-16", "stage+16"])
def test_hbm_copy_at_a_stage_edge_matches_jax(nbytes, dtype):
    n = nbytes // np.dtype(DTYPES[dtype][0]).itemsize
    x_j, x_t = _pair((n,), dtype, seed=nbytes)
    want = jax_bk.hbm_copy(x_j, interpret=True)
    assert _bytes(bk.hbm_copy(x_t)) == _bytes(want) == _bytes(x_t)


@pytest.mark.parametrize("src_off,dst_off", [(0, 0), (1, 1), (8, 0)])
@pytest.mark.parametrize("n", chip_smoke.copy_edge_lengths(H100_SMS))
def test_copy_bytes_across_the_kernels_spans_leaves_the_rest_alone(
        n, src_off, dst_off):
    rng = np.random.default_rng(n + src_off)
    src = torch.from_numpy(rng.integers(0, 256, n + 16, dtype=np.uint8))
    dst = torch.full((n + 16,), 0xA5, dtype=torch.uint8)
    bk.copy_bytes(src[src_off:src_off + n], dst[dst_off:dst_off + n])
    assert torch.equal(dst[dst_off:dst_off + n], src[src_off:src_off + n])
    assert bool((dst[:dst_off] == 0xA5).all())
    assert bool((dst[dst_off + n:] == 0xA5).all())


def test_copy_kernel_moves_its_body_on_bulk_async_copies():
    """copy.cu's body goes through cp.async.bulk loads on mbarriers and
    bulk stores freed by wait_group.read, and chip_smoke.py's edge lengths
    follow the kernel's own stage size, ring depth and blocks per SM."""
    def source(name):
        with open(os.path.join(_build.CSRC, name)) as fh:
            return fh.read()
    copy, hopper = source("copy.cu"), source("hopper.cuh")
    assert '#include "hopper.cuh"' in copy
    for call in ("bulk_load(", "bulk_store(", "bulk_wait_read<1>()",
                 "mbar_wait("):
        assert call in copy
    for op in ("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes", "cp.async.bulk.global.shared::cta.bulk_group",
               "cp.async.bulk.wait_group.read"):
        assert op in hopper

    def const(name):
        m = re.search(rf"constexpr int {name} = (\d+)( << 10)?;", copy)
        return int(m.group(1)) << (10 if m.group(2) else 0)
    assert (const("kStageBytes"), const("kStages"),
            const("kBlocksPerSM")) == (chip_smoke.COPY_STAGE_BYTES,
                                       chip_smoke.COPY_STAGES,
                                       chip_smoke.COPY_BLOCKS_PER_SM)


@pytest.mark.parametrize("shape,dtype", [
    ((1, 2048), "int32"), ((16, 2048), "int32"), ((512, 128), "int32"),
    ((1024, 128), "int32"), ((8, 256), "bfloat16"), ((48, 64), "uint8")])
def test_hbm_copy2d_matches_jax(shape, dtype):
    x_j, x_t = _pair(shape, dtype, seed=shape[0])
    want = jax_bk.hbm_copy2d(x_j, interpret=True)
    got = bk.hbm_copy2d(x_t)
    assert got.shape == shape and got.dtype == x_t.dtype
    assert _bytes(got) == _bytes(want) == _bytes(x_t)


@pytest.mark.parametrize("rounds", [0, 1, 3])
def test_echo_loop_matches_jax(rounds):
    x_j, x_t = _pair((16, 256), "int32", seed=rounds)
    want = jax_bk.echo_loop(x_j, rounds=rounds, interpret=True)
    got = bk.echo_loop(x_t, rounds=rounds)
    assert _bytes(got) == _bytes(want) == _bytes(x_t)


@pytest.mark.parametrize("rounds", [1, 2, 5])
@pytest.mark.parametrize("shape", [(1, 2048), (16, 2048), (512, 64)])
def test_echo_loop_probe_matches_jax(shape, rounds):
    x_j, x_t = _pair(shape, "int32", seed=7)
    want = jax_bk.echo_loop_probe(x_j, rounds=rounds, interpret=True)
    got = bk.echo_loop_probe(x_t, rounds)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(want)


def test_echo_loop_probe_int32_sum_wraps_as_in_jax():
    big = np.full((4, 2048), 2 ** 31 - 1, dtype=np.int32)
    want = jax_bk.echo_loop_probe(jnp.asarray(big), rounds=2, interpret=True)
    got = bk.echo_loop_probe(torch.from_numpy(big), 2)
    assert int(got) == int(want) == -2


def test_echo_loop_probe_refuses_non_2d_like_jax():
    x = np.arange(4096, dtype=np.int32)
    with pytest.raises(ValueError, match="2-D"):
        jax_bk.echo_loop_probe(jnp.asarray(x), rounds=1, interpret=True)
    with pytest.raises(ValueError, match="2-D"):
        bk.echo_loop_probe(torch.from_numpy(x), 1)


def test_copies_refuse_the_wrong_rank_like_jax():
    x2 = np.zeros((8, 128), dtype=np.int32)
    with pytest.raises(ValueError):
        jax_bk.hbm_copy(jnp.asarray(x2), interpret=True)
    with pytest.raises(ValueError):
        bk.hbm_copy(torch.from_numpy(x2))
    x1 = np.zeros(128, dtype=np.int32)
    with pytest.raises(ValueError):
        jax_bk.hbm_copy2d(jnp.asarray(x1), interpret=True)
    with pytest.raises(ValueError):
        bk.hbm_copy2d(torch.from_numpy(x1))


def test_echo_loop_never_writes_its_input():
    _, x = _pair((16, 512), "int32", seed=3)
    before = x.clone()
    out = bk.echo_loop(x, rounds=3)
    assert torch.equal(x, before) and torch.equal(out, before)
    assert out.data_ptr() != x.data_ptr()


@pytest.mark.parametrize("k", [1, 4, 32])
def test_hbm_copy_batched_matches_the_jax_store_batch(k):
    """The port's batched copy against the JAX dispatcher's k-copy program
    (DeviceStore._batched_copy_fn, x + uint8(0) per array) on the same
    arrays. Integer types only: the JAX program adds, which would
    canonicalise float NaNs and -0.0."""
    rng = np.random.default_rng(k)
    hosts = [rng.integers(-2 ** 31, 2 ** 31 - 1, size=n, dtype=np.int32)
             for n in rng.integers(1, 5000, size=k)]
    hosts[0] = hosts[0].view(np.uint8)  # dtypes and shapes may mix
    if k > 1:
        hosts[1] = hosts[1][:len(hosts[1]) // 8 * 8].reshape(-1, 8)
    want = jax_dl.DeviceStore()._batched_copy_fn(k)(
        *(jnp.asarray(h) for h in hosts))
    xs = [torch.from_numpy(h.copy()) for h in hosts]
    outs = bk.hbm_copy_batched(xs)
    assert len(outs) == len(want) == k
    for x, o, w in zip(xs, outs, want):
        assert o.dtype == x.dtype and o.shape == x.shape == w.shape
        assert o.data_ptr() != x.data_ptr()
        assert _bytes(o) == _bytes(w) == _bytes(bk.hbm_copy_reference(x))


@pytest.mark.parametrize("k", [0, 33])
def test_hbm_copy_batched_refuses_more_than_a_launch_takes(k):
    with pytest.raises(ValueError, match="1..32"):
        bk.hbm_copy_batched([torch.zeros(4)] * k)


@pytest.mark.parametrize("src_off,dst_off", [(0, 0), (1, 3), (3, 1), (8, 0)])
def test_copy_bytes_at_offsets_leaves_the_rest_alone(src_off, dst_off):
    n = 1000
    rng = np.random.default_rng(src_off * 16 + dst_off)
    src = torch.from_numpy(rng.integers(0, 256, n + 16, dtype=np.uint8))
    dst = torch.full((n + 16,), 0xA5, dtype=torch.uint8)
    bk.copy_bytes(src[src_off:src_off + n], dst[dst_off:dst_off + n])
    assert torch.equal(dst[dst_off:dst_off + n], src[src_off:src_off + n])
    assert bool((dst[:dst_off] == 0xA5).all())
    assert bool((dst[dst_off + n:] == 0xA5).all())


def test_copy_bytes_refuses_mismatched_or_strided_tensors():
    with pytest.raises(ValueError, match="bytes"):
        bk.copy_bytes(torch.zeros(4, dtype=torch.int32),
                      torch.zeros(15, dtype=torch.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        bk.hbm_copy(torch.zeros(8)[::2])


def test_a_tensor_off_cpu_and_cuda_never_takes_the_plain_path():
    x = torch.empty(16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        bk.hbm_copy(x)
    with pytest.raises(ValueError, match="cuda or cpu"):
        bk.hbm_copy_batched([x])


def test_cpu_copies_count_no_launch():
    before = pallas_ops.launches.snapshot()
    bk.hbm_copy(torch.arange(10))
    bk.echo_loop_probe(torch.zeros(2, 2048, dtype=torch.int32), 3)
    bk.hbm_copy_batched([torch.arange(3)] * 4)
    after = pallas_ops.launches.snapshot()
    assert after["hbm_copy"] == before["hbm_copy"]
    assert after["hbm_copy_batched"] == before["hbm_copy_batched"]


# ---------------------------------------------------------------------------
# The reference fault (ROADMAP Queue 3): the JAX grids stop at a whole
# number of blocks and leave the tail of the output unwritten; the port
# copies every byte
# ---------------------------------------------------------------------------
def test_hbm_copy2d_600_rows_port_whole_jax_tail_unwritten():
    x = np.arange(1, 600 * 128 + 1, dtype=np.int32).reshape(600, 128)
    got = bk.hbm_copy2d(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_bk.hbm_copy2d(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(want[:512], x[:512])
    assert not np.array_equal(want[512:], x[512:])


def test_hbm_copy_past_one_block_port_whole_jax_tail_unwritten():
    n = (1 << 20) + 4096
    x = np.arange(1, n + 1, dtype=np.int32)
    got = bk.hbm_copy(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_bk.hbm_copy(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(want[:1 << 20], x[:1 << 20])
    assert not np.array_equal(want[1 << 20:], x[1 << 20:])


def test_copy_designs_patch_the_kernels_own_source():
    """brpc_tpu_torch/bench/copy_designs.py times variants of copy.cu made
    by patching it: each patch must find what it replaces, so the designs
    it reports are the kernel with one decision changed."""
    from brpc_tpu_torch.bench import copy_designs as cd
    with open(os.path.join(_build.CSRC, "copy.cu")) as fh:
        base = fh.read()
    srcs = cd.designs(None)
    assert srcs["this"] == base and "parent" not in srcs
    assert cd.CONTIGUOUS_OFF in srcs["contiguous"]
    assert cd.ROUND_ROBIN_OFF not in srcs["contiguous"]
    assert srcs["contiguous"].replace(cd.CONTIGUOUS, cd.ROUND_ROBIN).replace(
        cd.CONTIGUOUS_OFF, cd.ROUND_ROBIN_OFF) == base
    for stages, kib, per_sm in cd.CONSTANTS:
        src = srcs[f"s{stages}_k{kib}_b{per_sm}"]
        assert f"kStages = {stages};" in src
        assert f"kStageBytes = {kib} << 10;" in src
        assert f"kBlocksPerSM = {per_sm};" in src
    with pytest.raises(ValueError, match="round-robin"):
        cd.contiguous("no deal here")
    with pytest.raises(ValueError, match="kStages"):
        cd.with_constants("", 4, 16, 2)
