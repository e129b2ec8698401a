"""The benchmark's FLOP and byte counts against hand-worked values for
both cells, and the interval arithmetic."""

import json
import os

import pytest

from benchmark import yardstick

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as fh:
        return json.load(fh)["model_config"]


# pythia-1.4b at 2 x 8192: 24 x (3 + 1 + 2 x 4) x 2048^2 + 2048 x 50304
# matrix-product parameters; per layer 2 B H S (S + 1) D causal FLOPs with
# n = B H S = 262144 rows of 128; pythia-6.9b-l16 at 8 x 2048 likewise.
CASES = {
    "pythia-1.4b": dict(
        batch=2, seq=8192, matmul_params=1_310_982_144,
        attn=549_822_922_752, step=168_462_039_121_920,
        fwd=(24 * 549_822_922_752, 6_467_616_768),
        bwd=(48 * 549_822_922_752, 11_324_620_800),
        rms=16_442_273_792, xent=3_296_919_552),
    "pythia-6.9b-l16": dict(
        batch=8, seq=2048, matmul_params=3_427_794_944,
        attn=275_012_124_672, step=350_166_536_159_232,
        fwd=(16 * 275_012_124_672, 8_623_489_024),
        bwd=(32 * 275_012_124_672, 15_099_494_400),
        rms=22_146_736_128, xent=3_305_308_160),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_counts_equal_hand_worked_values(name):
    m, c = _model(name), CASES[name]
    b, s = c["batch"], c["seq"]
    assert yardstick.matmul_params(m) == c["matmul_params"]
    heads = m["n_heads"]
    assert yardstick.attention_flops(b, heads, s, 128) == c["attn"]
    assert yardstick.attention_bwd_flops(b, heads, s, 128) == 2 * c["attn"]
    assert yardstick.step_flops(m, b, s) == c["step"]
    assert yardstick.step_flops(m, b, s) == (
        6 * c["matmul_params"] * b * s + 3 * m["n_layers"] * c["attn"])
    assert yardstick.flash_fwd_work(m, b, s) == c["fwd"]
    assert yardstick.flash_bwd_work(m, b, s) == c["bwd"]
    assert yardstick.rmsnorm_work(m, b, s) == (0.0, c["rms"])
    assert yardstick.xent_work(m, b, s) == (0.0, c["xent"])


def test_attention_counts_causal_pairs_and_the_full_square():
    # 1 x 1 x 4 x 2: causal 10 pairs x 2 products x 2 FLOPs x 2 dims
    assert yardstick.attention_flops(1, 1, 4, 2, causal=True) == 80
    assert yardstick.attention_flops(1, 1, 4, 2, causal=False) == 128


def test_roofline_share_takes_the_larger_bound():
    # 989 TFLOP in 2 s: the compute bound of 1 s is half the time
    assert yardstick.roofline_share(989e12, 1.0, 2.0) == (50.0, "flops")
    share, bound = yardstick.roofline_share(0.0, 3.35e12, 4.0)
    assert bound == "bytes" and share == pytest.approx(25.0)


def test_merged_busy_counts_overlap_once():
    assert yardstick.merged_busy([(0, 2), (1, 3), (5, 6), (5.5, 5.75)]) == 4
    assert yardstick.merged_busy([]) == 0


def test_idle_gaps_inside_the_window():
    spans = [(1, 2), (1.5, 3), (5, 6)]
    assert yardstick.idle_gaps(spans, 0, 8) == [(0, 1), (3, 5), (6, 8)]
    assert yardstick.idle_gaps([(0, 10)], 1, 9) == []


def test_kernel_names_match_whole_symbols():
    name = ("void (anonymous namespace)::dq_wgmma_kernel<128>"
            "(CUtensorMap_st, CUtensorMap_st)")
    assert yardstick.is_kernel_of(name, yardstick.FLASH_BWD_KERNELS)
    assert not yardstick.is_kernel_of(name, yardstick.FLASH_FWD_KERNELS)
    assert yardstick.is_kernel_of("void xent_kernel<float, long>(float*)",
                                  yardstick.XENT_KERNELS)
    assert not yardstick.is_kernel_of("my_xent_kernel2",
                                      yardstick.XENT_KERNELS)
    assert yardstick.is_matmul("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NTT")
    assert yardstick.is_matmul("sm90_xmma_gemm_bf16bf16_bf16f32")
    assert not yardstick.is_matmul(
        "void at::native::vectorized_elementwise_kernel<8>")
