"""The check's verdict: a sound run passes each cell's limits, and the fp8
control and each fault planted under the timed path fail them. On the
CPU at a tiny size, through the whole of a run but the look for a card;
on the card (``-m card``) at the cells' widths and traffic with two
layers."""

import pytest
import torch

from benchmark import check, faults
from benchmark.drivers import train as drv
from benchmark.registry import Registry

CELLS = [w["name"] for w in Registry().spec["workloads"]]
TINY = {"vocab": 512, "d_model": 64, "n_heads": 2, "n_layers": 2,
        "d_ff": 256, "max_seq": 64, "dtype": "bfloat16",
        "use_flash_attention": True, "use_pallas_norm": True,
        "use_fused_xent": True}
SEED = 2 ** 31 + 11


def _cell(name):
    reg = Registry()
    w = reg.workload(name)
    return reg.config(w["config"]), reg.traffic(w["traffic"]), \
        reg.limits(name)


def _tiny(name):
    config, traffic, limits = _cell(name)
    traffic = dict(traffic, batch=2, seq=64, warm_steps=1)
    return {"model_config": TINY}, traffic, limits


def _run(name, fault=None):
    config, traffic, limits = _tiny(name)
    args = (config, traffic, limits, SEED, 0.2, False, 0.0,
            torch.device("cpu"))
    if fault is None:
        return drv.run(*args)
    with faults.planted(fault):
        return drv.run(*args)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["check"]
    assert out["attempted"] >= 10 and out["failed"] == 0
    assert list(out["check"]) == list(_cell(cell)[2]["limits"])


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault):
    out = _run(cell, fault)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_fp8_control_is_not_correct(cell):
    config, traffic, limits = _tiny(cell)
    m = drv.model_fields(config)
    ref = drv.reference_readings(m, traffic, SEED, "cpu")
    ctl = drv.reference_readings(m, traffic, SEED, "cpu", quant="fp8")
    assert not check.verdict(check.compare(ctl, ref), limits["limits"])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_sound_passes_and_control_and_faults_fail(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    config, traffic, limits = _cell(cell)
    m = dict(drv.model_fields(config), n_layers=2)
    dev = torch.device("cuda", 0)
    ref = drv.reference_readings(m, traffic, SEED, dev)

    def program():
        model, weights = drv.build(m, SEED, dev)
        mine = drv.checked_steps(model, weights,
                                 drv.Batches(m, traffic, SEED, dev), traffic)
        del model, weights
        drv.free()
        return check.compare(mine, ref, dev)

    sound = program()
    assert check.verdict(sound, limits["limits"]), sound
    ctl = check.compare(drv.reference_readings(m, traffic, SEED, dev,
                                               quant="fp8"), ref, dev)
    assert not check.verdict(ctl, limits["limits"]), ctl
    for fault in faults.FAULTS:
        with faults.planted(fault):
            broken = program()
        assert not check.verdict(broken, limits["limits"]), (fault, broken)


def test_the_census_counts_one_ulp_differences():
    bf = torch.bfloat16
    up1, dn2 = 2.0 ** -7, 2.0 ** -8       # bf16 ulps above 1 and 0.5
    initial = torch.tensor([1.0, 1.0, 0.5, -0.5], dtype=bf)
    ref_state = torch.tensor([1.0 + up1, 1.0, 0.5, -0.5 - dn2], dtype=bf)
    mine_state = torch.tensor([1.0 + up1, 1.0 + up1, 0.5, -0.5 - 3 * dn2],
                              dtype=bf)
    ref = {"true_grad": {"a": 1.0}, "first_grad": {"a": 0.01}, "lr": 1.0,
           "first_state": {"a": ref_state}}
    got = check.census({"first_state": {"a": mine_state}}, ref,
                       {"a": initial})
    assert got["moved"] == 0.5 and got["moved_one_ulp"] == 1.0
    assert got["differ"] == 0.5 and got["differ_one_ulp"] == 0.5
    worst = got["worst"]
    assert worst["leaf"] == "a" and worst["one_ulp_sq_share"] == 0.5
    assert worst["update_gap"] == pytest.approx(2 ** 0.5 * up1 / 0.01)
    keys = check._ordered(torch.tensor([-1.0, -0.0, 0.0, 2.0 ** -133],
                                       dtype=bf))
    assert keys.tolist() == [-16256, 0, 0, 1]


def _norm_readings(flipped: float, matrix: float) -> tuple:
    """(program's, reference's) readings of three matrices and a norm
    weight of which the reference moved 4 elements by one ulp: the
    program moves 3 of them when ``flipped`` and puts ``matrix`` on the
    first matrix's norms."""
    ulp = 2.0 ** -8
    ref = {"true_grad": {"w1": 1.0, "w2": 1.0, "wo": 1.0, "ln_f": 0.02},
           "first_grad": {"w1": 0.1, "w2": 0.1, "wo": 0.1,
                          "ln_f": 4 ** 0.5 * ulp},
           "first_moved": {"w1": 10 ** 6, "w2": 10 ** 6, "wo": 10 ** 6,
                           "ln_f": 4},
           "moved": {"w1": 10 ** 6, "w2": 10 ** 6, "wo": 10 ** 6,
                     "ln_f": 4}}
    ref["change"] = dict(ref["first_grad"])
    mine = {k: dict(ref[k]) for k in ("first_grad", "change")}
    for kind in mine.values():
        kind["ln_f"] = (3 if flipped else 4) ** 0.5 * ulp
        kind["w1"] *= matrix
    return mine, ref


@pytest.mark.parametrize("number,moved", [("first_grad", "first_moved"),
                                          ("change", "moved")])
def test_a_norm_gap_skips_a_leaf_of_a_few_moved_elements(number, moved):
    mine, ref = _norm_readings(flipped=True, matrix=1.0)
    assert check._worst_gap(mine[number], ref[number],
                            check.counted(ref)) > 0.01
    keys = check.normed(ref, moved)
    assert keys == ["w1", "w2", "wo"]
    assert check._worst_gap(mine[number], ref[number], keys) == 0.0
    mine, ref = _norm_readings(flipped=True, matrix=1.02)
    assert check._worst_gap(mine[number], ref[number], keys) == \
        pytest.approx(0.02)
