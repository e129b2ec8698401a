"""How a training cell's ``correct`` is decided.

The numbers compare the program's first steps with the plain reference's
(:mod:`benchmark.reference`), each against a limit of the cell
(``benchmark/workloads/<cell>.json``), and the run is correct when none
passes its limit:

- ``loss_gap_<k>``: the gap of step k's loss, |program - reference| /
  |reference|, for each step compared. Step 1 sees the same weights on
  both sides; later steps start from states that have drifted apart by
  rounding, so each step has a limit of its own.
- ``grad_gap``: by the worst parameter, the gap between the norm of the
  program's first gradient, as SGD applied it (its change after one step
  over lr), and the reference's, over the larger of the reference's norm
  of that parameter and of the median parameter.
- ``change_gap``: the same for the change after the last step compared.
- ``update_gap``: by the worst parameter, the norm of the difference
  between the program's state after one step and the reference's, over
  the larger of the reference's change in that step of that parameter and
  of the median parameter. The two norm gaps above move with the square
  of a random error in the gradient; this moves with the error itself, so
  it tells the configuration's precision from the next one down.

Parameters whose true first gradient in the reference is under a
thousandth of the median parameter's are left out of the two norms:
round-off alone moves them. So are, in each of the two norm gaps,
parameters of which the reference moved fewer than ``FEW`` elements by
that step: such a change is a few whole ulps, and one element rounded
the other way by the gradient's own error moves its norm by a share of
1/(2n) for n moved elements, more than a sound run's whole gap (a final
RMSNorm weight of 1.0, whose ulp passes most of its updates, moves 0 to
52 elements in a step). ``update_gap`` compares them element by element.
"""

from __future__ import annotations

import math
import statistics

NEGLIGIBLE = 1e-3
FEW = 1000


def counted(ref: dict) -> list:
    """The parameters the norms compare."""
    med = statistics.median(ref["true_grad"].values())
    return [k for k, g in ref["true_grad"].items() if g >= NEGLIGIBLE * med]


def normed(ref: dict, moved: str) -> list:
    """The parameters a norm gap compares: those :func:`counted`, of
    which the reference moved at least FEW elements (``moved`` names the
    reading: ``first_moved`` for the first step, ``moved`` for the
    last)."""
    return [k for k in counted(ref) if ref[moved][k] >= FEW]


def _worst_gap(mine: dict, ref: dict, keys) -> float:
    """The worst parameter's norm gap over ``keys``; 0 with none."""
    if not keys:
        return 0.0
    med = statistics.median(ref[k] for k in keys)
    worst = 0.0
    for k in keys:
        gap = abs(mine[k] - ref[k]) / max(ref[k], med)
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def _update_gap(mine: dict, ref: dict, keys, device) -> float:
    """The worst parameter's ||program's state - reference's state||
    after one step, over the larger of the reference's change in that
    step (lr x ``first_grad``) and the median parameter's."""
    med = statistics.median(ref["first_grad"][k] for k in keys)
    worst = 0.0
    for k in keys:
        a = mine["first_state"][k].to(device).float()
        b = ref["first_state"][k].to(device).float()
        gap = float((a - b).norm()) / (ref["lr"] * max(ref["first_grad"][k],
                                                       med))
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def compare(mine: dict, ref: dict, device="cpu") -> dict:
    """{number: value} for the program's readings against the
    reference's, both as :func:`benchmark.reference.readings` gives
    them; states are compared on ``device``."""
    keys = counted(ref)
    out = {f"loss_gap_{k}": (abs(a - b) / abs(b) if math.isfinite(a)
                             else math.inf)
           for k, (a, b) in enumerate(zip(mine["losses"], ref["losses"]),
                                      start=1)}
    out["grad_gap"] = _worst_gap(mine["first_grad"], ref["first_grad"],
                                 normed(ref, "first_moved"))
    out["change_gap"] = _worst_gap(mine["change"], ref["change"],
                                   normed(ref, "moved"))
    out["update_gap"] = _update_gap(mine, ref, keys, device)
    return out


def leaves(mine: dict, ref: dict) -> dict:
    """For the record and not compared: each counted parameter's
    [program's first gradient norm, reference's, program's change norm,
    reference's, reference's true first gradient norm, how many of its
    elements the reference moved in the first step, and by the last]."""
    return {k: [mine["first_grad"][k], ref["first_grad"][k],
                mine["change"][k], ref["change"][k], ref["true_grad"][k],
                ref["first_moved"][k], ref["moved"][k]]
            for k in counted(ref)}


def _ordered(t):
    """A float tensor's values as integers in the order of the values,
    so that neighbouring representable values differ by 1."""
    import torch

    kind = {2: torch.int16, 4: torch.int32}[t.element_size()]
    bits = t.view(kind).long()
    low = (1 << (8 * t.element_size() - 1)) - 1
    return torch.where(bits < 0, -(bits & low), bits)


def census(mine: dict, ref: dict, initial: dict, device="cpu") -> dict:
    """Where the states after one step differ, for the record and not
    compared: over the parameters the norms compare, the share of
    elements the reference moved (``moved``), of those the share it moved
    by one ulp (``moved_one_ulp``), the share where the program's state
    differs from the reference's (``differ``) and of those the share one
    ulp apart (``differ_one_ulp``); and for the parameter that sets
    ``update_gap`` the same, its gap, and the share of its squared
    difference that one-ulp elements carry (``one_ulp_sq_share``)."""
    keys = counted(ref)
    med = statistics.median(ref["first_grad"][k] for k in keys)
    total = {"n": 0, "moved": 0, "moved_one_ulp": 0, "differ": 0,
             "differ_one_ulp": 0}
    worst = None
    for k in keys:
        a = mine["first_state"][k].to(device)
        b = ref["first_state"][k].to(device)
        i = initial[k].to(device=device, dtype=b.dtype)
        oa, ob, oi = _ordered(a), _ordered(b), _ordered(i)
        moved, differ = ob != oi, oa != ob
        one = (oa - ob).abs() == 1
        leaf = {"n": b.numel(), "moved": int(moved.sum()),
                "moved_one_ulp": int(((ob - oi).abs() == 1).sum()),
                "differ": int(differ.sum()), "differ_one_ulp": int(one.sum())}
        for name in total:
            total[name] += leaf[name]
        diff = a.float() - b.float()
        sq = float(diff.square().sum())
        gap = math.sqrt(sq) / (ref["lr"] * max(ref["first_grad"][k], med))
        if worst is None or gap > worst["update_gap"]:
            worst = dict(_shares(leaf), leaf=k, update_gap=gap,
                         one_ulp_sq_share=float(diff[one].square().sum())
                         / sq if sq else None)
    return dict(_shares(total), worst=worst)


def _shares(counts: dict) -> dict:
    n, moved, differ = counts["n"], counts["moved"], counts["differ"]
    return {"moved": moved / n,
            "moved_one_ulp": counts["moved_one_ulp"] / moved if moved
            else None,
            "differ": differ / n,
            "differ_one_ulp": counts["differ_one_ulp"] / differ if differ
            else None}


def verdict(numbers: dict, limits: dict) -> bool:
    """True when every number the cell's limits name is within its limit
    (NaN is not). A number a cell has no limit for is not compared."""
    return all(numbers[n] <= limit for n, limit in limits.items())


def report(numbers: dict, limits: dict) -> dict:
    """{number: {"value", "limit"}} for the numbers compared; a value that
    is not finite reads None."""
    return {n: {"value": numbers[n] if math.isfinite(numbers[n]) else None,
                "limit": limit} for n, limit in limits.items()}
