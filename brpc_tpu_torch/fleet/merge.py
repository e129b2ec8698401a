"""Op-correct variable merge core, shared by shard workers and the fleet.

The JAX package proved these semantics in-process (``shard/fleet.py``
merging worker snapshots into the parent's /vars); its fleet observer
reuses the same core across *servers* so ``cluster_x == sum(member_x)``
holds exactly for
Adder-backed counters, windowed latency means stay qps-weighted, and
percentiles degrade to the conservative max instead of a fake average.

The unit of exchange is the flat snapshot ``{name: [op, ptype, value]}``:
the side that owns the variable derives the merge op from what the variable
*is*, so no consumer ever guesses.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Sequence

from brpc_tpu_torch.metrics.status import PassiveStatus
from brpc_tpu_torch.metrics.variable import exposed_variables

# merge ops carried in snapshots
OP_SUM = "sum"
OP_MAX = "max"
OP_MIN = "min"
OP_AVG = "avg"
OP_WAVG_QPS = "wavg_qps"   # qps-weighted mean (windowed latency averages)


def merge_op(name: str, var) -> str:
    """Pick the cross-process merge op for one variable."""
    if getattr(var, "prometheus_type", "gauge") == "counter":
        return OP_SUM
    if name.endswith(("_qps", "_count", "_second", "_errors", "_error")):
        return OP_SUM
    if "_latency_p" in name:
        # per-process percentiles don't compose exactly; max is the
        # conservative fleet upper bound (documented in docs/observability)
        return OP_MAX
    tokens = name.split("_")
    if "max" in tokens:        # max_latency et al, before the _latency check
        return OP_MAX
    if "min" in tokens:
        return OP_MIN
    if name.endswith("_latency"):
        return OP_WAVG_QPS
    return OP_AVG


def qps_weight_name(name: str) -> str:
    """The sibling qps var used to weight a ``*_latency`` window average."""
    return name[: -len("_latency")] + "_qps"


def merge_values(op: str, values: Sequence[float],
                 weights: Optional[Sequence[float]] = None) -> float:
    """Merge already-collected member values under one op.

    ``weights`` applies only to ``OP_WAVG_QPS`` (qps of each member); when
    missing or all-zero the merge falls back to the plain mean.
    """
    if not values:
        return 0.0
    if op == OP_SUM:
        return sum(values)
    if op == OP_MAX:
        return max(values)
    if op == OP_MIN:
        return min(values)
    if op == OP_WAVG_QPS and weights is not None and sum(weights) > 0:
        total = sum(weights)
        return sum(v * w for v, w in zip(values, weights)) / total
    return sum(values) / len(values)


def snapshot_vars(skip_prefixes: Sequence[str] = ()) -> Dict[str, list]:
    """Flat ``{name: [op, ptype, value]}`` of every exposed numeric var.

    ``skip_prefixes`` drops derived families (e.g. a scraper skips
    ``cluster_*`` so an observer scraping an observer never feeds its own
    aggregates back into the merge).
    """
    out: Dict[str, list] = {}
    for name, var in exposed_variables():
        if skip_prefixes and name.startswith(tuple(skip_prefixes)):
            continue
        try:
            value = var.get_value()
        except Exception:
            continue
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            continue
        ptype = getattr(var, "prometheus_type", "gauge")
        out[name] = [merge_op(name, var), ptype, value]
    return out


def worker_snapshot(index: int) -> bytes:
    """The W_VARS payload shipped by shard workers over the stats lane."""
    return json.dumps({"index": index, "vars": snapshot_vars()}).encode()


class MergedVar(PassiveStatus):
    """PassiveStatus with exposition metadata slots (type + HELP) and a
    series opt-out knob — plain attrs read by prometheus_text and the
    series sweep."""

    def __init__(self, fn, ptype: str = "gauge", help_text: str = "",
                 opt_out: bool = False):
        super().__init__(fn)
        self.prometheus_type = ptype
        if help_text:
            self.prometheus_help = help_text
        if opt_out:
            self.series_opt_out = True
