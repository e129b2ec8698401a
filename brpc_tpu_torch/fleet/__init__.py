"""Fleet plane — cross-server observation.

The port's copy of the JAX package's ``fleet/`` holds its merge core,
:mod:`brpc_tpu_torch.fleet.merge`: the op-correct merge semantics (Adder
sums stay exact, windowed latencies weight by qps, percentiles take the
conservative max), whose ``snapshot_vars`` feeds ``/vars?series=json``.
The observer that scrapes a member set and the SLO engine
(``fleet/observer.py``, ``fleet/slo.py``) wait for ROADMAP Queue 1 item
2(b)10; until then ``/fleet`` and ``/slo`` answer an error naming it.
"""

from brpc_tpu_torch.fleet.merge import (  # noqa: F401
    OP_AVG,
    OP_MAX,
    OP_MIN,
    OP_SUM,
    OP_WAVG_QPS,
    MergedVar,
    merge_op,
    merge_values,
    qps_weight_name,
    snapshot_vars,
)

__all__ = [
    "OP_AVG", "OP_MAX", "OP_MIN", "OP_SUM", "OP_WAVG_QPS",
    "MergedVar", "merge_op", "merge_values", "qps_weight_name",
    "snapshot_vars",
]
