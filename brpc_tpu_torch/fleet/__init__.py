"""Fleet plane — cross-server observation (the sensing half of fleet ops).

Three parts, layered on the per-process observability stack:

- :mod:`brpc_tpu_torch.fleet.merge` — the op-correct merge semantics (Adder sums
  stay exact, windowed latencies weight by qps, percentiles take the
  conservative max) extracted from the in-process shard aggregation
  (``shard/fleet.py``) so one merge core serves both planes.
- :mod:`brpc_tpu_torch.fleet.observer` — :class:`FleetObserver` scrapes
  ``/vars?series=json`` / ``/serving?format=json`` / ``/watch?format=json``
  from a member set and exposes merged ``cluster_*`` vars + the ``/fleet``
  builtin.
- :mod:`brpc_tpu_torch.fleet.slo` — declarative latency/error objectives over
  the merged series with multi-window burn rates, ``g_slo_*`` vars,
  ``slo_burn`` watch rules and the ``/slo`` builtin.

The port's copy of the JAX package's ``fleet/``: the scraped pages are
the reference's JSON, so an observer of either package merges members of
either package.
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
from brpc_tpu_torch.fleet.observer import (  # noqa: F401
    FleetMember,
    FleetObserver,
    global_observer,
    set_global_observer,
)
from brpc_tpu_torch.fleet.slo import (  # noqa: F401
    SloEngine,
    SloObjective,
    global_slo,
)

__all__ = [
    "OP_AVG", "OP_MAX", "OP_MIN", "OP_SUM", "OP_WAVG_QPS",
    "MergedVar", "merge_op", "merge_values", "qps_weight_name",
    "snapshot_vars",
    "FleetMember", "FleetObserver", "global_observer",
    "set_global_observer",
    "SloEngine", "SloObjective", "global_slo",
]
