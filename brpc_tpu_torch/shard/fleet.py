"""Fleet var aggregation — worker metrics merged into the parent's /vars.

With the shard plane on, the Python lane runs in N worker processes, each with its own
metrics registry: the parent's /vars told only the parent's share of the
truth. This module closes that gap over the existing stats lane:

- **worker side** — :func:`worker_snapshot` walks the worker's exposed
  numeric variables into a flat JSON blob ``{name: [op, ptype, value]}``,
  shipped as a ``W_VARS`` record once per ``shard_vars_interval_s``. The
  merge op is derived from what the variable *is* (Adder counters sum,
  ``*_max*`` maxes, window averages weight by qps), so the parent never
  guesses.
- **parent side** — :class:`FleetVars` keeps the latest snapshot per worker
  and exposes two var families: namespaced ``worker<i>_<name>`` mirrors
  (opted out of series retention — high-cardinality by construction) and
  op-correct ``fleet_<name>`` aggregates merged across workers only, so
  ``fleet_x == sum(worker<i>_x)`` holds exactly for Adder-backed counters.
  Fleet vars carry a Prometheus ``# HELP`` naming the merge, and
  ``fleet_shard_workers`` says how many workers the aggregate covers.

The merge semantics themselves (op derivation, op arithmetic, the snapshot
walk) live in :mod:`brpc_tpu_torch.fleet.merge` since the fleet observer merges
the same way across *servers*; this module keeps the parent-side store and
the historical names.

Payloads are UTF-8 JSON of flat scalars — flat bytes over the ring, no
pickle, same as W_STATS.
"""

from __future__ import annotations

import threading
from typing import Dict, List

from brpc_tpu_torch.fleet.merge import (  # noqa: F401  (re-exported names)
    OP_AVG,
    OP_MAX,
    OP_MIN,
    OP_SUM,
    OP_WAVG_QPS,
    MergedVar as _FleetVar,
    merge_op as _merge_op,
    merge_values,
    qps_weight_name,
    worker_snapshot,
)
from brpc_tpu_torch.metrics.status import PassiveStatus


class FleetVars:
    """Parent-side store + /vars exposure of worker snapshots."""

    def __init__(self):
        self._lock = threading.Lock()
        # worker index -> {name: (op, ptype, value)}
        self._snaps: Dict[int, Dict[str, tuple]] = {}
        self._vars: Dict[str, PassiveStatus] = {}
        self._count_var = _FleetVar(
            lambda: len(self._snaps), "gauge",
            "shard workers currently reporting W_VARS snapshots")
        self._count_var.expose("fleet_shard_workers")

    # ------------------------------------------------------------ ingest
    def on_snapshot(self, index: int, payload: bytes) -> None:
        try:
            import json
            doc = json.loads(payload.decode())
            snap = {str(name): (str(rec[0]), str(rec[1]), rec[2])
                    for name, rec in doc["vars"].items()
                    if isinstance(rec, list) and len(rec) == 3
                    and isinstance(rec[2], (int, float))}
        except Exception:
            return
        with self._lock:
            self._snaps[index] = snap
        self._ensure_exposed(index, snap)

    def _ensure_exposed(self, index: int, snap: Dict[str, tuple]) -> None:
        for name, (op, ptype, _value) in snap.items():
            wname = f"worker{index}_{name}"
            if wname not in self._vars:
                self._vars[wname] = _FleetVar(
                    self._worker_reader(index, name), ptype,
                    opt_out=True).expose(wname)
            fname = f"fleet_{name}"
            if fname not in self._vars:
                self._vars[fname] = _FleetVar(
                    self._fleet_reader(name), ptype,
                    help_text=f"{op} of {name} over reporting shard "
                              f"workers (W_VARS merge)").expose(fname)

    # ------------------------------------------------------------ readers
    def _worker_reader(self, index: int, name: str):
        def read():
            with self._lock:
                rec = self._snaps.get(index, {}).get(name)
            return rec[2] if rec is not None else 0
        return read

    def _fleet_reader(self, name: str):
        def read():
            with self._lock:
                recs = [(i, s[name]) for i, s in self._snaps.items()
                        if name in s]
                if not recs:
                    return 0
                op = recs[0][1][0]
                values = [rec[2] for _, rec in recs]
                if op == OP_WAVG_QPS:
                    wname = qps_weight_name(name)
                    weights = [self._snaps[i].get(wname, (0, 0, 0))[2]
                               for i, _ in recs]
                else:
                    weights = None
            return merge_values(op, values, weights)
        return read

    # ------------------------------------------------------------- views
    def workers_reporting(self) -> int:
        with self._lock:
            return len(self._snaps)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._vars)

    def hide_all(self) -> None:
        self._count_var.hide()
        for var in self._vars.values():
            var.hide()
        self._vars.clear()
        with self._lock:
            self._snaps.clear()
