"""MultiDimension — labeled metric families (reference bvar/multi_dimension.h).

One exposed name fans out into per-label-combination sub-metrics, created
on first touch and enumerable for dumps:

    errs = MultiDimension(Adder, ["method", "status"]).expose("rpc_errors")
    errs.stats(["Echo", "ok"]).put(1)

Prometheus exposition renders each combination as a labeled sample
(reference builtin/prometheus_metrics_service.cpp renders MultiDimension
the same way):

    rpc_errors{method="Echo",status="ok"} 1
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

from brpc_tpu_torch.metrics.variable import Variable


class MultiDimension(Variable):
    def __init__(self, arg1=None, arg2=None):
        """Accepted forms (both argument orders are unambiguous because a
        factory is callable and label names are a sequence of strings):

            MultiDimension(Adder, ["method", "status"])   # canonical
            MultiDimension(["method", "status"], Adder)
            MultiDimension(("method", "status"))          # Status default
        """
        super().__init__()
        if callable(arg1) and not isinstance(arg1, (list, tuple)):
            factory, label_names = arg1, arg2
        elif isinstance(arg1, (list, tuple)):
            label_names, factory = arg1, arg2
            if factory is not None and not callable(factory):
                raise TypeError(f"factory must be callable, got {factory!r}")
        else:
            raise TypeError(
                "MultiDimension wants (factory, label_names) or "
                f"(label_names[, factory]); got {arg1!r}, {arg2!r}")
        if factory is None:
            from brpc_tpu_torch.metrics.status import Status

            factory = lambda: Status(0)  # noqa: E731
        if not label_names:
            raise ValueError("MultiDimension needs at least one label")
        self._factory = factory
        self.label_names: Tuple[str, ...] = tuple(label_names)
        self._stats: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    # ----------------------------------------------------------- sub-metrics
    def _key(self, label_values: Sequence[str]) -> Tuple[str, ...]:
        if len(label_values) != len(self.label_names):
            raise ValueError(
                f"expected {len(self.label_names)} label values "
                f"{self.label_names}, got {list(label_values)!r}")
        return tuple(str(v) for v in label_values)

    def stats(self, label_values: Sequence[str]):
        """The sub-metric for this label combination (created on demand —
        reference get_stats/LevelStats)."""
        key = self._key(label_values)
        with self._lock:
            m = self._stats.get(key)
            if m is None:
                m = self._stats[key] = self._factory()
            return m

    # reference bvar get_stats spelling
    get_stats = stats

    def has_stats(self, label_values: Sequence[str]) -> bool:
        with self._lock:
            return self._key(label_values) in self._stats

    def delete_stats(self, label_values: Sequence[str]) -> None:
        with self._lock:
            self._stats.pop(self._key(label_values), None)

    def count_stats(self) -> int:
        with self._lock:
            return len(self._stats)

    def list_stats(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._stats.items())

    # -------------------------------------------------------------- Variable
    def get_value(self):
        return self.count_stats()

    def describe(self) -> str:
        parts = []
        for key, m in self.list_stats():
            labels = ",".join(f'{n}={v}' for n, v in
                              zip(self.label_names, key))
            val = m.get_value() if hasattr(m, "get_value") else m
            parts.append(f"{{{labels}}}: {val}")
        return "; ".join(parts) or "(empty)"

    def prometheus_samples(self) -> List[Tuple[Dict[str, str], float]]:
        """(labels, numeric value) per combination; non-numeric sub-metrics
        are skipped (prometheus only carries numbers)."""
        out = []
        for key, m in self.list_stats():
            try:
                val = float(m.get_value() if hasattr(m, "get_value") else m)
            except (TypeError, ValueError):
                continue
            out.append((dict(zip(self.label_names, key)), val))
        return out
