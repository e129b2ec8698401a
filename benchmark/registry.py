"""Where the benchmark finds its parts, by the names ``BENCHMARK.json``
gives them.

- a configuration ``<name>``: ``benchmark/configs/<name>.json``
- a traffic mix ``<name>``: ``benchmark/traffic/<name>.json``, read by
  the driver its ``kind`` names, ``benchmark/drivers/<kind>.py``
- a cell ``<name>``: its entry in ``BENCHMARK.json`` and the limits of its
  correctness check, with the readings they were set from,
  ``benchmark/workloads/<name>.json``
- a per-layer metric ``<name>``: ``benchmark/metrics/<name>.py``, whose
  ``read(ctx)`` returns the value or None

A new configuration, traffic mix, cell or metric is a new file and an
entry in ``BENCHMARK.json``; no file that is there changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Registry:
    """The benchmark as one checkout holds it: ``root`` is the checkout's
    root, where ``BENCHMARK.json`` lies, and ``folder`` the harness's
    folder under it."""

    def __init__(self, root: str = ROOT, folder: str = HERE):
        self.root, self.folder = root, folder
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            self.spec = json.load(fh)

    def _json(self, kind: str, name: str) -> dict:
        path = os.path.join(self.folder, kind, name + ".json")
        if not os.path.exists(path):
            raise KeyError(f"no {kind[:-1]} {name!r}: {path} is missing")
        with open(path) as fh:
            return json.load(fh)

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> dict:
        return self._json("workloads", cell)

    def driver(self, kind: str):
        """The module that runs traffic of ``kind``."""
        return importlib.import_module(f"{__package__}.drivers.{kind}")

    def metric_reader(self, name: str):
        """``metrics/<name>.py`` as a module."""
        path = os.path.join(self.folder, "metrics", name + ".py")
        if not os.path.exists(path):
            raise KeyError(f"no reader for metric {name!r}: {path}")
        spec = importlib.util.spec_from_file_location(
            f"{__package__}.metrics.{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def end_to_end(self, cell: str) -> list:
        """The end-to-end metrics the cell reports: those whose
        ``workloads`` lists it, and those without a list."""
        self.workload(cell)
        return [m for m in self.spec["end_to_end"]
                if _listed(m, cell, True)]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics the cell reports: those whose
        ``workloads`` lists it, and those without a list that move an
        end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if _listed(m, cell, m["moves"] in e2e)]


def _listed(metric: dict, cell: str, default: bool) -> bool:
    """Whether ``metric``'s ``workloads`` names ``cell``; ``default``
    when the metric has no such list."""
    return cell in metric["workloads"] if "workloads" in metric \
        else default
