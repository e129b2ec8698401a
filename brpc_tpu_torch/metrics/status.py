"""Status / PassiveStatus / prometheus exposition.

Rebuilds bvar's gauge family: Status (set-once-read-many gauge,
``bvar/status.h``), PassiveStatus (callback-backed gauge,
``passive_status.h:42``), MultiDimension (labeled metrics,
``multi_dimension.h``), and the Prometheus text format exporter
(``builtin/prometheus_metrics_service.cpp:224``).
"""

from __future__ import annotations

from typing import Callable

from brpc_tpu_torch.metrics.variable import Variable


class Status(Variable):
    """A plain settable gauge."""

    def __init__(self, value=0):
        super().__init__()
        self._value = value

    def set_value(self, value) -> None:
        self._value = value

    def get_value(self):
        return self._value


class PassiveStatus(Variable):
    """Gauge computed by a callback at read time."""

    def __init__(self, fn: Callable[[], object]):
        super().__init__()
        self._fn = fn

    def get_value(self):
        return self._fn()


def _escape_label(v: str) -> str:
    # exposition format: backslash, quote, newline must be escaped
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _escape_help(v: str) -> str:
    # HELP lines escape backslash and newline only (exposition format)
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def prometheus_text() -> str:
    """Render every exposed variable in Prometheus exposition format.
    MultiDimension families render one labeled sample per combination
    (reference builtin/prometheus_metrics_service.cpp)."""
    from brpc_tpu_torch.metrics.variable import exposed_variables

    lines = []
    for name, var in exposed_variables():
        metric = name.replace(".", "_").replace("-", "_")
        mtype = getattr(var, "prometheus_type", "gauge")
        help_text = getattr(var, "prometheus_help", None)
        samples = getattr(var, "prometheus_samples", None)
        if samples is not None:
            rendered = False
            for labels, num in samples():
                if not rendered:
                    if help_text:
                        lines.append(f"# HELP {metric} "
                                     f"{_escape_help(help_text)}")
                    lines.append(f"# TYPE {metric} {mtype}")
                    rendered = True
                lbl = ",".join(
                    f'{k}="{_escape_label(v)}"'
                    for k, v in sorted(labels.items()))
                lines.append(f"{metric}{{{lbl}}} {num:g}")
            continue
        try:
            num = float(var.describe())
        except (TypeError, ValueError):
            continue  # prometheus only carries numeric samples
        if help_text:
            lines.append(f"# HELP {metric} {_escape_help(help_text)}")
        lines.append(f"# TYPE {metric} {mtype}")
        lines.append(f"{metric} {num:g}")
    return "\n".join(lines) + ("\n" if lines else "")
