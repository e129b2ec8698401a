"""metrics — bvar equivalent: contention-free instrumentation (SURVEY §2.3)."""

from brpc_tpu_torch.metrics.variable import (
    Variable,
    describe_exposed,
    get_exposed,
    list_exposed,
    dump_exposed,
    clear_registry,
)
from brpc_tpu_torch.metrics.reducer import Reducer, Adder, Maxer, Miner
from brpc_tpu_torch.metrics.percentile import Percentile, PercentileSamples
from brpc_tpu_torch.metrics.sampler import Sampler, SamplerCollector, global_collector
from brpc_tpu_torch.metrics.window import Window, PerSecond, WindowedPercentile
from brpc_tpu_torch.metrics.latency_recorder import IntRecorder, LatencyRecorder
from brpc_tpu_torch.metrics.status import (
    Status,
    PassiveStatus,
    prometheus_text,
)
from brpc_tpu_torch.metrics.series import (
    VarSeries,
    SeriesRegistry,
    global_series,
    ensure_series_installed,
)
from brpc_tpu_torch.metrics.watch import (
    WatchRule,
    WatchRegistry,
    global_watch,
    ensure_watch_hooked,
    install_default_rules,
)

__all__ = [
    "Variable",
    "describe_exposed",
    "get_exposed",
    "list_exposed",
    "dump_exposed",
    "clear_registry",
    "Reducer",
    "Adder",
    "Maxer",
    "Miner",
    "Percentile",
    "PercentileSamples",
    "Sampler",
    "SamplerCollector",
    "global_collector",
    "Window",
    "PerSecond",
    "WindowedPercentile",
    "IntRecorder",
    "LatencyRecorder",
    "Status",
    "PassiveStatus",
    "MultiDimension",
    "prometheus_text",
    "VarSeries",
    "SeriesRegistry",
    "global_series",
    "ensure_series_installed",
    "WatchRule",
    "WatchRegistry",
    "global_watch",
    "ensure_watch_hooked",
    "install_default_rules",
]
from brpc_tpu_torch.metrics.multi_dimension import MultiDimension  # noqa: E402,F401
