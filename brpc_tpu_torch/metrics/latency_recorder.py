"""LatencyRecorder — the latency/qps/max/percentile bundle.

Rebuild of ``bvar/latency_recorder.h:49-126``: one ``record(us)`` feeds (a) an
IntRecorder for windowed average latency, (b) a Percentile for p50..p99.99,
(c) a Maxer for max latency, (d) an Adder counted per second for qps. Every
RPC method/socket owns one; /status renders them.
"""

from __future__ import annotations

from brpc_tpu_torch.metrics.reducer import Adder, Maxer, Reducer
from brpc_tpu_torch.metrics.window import PerSecond, Window, WindowedPercentile
from brpc_tpu_torch.metrics.percentile import Percentile
from brpc_tpu_torch.metrics.variable import Variable


class IntRecorder(Reducer):
    """(sum, count) pair reducer — windowed average (bvar/recorder.h:98)."""

    def __init__(self):
        super().__init__(
            (0, 0),
            lambda a, b: (a[0] + b[0], a[1] + b[1]),
            lambda a, b: (a[0] - b[0], a[1] - b[1]),
        )

    def record(self, value: float) -> None:
        self.put((value, 1))

    def average(self) -> float:
        s, c = self.get_value()
        return s / c if c else 0.0


class LatencyRecorder:
    def __init__(self, window_size: int = 10, collector=None):
        import threading as _threading

        self._recorder = IntRecorder()
        self._percentile = Percentile()
        self._maxer = Maxer()
        self._count = Adder()
        self._fused_tls = _threading.local()
        self.window_size = window_size
        self._win_recorder = Window(self._recorder, window_size, collector)
        self._win_percentile = WindowedPercentile(
            self._percentile, window_size, collector
        )
        self._win_max = Window(self._maxer, window_size, collector)
        self._qps = PerSecond(self._count, window_size, collector)

    # ------------------------------------------------------------ write side
    def record(self, latency_us: float) -> "LatencyRecorder":
        # fused fast path: one TLS lookup, direct agent mutation (at 100k+
        # records/s the four dispatch+lambda rounds of the naive version
        # are measurable wall clock on the shared core); read side is the
        # component reducers', untouched
        tls = self._fused_tls
        f = getattr(tls, "agents", None)
        if f is None:
            f = (self._recorder._agent(), self._percentile._reservoir(),
                 self._maxer._agent(), self._count._agent())
            tls.agents = f
        ra, res, ma, ca = f
        s, c = ra.value
        ra.value = (s + latency_us, c + 1)
        res.add(latency_us)
        if latency_us > ma.value:
            ma.value = latency_us
        ca.value += 1
        return self

    __lshift__ = record

    # ------------------------------------------------------------- read side
    def latency(self) -> float:
        """Windowed average latency (us)."""
        s, c = self._win_recorder.get_value()
        return s / c if c else 0.0

    def latency_percentile(self, ratio: float) -> float:
        return self._win_percentile.get_number(ratio)

    def max_latency(self) -> float:
        return self._win_max.get_value()

    def qps(self) -> float:
        return self._qps.get_value()

    def count(self) -> int:
        return self._count.get_value()

    def describe(self) -> str:
        return (
            f"avg={self.latency():.1f}us qps={self.qps():.1f} "
            f"p50={self.latency_percentile(0.5):.0f} "
            f"p90={self.latency_percentile(0.9):.0f} "
            f"p99={self.latency_percentile(0.99):.0f} "
            f"p999={self.latency_percentile(0.999):.0f} "
            f"max={self.max_latency():.0f}"
        )

    def expose(self, prefix: str) -> "LatencyRecorder":
        rec = self

        class _V(Variable):
            def __init__(self, fn):
                super().__init__()
                self._fn = fn

            def get_value(self):
                return self._fn()

        self._vars = [
            _V(rec.latency).expose(f"{prefix}_latency"),
            _V(rec.qps).expose(f"{prefix}_qps"),
            _V(rec.count).expose(f"{prefix}_count"),
            _V(rec.max_latency).expose(f"{prefix}_max_latency"),
            _V(lambda: rec.latency_percentile(0.5)).expose(f"{prefix}_latency_p50"),
            _V(lambda: rec.latency_percentile(0.9)).expose(f"{prefix}_latency_p90"),
            _V(lambda: rec.latency_percentile(0.99)).expose(f"{prefix}_latency_p99"),
            _V(lambda: rec.latency_percentile(0.999)).expose(f"{prefix}_latency_p999"),
        ]
        # the count var is monotonically increasing; the rest are gauges
        self._vars[2].prometheus_type = "counter"
        return self
