"""Window / PerSecond — time-windowed views of reducers (bvar/window.h:174).

A Window(reducer, window_size) shows "the reducer's delta over the last W
seconds"; PerSecond divides by W. Implementation: a Sampler snapshots the
reducer once per second; for invertible ops (Adder) the window value is
``newest - oldest``; for non-invertible ops the sampler stores per-tick
deltas via reset() and the window combines them.
"""

from __future__ import annotations

from typing import Generic, TypeVar

from brpc_tpu_torch.metrics.reducer import Reducer
from brpc_tpu_torch.metrics.sampler import Sampler, global_collector
from brpc_tpu_torch.metrics.percentile import Percentile, PercentileSamples

T = TypeVar("T")


class Window(Generic[T]):
    def __init__(self, reducer: Reducer, window_size: int = 10,
                 collector=None):
        self._reducer = reducer
        self.window_size = max(1, window_size)
        if reducer.has_inverse:
            take = reducer.get_value  # cumulative snapshots
        else:
            take = reducer.reset      # per-tick deltas
        self._sampler = Sampler(take, self.window_size + 1)
        (collector or global_collector()).register(self._sampler)

    def get_value(self) -> T:
        if self._reducer.has_inverse:
            # Cumulative snapshots: window value = now - state W seconds ago.
            # If the series began inside the window, that state is identity.
            samples = self._sampler.recent(self.window_size + 1)
            current = self._reducer.get_value()
            if len(samples) <= self.window_size:
                oldest = self._reducer.identity
            else:
                oldest = samples[0]
            return self._reducer.inverse(current, oldest)
        # non-invertible: combine in-window deltas + live agents in the op's
        # raw domain, clamping only at the end (Maxer/Miner finalize maps
        # their +-inf identity to 0 — combining clamped values would pin
        # windowed min at <=0)
        samples = self._sampler.recent(self.window_size)
        result = self._reducer.get_raw_value()
        for s in samples:
            result = self._reducer._op(result, s)
        return self._reducer.finalize(result)

    def get_span_seconds(self) -> int:
        return min(self._sampler.sample_count(), self.window_size) or 1

    def expose(self, name: str) -> "Window":
        from brpc_tpu_torch.metrics.variable import Variable

        win = self

        class _Wrap(Variable):
            def __init__(w):
                super().__init__()
                # a windowed reading is a point-in-time value: always a
                # gauge, even when the underlying reducer is a monotonic
                # counter (scraping it as a counter would make rate() of
                # an already-rated value)
                w.prometheus_type = "gauge"

            def get_value(w):
                return win.get_value()

        self._var = _Wrap().expose(name)
        return self

    def hide(self) -> None:
        var = getattr(self, "_var", None)
        if var is not None:
            var.hide()


class PerSecond(Window):
    def get_value(self):
        total = super().get_value()
        return total / self.get_span_seconds()


class WindowedPercentile:
    """Percentile over the last W seconds (backs LatencyRecorder p99s)."""

    def __init__(self, percentile: Percentile, window_size: int = 10,
                 collector=None):
        self._p = percentile
        self.window_size = max(1, window_size)
        self._sampler = Sampler(percentile.reset, self.window_size + 1)
        (collector or global_collector()).register(self._sampler)

    def get_value(self) -> PercentileSamples:
        merged = PercentileSamples()
        for s in self._sampler.recent(self.window_size):
            merged.merge(s)
        merged.merge(self._p.get_value())  # not-yet-harvested samples
        return merged

    def get_number(self, ratio: float) -> float:
        return self.get_value().get_number(ratio)
