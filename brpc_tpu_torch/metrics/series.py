"""Multi-tier series rings — the bvar ``detail::SeriesSampler`` analog.

Every exposed numeric Variable grows a fixed-size time series: 60 one-second
samples, 60 one-minute samples and 24 one-hour samples (the reference keeps a
fourth 30-day tier; a Python process rarely lives that long, so we stop at
hours). Rings are identity-filled (0) before the first real sample, exactly
like the reference, so renderers never need a "no data" special case.

Rollups are **append-count based**, not wall-clock based: every 60 appends to
the second ring reduce into one minute sample; every 60 minute samples reduce
into one hour sample. The once-per-second sampler daemon
(:mod:`brpc_tpu_torch.metrics.sampler`) provides the 1 Hz cadence in production,
while tests drive ``tick()`` manually and get exact, clock-free rollups.

The sweep itself (`SeriesRegistry.tick`) is one O(vars) pass appending one
value per var — gated by the reloadable ``var_series_enabled`` flag, with
per-var opt-out for high-cardinality names (``var_series_optout`` glob list,
a ``series_opt_out`` attribute on the Variable, or ``opt_out()``).
"""

from __future__ import annotations

import fnmatch
import threading
import time
from typing import Callable, Dict, List, Optional

from brpc_tpu_torch import flags
from brpc_tpu_torch.metrics.sampler import Sampler, SamplerCollector, global_collector
from brpc_tpu_torch.metrics.variable import exposed_variables

SECOND_SAMPLES = 60
MINUTE_SAMPLES = 60
HOUR_SAMPLES = 24

# How a tier-N window collapses into one tier-N+1 sample. "avg" suits gauges
# and qps-style rates (the common case); vars carrying a ``series_reduce``
# attribute pick another op (e.g. Maxer-backed vars want "max").
_REDUCERS = {
    "avg": lambda xs: sum(xs) / len(xs),
    "max": max,
    "min": min,
    "sum": sum,
    "last": lambda xs: xs[-1],
}

flags.define(
    "var_series_enabled", True,
    "retain a 60x1s/60x1m/24x1h series ring for every exposed numeric "
    "variable, appended by the sampler daemon tick", reloadable=True)
flags.define(
    "var_series_optout", "",
    "comma-separated name globs excluded from series retention "
    "(high-cardinality families, e.g. 'worker*_*')", reloadable=True)


class _Ring:
    """Fixed-size ring, identity(0)-prefilled, oldest-first on read."""

    __slots__ = ("data", "pos")

    def __init__(self, capacity: int):
        self.data = [0] * capacity
        self.pos = 0  # next write slot

    def append(self, value) -> None:
        self.data[self.pos] = value
        self.pos = (self.pos + 1) % len(self.data)

    def ordered(self) -> list:
        return self.data[self.pos:] + self.data[: self.pos]


class VarSeries:
    """The three-tier ring attached to one variable."""

    __slots__ = ("second", "minute", "hour", "reduce_op", "is_float",
                 "count", "last", "_pending_minutes")

    def __init__(self, reduce_op: str = "avg"):
        self.second = _Ring(SECOND_SAMPLES)
        self.minute = _Ring(MINUTE_SAMPLES)
        self.hour = _Ring(HOUR_SAMPLES)
        self.reduce_op = reduce_op if reduce_op in _REDUCERS else "avg"
        self.is_float = False
        self.count = 0       # real samples appended (not identity fill)
        self.last = 0
        # minute samples accumulated since the last hour rollup; kept as a
        # plain list (not read off the ring) so the hour sample reduces over
        # exactly the minutes that produced it, even across ring wrap
        self._pending_minutes: List[float] = []

    def append(self, value) -> None:
        if isinstance(value, float):
            self.is_float = True
        self.last = value
        self.second.append(value)
        self.count += 1
        if self.count % SECOND_SAMPLES == 0:
            reduce_fn = _REDUCERS[self.reduce_op]
            minute = self._coerce(reduce_fn(self.second.ordered()))
            self.minute.append(minute)
            self._pending_minutes.append(minute)
            if len(self._pending_minutes) == MINUTE_SAMPLES:
                self.hour.append(self._coerce(reduce_fn(self._pending_minutes)))
                self._pending_minutes = []

    def _coerce(self, value):
        """Integer-aware rollup: int series stay int (floor the mean) so
        '/vars' plots of counters don't sprout decimals."""
        if not self.is_float and isinstance(value, float):
            return int(value)
        return value

    def to_dict(self) -> dict:
        return {
            "second": self.second.ordered(),
            "minute": self.minute.ordered(),
            "hour": self.hour.ordered(),
            "count": self.count,
            "last": self.last,
            "reduce": self.reduce_op,
            "float": self.is_float,
        }


class SeriesRegistry:
    """Sweeps the exposed-variable registry once per tick, appending one
    sample per numeric var. One of these hangs off the global sampler
    collector; tests build private instances and tick them directly."""

    def __init__(self):
        self._series: Dict[str, VarSeries] = {}
        self._lock = threading.Lock()
        self._optout: set = set()          # programmatic opt-outs (exact names)
        self._optout_globs: tuple = ()     # programmatic opt-outs (patterns)
        self.post_tick_hooks: List[Callable[["SeriesRegistry"], None]] = []
        self.ticks = 0
        self.last_tick_s = 0.0
        self.total_tick_s = 0.0

    # ------------------------------------------------------------- opt-out
    def opt_out(self, pattern: str) -> None:
        """Exclude a name (or glob) from series retention and drop any
        series already accumulated for it."""
        with self._lock:
            if any(ch in pattern for ch in "*?["):
                self._optout_globs += (pattern,)
                for name in [n for n in self._series
                             if fnmatch.fnmatchcase(n, pattern)]:
                    del self._series[name]
            else:
                self._optout.add(pattern)
                self._series.pop(pattern, None)

    def _opted_out(self, name: str, var) -> bool:
        if getattr(var, "series_opt_out", False):
            return True
        if name in self._optout:
            return True
        for pat in self._optout_globs:
            if fnmatch.fnmatchcase(name, pat):
                return True
        flag_pats = flags.get("var_series_optout")
        if flag_pats:
            for pat in flag_pats.split(","):
                pat = pat.strip()
                if pat and fnmatch.fnmatchcase(name, pat):
                    return True
        return False

    # ---------------------------------------------------------------- tick
    def tick(self) -> None:
        if not flags.get("var_series_enabled"):
            return
        t0 = time.perf_counter()
        snapshot = exposed_variables()
        live = set()
        with self._lock:
            for name, var in snapshot:
                if self._opted_out(name, var):
                    continue
                try:
                    value = var.get_value()
                except Exception:
                    continue
                # bool is an int subclass — a flag mirror, not a series
                if isinstance(value, bool) or \
                        not isinstance(value, (int, float)):
                    continue
                live.add(name)
                series = self._series.get(name)
                if series is None:
                    series = VarSeries(
                        reduce_op=getattr(var, "series_reduce", "avg"))
                    self._series[name] = series
                series.append(value)
            # GC series whose vars were hidden (cheap: set difference)
            for name in [n for n in self._series if n not in live]:
                del self._series[name]
        self.ticks += 1
        self.last_tick_s = time.perf_counter() - t0
        self.total_tick_s += self.last_tick_s
        for hook in list(self.post_tick_hooks):
            try:
                hook(self)
            except Exception:
                pass

    # ---------------------------------------------------------------- read
    def get(self, name: str) -> Optional[VarSeries]:
        with self._lock:
            return self._series.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def dump(self, name_glob: str = "*") -> Dict[str, dict]:
        """Snapshot for ``/vars?series=json`` — name glob -> tier dict."""
        with self._lock:
            items = sorted(self._series.items())
        return {name: s.to_dict() for name, s in items
                if fnmatch.fnmatchcase(name, name_glob)}

    def clear(self) -> None:
        """Test hook."""
        with self._lock:
            self._series.clear()
            self._optout.clear()
            self._optout_globs = ()
        self.ticks = 0
        self.total_tick_s = 0.0
        self.last_tick_s = 0.0


_global_series = SeriesRegistry()
_install_lock = threading.Lock()
_installed_sampler: Optional[Sampler] = None


def global_series() -> SeriesRegistry:
    return _global_series


def ensure_series_installed(
        collector: Optional[SamplerCollector] = None) -> SeriesRegistry:
    """Register the global series sweep with the sampler daemon (idempotent).
    Called from Server.start; harmless to call from anywhere else."""
    global _installed_sampler
    with _install_lock:
        if _installed_sampler is None:
            # capacity 1: the Sampler ring is unused — the registry keeps
            # its own tiers; the Sampler is just the 1 Hz tick hook
            _installed_sampler = Sampler(
                lambda: (_global_series.tick(), None)[1], 1)
            (collector or global_collector()).register(_installed_sampler)
    return _global_series
