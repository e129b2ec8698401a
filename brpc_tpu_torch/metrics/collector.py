"""Collector — the shared, rate-limited sampling budget.

Counterpart of the reference's bvar Collector (``bvar/collector.h``, used
by rpc_dump's speed limiter ``rpc_dump.h:46-57``, span sampling and the
contention profiler): every sampled subsystem draws grants from ONE
process-wide token bucket, so the combined overhead of observability stays
bounded no matter how many subsystems sample at once — a trace storm
cannot multiply with a dump storm.

Callers keep their own *selection* policy (ratio flags); the collector is
the global budget behind them:

    if ratio_ok and global_collector().ask_to_be_sampled():
        ...record the sample...

Budget: ``collector_max_samples_per_second`` (reloadable flag; <=0 turns
the cap off). Grants/denies are exposed via /vars.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from brpc_tpu_torch import flags as _flags
from brpc_tpu_torch.metrics.reducer import Adder

collector_max_samples_per_second = _flags.define(
    "collector_max_samples_per_second", 1000,
    "process-wide budget shared by every sampling subsystem "
    "(rpcz, rpc_dump, contention); <=0 disables the cap",
    reloadable=True)


class Collector:
    def __init__(self, max_per_second: Optional[int] = None):
        self._fixed_rate = max_per_second
        self._lock = threading.Lock()
        self._tokens = None  # primed to a full bucket on first ask
        self._last_refill = time.monotonic()
        # monotonic instant before which asks are denied without taking the
        # lock — under sustained sampling pressure (every RPC asks) nearly
        # all asks hit this branch (GIL-atomic read; small approximation
        # races only ever deny a touch early)
        # CONTRACT: rpc/server_processing.py's fast path reads _deny_until
        # directly (one attribute load; any accessor would cost the frames
        # the read exists to avoid) — keep name + semantics stable
        self._deny_until = 0.0
        self._deferred_denies = 0  # counted outside the Adder on the hot path
        self.grants = Adder()
        self.denies = Adder()
        self.grants.expose_as("collector_grants")
        self.denies.expose_as("collector_denies")

    def _rate(self) -> int:
        if self._fixed_rate is not None:
            return self._fixed_rate
        return int(_flags.get("collector_max_samples_per_second"))

    def ask_to_be_sampled(self, weight: int = 1) -> bool:
        """Draw ``weight`` grants from the shared budget. True = sample."""
        now = time.monotonic()
        if now < self._deny_until:
            # hot deny path (every RPC asks under load): one plain int +=,
            # no flags read, no reducer; the deferred count flushes into
            # the denies Adder the next time the gate opens
            self._deferred_denies += weight
            return False
        rate = self._rate()
        if rate <= 0:
            if self._deferred_denies:  # cap was just disabled: flush
                d, self._deferred_denies = self._deferred_denies, 0
                self.denies.put(d)
            self.grants.put(weight)
            return True  # cap disabled
        with self._lock:
            if self._deferred_denies:
                d, self._deferred_denies = self._deferred_denies, 0
                self.denies.put(d)
            if self._tokens is None:
                self._tokens = float(rate)  # full bucket at startup
            elapsed = now - self._last_refill
            if elapsed > 0:
                self._tokens = min(float(rate),
                                   self._tokens + elapsed * rate)
                self._last_refill = now
            if self._tokens >= weight:
                self._tokens -= weight
                granted = True
            else:
                granted = False
                # bucket refills at `rate`/s: deny lock-free until the
                # missing fraction of a token has accrued — capped at 1s
                # so a runtime rate change (including disabling the cap)
                # takes effect within a second
                self._deny_until = now + min(
                    (weight - self._tokens) / rate, 1.0)
        (self.grants if granted else self.denies).put(weight)
        return granted


_collector: Optional[Collector] = None
_collector_lock = threading.Lock()


def global_collector() -> Collector:
    global _collector
    c = _collector  # GIL-atomic read: no lock once initialized (hot path)
    if c is not None:
        return c
    with _collector_lock:
        if _collector is None:
            _collector = Collector()
        return _collector
