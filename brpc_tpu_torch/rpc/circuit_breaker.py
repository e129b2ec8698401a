"""CircuitBreaker — per-node EMA error isolation (reference
circuit_breaker.h:30-60).

Two EMA windows (long + short) over call outcomes; tripping isolates the
node for an exponentially-growing duration (repeat offenders stay out
longer), and a half-open probe ends isolation. The tunnel's healer
(``tpu/transport.py``) is its one user here.
"""

from __future__ import annotations

import threading
import time


class CircuitBreaker:
    def __init__(self,
                 error_threshold: float = 0.5,
                 min_samples: int = 10,
                 base_isolation_s: float = 0.1,
                 max_isolation_s: float = 30.0,
                 fail_streak_trip: int = 0):
        self.error_threshold = error_threshold
        self.min_samples = min_samples
        self.base_isolation_s = base_isolation_s
        self.max_isolation_s = max_isolation_s
        # >0: trip after this many CONSECUTIVE failures, independent of the
        # EMA windows — for low-rate probe traffic (tunnel re-handshakes)
        # where tens of samples would take forever to accumulate
        self.fail_streak_trip = fail_streak_trip
        self._lock = threading.Lock()
        # EMAs: long window reacts slowly, short window catches bursts
        self._long_ema = 0.0
        self._short_ema = 0.0
        self._samples = 0
        self._fail_streak = 0
        self._isolated_until = 0.0
        self._isolation_s = base_isolation_s

    def on_call_end(self, error_code: int, latency_us: float = 0.0) -> None:
        err = 1.0 if error_code != 0 else 0.0
        with self._lock:
            self._samples += 1
            self._long_ema += 0.02 * (err - self._long_ema)
            self._short_ema += 0.2 * (err - self._short_ema)
            self._fail_streak = self._fail_streak + 1 if err else 0
            if (not self._is_isolated_locked()
                    and ((self._samples >= self.min_samples
                          and (self._short_ema > self.error_threshold
                               or self._long_ema > self.error_threshold))
                         or (self.fail_streak_trip > 0
                             and self._fail_streak >=
                             self.fail_streak_trip))):
                self._trip_locked()
            elif err == 0.0 and not self._is_isolated_locked():
                # healthy traffic decays the penalty
                self._isolation_s = max(self.base_isolation_s,
                                        self._isolation_s * 0.98)

    def _trip_locked(self) -> None:
        self._isolated_until = time.monotonic() + self._isolation_s
        self._isolation_s = min(self.max_isolation_s, self._isolation_s * 2)
        # fresh slate for the half-open probe: a successful probe must not
        # re-trip on the residue of the burst that tripped us (the doubled
        # _isolation_s is what remembers repeat offenders)
        self._short_ema = 0.0
        self._long_ema = 0.0
        self._samples = 0
        self._fail_streak = 0

    def _is_isolated_locked(self) -> bool:
        return time.monotonic() < self._isolated_until

    @property
    def isolated(self) -> bool:
        with self._lock:
            return self._is_isolated_locked()
