"""Concurrency limiters — server-side admission control.

Rebuild of the reference's three policies (registered global.cpp:624-626):
  constant — fixed max concurrent requests
  auto     — gradient-style (policy/auto_concurrency_limiter.h:40-70):
             track the best latency ever seen (min_latency EMA); when
             current latency degrades well past it, shrink the limit, when
             near it, grow. Self-tunes to the knee of the latency curve.
  timeout  — (policy/timeout_concurrency_limiter.cpp) reject when expected
             queue time exceeds the caller's budget.

Wire-in: MethodEntry.limiter (rpc/server.py) consults on_request/on_response.
"""

from __future__ import annotations

import threading
from typing import Optional


class ConcurrencyLimiter:
    name = "base"

    def on_request(self) -> bool:
        raise NotImplementedError

    def on_response(self, latency_us: float, error_code: int) -> None:
        raise NotImplementedError

    @property
    def current(self) -> int:
        raise NotImplementedError


class ConstantLimiter(ConcurrencyLimiter):
    name = "constant"

    def __init__(self, max_concurrency: int):
        self.max_concurrency = max_concurrency
        self._current = 0
        self._lock = threading.Lock()

    def on_request(self) -> bool:
        with self._lock:
            if self._current >= self.max_concurrency:
                return False
            self._current += 1
            return True

    def on_response(self, latency_us: float, error_code: int) -> None:
        with self._lock:
            self._current -= 1

    @property
    def current(self) -> int:
        return self._current


class AutoLimiter(ConcurrencyLimiter):
    """Gradient limiter: limit chases the concurrency that keeps latency
    near the observed floor."""

    name = "auto"

    def __init__(self, initial: int = 32, min_limit: int = 4,
                 max_limit: int = 4096, sample_window: int = 64):
        self._limit = float(initial)
        self.min_limit = min_limit
        self.max_limit = max_limit
        self._current = 0
        self._lock = threading.Lock()
        self._min_latency_us: Optional[float] = None
        self._window_total = 0.0
        self._window_count = 0
        self._sample_window = sample_window

    def on_request(self) -> bool:
        with self._lock:
            if self._current >= int(self._limit):
                return False
            self._current += 1
            return True

    def on_response(self, latency_us: float, error_code: int) -> None:
        with self._lock:
            self._current -= 1
            if error_code != 0:
                return
            self._window_total += latency_us
            self._window_count += 1
            if self._window_count < self._sample_window:
                return
            avg = self._window_total / self._window_count
            self._window_total = 0.0
            self._window_count = 0
            if self._min_latency_us is None or avg < self._min_latency_us:
                self._min_latency_us = avg
            else:
                # slow drift so a transient floor doesn't pin us forever
                self._min_latency_us += 0.01 * (avg - self._min_latency_us)
            gradient = self._min_latency_us / max(avg, 1e-9)
            # gradient ~1: healthy -> grow; latency inflated -> shrink
            new_limit = self._limit * max(0.5, min(1.5, gradient)) + 2.0
            self._limit = max(self.min_limit,
                              min(self.max_limit, new_limit))

    @property
    def current(self) -> int:
        return self._current

    @property
    def limit(self) -> int:
        return int(self._limit)


class TimeoutLimiter(ConcurrencyLimiter):
    """Reject when the expected wait (queued x avg latency) would blow the
    caller's budget."""

    name = "timeout"

    def __init__(self, timeout_ms: float = 500.0):
        self.timeout_ms = timeout_ms
        self._current = 0
        self._avg_latency_us = 0.0
        self._lock = threading.Lock()

    def on_request(self) -> bool:
        with self._lock:
            expected_us = self._current * self._avg_latency_us
            if expected_us > self.timeout_ms * 1000.0:
                return False
            self._current += 1
            return True

    def on_response(self, latency_us: float, error_code: int) -> None:
        with self._lock:
            self._current -= 1
            if error_code == 0:
                self._avg_latency_us += 0.1 * (latency_us
                                               - self._avg_latency_us)

    @property
    def current(self) -> int:
        return self._current


def create_limiter(spec) -> Optional[ConcurrencyLimiter]:
    """spec: int -> constant; 'auto' | 'timeout' | 'timeout:MS' | 'constant:N'."""
    if spec in (None, 0, "", "unlimited"):
        return None
    if isinstance(spec, int):
        return ConstantLimiter(spec)
    name, _, arg = str(spec).partition(":")
    if name == "constant":
        return ConstantLimiter(int(arg or 64))
    if name == "auto":
        return AutoLimiter(initial=int(arg) if arg else 32)
    if name == "timeout":
        return TimeoutLimiter(timeout_ms=float(arg) if arg else 500.0)
    raise ValueError(f"unknown concurrency limiter {spec!r}")
