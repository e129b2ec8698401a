"""Sampler — the once-per-second background sweep (bvar/detail/sampler.cpp:52).

Every windowed variable registers a sampler; one daemon thread ticks them all
each second, pushing a sample into the variable's ring. Tests drive ticks
manually via ``tick_all()`` so they never sleep.
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, List


class Sampler:
    """One registered sampling callback, holding a ring of samples."""

    def __init__(self, take_sample: Callable[[], object], window_capacity: int):
        self._take_sample = take_sample
        self.capacity = window_capacity
        self.samples: List[object] = []
        self._lock = threading.Lock()

    def tick(self) -> None:
        sample = self._take_sample()
        with self._lock:
            self.samples.append(sample)
            if len(self.samples) > self.capacity:
                del self.samples[: len(self.samples) - self.capacity]

    def recent(self, n: int) -> List[object]:
        with self._lock:
            return self.samples[-n:] if n else []

    def sample_count(self) -> int:
        with self._lock:
            return len(self.samples)


class SamplerCollector:
    """The background thread sweeping all samplers once per second."""

    def __init__(self, interval_s: float = 1.0):
        self._samplers: "weakref.WeakSet[Sampler]" = weakref.WeakSet()
        self._lock = threading.Lock()
        self._interval = interval_s
        self._thread = None
        self._stop = threading.Event()

    def register(self, sampler: Sampler) -> None:
        with self._lock:
            self._samplers.add(sampler)
            self._ensure_thread()  # under the lock: exactly one sweeper

    def tick_all(self) -> None:
        """Manual tick — the test substrate (no 1 s waits in tests)."""
        with self._lock:
            samplers = list(self._samplers)
        for s in samplers:
            s.tick()

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="bvar-sampler", daemon=True
            )
            self._thread.start()

    def _run(self) -> None:
        from brpc_tpu_torch.profiling import registry as _prof

        _prof.register_current_thread(_prof.ROLE_SAMPLER)
        while not self._stop.wait(self._interval):
            try:
                self.tick_all()
            except Exception:
                pass

    def shutdown(self) -> None:
        self._stop.set()


_global_collector = SamplerCollector()


def global_collector() -> SamplerCollector:
    return _global_collector
