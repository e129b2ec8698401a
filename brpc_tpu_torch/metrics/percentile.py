"""Percentile — per-thread reservoir sampling merged on read.

Rebuild of ``bvar/detail/percentile.h:52,280,507``: writers add latencies to a
thread-local reservoir (bounded, count-weighted); readers merge all thread
reservoirs into one ``PercentileSamples`` and interpolate percentiles. Writes
stay contention-free; accuracy degrades gracefully under load exactly like
the reference (reservoir replacement is probabilistic once full).

Merging is COUNT-WEIGHTED: a reservoir that stands for 1M events outweighs
one that stands for 2k events by 500x regardless of both holding <=1024
samples (the reference's PercentileSamples carries num_added per interval).
"""

from __future__ import annotations

import random
import threading
import weakref
from typing import List, Tuple

SAMPLE_CAPACITY = 1024  # per-thread reservoir size


class PercentileSamples:
    """A merged set of (samples, represented_count) groups."""

    __slots__ = ("_groups", "count")

    def __init__(self):
        self._groups: List[Tuple[List[float], int]] = []
        self.count = 0

    def add_group(self, samples: List[float], count: int) -> None:
        if count > 0 and samples:
            self._groups.append((samples, count))
        self.count += count

    def merge(self, other: "PercentileSamples") -> None:
        self._groups.extend(other._groups)
        self.count += other.count

    def get_number(self, ratio: float) -> float:
        """Value at the given ratio in [0,1] (e.g. 0.99 -> p99),
        weighting each group's samples by the events it represents."""
        weighted: List[Tuple[float, float]] = []
        for samples, count in self._groups:
            w = count / len(samples)
            weighted.extend((v, w) for v in samples)
        if not weighted:
            return 0.0
        weighted.sort(key=lambda vw: vw[0])
        total = sum(w for _, w in weighted)
        target = ratio * total
        acc = 0.0
        for v, w in weighted:
            acc += w
            if acc >= target:
                return v
        return weighted[-1][0]


class _ThreadReservoir:
    __slots__ = ("samples", "count", "_seed")

    def __init__(self):
        self.samples: List[float] = []
        self.count = 0
        self._seed = random.getrandbits(63) | 1

    def add(self, value: float) -> None:
        self.count += 1
        if len(self.samples) < SAMPLE_CAPACITY:
            self.samples.append(value)
        else:
            # classic reservoir replacement keeps a uniform sample; the
            # index draw is an LCG, not random.randrange — this runs once
            # per RPC on the hot path and randrange's rejection loop is
            # ~2us of pure overhead there (metrics-grade uniformity only)
            s = (self._seed * 6364136223846793005
                 + 1442695040888963407) & 0xFFFFFFFFFFFFFFFF
            self._seed = s
            j = (s >> 33) % self.count
            if j < SAMPLE_CAPACITY:
                self.samples[j] = value

    def take(self) -> PercentileSamples:
        out = PercentileSamples()
        out.add_group(self.samples, self.count)
        self.samples = []
        self.count = 0
        return out

    def snapshot(self) -> PercentileSamples:
        out = PercentileSamples()
        out.add_group(list(self.samples), self.count)
        return out


class _ReservoirAnchor:
    __slots__ = ("__weakref__",)


class Percentile:
    """Contention-free percentile collector."""

    def __init__(self):
        self._tls = threading.local()
        self._reservoirs: List[_ThreadReservoir] = []
        self._lock = threading.Lock()
        # samples from dead threads, harvested into the next reset()
        self._retired = PercentileSamples()

    def _reservoir(self) -> "_ThreadReservoir":
        """This thread's reservoir, registered on first use (exposed so
        LatencyRecorder's fused write path can cache it)."""
        res = getattr(self._tls, "res", None)
        if res is None:
            res = _ThreadReservoir()
            anchor = _ReservoirAnchor()
            self._tls.res = res
            self._tls.anchor = anchor
            with self._lock:
                self._reservoirs.append(res)
            weakref.finalize(anchor, self._retire, res)
        return res

    def put(self, value: float) -> None:
        self._reservoir().add(value)

    __lshift__ = put

    def _retire(self, res: _ThreadReservoir) -> None:
        with self._lock:
            try:
                self._reservoirs.remove(res)
            except ValueError:
                return
            self._retired.merge(res.take())

    def get_value(self) -> PercentileSamples:
        """Merge current thread reservoirs (non-destructive snapshot)."""
        out = PercentileSamples()
        with self._lock:
            for samples, count in self._retired._groups:
                out.add_group(list(samples), count)
            for res in self._reservoirs:
                out.merge(res.snapshot())
        return out

    def reset(self) -> PercentileSamples:
        """Harvest and clear all reservoirs (the per-second sampler path)."""
        out = PercentileSamples()
        with self._lock:
            out.merge(self._retired)
            self._retired = PercentileSamples()
            for res in self._reservoirs:
                out.merge(res.take())
        return out
