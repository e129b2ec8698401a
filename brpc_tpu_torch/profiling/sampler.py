"""Statistical wall-clock sampler over ``sys._current_frames()``.

The reference ships gperftools' sampling CPU profiler behind
/hotspots/cpu; CPython's cProfile is *not* that — ``Profile.enable()``
instruments only the calling thread, so profiling a server by enabling it
on a sleeping handler thread observes nothing. This module is the real equivalent: a sampler that snapshots every
thread's stack at a fixed rate, folds them into collapsed-stack
aggregates, and keys each sample by the sampled thread's **role**
(profiling/registry.py) and current **span phase** so one run answers both
"which code is hot" and "which RPC phase burns the CPU".

Wall vs CPU: ``sys._current_frames()`` sees every live thread, including
ones parked in waits — that is the point (lock convoys show up). For CPU
attribution the aggregate classifies each sample as on-cpu/waiting by its
leaf frame (waits in CPython always sit in a recognizable C-call leaf:
``wait``/``sleep``/``select``/``poll``/``acquire``/``recv``/...), the
standard trick wall samplers use. Under the GIL at most one thread is
truly on-core at a time, so cpu-classified sample counts divided by hz
approximate process CPU seconds.

Budget: every sampling tick asks the global Collector for a grant
(``collector_max_samples_per_second`` caps total observability overhead
process-wide); denied ticks are skipped and counted on ``g_prof_dropped``.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from brpc_tpu_torch import flags
from brpc_tpu_torch.metrics.reducer import Adder
from brpc_tpu_torch.profiling import registry

flags.define(
    "tpu_prof_continuous_hz", 5.0,
    "sampling rate of the always-on continuous profiler (windows land in "
    "the /hotspots/continuous ring); 0 pauses it",
    validator=lambda v: v >= 0, reloadable=True)
flags.define(
    "tpu_prof_window_s", 15.0,
    "length of one continuous-profiler aggregation window",
    validator=lambda v: v > 0, reloadable=True)
flags.define(
    "tpu_prof_ring_windows", 24,
    "continuous-profiler ring capacity in windows (24 x 15s = 6 minutes "
    "of retention); older windows are evicted",
    validator=lambda v: v > 0, reloadable=True)

g_prof_samples = Adder("g_prof_samples")    # thread-stack samples folded in
g_prof_dropped = Adder("g_prof_dropped")    # ticks denied by the Collector
g_prof_overruns = Adder("g_prof_overruns")  # ticks that missed their slot

MAX_STACK_DEPTH = 48

# leaf-frame tokens that mark a sample as "waiting" rather than on-cpu
_WAIT_TOKENS = ("wait", "sleep", "select", "poll", "acquire", "park",
                "join", "recv", "accept", "epoll", "kqueue", "read_event",
                "channel_get", "_bootstrap")


def _is_wait_leaf(leaf: str) -> bool:
    name = leaf.rsplit(":", 1)[-1].lower()
    return any(tok in name for tok in _WAIT_TOKENS)


def collapse(frame, limit: int = MAX_STACK_DEPTH) -> Tuple[str, ...]:
    """Fold a frame chain into a root..leaf tuple of ``file.py:func``
    frames (line numbers deliberately dropped so samples inside one
    function aggregate)."""
    out: List[str] = []
    f = frame
    while f is not None and len(out) < limit:
        code = f.f_code
        out.append(f"{code.co_filename.rsplit('/', 1)[-1]}:{code.co_name}")
        f = f.f_back
    out.reverse()
    return tuple(out)


class FoldedProfile:
    """A collapsed-stack aggregate: (role, phase, stack) -> sample count,
    plus enough metadata to reason about rates and overhead."""

    __slots__ = ("counts", "start_ts", "end_ts", "hz", "ticks",
                 "dropped_ticks", "overruns", "sample_time_s",
                 "track_threads", "thread_counts", "thread_native")

    def __init__(self, hz: float = 0.0, track_threads: bool = False):
        self.counts: Dict[Tuple[str, str, Tuple[str, ...]], int] = {}
        self.start_ts = time.time()
        self.end_ts = self.start_ts
        self.hz = hz
        self.ticks = 0
        self.dropped_ticks = 0
        self.overruns = 0
        self.sample_time_s = 0.0  # wall time spent inside sampling ticks
        # per-thread attribution (bench --profile budget): tid -> phase ->
        # [wall_samples, cpu_samples], plus tid -> OS native thread id so
        # per-thread OS CPU (/proc/self/task/<tid>/stat) can be matched up
        self.track_threads = track_threads
        self.thread_counts: Dict[int, Dict[str, List[int]]] = {}
        self.thread_native: Dict[int, int] = {}

    # ------------------------------------------------------------ build
    def add(self, role: str, phase: str, stack: Tuple[str, ...],
            n: int = 1) -> None:
        key = (role, phase, stack)
        self.counts[key] = self.counts.get(key, 0) + n

    def merge(self, other: "FoldedProfile") -> "FoldedProfile":
        for key, n in other.counts.items():
            self.counts[key] = self.counts.get(key, 0) + n
        for tid, phases in other.thread_counts.items():
            mine = self.thread_counts.setdefault(tid, {})
            for ph, (w, c) in phases.items():
                ent = mine.setdefault(ph, [0, 0])
                ent[0] += w
                ent[1] += c
        self.thread_native.update(other.thread_native)
        self.ticks += other.ticks
        self.dropped_ticks += other.dropped_ticks
        self.overruns += other.overruns
        self.sample_time_s += other.sample_time_s
        self.start_ts = min(self.start_ts, other.start_ts)
        self.end_ts = max(self.end_ts, other.end_ts)
        self.hz = self.hz or other.hz
        return self

    # ---------------------------------------------------------- queries
    @property
    def samples(self) -> int:
        return sum(self.counts.values())

    def cpu_samples(self) -> int:
        return sum(n for (_, _, st), n in self.counts.items()
                   if st and not _is_wait_leaf(st[-1]))

    def by_role(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for (role, _, _), n in self.counts.items():
            out[role] = out.get(role, 0) + n
        return out

    def by_phase(self, cpu_only: bool = False) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for (_, phase, st), n in self.counts.items():
            if cpu_only and (not st or _is_wait_leaf(st[-1])):
                continue
            out[phase] = out.get(phase, 0) + n
        return out

    def top_self(self, limit: int = 25,
                 cpu_only: bool = True) -> List[Tuple[str, int]]:
        """Leaf frames ranked by self samples — the flat hotspot view."""
        out: Dict[str, int] = {}
        for (_, _, st), n in self.counts.items():
            if not st:
                continue
            if cpu_only and _is_wait_leaf(st[-1]):
                continue
            out[st[-1]] = out.get(st[-1], 0) + n
        return sorted(out.items(), key=lambda kv: -kv[1])[:limit]

    def folded_lines(self, tag_role: bool = True, tag_phase: bool = True,
                     cpu_only: bool = False) -> List[str]:
        """Collapsed-stack lines ("f1;f2;f3 N") flamegraph.pl/pprof read;
        role/phase ride along as synthetic root frames when tagged."""
        rows: Dict[str, int] = {}
        for (role, phase, st), n in self.counts.items():
            if cpu_only and (not st or _is_wait_leaf(st[-1])):
                continue
            parts: List[str] = []
            if tag_role:
                parts.append(f"role={role}")
            if tag_phase:
                parts.append(f"phase={phase}")
            parts.extend(st)
            key = ";".join(parts)
            rows[key] = rows.get(key, 0) + n
        return [f"{stack} {n}"
                for stack, n in sorted(rows.items(), key=lambda kv: -kv[1])]

    def to_dict(self) -> dict:
        dur = max(self.end_ts - self.start_ts, 1e-9)
        return {
            "start_ts": self.start_ts, "end_ts": self.end_ts,
            "hz": self.hz, "ticks": self.ticks,
            "samples": self.samples, "cpu_samples": self.cpu_samples(),
            "dropped_ticks": self.dropped_ticks, "overruns": self.overruns,
            "sample_time_s": round(self.sample_time_s, 6),
            "overhead_pct": round(100.0 * self.sample_time_s / dur, 3),
            "by_role": self.by_role(), "by_phase": self.by_phase(),
        }


# ----------------------------------------------------------------- engine
def _sample_tick(prof: FoldedProfile, skip: frozenset) -> None:
    t0 = time.monotonic()
    frames = sys._current_frames()
    try:
        added = 0
        for tid, frame in frames.items():
            if tid in skip:
                continue
            phase = registry.phase_of(tid) or "-"
            stack = collapse(frame)
            prof.add(registry.role_of(tid), phase, stack)
            if prof.track_threads:
                if tid not in prof.thread_native:
                    th = threading._active.get(tid)
                    prof.thread_native[tid] = getattr(th, "native_id",
                                                      0) or 0 if th else 0
                ent = prof.thread_counts.setdefault(tid, {}) \
                    .setdefault(phase, [0, 0])
                ent[0] += 1
                if stack and not _is_wait_leaf(stack[-1]):
                    ent[1] += 1
            added += 1
        if added:
            g_prof_samples.put(added)
        prof.ticks += 1
        if prof.ticks % 64 == 0:
            registry.prune(frames.keys())
    finally:
        del frames  # break frame refs promptly (they pin locals)
    prof.sample_time_s += time.monotonic() - t0


def _sample_loop(prof: FoldedProfile, hz: float, should_stop,
                 budget: bool, wait) -> FoldedProfile:
    """Shared tick loop: monotonic schedule, Collector gating, overrun
    accounting. ``wait(seconds)`` parks between ticks (Event.wait for
    stoppable sessions, time.sleep for one-shots)."""
    interval = 1.0 / max(hz, 0.001)
    skip = frozenset((threading.get_ident(),))
    collector = None
    if budget:
        from brpc_tpu_torch.metrics.collector import global_collector
        collector = global_collector()
    next_t = time.monotonic()
    while not should_stop():
        now = time.monotonic()
        if now > next_t + interval:
            # we fell behind by a full slot (GIL stall / suspended box)
            missed = int((now - next_t) / interval)
            prof.overruns += missed
            g_prof_overruns.put(missed)
            next_t = now
        if collector is not None and not collector.ask_to_be_sampled():
            prof.dropped_ticks += 1
            g_prof_dropped.put(1)
        else:
            _sample_tick(prof, skip)
        next_t += interval
        delay = next_t - time.monotonic()
        if delay > 0:
            wait(delay)
    prof.end_ts = time.time()
    return prof


def run_profile(seconds: float, hz: float = 100.0,
                budget: bool = True) -> FoldedProfile:
    """One-shot sampling run on the calling thread (the /hotspots/cpu
    engine). The calling thread itself is excluded from samples."""
    prof = FoldedProfile(hz=hz)
    end = time.monotonic() + seconds
    _sample_loop(prof, hz, lambda: time.monotonic() >= end, budget,
                 time.sleep)
    return prof


class ProfileSession:
    """Start/stop sampler on a background thread — the bench.py --profile
    harness wraps a workload with one of these."""

    def __init__(self, hz: float = 200.0, budget: bool = False,
                 track_threads: bool = False):
        self._hz = hz
        self._budget = budget
        self._stop = threading.Event()
        self.profile = FoldedProfile(hz=hz, track_threads=track_threads)
        self._thread = threading.Thread(target=self._run,
                                        name="tpu-prof-session", daemon=True)

    def _run(self):
        registry.register_current_thread(registry.ROLE_SAMPLER)
        _sample_loop(self.profile, self._hz, self._stop.is_set,
                     self._budget, self._stop.wait)

    def start(self) -> "ProfileSession":
        self.profile.start_ts = time.time()
        self._thread.start()
        return self

    def stop(self) -> FoldedProfile:
        self._stop.set()
        self._thread.join(timeout=5)
        return self.profile


# ------------------------------------------------------------- continuous
class ContinuousProfiler(threading.Thread):
    """Always-on low-rate sampler retaining an N-minute ring of per-window
    aggregates (the "what changed in the last five minutes" profiler).
    Rate/window/retention read the tpu_prof_* flags every window so
    /flags updates apply live; hz 0 pauses sampling but keeps the ring."""

    def __init__(self):
        super().__init__(name="tpu-prof-continuous", daemon=True)
        self._stop_ev = threading.Event()
        self._ring_lock = threading.Lock()
        self._windows: deque = deque()

    # ------------------------------------------------------------- loop
    def run(self):
        registry.register_current_thread(registry.ROLE_SAMPLER)
        while not self._stop_ev.is_set():
            hz = float(flags.get("tpu_prof_continuous_hz"))
            if hz <= 0:
                self._stop_ev.wait(0.25)
                continue
            window_s = float(flags.get("tpu_prof_window_s"))
            prof = FoldedProfile(hz=hz)
            end = time.monotonic() + window_s

            def _done():
                return (self._stop_ev.is_set()
                        or time.monotonic() >= end
                        or float(flags.get("tpu_prof_continuous_hz")) != hz)

            _sample_loop(prof, hz, _done, True, self._stop_ev.wait)
            with self._ring_lock:
                self._windows.append(prof)
                cap = int(flags.get("tpu_prof_ring_windows"))
                while len(self._windows) > cap:
                    self._windows.popleft()

    def stop(self):
        self._stop_ev.set()

    # ---------------------------------------------------------- queries
    def windows(self) -> List[FoldedProfile]:
        with self._ring_lock:
            return list(self._windows)

    def query(self, from_ts: Optional[float] = None,
              to_ts: Optional[float] = None) -> FoldedProfile:
        """Merge ring windows overlapping [from_ts, to_ts] (epoch seconds;
        None = unbounded)."""
        merged = FoldedProfile()
        hit = False
        for w in self.windows():
            if from_ts is not None and w.end_ts < from_ts:
                continue
            if to_ts is not None and w.start_ts > to_ts:
                continue
            merged.merge(w)
            hit = True
        if not hit:
            merged.start_ts = from_ts or time.time()
            merged.end_ts = to_ts or merged.start_ts
        return merged


_continuous: Optional[ContinuousProfiler] = None
_continuous_lock = threading.Lock()


def ensure_continuous_started() -> ContinuousProfiler:
    """Singleton accessor; the first Server.start() (and the
    /hotspots/continuous endpoint) call this."""
    global _continuous
    with _continuous_lock:
        if _continuous is None or not _continuous.is_alive():
            _continuous = ContinuousProfiler()
            _continuous.start()
        return _continuous


def continuous() -> Optional[ContinuousProfiler]:
    return _continuous
