"""Phase 4j's QoS replays of one checkout, repeated, with the process's
stalls recorded:

    python3 brpc_tpu_torch/bench/qos_stalls.py [CHECKOUT] [REPEATS]

CHECKOUT (default: this one) is the root of a checkout, for example a
parent commit unpacked with ``git archive`` into a git-ignored directory;
REPEATS (default 5) how many times its ``chip_smoke.run_qos`` runs. The
script builds that checkout's kernels, then prints one JSON line a
repeat: the verdict of the phase's gates (``pass``, or the failure), and
what stopped the process meanwhile: each garbage-collection generation's
count, total and longest pause (``gc.callbacks``), the series sampler's
sweeps, and the overshoots past 10 ms of a thread that sleeps 1 ms at a
time (a stall of every thread), with the longest ones and when they fell
(seconds into the repeat). Run parent, change, change, parent in one call
to compare two commits: two calls may land on two cards. Needs a card.
"""

import gc
import json
import os
import subprocess
import sys
import threading
import time

import torch

WATCH_MS = 10.0  # a watchdog overshoot past this is recorded as a stall
LAYERS = 2       # the llm_server example's, which phase 4j serves


class Stalls:
    """The process's pauses while open: garbage collections by
    generation, series sweeps, and a 1 ms watchdog's overshoots."""

    def __init__(self, series_registry):
        self.events = []
        self._gc_t0 = None
        self._series = series_registry
        self._tick = series_registry.tick
        self._stop = threading.Event()

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.events.append((f"gc{info['generation']}", self._gc_t0,
                                (time.perf_counter() - self._gc_t0) * 1e3))

    def _timed_tick(self):
        t0 = time.perf_counter()
        self._tick()
        self.events.append(("series", t0, (time.perf_counter() - t0) * 1e3))

    def _watch(self):
        while not self._stop.is_set():
            t0 = time.perf_counter()
            time.sleep(0.001)
            over = (time.perf_counter() - t0) * 1e3 - 1.0
            if over > WATCH_MS:
                self.events.append(("stall", t0, over))

    def __enter__(self):
        gc.callbacks.append(self._gc)
        self._series.tick = self._timed_tick
        threading.Thread(target=self._watch, name="qos-stall-watch",
                         daemon=True).start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        gc.callbacks.remove(self._gc)
        self._series.tick = self._tick

    def summary(self, t0):
        by = {}
        for kind, _, ms in self.events:
            row = by.setdefault(kind, {"count": 0, "total_ms": 0.0,
                                       "max_ms": 0.0})
            row["count"] += 1
            row["total_ms"] += ms
            row["max_ms"] = max(row["max_ms"], ms)
        longest = sorted((ms, kind, t - t0) for kind, t, ms in self.events
                         if ms > 30)[-12:]
        return by, [{"ms": ms, "kind": kind, "at_s": at}
                    for ms, kind, at in longest]


def main(argv):
    root = os.path.abspath(argv[1] if len(argv) > 1 else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    repeats = int(argv[2]) if len(argv) > 2 else 5
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke
    from brpc_tpu_torch.metrics.series import global_series
    from brpc_tpu_torch.tpu import _build

    if not torch.cuda.is_available():
        print("qos_stalls: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    _build.build_all()
    dev = torch.device("cuda", 0)
    for i in range(repeats):
        t0 = time.perf_counter()
        with Stalls(global_series()) as stalls:
            try:
                chip_smoke.run_qos(dev, smi, LAYERS)
                verdict = "pass"
            except AssertionError as e:
                verdict = f"fail: {e}"[:300]
        by, longest = stalls.summary(t0)
        print(json.dumps({"qos_stalls": {
            "checkout": argv[1] if len(argv) > 1 else ".", "repeat": i,
            "verdict": verdict, "card": smi,
            "s": time.perf_counter() - t0, "by_kind": by,
            "longest": longest}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
