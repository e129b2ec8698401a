"""Phase 4j's QoS replays of one checkout, repeated, with the process's
stalls recorded:

    python3 brpc_tpu_torch/bench/qos_stalls.py [CHECKOUT] [REPEATS]

CHECKOUT (default: this one) is the root of a checkout, for example a
parent commit unpacked with ``git archive`` into a git-ignored directory;
REPEATS (default 5) how many times its ``chip_smoke.run_qos`` runs. The
script builds that checkout's kernels, then prints one JSON line a
repeat: the verdict of the phase's gates (``pass``, or the failure with
its traces), the card's clocks before and after (``nvidia-smi``), the
load average, and what stopped the process meanwhile (:class:`Stalls`): each
garbage-collection generation's count, total and longest pause
(``gc.callbacks``), the series sampler's sweeps, and the overshoots past
10 ms of a thread that sleeps 2 ms at a time (a stall of every thread),
with the longest ones and when they fell (seconds into the repeat). Run
parent, change, change, parent in one call to compare two commits: two
calls may land on two cards. Needs a card.

:class:`EngineTrace` adds one serving engine's steps to those pauses;
phase 4j prints it for its 2x replays (``trace_2x``).
"""

import gc
import json
import os
import subprocess
import sys
import threading
import time
import traceback

import torch

WATCH_MS = 10.0  # a watchdog overshoot past this is recorded as a stall
LAYERS = 2       # the llm_server example's, which phase 4j serves
# innermost frames of a thread parked, not running
_PARKED = {"wait", "sleep", "select", "poll", "epoll", "_recv",
           "recv_into", "accept", "get", "acquire", "_wait_for_tstate_lock",
           "join"}


class Stalls:
    """The process's pauses while open, as ``events`` of (kind, start on
    ``time.perf_counter``, ms): garbage collections (``gc0``..``gc2``),
    the series registry's sweeps (``series``), and the overshoots past
    WATCH_MS of a thread that sleeps 2 ms at a time (``stall``). With
    ``dump_path``, the stacks of the threads not parked in a wait are
    appended there as soon as that thread runs again after a stall (the
    thread that held the interpreter is among them, where it let go), at
    most DUMPS times."""

    DUMPS = 40

    def __init__(self, series_registry, dump_path=None):
        self.events = []
        self.dump_path = dump_path
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
        dumps = open(self.dump_path, "a") if self.dump_path else None
        me = threading.get_ident()
        dumped = 0
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                time.sleep(0.002)
                over = (time.perf_counter() - t0) * 1e3 - 2.0
                if over <= WATCH_MS:
                    continue
                self.events.append(("stall", t0, over))
                if dumps is None or dumped >= self.DUMPS:
                    continue
                dumped += 1
                names = {t.ident: t.name for t in threading.enumerate()}
                dumps.write(f"# stall t={t0:.6f} over_ms={over:.2f}\n")
                for tid, frame in sys._current_frames().items():
                    stack = traceback.extract_stack(frame)[-6:]
                    if tid == me or not stack or stack[-1].name in _PARKED:
                        continue
                    dumps.write(f"  thread {names.get(tid, tid)}:\n")
                    for fs in stack:
                        dumps.write(f"    {fs.filename}:{fs.lineno} "
                                    f"{fs.name}\n")
                dumps.flush()
        finally:
            if dumps is not None:
                dumps.close()

    def __enter__(self):
        if self.dump_path:
            os.makedirs(os.path.dirname(os.path.abspath(self.dump_path)),
                        exist_ok=True)
        gc.callbacks.append(self._gc)
        self._series.tick = self._timed_tick
        threading.Thread(target=self._watch, name="qos-stall-watch",
                         daemon=True).start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        gc.callbacks.remove(self._gc)
        self._series.tick = self._tick

    def of(self, kind, t0, t1):
        """(ms after ``t0``, ms) of the ``kind`` events in [t0, t1]."""
        return [((t - t0) * 1e3, ms) for k, t, ms in self.events
                if k == kind and t0 <= t <= t1]

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


class EngineTrace(Stalls):
    """:class:`Stalls` and one serving engine's steps and admissions while
    open, on the host's monotonic clock (``time.perf_counter``, the same
    clock in every process of the machine, so a client process's send
    times line up): each step's start, host time, the step thread's CPU
    time (``time.thread_time``: less than the host time by what it spent
    off a core, waiting for the interpreter or descheduled), device time
    (CUDA events around it when the engine is on a card), the prefills it ran
    and the decode batch, and the caching allocator's reserved bytes
    before and after; each ``submit``'s code and tenant; each sequence
    finished with an error; each QoS governor tick with the ceiling it
    left. :meth:`window` summarises one replay's span and the 250 ms
    before each shed of a protected request."""

    def __init__(self, engine, dump_path=None):
        from brpc_tpu_torch.metrics.series import global_series

        super().__init__(global_series(), dump_path)
        self.engine = engine
        self.cuda = engine.kv.store.device.type == "cuda"
        # [t0, host_ms, prefills, batch, mem0, mem1, events, thread cpu ms]
        self.steps = []
        self.submits = []   # (t, tenant, priority, code)
        self.errors = []    # (t, tenant, priority, code)
        self.ticks = []     # (t, ms, ceiling, inflight)

    def _step(self, admitted):
        eng = self.engine
        prefills = [len(s.prompt) for s in admitted if not s.adopted]
        batch = len(eng._running)
        ev = None
        mem0 = torch.cuda.memory_reserved() if self.cuda else 0
        if self.cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t0 = time.perf_counter()
        c0 = time.thread_time()
        try:
            self._orig_step(admitted)
        finally:
            host = (time.perf_counter() - t0) * 1e3
            cpu = (time.thread_time() - c0) * 1e3
            if ev is not None:
                ev[1].record()
            mem1 = torch.cuda.memory_reserved() if self.cuda else 0
            self.steps.append([t0, host, prefills, batch, mem0, mem1, ev,
                               cpu])

    def _submit(self, *args, **kw):
        code, seq = self._orig_submit(*args, **kw)
        cntl = kw.get("cntl")
        tenant = kw.get("tenant_id") or getattr(cntl, "tenant_id", "")
        prio = kw.get("priority")
        if prio is None:
            prio = getattr(cntl, "priority", 0)
        self.submits.append((time.perf_counter(), tenant, prio, code))
        return code, seq

    def _finish(self, seq, code, reason):
        if code:
            self.errors.append((time.perf_counter(), seq.tenant_id,
                                seq.priority, code))
        return self._orig_finish(seq, code, reason)

    def _gov_tick(self, *args, **kw):
        t0 = time.perf_counter()
        try:
            return self._orig_gov_tick(*args, **kw)
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            with self.engine._cv:
                qos = self.engine.qos
                self.ticks.append((t0, ms, qos.limiter.ceiling,
                                   qos.inflight()))

    def __enter__(self):
        eng = self.engine
        self._orig_step, eng._step = eng._step, self._step
        self._orig_submit, eng.submit = eng.submit, self._submit
        self._orig_finish, eng._finish = eng._finish, self._finish
        gov = eng._qos_governor
        if gov is not None:
            self._orig_gov_tick, gov.tick = gov.tick, self._gov_tick
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        eng = self.engine
        for name in ("_step", "submit", "_finish"):
            eng.__dict__.pop(name, None)
        if eng._qos_governor is not None:
            eng._qos_governor.__dict__.pop("tick", None)

    def device_ms(self):
        """Each step's device time in ms (None off the card): the card's
        time between the events around the step, idle time included;
        waits for the steps' events."""
        out = []
        for row in self.steps:
            ev = row[6]
            if ev is None:
                out.append(None)
                continue
            ev[1].synchronize()
            out.append(ev[0].elapsed_time(ev[1]))
        return out

    def window(self, t0, t1, protected=1):
        """The span [t0, t1] (a replay's): step count, host / device ms
        p50 and max, the longest gap between two steps, the five longest
        steps, the steps that grew the allocator's reserve, every garbage
        collection past 1 ms, series sweep and watchdog stall in it, the
        ceilings the governor left, and for each protected request shed
        (at submit or by the governor) the 250 ms before it."""
        dev = self.device_ms()
        rows = [(r[0], r[1], d, r[2], r[3], r[5] - r[4], r[7])
                for r, d in zip(self.steps, dev) if t0 <= r[0] <= t1]

        def step_row(r):
            return {"at_ms": (r[0] - t0) * 1e3, "host_ms": r[1],
                    "cpu_ms": r[6], "device_ms": r[2], "prefills": r[3],
                    "batch": r[4], "grew_bytes": r[5]}

        host = sorted(r[1] for r in rows)
        cpu = sorted(r[6] for r in rows)
        devs = sorted(r[2] for r in rows if r[2] is not None)
        gaps = [(b[0] - (a[0] + a[1] / 1e3)) * 1e3
                for a, b in zip(rows, rows[1:])]
        sheds = [e for e in self.submits + self.errors
                 if t0 <= e[0] <= t1 and e[3] and e[2] >= protected]
        out = {
            "steps": len(rows),
            "host_ms_p50": host[len(host) // 2] if host else 0.0,
            "host_ms_max": host[-1] if host else 0.0,
            "cpu_ms_p50": cpu[len(cpu) // 2] if cpu else 0.0,
            "device_ms_p50": devs[len(devs) // 2] if devs else None,
            "device_ms_max": devs[-1] if devs else None,
            "gap_ms_max": max(gaps, default=0.0),
            "longest": [step_row(r) for r in
                        sorted(rows, key=lambda r: -r[1])[:5]],
            "grew": [step_row(r) for r in rows if r[5]],
            "gcs": [((t - t0) * 1e3, k, ms) for k, t, ms in self.events
                    if k.startswith("gc") and t0 <= t <= t1 and ms > 1.0],
            "series_sweeps": self.of("series", t0, t1),
            "stalls": self.of("stall", t0, t1),
            "ceilings": [((t - t0) * 1e3, ms, c, n)
                         for t, ms, c, n in self.ticks if t0 <= t <= t1],
            "threads": threading.active_count(),
            "protected_sheds": [],
        }
        for t, tenant, prio, code in sheds:
            lo = t - 0.25
            out["protected_sheds"].append({
                "at_ms": (t - t0) * 1e3, "tenant": tenant, "code": code,
                "steps": [step_row(r) for r in rows if lo <= r[0] <= t],
                "submits": [((s - t0) * 1e3, tn, p, c)
                            for s, tn, p, c in self.submits
                            if lo <= s <= t],
            })
        return out


def _clocks():
    """The card's SM and memory clocks, power draw and temperature, as
    ``nvidia-smi`` reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60).stdout.strip()


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
        clocks = [_clocks()]
        with Stalls(global_series()) as stalls:
            try:
                chip_smoke.run_qos(dev, smi, LAYERS)
                verdict = "pass"
            except AssertionError as e:
                verdict = f"fail: {e}"
        clocks.append(_clocks())
        by, longest = stalls.summary(t0)
        print(json.dumps({"qos_stalls": {
            "checkout": argv[1] if len(argv) > 1 else ".", "repeat": i,
            "verdict": verdict, "card": smi, "clocks": clocks,
            "loadavg": os.getloadavg(),
            "s": time.perf_counter() - t0, "by_kind": by,
            "longest": longest}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
