"""Profiler builtin services — /hotspots/{cpu,heap,growth,contention,
flame,continuous}, /pprof/{profile,heap,symbol,cmdline}, /vlog.

Counterpart of the reference's ``builtin/hotspots_service.cpp`` (gperftools
ProfilerStart / MallocExtension) and ``builtin/pprof_service.cpp`` (the
pprof-tool-compatible endpoints). The CPU surface runs on the statistical
sampler (brpc_tpu/profiling/): ``sys._current_frames()`` snapshots every
thread at a fixed rate and folds collapsed stacks keyed by thread role and
span phase — the whole-process view gperftools gives the reference.
cProfile remains available as ``?engine=cprofile`` but in CPython it
instruments ONLY the calling thread (the old default's blind spot). Heap
endpoints map to tracemalloc; contention to the fiber runtime's wait
counters plus sampled waiter stacks. Output is the pprof collapsed/text
format (one "stack count" per line) that pprof and flamegraph.pl both
read.
"""

from __future__ import annotations

import cProfile
import io
import json
import logging
import pstats
import sys
import threading
import time
import tracemalloc

from brpc_tpu_torch.builtin import register_builtin
from brpc_tpu_torch.policy.http_protocol import CONTENT_TEXT, HttpMessage
from brpc_tpu_torch.profiling import sampler as _sampler

_lock = threading.Lock()  # one profile run at a time (reference behavior)

_CPROFILE_HEADER = (
    "# WARNING: the cProfile engine instruments ONLY the thread that\n"
    "# started it (this handler thread) — pollers, fiber workers, timers\n"
    "# and healers are invisible to it. Use the default sampler engine\n"
    "# (drop ?engine=cprofile) for a whole-process profile.\n")


def _seconds(http: HttpMessage, default: float = 1.0) -> float:
    try:
        return min(float(http.query.get("seconds", default)), 60.0)
    except (TypeError, ValueError):
        return default


def _hz(http: HttpMessage, default: float = 100.0) -> float:
    try:
        return max(1.0, min(float(http.query.get("hz", default)), 1000.0))
    except (TypeError, ValueError):
        return default


# ------------------------------------------------------------------ cpu
def _run_cpu_profile(seconds: float) -> pstats.Stats:
    prof = cProfile.Profile()
    prof.enable()
    time.sleep(seconds)  # observes only what THIS thread runs: the sleep
    prof.disable()
    return pstats.Stats(prof)


def _stats_text(stats: pstats.Stats, sort: str = "cumulative",
                limit: int = 60) -> str:
    out = io.StringIO()
    stats.stream = out
    stats.sort_stats(sort).print_stats(limit)
    return out.getvalue()


def _render_profile_text(prof, title: str) -> str:
    """The /hotspots/cpu (and /hotspots/continuous) text report: summary,
    role/phase breakdowns, flat top-self, then the folded stacks."""
    d = prof.to_dict()
    total = max(d["samples"], 1)
    cpu = d["cpu_samples"]
    lines = [
        f"# {title}",
        f"# samples={d['samples']} cpu={cpu} "
        f"({100.0 * cpu / total:.1f}%) ticks={d['ticks']} "
        f"dropped={d['dropped_ticks']} overruns={d['overruns']} "
        f"sampler_overhead={d['overhead_pct']:.2f}%",
        "# (cProfile single-thread engine available via ?engine=cprofile; "
        "?format=folded for the raw artifact, ?format=json for metadata)",
        "#",
        "# by role (wall samples): " + " ".join(
            f"{r}={n}" for r, n in sorted(d["by_role"].items(),
                                          key=lambda kv: -kv[1])),
        "# by phase (cpu samples): " + " ".join(
            f"{p}={n}" for p, n in sorted(prof.by_phase(cpu_only=True)
                                          .items(), key=lambda kv: -kv[1])),
        "#",
        "# top self (cpu samples):",
    ]
    cpu_total = max(cpu, 1)
    for frame, n in prof.top_self(25, cpu_only=True):
        lines.append(f"# {100.0 * n / cpu_total:6.1f}% {n:>7d}  {frame}")
    lines.append("#")
    lines.append("# folded stacks (wall; role/phase tagged):")
    lines.extend(prof.folded_lines())
    return "\n".join(lines) + "\n"


def _profile_response(prof, http: HttpMessage, title: str):
    fmt = http.query.get("format", "")
    if fmt == "json":
        return 200, "application/json", json.dumps(
            {**prof.to_dict(),
             "top_self_cpu": prof.top_self(25, cpu_only=True)}, indent=1)
    if fmt == "folded":
        return 200, CONTENT_TEXT, "\n".join(prof.folded_lines()) + "\n"
    return 200, CONTENT_TEXT, _render_profile_text(prof, title)


def cpu_service(server, http: HttpMessage):
    """/hotspots/cpu?seconds=N&hz=H — whole-process statistical profile
    (every thread, role- and phase-attributed). ?engine=cprofile opts into
    the legacy single-thread instrumenting engine."""
    if not _lock.acquire(blocking=False):
        return 503, CONTENT_TEXT, "another profile is running\n"
    try:
        seconds = _seconds(http)
        if http.query.get("engine") == "cprofile":
            stats = _run_cpu_profile(seconds)
            return 200, CONTENT_TEXT, (
                f"# cpu profile over {seconds:.1f}s "
                f"(cProfile; calling thread ONLY)\n"
                + _CPROFILE_HEADER + _stats_text(stats))
        hz = _hz(http)
        prof = _sampler.run_profile(seconds, hz)
        return _profile_response(
            prof, http,
            f"cpu wall profile over {seconds:.1f}s at {hz:g}hz "
            f"(sampler; whole process, all threads)")
    finally:
        _lock.release()


def _merge_worker_stacks(prof, server) -> None:
    """Fold shard-worker stacks into a continuous-profiler query: each
    worker process samples itself and ships top folded lines home over
    its ring (W_PROF), already role-tagged ``worker:<i>/...`` by the
    registry prefix — so one /hotspots/continuous view covers the whole
    plane, parent and workers."""
    plane = getattr(server, "_shard_plane", None) if server is not None \
        else None
    if plane is None:
        return
    for ln in plane.worker_folded_lines():
        try:
            stack, n = ln.rsplit(" ", 1)
            parts = stack.split(";")
            role = phase = ""
            while parts and (parts[0].startswith("role=")
                             or parts[0].startswith("phase=")):
                head = parts.pop(0)
                if head.startswith("role="):
                    role = head[5:]
                else:
                    phase = head[6:]
            prof.add(role, phase, tuple(parts), int(n))
        except (ValueError, IndexError):
            continue


# ------------------------------------------------------------ continuous
def continuous_service(server, http: HttpMessage):
    """/hotspots/continuous — query the always-on low-rate profiler's
    window ring. No params: list windows. ?from=&to= (epoch seconds;
    negative = relative to now) merge the overlapping windows.
    ?base_from=&base_to= additionally diff base -> [from,to] (top
    self-time movers)."""
    cont = _sampler.ensure_continuous_started()
    q = http.query

    def _ts(name):
        raw = q.get(name)
        if raw in (None, ""):
            return None
        try:
            v = float(raw)
        except ValueError:
            return None
        return time.time() + v if v <= 0 else v

    frm, to = _ts("from"), _ts("to")
    if frm is None and to is None:
        wins = cont.windows()
        lines = [
            "# continuous profiler ring "
            f"({len(wins)} windows; hz/window/retention via "
            "tpu_prof_continuous_hz / tpu_prof_window_s / "
            "tpu_prof_ring_windows flags)",
            "# query: ?from=-300&to=0 merges the last 5 minutes; add "
            "&base_from=-600&base_to=-300 to diff; &format=folded|json",
        ]
        for i, w in enumerate(wins):
            lines.append(
                f"window[{i}] start={w.start_ts:.1f} end={w.end_ts:.1f} "
                f"hz={w.hz:g} samples={w.samples} cpu={w.cpu_samples()}")
        return 200, CONTENT_TEXT, "\n".join(lines) + "\n"

    prof = cont.query(frm, to)
    _merge_worker_stacks(prof, server)
    b_frm, b_to = _ts("base_from"), _ts("base_to")
    if b_frm is not None or b_to is not None:
        from brpc_tpu_torch.profiling import diff as _diff

        base = cont.query(b_frm, b_to)
        report = _diff.diff_folded(base, prof)
        if q.get("format") == "json":
            return 200, "application/json", json.dumps(report, indent=1)
        return 200, CONTENT_TEXT, _diff.render_text(report)
    return _profile_response(
        prof, http,
        f"continuous profile [{prof.start_ts:.1f}, {prof.end_ts:.1f}] "
        f"({prof.ticks} ticks merged from the ring)")


# ------------------------------------------------------------------ heap
_heap_baseline = None


def heap_service(server, http: HttpMessage):
    """/hotspots/heap — top allocation sites right now (tracemalloc)."""
    if not tracemalloc.is_tracing():
        tracemalloc.start(16)
        return (200, CONTENT_TEXT,
                "heap tracing just started — request again for a snapshot\n")
    snap = tracemalloc.take_snapshot()
    lines = ["# heap snapshot: top allocation sites (tracemalloc)"]
    for stat in snap.statistics("lineno")[:60]:
        lines.append(f"{stat.size:>12d} B {stat.count:>8d} blocks  "
                     f"{stat.traceback}")
    total = sum(s.size for s in snap.statistics("filename"))
    lines.append(f"# total traced: {total} bytes")
    return 200, CONTENT_TEXT, "\n".join(lines) + "\n"


def growth_service(server, http: HttpMessage):
    """/hotspots/growth — allocation growth since the previous call
    (the reference's MallocExtension growth stacks)."""
    global _heap_baseline
    if not tracemalloc.is_tracing():
        tracemalloc.start(16)
    snap = tracemalloc.take_snapshot()
    if _heap_baseline is None:
        _heap_baseline = snap
        return (200, CONTENT_TEXT,
                "growth baseline captured — request again to diff\n")
    diffs = snap.compare_to(_heap_baseline, "lineno")
    _heap_baseline = snap
    lines = ["# heap growth since previous /hotspots/growth"]
    for d in diffs[:60]:
        if d.size_diff == 0:
            continue
        lines.append(f"{d.size_diff:>+12d} B {d.count_diff:>+8d} blocks  "
                     f"{d.traceback}")
    return 200, CONTENT_TEXT, "\n".join(lines) + "\n"


# ------------------------------------------------------------- contention
def contention_service(server, http: HttpMessage):
    """/hotspots/contention — lock/butex wait hotspots: per-site wait
    totals plus sampled waiter STACKS captured at the wait sites."""
    from brpc_tpu_torch.fiber import butex as _butex
    from brpc_tpu_torch.fiber import runtime

    lines = ["# contention (fiber runtime)"]
    stats = getattr(runtime, "contention_stats", None)
    stacks = _butex.contention_stacks()
    if callable(stats):
        for site, waits, wait_ns in stats():
            lines.append(f"{wait_ns / 1e6:>12.2f} ms {waits:>8d} waits  {site}")
            for folded, n, ns in stacks.get(site, ())[:4]:
                lines.append(f"{'':>12}    stack x{n} "
                             f"({ns / 1e6:.2f} ms): {folded}")
    else:
        # fall back to a thread-stack sample: threads inside lock.acquire
        frames = sys._current_frames()
        for tid, frame in frames.items():
            import traceback as _tb

            stack = _tb.extract_stack(frame)
            if any("acquire" in (f.name or "") or "wait" in (f.name or "")
                   for f in stack[-3:]):
                lines.append(f"thread {tid} blocked at "
                             f"{stack[-1].filename}:{stack[-1].lineno} "
                             f"({stack[-1].name})")
    if len(lines) == 1:
        lines.append("(no contention observed)")
    return 200, CONTENT_TEXT, "\n".join(lines) + "\n"


# ---------------------------------------------------------------- pprof
def pprof_profile_service(server, http: HttpMessage):
    """/pprof/profile?seconds=N&hz=H — collapsed-stack format (flamegraph
    and pprof both ingest it), from the whole-process sampler.
    ?engine=cprofile emits the legacy caller;callee weights (calling
    thread only)."""
    if not _lock.acquire(blocking=False):
        return 503, CONTENT_TEXT, "another profile is running\n"
    try:
        seconds = _seconds(http)
        if http.query.get("engine") == "cprofile":
            stats = _run_cpu_profile(seconds)
            lines = [_CPROFILE_HEADER.rstrip("\n")]
            for (filename, lineno, name), (cc, nc, tt, ct, callers) in \
                    stats.stats.items():
                frame = f"{filename.rsplit('/', 1)[-1]}:{lineno}:{name}"
                # weight = time in microseconds so small profiles don't all
                # collapse to zero
                weight = max(int(tt * 1e6), 0)
                if weight and not callers:
                    lines.append(f"{frame} {weight}")
                for (cfile, cline, cname), (ccc, cnc, ctt, cct) in \
                        callers.items():
                    cframe = f"{cfile.rsplit('/', 1)[-1]}:{cline}:{cname}"
                    w = max(int(cct * 1e6), 1)
                    lines.append(f"{cframe};{frame} {w}")
            return 200, CONTENT_TEXT, "\n".join(lines) + "\n"
        prof = _sampler.run_profile(seconds, _hz(http))
        return 200, CONTENT_TEXT, "\n".join(prof.folded_lines()) + "\n"
    finally:
        _lock.release()


def flame_service(server, http: HttpMessage):
    """/hotspots/flame?seconds=N&hz=H — self-contained HTML flame graph
    from the whole-process sampler (wall-time stacks — including lock
    waits cProfile misses; costs ~nothing while idle)."""
    if not _lock.acquire(blocking=False):
        return 503, CONTENT_TEXT, "another profile is running\n"
    try:
        seconds = min(_seconds(http), 30.0)
        prof = _sampler.run_profile(seconds, _hz(http, 200.0))
        root: dict = {}
        total = prof.samples
        for (role, phase, stack), n in prof.counts.items():
            node = root
            for name in (f"role={role}", f"phase={phase}") + stack:
                nd = node.setdefault(name, {"n": 0, "c": {}})
                nd["n"] += n
                node = nd["c"]

        import html as _html

        def render(children: dict, parent_n: int, depth: int) -> list:
            out = []
            for name, nd in sorted(children.items(), key=lambda kv:
                                   -kv[1]["n"]):
                pct = 100.0 * nd["n"] / max(total, 1)
                width = 100.0 * nd["n"] / max(parent_n, 1)
                if pct < 0.3 or depth > 50:
                    continue
                hue = 10 + (hash(name) % 40)
                esc = _html.escape(name, quote=True)  # <module>/<lambda>...
                out.append(
                    f'<div class="f" style="width:{width:.2f}%;'
                    f'background:hsl({hue},85%,{70 - min(depth, 20)}%)" '
                    f'title="{esc} — {pct:.1f}% ({nd["n"]} samples)">'
                    f'<span>{_html.escape(name.split(":")[-1])}</span>')
                out += render(nd["c"], nd["n"], depth + 1)
                out.append("</div>")
            return out

        body = "".join(render(root, total, 0))
        html = (
            "<!doctype html><title>flame</title><style>"
            ".f{display:inline-block;vertical-align:top;overflow:hidden;"
            "white-space:nowrap;font:10px monospace;border:1px solid #fff;"
            "box-sizing:border-box;min-height:14px}"
            ".f>span{pointer-events:none}</style>"
            f"<p>{total} samples over {seconds:.1f}s "
            "(hover a frame for file:line; width = share of parent)</p>"
            f"<div style='width:100%'>{body}</div>")
        return 200, "text/html", html
    finally:
        _lock.release()


def pprof_heap_service(server, http: HttpMessage):
    return heap_service(server, http)


def pprof_symbol_service(server, http: HttpMessage):
    """pprof probes this to decide symbolization; Python stacks are already
    symbolized."""
    return 200, CONTENT_TEXT, "num_symbols: 1\n"


def pprof_cmdline_service(server, http: HttpMessage):
    return 200, CONTENT_TEXT, "\x00".join(sys.argv) + "\n"


# ------------------------------------------------------------------ vlog
def vlog_service(server, http: HttpMessage):
    """/vlog — list logger levels; /vlog?logger=name&level=DEBUG sets one
    (the reference's VLOG site toggling)."""
    q = http.query
    if q.get("logger") is not None:
        name = q.get("logger") or None
        level = (q.get("level") or "INFO").upper()
        if level not in ("DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL"):
            return 400, CONTENT_TEXT, f"bad level {level!r}\n"
        logging.getLogger(name).setLevel(level)
        return 200, CONTENT_TEXT, f"{name or 'root'} -> {level}\n"
    lines = ["# loggers (set with /vlog?logger=<name>&level=<LEVEL>)"]
    all_loggers = [logging.getLogger()] + [
        logging.getLogger(n)
        for n in sorted(logging.root.manager.loggerDict)
    ]
    for lg in all_loggers:
        if isinstance(lg, logging.PlaceHolder):
            continue
        eff = logging.getLevelName(lg.getEffectiveLevel())
        own = (logging.getLevelName(lg.level) if lg.level else "-")
        lines.append(f"{lg.name or 'root':<50} level={own:<8} eff={eff}")
    return 200, CONTENT_TEXT, "\n".join(lines) + "\n"


def _sub(http: HttpMessage) -> str:
    parts = http.path.strip("/").split("/", 1)
    return parts[1] if len(parts) > 1 else ""


_HOTSPOTS = {"cpu": cpu_service, "heap": heap_service,
             "growth": growth_service, "contention": contention_service,
             "flame": flame_service, "continuous": continuous_service}
_PPROF = {"profile": pprof_profile_service, "heap": pprof_heap_service,
          "symbol": pprof_symbol_service, "cmdline": pprof_cmdline_service}


def hotspots_service(server, http: HttpMessage):
    sub = _sub(http)
    handler = _HOTSPOTS.get(sub)
    if handler is None:
        return 200, CONTENT_TEXT, (
            "profilers: " + " ".join(f"/hotspots/{k}" for k in _HOTSPOTS)
            + "\n")
    return handler(server, http)


def pprof_service(server, http: HttpMessage):
    handler = _PPROF.get(_sub(http))
    if handler is None:
        return 404, CONTENT_TEXT, (
            "endpoints: " + " ".join(f"/pprof/{k}" for k in _PPROF) + "\n")
    return handler(server, http)


register_builtin("hotspots", hotspots_service,
                 "cpu/heap/growth/contention/continuous profilers")
register_builtin("pprof", pprof_service, "pprof-compatible endpoints")
register_builtin("vlog", vlog_service, "list/set logger levels")
