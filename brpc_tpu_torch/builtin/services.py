"""The builtin service handlers (reference src/brpc/builtin/*).

Each handler renders plain text (curl-friendly) unless the client is a
browser asking for HTML (the reference's use_html sniffing via the
User-Agent). Registered into the brpc_tpu_torch.builtin registry at import.

The port's copy of the JAX package's ``builtin/services.py``: every page
it registers is here. ``/fleet`` and ``/slo`` read the fleet observer and
the SLO engine (``fleet/``), ``/tpu`` carries the shard plane's section
when the server runs one. ``/serving`` reads each engine's host-side
counters (``ServingEngine.snapshot``), never a device tensor, so a fetch
issues no device sync.
"""

from __future__ import annotations

import json
import os
import sys
import time

import brpc_tpu_torch
from brpc_tpu_torch import flags as _flags
from brpc_tpu_torch.builtin import register_builtin
from brpc_tpu_torch.metrics import dump_exposed, prometheus_text
from brpc_tpu_torch.policy.http_protocol import (
    CONTENT_HTML,
    CONTENT_JSON,
    CONTENT_TEXT,
    HttpMessage,
)

_start_time = time.time()


def _wants_html(http: HttpMessage) -> bool:
    return "text/html" in http.header("accept", "")


def _sub_path(http: HttpMessage) -> str:
    parts = http.path.strip("/").split("/", 1)
    return parts[1] if len(parts) > 1 else ""


# ---------------------------------------------------------------------- index
def index_service(server, http: HttpMessage):
    from brpc_tpu_torch.builtin import list_builtin

    if _wants_html(http):
        rows = "".join(
            f'<li><a href="/{s.name}">/{s.name}</a> — {s.help}</li>'
            for s in list_builtin())
        body = (f"<html><head><title>brpc_tpu_torch</title></head><body>"
                f"<h1>brpc_tpu_torch {brpc_tpu_torch.__version__}</h1>"
                f"<ul>{rows}</ul></body></html>")
        return 200, CONTENT_HTML, body
    lines = [f"/{s.name:<16} {s.help}" for s in list_builtin()]
    return 200, CONTENT_TEXT, "\n".join(lines) + "\n"


# --------------------------------------------------------------------- status
def _rss_kb() -> int:
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * (os.sysconf("SC_PAGE_SIZE") // 1024)
    except (OSError, ValueError, IndexError):
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss


def status_service(server, http: HttpMessage):
    import tracemalloc

    from brpc_tpu_torch.profiling import registry as _prof_reg
    from brpc_tpu_torch.profiling import continuous as _prof_cont

    by_role = _prof_reg.threads_by_role()
    roles = " ".join(f"{r}={n}" for r, n in sorted(by_role.items()))
    cont = _prof_cont()
    out = [f"version: {brpc_tpu_torch.__version__}",
           f"uptime_s: {time.time() - _start_time:.0f}",
           f"rss_kb: {_rss_kb()}",
           f"threads: {sum(by_role.values())} ({roles})",
           f"tracemalloc: {'on' if tracemalloc.is_tracing() else 'off'}",
           f"continuous_profiler: "
           f"{'running' if cont is not None and cont.is_alive() else 'off'}",
           "profilers: /hotspots/cpu /hotspots/continuous "
           "/hotspots/contention /hotspots/heap /pprof/profile /flame"]
    if server is not None:
        ep = server.listen_endpoint()
        out += [f"listen: {ep}",
                f"connections: {server.connection_count()}",
                f"concurrency: {server.concurrency}",
                f"requests_processed: {server.requests_processed.get_value()}"]
        for sname, svc in sorted(server.services.items()):
            out.append(f"\n[{sname}]")
            for mname, entry in sorted(svc._methods.items()):
                lr = entry.latency
                out.append(
                    f"  {mname}: count={lr.count()} qps={lr.qps():.1f} "
                    f"latency={lr.latency():.0f}us "
                    f"p50={lr.latency_percentile(0.5):.0f}us "
                    f"p90={lr.latency_percentile(0.9):.0f}us "
                    f"p99={lr.latency_percentile(0.99):.0f}us "
                    f"max={lr.max_latency():.0f}us "
                    f"concurrency={entry.current_concurrency} "
                    f"errors={entry.errors_count.get_value()}")
        native = server.native_method_stats() \
            if hasattr(server, "native_method_stats") else []
        for sname, mname, st in native:
            out.append(
                f"\n[{sname}] (native)\n"
                f"  {mname}: count={st['requests']} "
                f"latency={st['latency_avg_us']:.0f}us "
                f"max={st['latency_max_us']:.0f}us "
                f"concurrency={st['concurrency']} "
                f"errors={st['errors']}")
    return 200, CONTENT_TEXT, "\n".join(out) + "\n"


# ----------------------------------------------------------------------- vars
CONTENT_SVG = "image/svg+xml"


def vars_service(server, http: HttpMessage):
    from brpc_tpu_torch.metrics.series import global_series

    name = _sub_path(http)
    snapshot = dump_exposed()
    if name:
        if name not in snapshot:
            return 404, CONTENT_TEXT, f"no var {name!r}\n"
        series = global_series().get(name)
        sd = series.to_dict() if series is not None else None
        if http.query.get("series") == "json":
            if sd is None:
                return 404, CONTENT_TEXT, f"no series for {name!r}\n"
            return 200, CONTENT_JSON, json.dumps({name: sd}) + "\n"
        if http.query.get("format") == "svg":
            from brpc_tpu_torch.builtin.series_plot import var_svg

            if sd is None:
                return 404, CONTENT_TEXT, f"no series for {name!r}\n"
            return 200, CONTENT_SVG, var_svg(name, sd)
        if _wants_html(http):
            from brpc_tpu_torch.builtin.series_plot import detail_page_html

            return 200, CONTENT_HTML, detail_page_html(
                name, str(snapshot[name]), sd)
        out = f"{name} : {snapshot[name]}\n"
        if sd is not None:
            sec = sd["second"]
            out += (f"series : {sd['count']} samples, "
                    f"last={sd['last']} "
                    f"1s[-10:]={sec[-10:]} (?series=json, ?format=svg)\n")
        return 200, CONTENT_TEXT, out
    if http.query.get("series") == "json":
        from brpc_tpu_torch.fleet.merge import snapshot_vars

        glob = http.query.get("name", "*")
        dump = global_series().dump(glob)
        return 200, CONTENT_JSON, json.dumps(
            {"workers": getattr(server, "shard_worker_count", 0)
             if server is not None else 0,
             "series": dump,
             # exact last values + merge op + prometheus type per var —
             # the fleet observer's scrape unit (Adder sums over members
             # stay exact because this is the live value, not a series
             # sample)
             "vars": snapshot_vars()}) + "\n"
    body = "".join(f"{k} : {v}\n" for k, v in snapshot.items())
    return 200, CONTENT_TEXT, body


# ---------------------------------------------------------------------- watch
def watch_service(server, http: HttpMessage):
    from brpc_tpu_torch.metrics.watch import global_watch

    rules = global_watch().rules()
    if http.query.get("format") == "json":
        return 200, CONTENT_JSON, json.dumps(
            {"rules": [r.to_dict() for r in rules]}, indent=2) + "\n"
    if not rules:
        return 200, CONTENT_TEXT, "no watch rules installed\n"
    lines = [f"{'state':8} {'rule':28} {'observed':>12}  condition"]
    for r in rules:
        lines.append(f"{r.state:8} {r.name:28} {r.observed:>12.4g}  "
                     f"{r.condition()}")
    return 200, CONTENT_TEXT, "\n".join(lines) + "\n"


# ----------------------------------------------------------------------- vlog
def vlog_service(server, http: HttpMessage):
    """Verbose-log control (reference builtin/vlog_service.cpp), two planes:
    VLOG sites (?setlevel=pattern=N) and python logger levels
    (?logger=name&level=DEBUG)."""
    import logging as _logging

    from brpc_tpu_torch.butil import vlog as _vlog

    if "logger" in http.query:
        name = http.query["logger"]
        level_name = http.query.get("level", "")
        level = _logging.getLevelName(level_name.upper())
        if not isinstance(level, int):
            return 400, CONTENT_TEXT, f"bad level {level_name!r}\n"
        _logging.getLogger(name).setLevel(level)
        return 200, CONTENT_TEXT, f"{name} -> {level_name.upper()}\n"
    if "setlevel" in http.query:
        spec = http.query["setlevel"]
        pattern, _, level = spec.rpartition("=")
        if not pattern:
            return 400, CONTENT_TEXT, "setlevel wants pattern=level\n"
        try:
            n = _vlog.set_vlevel(pattern, int(level))
        except ValueError:
            return 400, CONTENT_TEXT, f"bad level {level!r}\n"
        return 200, CONTENT_TEXT, f"{pattern} -> {level} ({n} modules)\n"
    lines = ["== vlog sites (setlevel=pattern=N) =="]
    lines += [f"{m}={lv}  (sites up to v{seen})"
              for m, lv, seen in _vlog.dump()] or ["(none yet)"]
    lines.append("")
    lines.append("== python loggers (logger=name&level=NAME) ==")
    root = _logging.getLogger()
    names = sorted(n for n in root.manager.loggerDict
                   if n.startswith("brpc_tpu"))
    lines += [f"{n}={_logging.getLevelName(_logging.getLogger(n).level)}"
              for n in names]
    return 200, CONTENT_TEXT, "\n".join(lines) + "\n"


# ---------------------------------------------------------------------- flags
def flags_service(server, http: HttpMessage):
    name = _sub_path(http)
    if name:
        f = _flags.find(name)
        if f is None:
            return 404, CONTENT_TEXT, f"no flag {name!r}\n"
        if "setvalue" in http.query:
            try:
                _flags.set_flag(name, http.query["setvalue"])
            except _flags.FlagError as e:
                return 403, CONTENT_TEXT, f"{e}\n"
            return 200, CONTENT_TEXT, f"{name} set to {f.value!r}\n"
        reload_tag = " [reloadable]" if f.reloadable else ""
        return 200, CONTENT_TEXT, (
            f"{f.name}={f.value!r} (default {f.default!r}){reload_tag}\n"
            f"  {f.help}\n")
    lines = []
    for f in _flags.list_flags():
        tag = " [R]" if f.reloadable else ""
        lines.append(f"{f.name}={f.value!r}{tag}  # {f.help}")
    return 200, CONTENT_TEXT, "\n".join(lines) + "\n"


# ---------------------------------------------------------------- connections
def connections_service(server, http: HttpMessage):
    lines = ["fd  remote                in_bytes  out_bytes  in_msg  out_msg"]
    if server is not None:
        with server._conn_lock:
            conns = list(server._connections)
        for c in sorted(conns, key=lambda s: s.fd):
            lines.append(
                f"{c.fd:<3} {str(c.remote):<21} {c.in_bytes:<9} "
                f"{c.out_bytes:<10} {c.in_messages:<7} {c.out_messages}")
        dp = getattr(server, "_native_dp", None)
        if dp is not None:
            native = dp.server_socks(server)
            if native:
                lines.append("-- native engine conns --")
            for s in sorted(native, key=lambda s: s.conn_id):
                lines.append(
                    f"c{s.conn_id:<2} {str(s.remote):<21} {s.in_bytes:<9} "
                    f"{s.out_bytes:<10} {s.in_messages:<7} {s.out_messages}")
    return 200, CONTENT_TEXT, "\n".join(lines) + "\n"


# -------------------------------------------------------------------- sockets
def sockets_service(server, http: HttpMessage):
    from brpc_tpu_torch.rpc.socket import Socket

    lines = ["socket_id           fd  remote                state"]
    for s in Socket.live_sockets():
        state = "failed" if s.failed else "ok"
        lines.append(f"{s.socket_id:<19} {s.fd:<3} {str(s.remote):<21} {state}")
    return 200, CONTENT_TEXT, "\n".join(lines) + "\n"


# --------------------------------------------------------------------- health
def health_service(server, http: HttpMessage):
    if server is not None and not server.is_running:
        return 503, CONTENT_TEXT, "server is stopping\n"
    return 200, CONTENT_TEXT, "OK\n"


def version_service(server, http: HttpMessage):
    return 200, CONTENT_TEXT, f"brpc_tpu_torch {brpc_tpu_torch.__version__}\n"


# ------------------------------------------------------------------ protobufs
def protobufs_service(server, http: HttpMessage):
    want = _sub_path(http)
    out = []
    if server is not None:
        for sname, svc in sorted(server.services.items()):
            for mname, entry in sorted(svc._methods.items()):
                req = entry.request_class
                resp = entry.response_class
                line = (f"{sname}.{mname}("
                        f"{getattr(req, 'DESCRIPTOR', None) and req.DESCRIPTOR.full_name}"
                        f") returns ("
                        f"{getattr(resp, 'DESCRIPTOR', None) and resp.DESCRIPTOR.full_name})")
                if want and want not in line:
                    continue
                out.append(line)
    return 200, CONTENT_TEXT, "\n".join(out) + "\n"


# -------------------------------------------------------------------- metrics
def prometheus_service(server, http: HttpMessage):
    return 200, CONTENT_TEXT, prometheus_text()


# --------------------------------------------------------------------- fibers
def fibers_service(server, http: HttpMessage):
    from brpc_tpu_torch.fiber.runtime import global_control

    tc = global_control()
    with tc._lock:
        workers = [w for group in tc._workers.values() for w in group]
    lines = [f"workers: {len(workers)}",
             f"tasks_executed: {tc.tasks_executed.get_value()}"]
    for w in workers:
        cur = w.current
        if cur is None:
            state = " idle"
        else:
            fn = getattr(cur, "fn", None)
            name = getattr(fn, "__qualname__", None) or repr(fn)
            state = f" running={name}"
        lines.append(f"  worker[{w.index}] tag={w.tag} "
                     f"queue={len(w.local)} alive={w.is_alive()}{state}")
    return 200, CONTENT_TEXT, "\n".join(lines) + "\n"


# -------------------------------------------------------------------- threads
def threads_service(server, http: HttpMessage):
    from brpc_tpu_torch.butil.debug import dump_all_stacks

    return 200, CONTENT_TEXT, dump_all_stacks()


# --------------------------------------------------------------------- memory
def memory_service(server, http: HttpMessage):
    import gc
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    counts = gc.get_count()
    body = (f"max_rss_kb: {ru.ru_maxrss}\n"
            f"user_time_s: {ru.ru_utime:.2f}\n"
            f"sys_time_s: {ru.ru_stime:.2f}\n"
            f"gc_counts: {counts}\n"
            f"gc_objects: {len(gc.get_objects())}\n")
    return 200, CONTENT_TEXT, body


# ----------------------------------------------------------------------- ids
def ids_service(server, http: HttpMessage):
    from brpc_tpu_torch.fiber import call_id as _cid

    pool = _cid._pool if hasattr(_cid, "_pool") else None
    n = len(pool) if pool is not None else -1
    return 200, CONTENT_TEXT, f"live_call_ids: {n}\n"


# ----------------------------------------------------------------------- rpcz
def rpcz_service(server, http: HttpMessage):
    """Recent sampled spans with phase breakdowns.

    GET /rpcz                         newest-first listing
        ?count=N                      how many rows (default 50)
        ?method=substr                substring match on service.method
        ?min_latency_us=N             only slower spans
        ?error_only=1                 only spans with a non-zero error code
        ?retained=tail                only spans tail retention committed
        ?format=json                  structured export (tools/trace_view.py)
    GET /rpcz/<trace_id hex>          every span of one trace
        ?format=json                  whole-trace JSON export
    """
    from brpc_tpu_torch.trace import span as _span

    as_json = http.query.get("format", "") == "json"
    sub = _sub_path(http)
    if sub:
        try:
            trace_id = int(sub, 16)
        except ValueError:
            return 404, CONTENT_TEXT, "bad trace id\n"
        spans = _span.spans_of_trace(trace_id)
        if not spans:
            return 404, CONTENT_TEXT, f"no spans for trace {sub}\n"
        if as_json:
            body = json.dumps(_span.trace_to_dict(trace_id), indent=2)
            return 200, CONTENT_JSON, body + "\n"
        return 200, CONTENT_TEXT, "".join(s.render() for s in spans)
    try:
        count = int(http.query.get("count", "50"))
        min_latency_us = float(http.query.get("min_latency_us", "0"))
    except ValueError:
        return 400, CONTENT_TEXT, "count/min_latency_us must be numeric\n"
    recent = _span.recent_spans(
        count,
        method=http.query.get("method", ""),
        min_latency_us=min_latency_us,
        error_only=http.query.get("error_only", "") in ("1", "true"),
        retained=http.query.get("retained", ""),
    )
    if as_json:
        body = json.dumps({"spans": [s.to_dict() for s in recent]}, indent=2)
        return 200, CONTENT_JSON, body + "\n"
    lines = ["time                 trace_id         span      kind  "
             "latency_us  method"]
    for s in recent:
        lines.append(s.render_row())
    return 200, CONTENT_TEXT, "\n".join(lines) + "\n"


# ------------------------------------------------------------------------ tpu
def tpu_service(server, http: HttpMessage):
    """tpu:// tunnel observability: window occupancy, borrowed-block peak,
    credit stalls, epochs, and healer/breaker state. ``?format=json`` for
    the structured snapshot."""
    try:
        from brpc_tpu_torch.tpu import transport as _transport
    except Exception as e:  # pragma: no cover - tpu lane absent
        return 200, CONTENT_TEXT, f"tpu transport unavailable: {e}\n"

    state = _transport.tunnel_state()
    state["server_endpoints"] = []
    if server is not None:
        for ep in sorted(getattr(server, "_tpu_endpoints", ()),
                         key=id):
            try:
                state["server_endpoints"].append(ep.state_dict())
            except Exception:  # endpoint torn down mid-snapshot
                continue
    # small-message fastpath observability: adaptive spin budgets, the
    # coalesced-doorbell / priority-lane counters (already in pri_lane),
    # and run-to-completion per-method classification
    from brpc_tpu_torch.fiber import wakeup as _wakeup
    from brpc_tpu_torch.rpc import run_to_completion as _rtc

    state["wakeup"] = _wakeup.stats()
    state["rtc"] = _rtc.stats()
    plane = getattr(server, "_shard_plane", None) if server else None
    if plane is not None:
        state["shard"] = plane.state_dict()
    if http.query.get("format", "") == "json":
        return 200, CONTENT_JSON, json.dumps(state, indent=2) + "\n"

    def _ep_lines(title, eps):
        out = [f"== {title} =="]
        if not eps:
            out.append("(none)")
        for d in eps:
            key = d.get("key") or f"{d.get('remote', '?')}"
            out.append(
                f"{key}  role={d.get('role')} epoch={d.get('epoch')} "
                f"ready={d.get('ready')} failed={d.get('failed')} "
                f"inline_only={d.get('inline_only')}")
            out.append(
                f"  window: free={d.get('window_free')}/"
                f"{d.get('window_total')} "
                f"borrowed_out={d.get('borrowed_outstanding')} "
                f"acks_pending={d.get('acks_pending')} "
                f"credits_released={d.get('credits_released_total')}")
            out.append(
                f"  credit: stalls={d.get('credit_stalls')} "
                f"wait_us={d.get('credit_wait_us', 0.0):.0f}")
            out.append(
                f"  io: in={d.get('in_bytes')}B/{d.get('in_messages')}msg "
                f"out={d.get('out_bytes')}B/{d.get('out_messages')}msg")
        return out

    lines = [f"borrowed_peak_blocks: {state['borrowed_peak_blocks']}", ""]
    lines += _ep_lines("client endpoints", state["client_endpoints"])
    lines.append("")
    lines += _ep_lines("server endpoints", state["server_endpoints"])
    lines.append("")
    lines.append("== healers ==")
    if not state["healers"]:
        lines.append("(none)")
    for h in state["healers"]:
        lines.append(
            f"{h['key']}  gen={h['gen']} dialing={h['dialing']} "
            f"bg_healing={h['bg_healing']} "
            f"breaker_isolated={h['breaker_isolated']} "
            f"last_error={h['last_error'] or '-'}")
    pri = state.get("pri_lane", {})
    lines.append("")
    lines.append("== priority lane / doorbells ==")
    lines.append(
        f"pri_tx={pri.get('tx_frames', 0)} pri_rx={pri.get('rx_frames', 0)} "
        f"pri_bytes={pri.get('bytes', 0)} "
        f"doorbell_flushes={pri.get('doorbell_flushes', 0)} "
        f"doorbell_frames={pri.get('doorbell_frames', 0)}")
    wk = state.get("wakeup", {})
    lines.append("")
    lines.append("== wakeup (adaptive spin) ==")
    lines.append(
        f"spins={wk.get('spins', 0)} wins={wk.get('spin_wins', 0)} "
        f"losses={wk.get('spin_losses', 0)} parks={wk.get('parks', 0)}")
    for name, budget in sorted(wk.get("budgets", {}).items()):
        lines.append(f"  {name}: budget={budget}")
    rtc = state.get("rtc", {})
    lines.append("")
    lines.append("== run-to-completion ==")
    lines.append(
        f"inline_requests={rtc.get('inline_requests', 0)} "
        f"inline_responses={rtc.get('inline_responses', 0)} "
        f"demotions={rtc.get('demotions', 0)}")
    for name, m in sorted(rtc.get("methods", {}).items()):
        lines.append(
            f"  {name}: ema_us={m['ema_us']} samples={m['samples']} "
            f"hits={m['hits']} demoted={m['demoted']} "
            f"opted_in={m['opted_in']}")
    shard = state.get("shard")
    if shard is not None:
        lines.append("")
        lines.append("== shard plane ==")
        lines.append(
            f"workers={shard['workers_configured']} "
            f"generation={shard['generation']} "
            f"forwarded={shard['forwarded']} "
            f"fallback={shard['fallback']} "
            f"fanin_batches={shard['fanin_batches']} "
            f"fanin_frames={shard['fanin_frames']}")
        for wd in shard["workers"]:
            lines.append(
                f"  {wd['role']}: pid={wd['pid']} alive={wd['alive']} "
                f"gen={wd['gen']} respawns={wd['respawns']} "
                f"inflight_cids={wd['inflight_cids']} "
                f"lease_held={wd['lease_held']} "
                f"lease_free={wd['lease_free']} "
                f"dispatched={wd['dispatched']}")
    return 200, CONTENT_TEXT, "\n".join(lines) + "\n"


# ---------------------------------------------------------------------- dump
def dump_service(server, http: HttpMessage):
    """rpc_dump sampler state: gates, g_dump_* counters, the per-method
    sample histogram, and the dump files on disk. ``?format=json`` for the
    structured snapshot."""
    from brpc_tpu_torch.trace import rpc_dump as _dump

    state = {
        "rpc_dump_ratio": _flags.get("rpc_dump_ratio"),
        "rpc_dump_max_per_sec": _flags.get("rpc_dump_max_per_sec"),
        "sampled": _dump.g_dump_sampled.get_value(),
        "skipped": _dump.g_dump_skipped.get_value(),
        "bytes": _dump.g_dump_bytes.get_value(),
        "rotations": _dump.g_dump_rotations.get_value(),
        "errors": _dump.g_dump_errors.get_value(),
    }
    retainer = getattr(server, "tail_retainer", None) \
        if server is not None else None
    if retainer is not None:
        from brpc_tpu_torch.trace import tail as _tail

        state["tail"] = {
            **retainer.state(),
            "retained": _tail.g_dump_tail_retained.get_value(),
            "dropped": _tail.g_dump_tail_dropped.get_value(),
            "shed": _tail.g_dump_tail_shed.get_value(),
        }
    dumper = getattr(server, "rpc_dumper", None) if server is not None else None
    if dumper is not None:
        st = dumper.state()
        try:
            st["files"] = [
                {"name": f,
                 "bytes": os.path.getsize(os.path.join(st["directory"], f))}
                for f in sorted(os.listdir(st["directory"]))
                if f.endswith(".dump")]
        except OSError:
            st["files"] = []
        state["dumper"] = st
    if http.query.get("format", "") == "json":
        return 200, CONTENT_JSON, json.dumps(state, indent=2) + "\n"
    lines = [f"rpc_dump_ratio: {state['rpc_dump_ratio']}",
             f"rpc_dump_max_per_sec: {state['rpc_dump_max_per_sec']}",
             f"sampled: {state['sampled']}  skipped: {state['skipped']}  "
             f"errors: {state['errors']}",
             f"bytes: {state['bytes']}  rotations: {state['rotations']}"]
    if "tail" in state:
        t = state["tail"]
        lines.append(
            f"tail: enabled={t['enabled']} held={t['held']} "
            f"retained={t['retained']} dropped={t['dropped']} "
            f"shed={t['shed']} slow_x={t['slow_x']} hold_s={t['hold_s']} "
            f"max_per_sec={t['max_per_sec']}")
    if dumper is None:
        lines.append("")
        lines.append("this server has no dumper "
                     "(start with ServerOptions(rpc_dump_dir=...))")
    else:
        st = state["dumper"]
        lines.append(f"directory: {st['directory']} "
                     f"(file {st['file_index']}, {st['file_bytes']}B of "
                     f"{st['max_file_bytes']}B)")
        lines.append("")
        lines.append("== per-method samples ==")
        if not st["per_method"]:
            lines.append("(none)")
        for m, n in sorted(st["per_method"].items()):
            lines.append(f"{m}: {n}")
        lines.append("")
        lines.append("== files ==")
        if not st["files"]:
            lines.append("(none)")
        for f in st["files"]:
            lines.append(f"{f['name']}: {f['bytes']}B")
    return 200, CONTENT_TEXT, "\n".join(lines) + "\n"


# --------------------------------------------------------------------- fault
def fault_service(server, http: HttpMessage):
    """Chaos console: inspect / arm / disarm injection points at runtime.

    GET /fault                     registry snapshot (JSON)
    GET /fault/arm?point=X&...     arm (mode=/after=/count=/match_*/params)
    GET /fault/disarm?point=X      disarm one point
    GET /fault/disarm_all          disarm everything

    Arming only changes specs — nothing fires until the master switch
    ``fault_injection_enabled`` is on (flip via /flags)."""
    from brpc_tpu_torch import fault as _fault

    sub = _sub_path(http)
    if sub == "arm":
        point = http.query.get("point", "")
        if not point:
            return 400, CONTENT_TEXT, "arm wants ?point=<name>\n"
        try:
            _fault.parse_spec_kv(point, dict(http.query))
        except (ValueError, TypeError) as e:
            return 400, CONTENT_TEXT, f"bad spec: {e}\n"
        return 200, CONTENT_TEXT, f"armed {point}\n"
    if sub == "disarm":
        point = http.query.get("point", "")
        if not point:
            return 400, CONTENT_TEXT, "disarm wants ?point=<name>\n"
        if not _fault.disarm(point):
            return 404, CONTENT_TEXT, f"{point} was not armed\n"
        return 200, CONTENT_TEXT, f"disarmed {point}\n"
    if sub == "disarm_all":
        n = _fault.disarm_all()
        return 200, CONTENT_TEXT, f"disarmed {n} points\n"
    if sub:
        return 404, CONTENT_TEXT, f"no /fault/{sub}\n"
    body = json.dumps({
        "enabled": bool(_flags.get("fault_injection_enabled")),
        "points": _fault.snapshot(),
    }, indent=2)
    return 200, CONTENT_JSON, body + "\n"


# ------------------------------------------------------------------- serving
def serving_service(server, http: HttpMessage):
    """Serving-plane engines: batch occupancy, KV pool watermark, queue
    depth and step timings. ``?format=json`` for the structured view.

    No engine can run in a process that never imported the engine module,
    so the page reads it only from ``sys.modules``: importing it here
    would load torch inside a scrape (over a second, past a fleet
    observer's fetch limit under load)."""
    engine_mod = sys.modules.get("brpc_tpu_torch.serving.engine")
    active = getattr(engine_mod, "active_engines", None)
    snaps = [e.snapshot() for e in active()] if active is not None else []
    if http.query.get("format", "") == "json":
        return 200, CONTENT_JSON, json.dumps(
            {"engines": snaps}, indent=2) + "\n"
    if not snaps:
        return 200, CONTENT_TEXT, "no serving engine running\n"
    out = []
    for i, s in enumerate(snaps):
        kv = s["kv"]
        out.append(f"[engine {i}] scheduling={s['scheduling']} "
                   f"max_batch={s['max_batch']} "
                   f"token_budget={s['token_budget']}")
        out.append(f"  queue_depth={s['queue_depth']} "
                   f"running={s['running']} steps={s['steps']} "
                   f"tokens={s['tokens_generated']}")
        out.append(f"  batch_occupancy_avg={s['batch_occupancy_avg']} "
                   f"step_us p50={s['step_us_p50']:.0f} "
                   f"p99={s['step_us_p99']:.0f} "
                   f"last={s['last_step_us']:.0f}")
        out.append(f"  ttft_us p50={s['ttft_us_p50']:.0f} "
                   f"p99={s['ttft_us_p99']:.0f} "
                   f"itl_us p50={s['itl_us_p50']:.0f}")
        out.append(f"  kv: {kv['blocks_used']}/{kv['blocks_total']} blocks "
                   f"used ({kv['used_ratio']:.0%}), "
                   f"watermark={kv['watermark']:.0%}, "
                   f"block_size={kv['block_size']}, "
                   f"sequences={kv['sequences']}")
        pfx = s.get("prefix")
        if pfx:
            out.append(
                f"  prefix: nodes={pfx['nodes']} blocks={pfx['blocks']} "
                f"hits seqs={pfx['hit_seqs']} blocks={pfx['hit_blocks']} "
                f"tokens={pfx['hit_tokens']} "
                f"inserted={pfx['inserted_blocks']} "
                f"evicted={pfx['evicted_blocks']} "
                f"hit_ratio={pfx['hit_ratio']:.2f}"
                + ("" if pfx.get("enabled", True) else " (disabled)"))
        # speculative decoding: draft/verify economics — how many tokens
        # each verify launch commits and how many rows it wastes
        sp = s.get("spec")
        if sp:
            out.append(
                f"  spec: k_max={sp['k_max']} drafted={sp['drafted']} "
                f"accepted={sp['accepted']} rejected={sp['rejected']} "
                f"bonus={sp['bonus']} accept_rate={sp['accept_rate']:.2f} "
                f"collapsed_seqs={sp['collapsed_seqs']}")
        # multi-tenant QoS: the limiter ceiling the governor is holding,
        # and each tenant's fair-share lane (weight, backlog, realized
        # token share, sheds)
        qos = s.get("qos")
        if qos:
            lim = qos["limiter"]
            out.append(
                f"  qos: ceiling={lim['ceiling']:.1f} "
                f"inflight={qos['inflight']} "
                f"occupancy={qos['occupancy']:.2f} "
                f"oldest_wait_ms={qos['oldest_wait_ms']:.1f} "
                f"protected_priority>={qos['protected_priority']}")
            for name, t in qos["tenants"].items():
                out.append(
                    f"    [tenant {name}] weight={t['weight']:g} "
                    f"queued={t['queued']} admitted={t['admitted']} "
                    f"tokens={t['admitted_tokens']} "
                    f"share={t['token_share']:.2f} shed={t['shed']}")
        # disaggregated serving: outbound handoff counters on prefill
        # engines, inbound adoption counters on decode engines, plus the
        # parked (adopted-not-yet-attached) sequence count
        mig = s.get("migration")
        if mig:
            line = (f"  migrate: role={s.get('role', 'both')} "
                    f"parked={mig['parked']}")
            mo = mig.get("out")
            if mo:
                line += (f" | out -> {mo['dest']} (shard {mo['dest_shard']})"
                         f" seqs={mo['seqs']} blocks={mo['blocks']} "
                         f"bytes={mo['bytes']} failed={mo['failed']} "
                         f"gbps={mo['gbps']:.3f}")
            mi = mig.get("in")
            if mi:
                line += (f" | in seqs={mi['seqs_in']} "
                         f"failed={mi['failed_in']} "
                         f"pending={mi['pending_in']}")
            out.append(line)
        # sharded pools: per-device occupancy, per-shard step latency,
        # and which shard owns each live sequence's block table
        if "shards" in kv:
            out.append(f"  sharded: n_shards={kv['n_shards']} "
                       f"skew={kv['shard_skew']:.3f}")
            steps = s.get("shard_steps", {})
            for sh in kv["shards"]:
                st = steps.get(sh["shard"], {})
                out.append(
                    f"    [shard {sh['shard']}] "
                    f"{sh['blocks_used']}/{sh['blocks_total']} blocks "
                    f"({sh['used_ratio']:.0%}) seqs={sh['sequences']} "
                    f"step_us last={st.get('last_us', 0)} "
                    f"avg={st.get('avg_us', 0)} "
                    f"devices={','.join(sh['devices'])}")
            if kv.get("shard_map"):
                pairs = " ".join(f"{sid}->{sh}"
                                 for sid, sh in kv["shard_map"].items())
                out.append(f"    shard_map: {pairs}")
    return 200, CONTENT_TEXT, "\n".join(out) + "\n"


# --------------------------------------------------------------------- fleet
def fleet_service(server, http: HttpMessage):
    """Fleet observer state: per-member liveness/staleness, cluster_* var
    coverage, serving shard-map union, fleet-wide firing rules.

    GET /fleet                      member table + cluster summary
        ?format=json                structured snapshot
    GET /fleet/trace/<trace_id>     retained trace stitched across live
                                    members (merge_trace_docs), JSON
    """
    from brpc_tpu_torch.fleet.observer import global_observer

    obs = global_observer()
    sub = _sub_path(http)
    if sub.startswith("trace/"):
        if obs is None:
            return 404, CONTENT_TEXT, "no fleet observer running\n"
        doc = obs.fleet_trace(sub[len("trace/"):])
        if not doc.get("spans"):
            return 404, CONTENT_TEXT, "no spans on any live member\n"
        return 200, CONTENT_JSON, json.dumps(doc, indent=2) + "\n"
    if sub:
        return 404, CONTENT_TEXT, f"no /fleet/{sub}\n"
    if obs is None:
        return 200, CONTENT_TEXT, (
            "no fleet observer running\n"
            "(FleetObserver('list://h1:p1,h2:p2').start() then "
            "set_global_observer(obs))\n")
    doc = obs.to_dict()
    if http.query.get("format", "") == "json":
        return 200, CONTENT_JSON, json.dumps(doc, indent=2) + "\n"
    lines = [f"fleet: {doc['live']}/{len(doc['members'])} members live, "
             f"{doc['cluster_vars']} cluster vars, "
             f"scrape interval {doc['interval_s']:g}s",
             "",
             f"{'member':24} {'state':7} {'age_s':>8} {'ok':>6} "
             f"{'fail':>6} {'vars':>6}  firing"]
    for m in doc["members"]:
        state = "live" if m["live"] else (
            "stale" if m["stale"] else "down")
        age = f"{m['age_s']:.1f}" if m["age_s"] is not None else "-"
        lines.append(
            f"{m['addr']:24} {state:7} {age:>8} {m['scrapes_ok']:>6} "
            f"{m['scrapes_failed']:>6} {m['vars']:>6}  "
            f"{','.join(m['firing']) or '-'}")
        if m["last_error"]:
            lines.append(f"  last_error: {m['last_error']}")
    if doc["serving_shards"]:
        lines.append("")
        lines.append("== serving shard map (union) ==")
        for key, shard in sorted(doc["serving_shards"].items()):
            lines.append(f"{key} -> {shard}")
    return 200, CONTENT_TEXT, "\n".join(lines) + "\n"


# ----------------------------------------------------------------------- slo
def slo_service(server, http: HttpMessage):
    """SLO objectives and their error-budget burn rates (?format=json)."""
    from brpc_tpu_torch.fleet.slo import global_slo

    doc = global_slo().to_dict()
    if http.query.get("format", "") == "json":
        return 200, CONTENT_JSON, json.dumps(doc, indent=2) + "\n"
    if not doc["objectives"]:
        return 200, CONTENT_TEXT, (
            "no slo objectives installed\n"
            "(set the slo_objectives flag: "
            "'name:var=<stem>,bound_ms=...,objective=...')\n")
    lines = [f"burn threshold: {doc['threshold']:g}  "
             f"(series source: {doc['source']})",
             "",
             f"{'objective':20} {'burn':>8} {'fast':>8} {'slow':>8} "
             f"{'budget':>8}  rule"]
    for o in doc["objectives"]:
        rule = o.get("rule") or {}
        lines.append(
            f"{o['name']:20} {o['burn']:>8.3f} {o['burn_fast']:>8.3f} "
            f"{o['burn_slow']:>8.3f} {o['budget_left']:>8.3f}  "
            f"{rule.get('state', 'no rule')}")
        bound = o["latency_bound_us"]
        parts = []
        if o["latency_var"] and bound:
            parts.append(f"p99({o['latency_var']}) <= {bound:g}us")
        if o["errors_var"]:
            parts.append(f"errors({o['errors_var']}/{o['total_var']})")
        tenant = f" tenant={o['tenant']}" if o["tenant"] else ""
        lines.append(f"  {' and '.join(parts)} for >= "
                     f"{1.0 - o['objective']:.2%} of seconds{tenant} "
                     f"(windows {o['fast_window_s']}s/{o['slow_window_s']}s)")
    return 200, CONTENT_TEXT, "\n".join(lines) + "\n"


# -------------------------------------------------------------------- logoff
def logoff_service(server, http: HttpMessage):
    if server is None:
        return 400, CONTENT_TEXT, "no server\n"
    server.stop()
    return 200, CONTENT_TEXT, "server is logging off\n"


register_builtin("index", index_service, "this page")
register_builtin("status", status_service, "server + per-method stats")
register_builtin("vars", vars_service,
                 "all exposed metrics (/vars/<name>, ?series=json&name=glob)")
register_builtin("watch", watch_service,
                 "watch rules over series rings (?format=json)")
register_builtin("flags", flags_service,
                 "runtime flags (/flags/<name>?setvalue=v)")
register_builtin("connections", connections_service, "accepted connections")
register_builtin("sockets", sockets_service, "every live socket")
register_builtin("health", health_service, "liveness probe")
register_builtin("version", version_service, "framework version")
register_builtin("protobufs", protobufs_service, "registered rpc methods")
register_builtin("brpc_metrics", prometheus_service, "prometheus exposition")
register_builtin("fibers", fibers_service, "fiber runtime workers")
register_builtin("threads", threads_service, "python thread stacks")
register_builtin("memory", memory_service, "process memory stats")
register_builtin("ids", ids_service, "live call ids")
register_builtin("rpcz", rpcz_service,
                 "recent rpc spans (/rpcz/<trace_id>, ?method= "
                 "?min_latency_us= ?error_only=1 ?format=json)")
register_builtin("tpu", tpu_service,
                 "tpu:// tunnel state: windows, credit stalls, epochs, "
                 "healers")
register_builtin("logoff", logoff_service, "stop accepting new requests")
register_builtin("vlog", vlog_service,
                 "verbose-log sites (/vlog?setlevel=module=N)")
register_builtin("fault", fault_service,
                 "fault injection points (/fault/arm?point=<name>)")
register_builtin("dump", dump_service,
                 "rpc_dump sampler state: counters, per-method histogram, "
                 "dump files")
register_builtin("serving", serving_service,
                 "serving engines: batch occupancy, kv watermark, queue "
                 "depth, step timings, qos tenant lanes, per-shard "
                 "occupancy/latency (?format=json)")
register_builtin("fleet", fleet_service,
                 "fleet observer: member liveness, cluster_* merge, "
                 "serving shard union (/fleet/trace/<tid>, ?format=json)")
register_builtin("slo", slo_service,
                 "slo objectives and error-budget burn rates "
                 "(?format=json)")
