"""Span — one timed segment of an RPC, the unit of /rpcz.

Rebuild of ``src/brpc/span.h:47-88`` / ``span.cpp``: a client span is born
in Channel.call_method, a server span in request processing; both carry
trace_id/span_id/parent_span_id (propagated via RpcMeta, SURVEY §5.1) and a
list of timestamped annotations. Finished spans land in a bounded in-memory
SpanDB (the reference persists to disk via the bvar Collector; our DB is a
ring — the /rpcz surface is identical, the storage budget explicit).

Beyond the reference, spans carry a **phase timeline**: typed duration
marks (:data:`PHASE_NAMES` — queue/parse/credit_wait/send/batch_wait/
execute/respond) accumulated by the layers a request crosses, plus a
bounded list of structured **events** (credit stalls, send quanta, healer
dials, epoch restarts, batch flushes). Durations are measured on the
monotonic clock (``time.monotonic_ns``); the wall clock is kept only for
the displayed start timestamp, so NTP skew can't produce negative or
inflated latencies. ``to_dict``/``trace_to_dict`` export the whole
timeline as JSON for ``/rpcz?format=json`` and ``tools/trace_view.py``.

Sampling: ``rpcz_sample_ratio`` flag (1.0 = record everything). The
decision is made once per trace at the root and inherited downstream, so a
trace is either fully recorded or not at all.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from brpc_tpu_torch import flags as _flags

SPAN_DB_CAPACITY = 10000

KIND_CLIENT = "client"
KIND_SERVER = "server"

# The typed phase vocabulary. add_phase accepts any name, but
# only these roll up into the process-wide g_span_phase_* aggregates so a
# buggy caller can't mint unbounded /vars.
PHASE_NAMES = ("queue_us", "parse_us", "credit_wait_us", "send_us",
               "batch_wait_us", "execute_us", "respond_us",
               # serving plane: prompt prefill and the request's share of
               # each fused decode step, stamped by the engine's step loop
               "prefill_us", "decode_us")

# Hard cap on structured events per span: a 16MB streaming send emits one
# event per pipeline quantum, which is bounded, but a pathological retry
# loop isn't — drop past the cap and count the drops.
MAX_EVENTS_PER_SPAN = 64


def _mono_us() -> float:
    return time.monotonic_ns() / 1000.0


class Span:
    __slots__ = ("trace_id", "span_id", "parent_span_id", "kind",
                 "service", "method", "peer", "start_us", "end_us",
                 "start_mono_us", "end_mono_us",
                 "error_code", "request_size", "response_size",
                 "annotations", "phases", "events", "events_dropped",
                 "retained_reason", "_ended")

    def __init__(self, trace_id: int, span_id: int, parent_span_id: int,
                 kind: str, service: str = "", method: str = "",
                 peer: str = ""):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id
        self.kind = kind
        self.service = service
        self.method = method
        self.peer = peer
        # wall clock for display/cross-process alignment only; all
        # durations come from the monotonic pair below.
        self.start_us = time.time() * 1e6  # tpulint: disable=monotonic-clock
        self.end_us = 0.0
        self.start_mono_us = _mono_us()
        self.end_mono_us = 0.0
        self.error_code = 0
        self.request_size = 0
        self.response_size = 0
        self.annotations: List = []  # (offset_us from start, text)
        self.phases: Dict[str, float] = {}
        self.events: List = []  # (offset_us from start, name, fields dict)
        self.events_dropped = 0
        # non-empty once tail retention committed this span to rpc_dump
        # ("slow_p99" / "error" / "qos_shed" / "watch:<rule>") — the
        # /rpcz?retained=tail filter key
        self.retained_reason = ""
        self._ended = False

    # ------------------------------------------------------------ lifecycle
    def annotate(self, text: str) -> None:
        """TRACEPRINTF equivalent."""
        self.annotations.append((_mono_us() - self.start_mono_us, text))

    def add_phase(self, name: str, us: float) -> None:
        """Accumulate ``us`` microseconds into the named phase (a phase
        may be touched several times — e.g. credit_wait once per send
        quantum — and the mark is the sum)."""
        if us < 0.0:
            us = 0.0
        self.phases[name] = self.phases.get(name, 0.0) + us

    def event(self, name: str, **fields) -> None:
        """Record a structured point-in-time event (credit stall, send
        quantum, healer dial, epoch restart, batch flush...)."""
        if len(self.events) >= MAX_EVENTS_PER_SPAN:
            self.events_dropped += 1
            return
        self.events.append((_mono_us() - self.start_mono_us, name, fields))

    def end(self, error_code: int = 0) -> None:
        if self._ended:
            return
        self._ended = True
        # display twin of end_mono_us, never differenced against a start
        self.end_us = time.time() * 1e6  # tpulint: disable=monotonic-clock
        self.end_mono_us = _mono_us()
        self.error_code = error_code
        _account_phases(self.phases)
        _db_add(self)
        _maybe_export(self)

    @property
    def latency_us(self) -> float:
        return (self.end_mono_us or _mono_us()) - self.start_mono_us

    # ------------------------------------------------------------ export
    def to_dict(self) -> Dict[str, Any]:
        """JSON-shaped export (trace -> spans -> phases/events), the unit
        of ``/rpcz?format=json`` consumed by tools/trace_view.py."""
        d: Dict[str, Any] = {
            "trace_id": f"{self.trace_id:016x}",
            "span_id": f"{self.span_id:016x}",
            "parent_span_id": f"{self.parent_span_id:016x}",
            "kind": self.kind,
            "service": self.service,
            "method": self.method,
            "peer": self.peer,
            "start_us": self.start_us,
            "latency_us": self.latency_us,
            "error_code": self.error_code,
            "request_size": self.request_size,
            "response_size": self.response_size,
            "phases": {k: round(v, 1) for k, v in self.phases.items()},
            "events": [{"offset_us": round(off, 1), "name": name,
                        **fields} for off, name, fields in self.events],
            "annotations": [{"offset_us": round(off, 1), "text": text}
                            for off, text in self.annotations],
        }
        if self.events_dropped:
            d["events_dropped"] = self.events_dropped
        if self.retained_reason:
            d["retained_reason"] = self.retained_reason
        return d

    # ------------------------------------------------------------ rendering
    def render_row(self) -> str:
        ts = time.strftime("%Y-%m-%d %H:%M:%S",
                           time.localtime(self.start_us / 1e6))
        return (f"{ts}  {self.trace_id:016x} {self.span_id:08x}  "
                f"{self.kind:<6}{self.latency_us:>10.0f}  "
                f"{self.service}.{self.method}")

    def render(self) -> str:
        out = [self.render_row()]
        if self.peer:
            out.append(f"    peer={self.peer}")
        if self.error_code:
            out.append(f"    error_code={self.error_code}")
        out.append(f"    request_size={self.request_size} "
                   f"response_size={self.response_size}")
        if self.phases:
            total = self.latency_us or 1.0
            parts = []
            for name in PHASE_NAMES:
                if name in self.phases:
                    v = self.phases[name]
                    parts.append(f"{name[:-3]}={v:.0f}us"
                                 f"({100.0 * v / total:.0f}%)")
            for name, v in self.phases.items():
                if name not in PHASE_NAMES:
                    parts.append(f"{name}={v:.0f}us")
            out.append("    phases: " + " ".join(parts))
        for off, name, fields in self.events:
            kv = " ".join(f"{k}={v}" for k, v in fields.items())
            out.append(f"    +{off:.0f}us  [{name}] {kv}".rstrip())
        if self.events_dropped:
            out.append(f"    ... {self.events_dropped} events dropped")
        for off, text in self.annotations:
            out.append(f"    +{off:.0f}us  {text}")
        return "\n".join(out) + "\n"


# ---------------------------------------------------- phase aggregation
# Process-wide per-phase totals, exported on /vars and prometheus_text as
# g_span_phase_<name> (microsecond counters across all sampled spans).
_phase_adders: Dict[str, Any] = {}
_phase_lock = threading.Lock()


def _account_phases(phases: Dict[str, float]) -> None:
    if not phases:
        return
    from brpc_tpu_torch.metrics.reducer import Adder

    for name in phases:
        if name not in PHASE_NAMES:
            continue
        adder = _phase_adders.get(name)
        if adder is None:
            with _phase_lock:
                adder = _phase_adders.get(name)
                if adder is None:
                    adder = Adder(f"g_span_phase_{name}")
                    _phase_adders[name] = adder
        adder.put(int(phases[name]))


# ------------------------------------------------------------------- export
# OTLP/JSON-lines export hook (trace/export.py). Module cached after the
# first ended span; with span_export_path empty the call is one dict
# lookup, so untraced deployments pay nothing.
_export_mod = None


def _maybe_export(span: "Span") -> None:
    global _export_mod
    if _export_mod is None:
        from brpc_tpu_torch.trace import export as _export_mod_imported

        _export_mod = _export_mod_imported
    _export_mod.maybe_export(span)


# -------------------------------------------------------------------- SpanDB
_db: deque = deque(maxlen=SPAN_DB_CAPACITY)
_by_trace: Dict[int, List[Span]] = {}
_db_lock = threading.Lock()


def _db_add(span: Span) -> None:
    with _db_lock:
        if len(_db) == _db.maxlen:
            old = _db[0]
            spans = _by_trace.get(old.trace_id)
            if spans is not None:
                try:
                    spans.remove(old)
                except ValueError:
                    pass
                if not spans:
                    del _by_trace[old.trace_id]
        _db.append(span)
        _by_trace.setdefault(span.trace_id, []).append(span)


def recent_spans(count: int = 50, method: str = "",
                 min_latency_us: float = 0.0,
                 error_only: bool = False,
                 retained: str = "") -> List[Span]:
    """Newest-first finished spans, optionally filtered (the /rpcz query
    surface): ``method`` is a substring match against service.method,
    ``min_latency_us`` keeps only slower spans, ``error_only`` keeps only
    spans with a non-zero error code, ``retained="tail"`` keeps only spans
    committed to rpc_dump by tail retention (any reason)."""
    with _db_lock:
        spans = list(_db)
    out: List[Span] = []
    for sp in reversed(spans):
        if method and method not in f"{sp.service}.{sp.method}":
            continue
        if min_latency_us and sp.latency_us < min_latency_us:
            continue
        if error_only and not sp.error_code:
            continue
        if retained and not sp.retained_reason:
            continue
        out.append(sp)
        if len(out) >= count:
            break
    return out


def spans_of_trace(trace_id: int) -> List[Span]:
    with _db_lock:
        return list(_by_trace.get(trace_id, ()))


def trace_to_dict(trace_id: int) -> Dict[str, Any]:
    """Whole-trace JSON export: trace -> spans -> phases/events, plus the
    stitched parent->child ``tree`` (client and server spans of one trace
    nest by parent_span_id — the ids line up across processes)."""
    spans = [sp.to_dict() for sp in spans_of_trace(trace_id)]
    return {"trace_id": f"{trace_id:016x}",
            "spans": spans,
            "tree": build_span_tree(spans)}


def build_span_tree(span_dicts: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Nest span dicts (``to_dict`` shape) into parent->children trees by
    span id: a server span hangs under the client span that issued it, a
    downstream client span under the server span whose handler made the
    call. Returns the roots (spans whose parent isn't in the set), each
    node a copy of the span dict plus a ``children`` list; siblings order
    by wall-clock start."""
    nodes = [{**d, "children": []} for d in span_dicts]
    by_id: Dict[Any, Dict[str, Any]] = {}
    for n in nodes:
        by_id.setdefault(n.get("span_id"), n)
    roots = []
    for n in nodes:
        parent = by_id.get(n.get("parent_span_id"))
        if parent is not None and parent is not n:
            parent["children"].append(n)
        else:
            roots.append(n)

    def _sort(ns: List[Dict[str, Any]]) -> None:
        ns.sort(key=lambda d: d.get("start_us", 0.0))
        for d in ns:
            _sort(d["children"])

    _sort(roots)
    return roots


def merge_trace_docs(docs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stitch trace exports from several processes into one doc: the
    client half of a trace lives in the caller's span DB, the server half
    in the callee's — fetch ``/rpcz/<trace_id>?format=json`` from each and
    merge. Spans dedup by (span_id, kind); the result carries a rebuilt
    ``tree``."""
    seen = set()
    spans: List[Dict[str, Any]] = []
    tid = ""
    for doc in docs:
        for d in doc.get("spans", []):
            key = (d.get("span_id"), d.get("kind"))
            if key in seen:
                continue
            seen.add(key)
            spans.append(d)
        tid = tid or doc.get("trace_id", "")
    spans.sort(key=lambda d: d.get("start_us", 0.0))
    return {"trace_id": tid, "spans": spans,
            "tree": build_span_tree(spans)}


def reset_for_test() -> None:
    with _db_lock:
        _db.clear()
        _by_trace.clear()


# ----------------------------------------------------- current span context
# Server request processing parks its span here while user code runs, so
# downstream client calls made inside a handler stitch into the same trace
# (the reference parks the Span on the bthread's local storage).
_current = threading.local()


def set_current(span: Optional[Span]):
    prev = getattr(_current, "span", None)
    _current.span = span
    return prev


def current_span() -> Optional[Span]:
    return getattr(_current, "span", None)


# ------------------------------------------------------------------ creation
def _gen_id() -> int:
    return random.getrandbits(63) | 1


_collector_mod = None


def _sampled() -> bool:
    # the selection ratio rides the PROCESS-WIDE sampling budget shared
    # with rpc_dump etc. (metrics/collector.py, reference bvar Collector)
    global _collector_mod
    if _collector_mod is None:  # lazy: collector imports flags at load
        from brpc_tpu_torch.metrics import collector as _collector_mod_

        _collector_mod = _collector_mod_
    # cache the MODULE, not the instance: tests (and a future reset) swap
    # collector._collector, and a cached instance would gate on the dead
    # one's budget
    coll = _collector_mod._collector
    if coll is None:
        coll = _collector_mod.global_collector()
    # pre-gate on the collector's standing denial window (`_deny_until` is
    # a documented contract, collector.py): during a denial no draw can
    # succeed, so skip the ratio draw entirely — this runs once per
    # untraced RPC on BOTH roles and the saved microseconds are measurable
    # at small-echo rates
    if time.monotonic() < coll._deny_until:
        return False
    ratio = _flags.get("rpcz_sample_ratio")
    if ratio < 1.0 and random.random() >= ratio:
        return False
    return coll.ask_to_be_sampled()


def start_client_span(service: str, method: str,
                      parent: Optional[Span] = None) -> Optional[Span]:
    """Root or child client span. Returns None when the trace isn't
    sampled (callers must tolerate span=None everywhere)."""
    if parent is not None:
        return Span(parent.trace_id, _gen_id(), parent.span_id,
                    KIND_CLIENT, service, method)
    if not _sampled():
        return None
    tid = _gen_id()
    return Span(tid, tid, 0, KIND_CLIENT, service, method)


def start_server_span(meta, service: str, method: str,
                      peer: str = "") -> Optional[Span]:
    """Server span continuing a propagated trace (or rooting a new one
    when the client didn't trace)."""
    return start_server_span_ids(
        meta.request.trace_id if meta is not None else 0,
        meta.request.span_id if meta is not None else 0,
        service, method, peer)


def start_server_span_ids(trace_id: int, parent_span_id: int, service: str,
                          method: str, peer: str = "") -> Optional[Span]:
    """Same as :func:`start_server_span` from pre-cracked ids."""
    if trace_id:
        return Span(trace_id, _gen_id(), parent_span_id,
                    KIND_SERVER, service, method, peer)
    if not _sampled():
        return None
    tid = _gen_id()
    return Span(tid, tid, 0, KIND_SERVER, service, method, peer)
