"""Span export to OTLP JSON lines — the bridge from /rpcz to external
tracing backends.

When the reloadable ``span_export_path`` flag names a file, every finished
span appends ONE line to it: a complete OTLP ``ExportTraceServiceRequest``
JSON object (resourceSpans -> scopeSpans -> spans), so each line is
independently ingestible by an OTLP file receiver / collector — and by
``jq`` — without framing state. Phase marks become ``phase.<name>``
double attributes, structured events become OTLP span events, and the
trace/span ids are the same ids /rpcz shows (trace ids zero-padded to the
OTLP 128-bit width).

The hook is :func:`maybe_export`, called from ``Span.end``; with the flag
empty it is one dict lookup and a falsy check, so the tracing hot path
pays nothing when export is off.

No clock reads here: timestamps derive from the span's already-captured
wall-clock start and monotonic latency.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict

from brpc_tpu_torch import flags as _flags
from brpc_tpu_torch.metrics.reducer import Adder

g_spans_exported = Adder("g_spans_exported")
g_span_export_errors = Adder("g_span_export_errors")

# OTLP SpanKind enum values (trace.proto): SERVER=2, CLIENT=3
_OTLP_KIND = {"server": 2, "client": 3}

_lock = threading.Lock()
_file = None
_file_path = None


def _attr(key: str, value) -> Dict[str, Any]:
    if isinstance(value, bool):
        return {"key": key, "value": {"boolValue": value}}
    if isinstance(value, int):
        return {"key": key, "value": {"intValue": str(value)}}
    if isinstance(value, float):
        return {"key": key, "value": {"doubleValue": value}}
    return {"key": key, "value": {"stringValue": str(value)}}


def span_to_otlp(span) -> Dict[str, Any]:
    """One span as an OTLP Span JSON object."""
    start_ns = int(span.start_us * 1000.0)
    # derive the end from the integer start so the span width survives
    # float64 rounding at epoch-nanosecond magnitudes
    end_ns = start_ns + int(round(span.latency_us * 1000.0))
    attrs = [
        _attr("rpc.service", span.service),
        _attr("rpc.method", span.method),
        _attr("rpc.request_size", int(span.request_size)),
        _attr("rpc.response_size", int(span.response_size)),
    ]
    if span.peer:
        attrs.append(_attr("net.peer", span.peer))
    for name, us in sorted(span.phases.items()):
        attrs.append(_attr(f"phase.{name}", float(us)))
    events = []
    for off_us, name, fields in span.events:
        events.append({
            "timeUnixNano": str(int((span.start_us + off_us) * 1000.0)),
            "name": name,
            "attributes": [_attr(k, v) for k, v in fields.items()],
        })
    for off_us, text in span.annotations:
        events.append({
            "timeUnixNano": str(int((span.start_us + off_us) * 1000.0)),
            "name": "annotation",
            "attributes": [_attr("text", text)],
        })
    out: Dict[str, Any] = {
        "traceId": f"{span.trace_id:032x}",
        "spanId": f"{span.span_id:016x}",
        "name": f"{span.service}.{span.method}",
        "kind": _OTLP_KIND.get(span.kind, 0),
        "startTimeUnixNano": str(start_ns),
        "endTimeUnixNano": str(end_ns),
        "attributes": attrs,
        "status": ({"code": 2, "message": f"error_code={span.error_code}"}
                   if span.error_code else {"code": 1}),
    }
    if span.parent_span_id:
        out["parentSpanId"] = f"{span.parent_span_id:016x}"
    if events:
        out["events"] = events
    return out


def envelope(otlp_span: Dict[str, Any],
             service_name: str = "brpc_tpu_torch") -> Dict[str, Any]:
    """Wrap one OTLP span in a full ExportTraceServiceRequest."""
    return {"resourceSpans": [{
        "resource": {"attributes": [_attr("service.name", service_name)]},
        "scopeSpans": [{"scope": {"name": "brpc_tpu_torch.trace"},
                        "spans": [otlp_span]}],
    }]}


def _writer(path: str):
    global _file, _file_path
    if path != _file_path:
        if _file is not None:
            try:
                _file.close()
            except OSError:
                pass
        _file = open(path, "a", encoding="utf-8")
        _file_path = path
    return _file


def maybe_export(span) -> bool:
    """Append ``span`` to the file named by ``span_export_path``; no-op
    (False) when the flag is empty. Never raises — export failures count
    on g_span_export_errors and the RPC path moves on."""
    path = _flags.get("span_export_path")
    if not path:
        return False
    try:
        line = json.dumps(envelope(span_to_otlp(span)),
                          separators=(",", ":"))
        with _lock:
            f = _writer(path)
            f.write(line + "\n")
            f.flush()
    except (OSError, ValueError, TypeError):
        g_span_export_errors.put(1)
        return False
    g_spans_exported.put(1)
    return True


def reset_for_test() -> None:
    global _file, _file_path
    with _lock:
        if _file is not None:
            try:
                _file.close()
            except OSError:
                pass
        _file = None
        _file_path = None
