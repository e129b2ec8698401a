#!/usr/bin/env python
"""trace_view — render /rpcz JSON exports as ASCII waterfalls.

Input is what ``GET /rpcz?format=json`` or ``GET /rpcz/<trace>?format=json``
returns (a ``{"spans": [...]}`` object, one span dict per sampled span —
see brpc_tpu_torch/trace/span.py Span.to_dict). Spans of one trace render as a
waterfall aligned on wall-clock start, each bar subdivided by phase::

    trace 00c49a55febc1d03  total=18234us  2 spans
    server EchoService.Echo                       18234us [QQPssssssEEEEER]
      client EchoService.Echo                     17102us  [ssssssEEEEEERr]
    phase legend: Q=queue P=parse c=credit_wait s=send b=batch_wait
                  E=execute R=respond .=unattributed

Usage::

    python -m brpc_tpu_torch.tools.trace_view TRACE.json     # file
    cat TRACE.json | python -m brpc_tpu_torch.tools.trace_view -
    python -m brpc_tpu_torch.tools.trace_view --fetch HOST:PORT [TRACE_ID]
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# phase -> one-letter bar glyph, in timeline order
PHASE_GLYPHS = (
    ("queue_us", "Q"),
    ("parse_us", "P"),
    ("credit_wait_us", "c"),
    ("send_us", "s"),
    ("batch_wait_us", "b"),
    ("execute_us", "E"),
    ("respond_us", "R"),
)
BAR_WIDTH = 50


def _bar(span: Dict, width: int) -> str:
    """One span's bar: phases scaled to their share of the span latency,
    leftover (unattributed) time rendered as dots."""
    total = float(span.get("latency_us") or 0.0)
    if total <= 0 or width <= 0:
        return ""
    phases = span.get("phases") or {}
    cells: List[str] = []
    for name, glyph in PHASE_GLYPHS:
        us = float(phases.get(name, 0.0))
        n = int(round(width * us / total))
        cells.append(glyph * n)
    bar = "".join(cells)[:width]
    return bar + "." * (width - len(bar))


def _span_sort_key(span: Dict):
    return (float(span.get("start_us") or 0.0), span.get("span_id", ""))


def render_trace(trace_id: str, spans: List[Dict], width: int = BAR_WIDTH,
                 out=None) -> None:
    out = out or sys.stdout
    spans = sorted(spans, key=_span_sort_key)
    t0 = float(spans[0].get("start_us") or 0.0)
    total = max(float(s.get("start_us") or 0.0) - t0
                + float(s.get("latency_us") or 0.0) for s in spans)
    print(f"trace {trace_id}  total={total:.0f}us  "
          f"{len(spans)} span{'s' if len(spans) != 1 else ''}", file=out)
    # indent children under their parent (one level is enough for the
    # client-under-server shape the tunnel produces)
    ids = {s.get("span_id") for s in spans}
    for s in spans:
        depth = 1 if s.get("parent_span_id") in ids else 0
        name = f"{s.get('service', '?')}.{s.get('method', '?')}"
        label = f"{'  ' * depth}{s.get('kind', '?'):<6} {name}"
        # offset the bar by the span's start relative to the trace start
        off_us = float(s.get("start_us") or 0.0) - t0
        lead = int(round(width * off_us / total)) if total > 0 else 0
        w = max(1, width - lead)
        err = f" err={s['error_code']}" if s.get("error_code") else ""
        print(f"{label:<44} {float(s.get('latency_us') or 0):>9.0f}us "
              f"{' ' * lead}[{_bar(s, w)}]{err}", file=out)
        for ev in s.get("events") or ():
            kv = " ".join(f"{k}={v}" for k, v in ev.items()
                          if k not in ("offset_us", "name"))
            print(f"{'  ' * (depth + 1)}  +{ev.get('offset_us', 0):.0f}us "
                  f"[{ev.get('name')}] {kv}".rstrip(), file=out)
    legend = " ".join(f"{g}={n[:-3]}" for n, g in PHASE_GLYPHS)
    print(f"phase legend: {legend} .=unattributed", file=out)


def render(doc: Dict, width: int = BAR_WIDTH, out=None) -> None:
    """Render an /rpcz JSON document: spans grouped per trace, newest
    trace last (so the freshest waterfall sits at the prompt)."""
    out = out or sys.stdout
    spans = doc.get("spans", [])
    if not spans:
        print("(no spans)", file=out)
        return
    by_trace: Dict[str, List[Dict]] = {}
    order: List[str] = []
    for s in spans:
        tid = s.get("trace_id", "?")
        if tid not in by_trace:
            by_trace[tid] = []
            order.append(tid)
        by_trace[tid].append(s)
    for i, tid in enumerate(reversed(order)):
        if i:
            print(file=out)
        render_trace(tid, by_trace[tid], width, out)


def _fetch(target: str, trace_id: str = "") -> Dict:
    from brpc_tpu_torch.policy.http_protocol import http_fetch

    path = f"/rpcz/{trace_id}" if trace_id else "/rpcz"
    resp = http_fetch(target, "GET", path + "?format=json")
    if resp.status != 200:
        raise RuntimeError(f"GET {path} -> {resp.status}: "
                           f"{resp.body.decode(errors='replace').strip()}")
    return json.loads(bytes(resp.body))


def main(argv) -> int:
    args = list(argv[1:])
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    if args[0] == "--fetch":
        if len(args) not in (2, 3):
            print(__doc__, file=sys.stderr)
            return 2
        doc = _fetch(args[1], args[2] if len(args) == 3 else "")
    elif args[0] == "-":
        doc = json.load(sys.stdin)
    else:
        with open(args[0]) as f:
            doc = json.load(f)
    render(doc)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
