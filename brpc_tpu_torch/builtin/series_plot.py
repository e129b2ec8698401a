"""Inline-SVG renderer for /vars/<name> series plots.

Same philosophy as ``tools/flame_view.py``: zero dependencies, fully
deterministic output (stable coordinates, fixed palette, no timestamps or
random ids), self-contained markup — the page keeps working when saved to a
file. One SVG per tier (second/minute/hour), a filled polyline with min/max/
last annotations and a hover ``<title>`` per sample point.
"""

from __future__ import annotations

import html
from typing import List

# fixed palette, one colour per tier (deterministic — no hashing)
TIER_COLORS = {
    "second": "#1f77b4",
    "minute": "#2ca02c",
    "hour": "#d62728",
}

PLOT_W = 600
PLOT_H = 120
PAD = 4


def _fmt(value, is_float: bool) -> str:
    if is_float:
        return f"{value:.6g}"
    return str(int(value))


def tier_svg(values: List[float], tier: str, is_float: bool = False,
             width: int = PLOT_W, height: int = PLOT_H) -> str:
    """One tier ring (oldest-first) -> a self-contained <svg> string."""
    color = TIER_COLORS.get(tier, "#7f7f7f")
    n = len(values)
    lo = min(values) if values else 0
    hi = max(values) if values else 0
    span = (hi - lo) or 1
    inner_w = width - 2 * PAD
    inner_h = height - 2 * PAD
    pts = []
    for i, v in enumerate(values):
        x = PAD + (inner_w * i / (n - 1) if n > 1 else inner_w / 2)
        y = PAD + inner_h * (1 - (v - lo) / span)
        pts.append((round(x, 2), round(y, 2), v))
    poly = " ".join(f"{x},{y}" for x, y, _ in pts)
    area = f"{PAD},{height - PAD} {poly} {width - PAD},{height - PAD}"
    out = [
        f'<svg class="series" width="{width}" height="{height}" '
        f'viewBox="0 0 {width} {height}" '
        f'xmlns="http://www.w3.org/2000/svg">',
        f'<rect width="{width}" height="{height}" fill="#fafafa" '
        f'stroke="#ddd"/>',
        f'<polygon points="{area}" fill="{color}" fill-opacity="0.15"/>',
        f'<polyline points="{poly}" fill="none" stroke="{color}" '
        f'stroke-width="1.5"/>',
    ]
    # hover targets: one invisible circle per sample with a <title> tooltip
    for i, (x, y, v) in enumerate(pts):
        out.append(
            f'<circle cx="{x}" cy="{y}" r="3" fill="{color}" '
            f'fill-opacity="0"><title>{tier}[-{n - 1 - i}] = '
            f'{html.escape(_fmt(v, is_float))}</title></circle>')
    last = values[-1] if values else 0
    out.append(
        f'<text x="{PAD + 2}" y="{PAD + 10}" font-size="10" '
        f'font-family="monospace" fill="#555">'
        f'{tier} max={html.escape(_fmt(hi, is_float))} '
        f'min={html.escape(_fmt(lo, is_float))} '
        f'last={html.escape(_fmt(last, is_float))}</text>')
    out.append("</svg>")
    return "".join(out)


def var_svg(name: str, series_dict: dict) -> str:
    """All three tiers stacked in one SVG (the ?format=svg payload)."""
    is_float = series_dict.get("float", False)
    tiers = ("second", "minute", "hour")
    gap = 8
    total_h = len(tiers) * PLOT_H + (len(tiers) - 1) * gap + 20
    out = [
        f'<svg width="{PLOT_W}" height="{total_h}" '
        f'viewBox="0 0 {PLOT_W} {total_h}" '
        f'xmlns="http://www.w3.org/2000/svg">',
        f'<text x="2" y="12" font-size="12" font-family="monospace">'
        f'{html.escape(name)}</text>',
    ]
    y = 20
    for tier in tiers:
        inner = tier_svg(series_dict.get(tier, []), tier, is_float)
        # embed by wrapping in a translated group; strip the outer svg tag
        body = inner[inner.index(">") + 1: -len("</svg>")]
        out.append(f'<g transform="translate(0,{y})">{body}</g>')
        y += PLOT_H + gap
    out.append("</svg>")
    return "".join(out)


def detail_page_html(name: str, value: str, series_dict: dict) -> str:
    """The /vars/<name> HTML detail page (browser Accept: text/html)."""
    esc = html.escape(name)
    parts = [
        "<!DOCTYPE html><html><head>",
        f"<title>{esc} — brpc_tpu vars</title>",
        "<style>body{font-family:monospace;margin:16px}"
        "h1{font-size:16px}table{border-collapse:collapse}"
        "td{padding:2px 10px 2px 0}</style>",
        "</head><body>",
        f"<h1><a href=\"/vars\">/vars</a> / {esc}</h1>",
        f"<p>current value: <b>{html.escape(value)}</b></p>",
    ]
    if series_dict is None:
        parts.append("<p>no series retained for this variable "
                     "(non-numeric, opted out, or series disabled)</p>")
    else:
        parts.append(var_svg(name, series_dict))
        parts.append(
            f"<table><tr><td>samples</td><td>{series_dict['count']}</td></tr>"
            f"<tr><td>reduce</td><td>{series_dict['reduce']}</td></tr>"
            f"<tr><td>json</td><td><a href=\"/vars/{esc}?series=json\">"
            f"?series=json</a></td></tr></table>")
    parts.append("</body></html>")
    return "".join(parts)
