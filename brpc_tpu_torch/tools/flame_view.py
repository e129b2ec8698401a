#!/usr/bin/env python
"""flame_view — render a folded-stacks artifact as a self-contained SVG.

Input is the collapsed-stack format every profiler surface here emits
(``/pprof/profile``, ``/hotspots/cpu?format=folded``,
``/hotspots/continuous?...&format=folded``)::

    frame1;frame2;frame3 128

Output is one SVG file with no external assets or scripts: frame
rectangles sized by sample share, hover ``<title>`` tooltips carrying the
full frame name, sample count, and percentage. Open it in any browser.

Examples:
    python -m brpc_tpu_torch.tools.flame_view prof.folded -o flame.svg
    curl -s host:port/pprof/profile?seconds=2 | \\
        python -m brpc_tpu_torch.tools.flame_view - -o flame.svg
    python -m brpc_tpu_torch.tools.flame_view prof.folded --width 1600 \\
        --min-pct 0.2
"""

from __future__ import annotations

import argparse
import html
import sys
from typing import Dict, List, Tuple

ROW_H = 17          # px per stack level
FONT_PX = 11
CHAR_W = 6.6        # crude monospace advance for label truncation


def parse_folded(text: str) -> Dict[Tuple[str, ...], int]:
    counts: Dict[Tuple[str, ...], int] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        stack_part, _, weight = line.rpartition(" ")
        if not stack_part:
            continue
        try:
            n = int(weight)
        except ValueError:
            continue
        stack = tuple(stack_part.split(";"))
        counts[stack] = counts.get(stack, 0) + n
    return counts


class Node:
    __slots__ = ("name", "value", "children")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self.children: Dict[str, "Node"] = {}

    def add(self, stack: Tuple[str, ...], n: int) -> None:
        self.value += n
        if not stack:
            return
        child = self.children.get(stack[0])
        if child is None:
            child = self.children[stack[0]] = Node(stack[0])
        child.add(stack[1:], n)

    def depth(self) -> int:
        return 1 + max((c.depth() for c in self.children.values()),
                       default=0)


def _color(name: str) -> str:
    """Deterministic warm palette keyed by the frame name (same frame →
    same hue across diffs and reruns)."""
    h = 0
    for ch in name:
        h = (h * 131 + ord(ch)) & 0xFFFFFFFF
    r = 205 + h % 50
    g = 60 + (h >> 8) % 130
    b = (h >> 16) % 60
    return f"rgb({r},{g},{b})"


def render_svg(counts: Dict[Tuple[str, ...], int], width: int = 1200,
               min_pct: float = 0.1, title: str = "flame_view") -> str:
    root = Node("all")
    for stack, n in counts.items():
        root.add(stack, n)
    total = max(root.value, 1)
    min_w = width * min_pct / 100.0
    height = (root.depth() + 1) * ROW_H + 28
    out: List[str] = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" font-family="monospace" '
        f'font-size="{FONT_PX}">',
        f'<rect width="100%" height="100%" fill="#fdf6e3"/>',
        f'<text x="8" y="16">{html.escape(title)} — {total} samples '
        f'(hover for detail)</text>',
    ]

    def emit(node: Node, x: float, y: int) -> None:
        w = width * node.value / total
        if w < min_w:
            return
        pct = 100.0 * node.value / total
        label = html.escape(node.name)
        out.append(
            f'<g><title>{label} — {node.value} samples '
            f'({pct:.2f}%)</title>'
            f'<rect x="{x:.1f}" y="{y}" width="{max(w - 0.5, 0.5):.1f}" '
            f'height="{ROW_H - 1}" fill="{_color(node.name)}" '
            f'rx="1"/>')
        max_chars = int(w / CHAR_W)
        if max_chars >= 3:
            shown = (node.name if len(node.name) <= max_chars
                     else node.name[:max_chars - 1] + "…")
            out.append(
                f'<text x="{x + 3:.1f}" y="{y + ROW_H - 5}" '
                f'fill="#fff">{html.escape(shown)}</text>')
        out.append('</g>')
        cx = x
        for child in sorted(node.children.values(),
                            key=lambda c: -c.value):
            emit(child, cx, y + ROW_H)
            cx += width * child.value / total

    emit(root, 0.0, 26)
    out.append("</svg>")
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("input", help="folded-stacks file, or '-' for stdin")
    p.add_argument("-o", "--output", default="flame.svg",
                   help="output SVG path (default flame.svg)")
    p.add_argument("--width", type=int, default=1200,
                   help="SVG width in px (default 1200)")
    p.add_argument("--min-pct", type=float, default=0.1,
                   help="hide frames below this share (default 0.1%%)")
    p.add_argument("--title", default=None,
                   help="headline (default: the input path)")
    args = p.parse_args(argv)

    if args.input == "-":
        text = sys.stdin.read()
    else:
        try:
            with open(args.input, "r", encoding="utf-8") as fh:
                text = fh.read()
        except OSError as e:
            print(f"flame_view: {e}", file=sys.stderr)
            return 2
    counts = parse_folded(text)
    if not counts:
        print("flame_view: no folded stacks in input", file=sys.stderr)
        return 2
    svg = render_svg(counts, width=args.width, min_pct=args.min_pct,
                     title=args.title or args.input)
    with open(args.output, "w", encoding="utf-8") as fh:
        fh.write(svg)
    print(f"{args.output}: {len(counts)} unique stacks, "
          f"{sum(counts.values())} samples")
    return 0


if __name__ == "__main__":
    sys.exit(main())
