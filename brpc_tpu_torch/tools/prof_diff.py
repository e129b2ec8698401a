#!/usr/bin/env python
"""prof_diff — which FRAME moved between two folded CPU profiles.

The trace_diff analog for the sampling profiler: compares two collapsed-
stack artifacts (``/pprof/profile``, ``/hotspots/cpu?format=folded``)
and ranks the top self-time movers in percentage points of each
profile's own total, so profiles of different durations or sample rates
compare directly.

BASE and NEW each accept:

- a folded-stacks file ("frame;frame;frame N" lines, '#' comments ok);
- a live ``host:port`` — fetched as ``/pprof/profile?seconds=1`` over HTTP.

Exit code 0 = ok, 1 = a mover exceeded --fail-above-pct, 2 = usage error.

Examples:
    python -m brpc_tpu_torch.tools.prof_diff base.folded new.folded
    python -m brpc_tpu_torch.tools.prof_diff base.folded 127.0.0.1:8000 \\
        --top 10
    python -m brpc_tpu_torch.tools.prof_diff a.folded b.folded --total --json
    python -m brpc_tpu_torch.tools.prof_diff a.folded b.folded \\
        --fail-above-pct 5
    python -m brpc_tpu_torch.tools.prof_diff base.folded new.folded --total \\
        --only-prefix phase= --fail-above-pct 15   # per-phase ratchet
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from brpc_tpu_torch.profiling import diff as _diff  # noqa: E402

_HOSTPORT = re.compile(r"^[\w.\-]+:\d+$")


def load_source(src: str, seconds: float) -> str:
    """Folded text from a file path or a live host:port target."""
    if not os.path.exists(src) and _HOSTPORT.match(src):
        from brpc_tpu_torch.policy.http_protocol import http_fetch

        resp = http_fetch(src, "GET", f"/pprof/profile?seconds={seconds}",
                          timeout=seconds + 10)
        if resp.status // 100 != 2:
            raise RuntimeError(f"GET /pprof/profile from {src} -> "
                               f"{resp.status}")
        return bytes(resp.body).decode("utf-8", "replace")
    with open(src, "r", encoding="utf-8") as fh:
        return fh.read()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("base", help="folded file or host:port")
    p.add_argument("new", help="folded file or host:port")
    p.add_argument("--top", type=int, default=20,
                   help="movers to show (default 20)")
    p.add_argument("--min-delta-pct", type=float, default=0.5,
                   help="hide movers below this many percentage points "
                        "(default 0.5)")
    p.add_argument("--total", action="store_true",
                   help="rank by total (frame-anywhere-on-stack) share "
                        "instead of self (leaf) share")
    p.add_argument("--only-prefix", default="",
                   help="rank only frames starting with this prefix "
                        "('phase=' with --total = per-phase CPU ratchet "
                        "over the synthetic root frames)")
    p.add_argument("--seconds", type=float, default=1.0,
                   help="profile duration when a source is a live "
                        "host:port (default 1)")
    p.add_argument("--fail-above-pct", type=float, default=None,
                   help="exit 1 if any mover's |delta| exceeds this "
                        "(CI regression gate)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable report")
    args = p.parse_args(argv)

    try:
        base = load_source(args.base, args.seconds)
        new = load_source(args.new, args.seconds)
    except (OSError, RuntimeError) as e:
        print(f"prof_diff: {e}", file=sys.stderr)
        return 2

    report = _diff.diff_folded(
        base, new, top=args.top, min_delta_pct=args.min_delta_pct,
        mode="total" if args.total else "self",
        only_prefix=args.only_prefix)
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        sys.stdout.write(_diff.render_text(report))
    if args.fail_above_pct is not None and any(
            abs(m["delta_pct"]) > args.fail_above_pct
            for m in report["movers"]):
        if not args.json:
            print(f"FAIL: a mover exceeded {args.fail_above_pct}pp",
                  file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
