"""Phase-timeline diff — localize a latency regression to a *phase*.

Every span carries the typed additive phase timeline (queue/parse/
credit_wait/send/batch_wait/execute/respond), so two runs of the same
workload — a recorded dump and its replay, or yesterday's baseline and
today's build — can be compared per method per phase instead of per p99:
the report says WHICH stage moved ("credit_wait p99 +38% on Echo.echo"),
not just that something did.

Inputs are interchangeable:

- ``/rpcz?format=json`` exports (``{"spans": [...]}``, the live surface
  chaos_run saves) — server spans by default;
- rpc_dump v2 files/directories (each record carries the server span's
  settled phases + latency).

Samples group into per-method :class:`MethodProfile` buckets; each phase
is summarized at a percentile (nearest-rank). A regression needs BOTH a
relative move past ``threshold`` AND an absolute move past
``min_delta_us`` (so a 3us->6us jitter never pages anyone), with at least
``min_samples`` on each side.

The port's copy of the JAX package's ``trace/diff.py``, with the
reference's ``tools/trace_diff.py`` as its command line::

    python -m brpc_tpu_torch.trace.diff BASELINE CURRENT [--percentile 99]
        [--threshold 0.30] [--min-delta-us 2000] [--min-samples 3]
        [--kind server] [--json]

BASELINE and CURRENT are each an rpc_dump v2 file or directory, an
``/rpcz?format=json`` export, or a live ``host:port`` (fetched as
``/rpcz?format=json`` over HTTP). Exit code 0 = no regression, 1 =
regression(s), 2 = usage error.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import sys
from typing import Any, Dict, Iterable, List, Optional

DEFAULT_PERCENTILE = 0.99
DEFAULT_THRESHOLD = 0.30
DEFAULT_MIN_DELTA_US = 2000.0
DEFAULT_MIN_SAMPLES = 3

# latency rides the profiles as a pseudo-phase so reports show the
# end-to-end move next to the per-phase ones; it is NOT flagged as a
# regression on its own — the phases are the localization
LATENCY_KEY = "latency_us"


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (q in [0, 1])."""
    vs = sorted(values)
    if not vs:
        return 0.0
    idx = int(math.ceil(q * len(vs))) - 1
    return vs[max(0, min(idx, len(vs) - 1))]


class MethodProfile:
    """All phase samples of one service.method in one run."""

    __slots__ = ("method", "count", "phases")

    def __init__(self, method: str):
        self.method = method
        self.count = 0
        self.phases: Dict[str, List[float]] = {}

    def add(self, phases: Dict[str, float], latency_us: float) -> None:
        self.count += 1
        for k, v in phases.items():
            self.phases.setdefault(k, []).append(float(v))
        self.phases.setdefault(LATENCY_KEY, []).append(float(latency_us))

    def phase_percentile(self, phase: str, q: float) -> float:
        return percentile(self.phases.get(phase, ()), q)


class PhaseRegression:
    """One flagged move: a phase of a method got slower between runs."""

    __slots__ = ("method", "phase", "percentile", "base_us", "new_us",
                 "base_count", "new_count")

    def __init__(self, method: str, phase: str, q: float,
                 base_us: float, new_us: float,
                 base_count: int, new_count: int):
        self.method = method
        self.phase = phase
        self.percentile = q
        self.base_us = base_us
        self.new_us = new_us
        self.base_count = base_count
        self.new_count = new_count

    @property
    def delta_pct(self) -> float:
        if self.base_us <= 0.0:
            return float("inf")
        return 100.0 * (self.new_us - self.base_us) / self.base_us

    def describe(self) -> str:
        short = self.phase[:-3] if self.phase.endswith("_us") else self.phase
        pct = int(round(self.percentile * 100))
        if math.isinf(self.delta_pct):
            move = "new"
        else:
            move = f"+{self.delta_pct:.0f}%"
        return (f"{short} p{pct} {move} on {self.method} "
                f"({self.base_us:.0f}us -> {self.new_us:.0f}us, "
                f"n={self.base_count}/{self.new_count})")

    def to_dict(self) -> Dict[str, Any]:
        return {"method": self.method, "phase": self.phase,
                "percentile": self.percentile,
                "base_us": round(self.base_us, 1),
                "new_us": round(self.new_us, 1),
                "base_count": self.base_count, "new_count": self.new_count,
                "summary": self.describe()}


# --------------------------------------------------------------- collection
def profiles_from_spans(span_dicts: Iterable[Dict[str, Any]],
                        kind: str = "server") -> Dict[str, MethodProfile]:
    """Group span dicts (``Span.to_dict`` shape) into method profiles.
    ``kind`` filters ("server"/"client"; "" keeps both)."""
    out: Dict[str, MethodProfile] = {}
    for d in span_dicts:
        if kind and d.get("kind") != kind:
            continue
        m = f"{d.get('service', '')}.{d.get('method', '')}"
        prof = out.get(m)
        if prof is None:
            prof = out[m] = MethodProfile(m)
        prof.add(d.get("phases") or {}, float(d.get("latency_us", 0.0)))
    return out


def profiles_from_dump(path: str) -> Dict[str, MethodProfile]:
    """Method profiles from rpc_dump v2 records (v1 records carry no
    phase timeline and are skipped)."""
    from brpc_tpu_torch.trace.rpc_dump import RpcDumpLoader

    out: Dict[str, MethodProfile] = {}
    for rec in RpcDumpLoader(path):
        info = rec.info
        if not info:
            continue
        m = rec.method_key
        prof = out.get(m)
        if prof is None:
            prof = out[m] = MethodProfile(m)
        prof.add(info.get("phases") or {},
                 float(info.get("latency_us", 0.0)))
    return out


def load_profiles(source, kind: str = "server") -> Dict[str, MethodProfile]:
    """Profiles from any supported source: an already-parsed /rpcz doc
    (dict), a ``.dump`` file, a directory containing ``*.dump`` files, or
    a JSON export file."""
    if isinstance(source, dict):
        return profiles_from_spans(source.get("spans", []), kind)
    if os.path.isdir(source):
        if any(f.endswith(".dump") for f in os.listdir(source)):
            return profiles_from_dump(source)
        source = os.path.join(source, "traces.json")
    if source.endswith(".dump"):
        return profiles_from_dump(source)
    with open(source) as f:
        doc = json.load(f)
    return profiles_from_spans(doc.get("spans", []), kind)


# --------------------------------------------------------------------- diff
def diff_profiles(base: Dict[str, MethodProfile],
                  new: Dict[str, MethodProfile],
                  q: float = DEFAULT_PERCENTILE,
                  threshold: float = DEFAULT_THRESHOLD,
                  min_delta_us: float = DEFAULT_MIN_DELTA_US,
                  min_samples: int = DEFAULT_MIN_SAMPLES,
                  ) -> List[PhaseRegression]:
    """Phases (per method) whose percentile-``q`` value regressed from
    ``base`` to ``new``, worst absolute move first. Methods present on
    only one side are skipped (nothing to compare), as are methods with
    fewer than ``min_samples`` on either side."""
    regs: List[PhaseRegression] = []
    for method in sorted(new):
        np = new[method]
        bp = base.get(method)
        if bp is None or bp.count < min_samples or np.count < min_samples:
            continue
        names = (set(bp.phases) | set(np.phases)) - {LATENCY_KEY}
        for phase in sorted(names):
            b = bp.phase_percentile(phase, q)
            n = np.phase_percentile(phase, q)
            if n - b < min_delta_us:
                continue
            if b > 0.0 and (n - b) / b < threshold:
                continue
            regs.append(PhaseRegression(method, phase, q, b, n,
                                        bp.count, np.count))
    regs.sort(key=lambda r: r.base_us - r.new_us)
    return regs


def render_report(base: Dict[str, MethodProfile],
                  new: Dict[str, MethodProfile],
                  regressions: List[PhaseRegression],
                  q: float = DEFAULT_PERCENTILE) -> str:
    """Human-readable diff: a per-method phase table (base vs new at the
    chosen percentile) and the regression verdict."""
    pct = int(round(q * 100))
    lines = [f"phase diff at p{pct} (base vs new, us)"]
    for method in sorted(set(base) | set(new)):
        bp = base.get(method)
        np = new[method] if method in new else None
        bn = bp.count if bp else 0
        nn = np.count if np else 0
        lines.append(f"  {method}  n={bn}/{nn}")
        names = set()
        if bp:
            names |= set(bp.phases)
        if np:
            names |= set(np.phases)
        for phase in sorted(names - {LATENCY_KEY}) + [LATENCY_KEY]:
            if phase not in names:
                continue
            b = bp.phase_percentile(phase, q) if bp else 0.0
            n = np.phase_percentile(phase, q) if np else 0.0
            mark = ""
            if any(r.method == method and r.phase == phase
                   for r in regressions):
                mark = "  <-- REGRESSED"
            lines.append(f"    {phase:<16} {b:>10.0f} {n:>10.0f}{mark}")
    if regressions:
        lines.append("")
        lines.append(f"{len(regressions)} phase regression(s):")
        for r in regressions:
            lines.append(f"  {r.describe()}")
    else:
        lines.append("")
        lines.append("no phase regressions")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------- cli
_HOSTPORT = re.compile(r"^[\w.\-]+:\d+$")


def load_source(src: str, kind: str = "server") -> Dict[str, MethodProfile]:
    """Profiles from a path (dump/JSON) or a live host:port target."""
    if not os.path.exists(src) and _HOSTPORT.match(src):
        from brpc_tpu_torch.policy.http_protocol import http_fetch

        resp = http_fetch(src, "GET", "/rpcz?format=json")
        if resp.status // 100 != 2:
            raise RuntimeError(f"GET /rpcz from {src} -> {resp.status}")
        return profiles_from_spans(
            json.loads(bytes(resp.body)).get("spans", []), kind)
    return load_profiles(src, kind)


def main(argv=None,
         prog: str = "python -m brpc_tpu_torch.trace.diff") -> int:
    """The trace diff's CLI (``tools/trace_diff.py``'s flags and exit
    codes); ``brpc_tpu_torch.tools.trace_diff`` runs it as ``prog``."""
    p = argparse.ArgumentParser(
        prog=prog,
        description="which PHASE moved between two runs of the same "
                    "workload")
    p.add_argument("baseline", help="dump file/dir, rpcz JSON, or host:port")
    p.add_argument("current", help="dump file/dir, rpcz JSON, or host:port")
    p.add_argument("--percentile", type=float,
                   default=DEFAULT_PERCENTILE * 100,
                   help="percentile to compare, 0-100 (default 99)")
    p.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD,
                   help="relative move to flag, e.g. 0.30 = +30%% "
                        "(default 0.30)")
    p.add_argument("--min-delta-us", type=float,
                   default=DEFAULT_MIN_DELTA_US,
                   help="absolute move floor in us (default 2000)")
    p.add_argument("--min-samples", type=int, default=DEFAULT_MIN_SAMPLES,
                   help="skip methods with fewer samples on either side")
    p.add_argument("--kind", default="server",
                   help="span kind to compare from JSON sources "
                        "(server/client/'' for both; default server)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    args = p.parse_args(argv)

    q = args.percentile / 100.0
    if not (0.0 < q <= 1.0):
        print("--percentile must be in (0, 100]", file=sys.stderr)
        return 2
    try:
        base = load_source(args.baseline, args.kind)
        new = load_source(args.current, args.kind)
    except (OSError, ValueError, RuntimeError) as e:
        print(f"trace_diff: {e}", file=sys.stderr)
        return 2

    regs = diff_profiles(base, new, q=q, threshold=args.threshold,
                         min_delta_us=args.min_delta_us,
                         min_samples=args.min_samples)
    if args.json:
        print(json.dumps({
            "percentile": q,
            "threshold": args.threshold,
            "min_delta_us": args.min_delta_us,
            "methods_compared": sorted(set(base) & set(new)),
            "regressions": [r.to_dict() for r in regs],
        }, indent=2))
    else:
        sys.stdout.write(render_report(base, new, regs, q))
    return 1 if regs else 0


if __name__ == "__main__":
    raise SystemExit(main())
