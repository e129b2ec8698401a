"""Folded-profile differ — the trace_diff analog for CPU.

Compares two collapsed-stack profiles (FoldedProfile objects or folded
text) and ranks the **top self-time movers**: leaf frames whose share of
total samples shifted most between base and new. Shares (fractions of
each profile's own total) make profiles of different durations or sample
rates directly comparable; deltas are reported in percentage points.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

Counts = Dict[Tuple[str, ...], int]


def parse_folded(text: str) -> Counts:
    """Parse "f1;f2;f3 N" lines (the /pprof/profile and bench --profile
    artifact format). Synthetic role=/phase= root frames are kept — they
    fold into the stack like any other frame and never appear as leaves."""
    counts: Counts = {}
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


def _as_counts(profile) -> Counts:
    if isinstance(profile, dict):
        return profile
    if isinstance(profile, str):
        return parse_folded(profile)
    # FoldedProfile: flatten (role, phase, stack) keys to plain stacks
    counts: Counts = {}
    for (_, _, stack), n in profile.counts.items():
        counts[stack] = counts.get(stack, 0) + n
    return counts


def self_weights(counts: Counts) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for stack, n in counts.items():
        if not stack:
            continue
        out[stack[-1]] = out.get(stack[-1], 0) + n
    return out


def total_weights(counts: Counts) -> Dict[str, int]:
    """Samples in which a frame appears anywhere (deduped per stack) —
    the 'cumulative' view."""
    out: Dict[str, int] = {}
    for stack, n in counts.items():
        for frame in set(stack):
            out[frame] = out.get(frame, 0) + n
    return out


def diff_folded(base, new, top: int = 20,
                min_delta_pct: float = 0.5, mode: str = "self",
                only_prefix: str = "") -> dict:
    """Rank frames by |share(new) - share(base)|, dropping movers below
    min_delta_pct percentage points. mode: 'self' (leaf time, default) or
    'total' (frame anywhere on stack). only_prefix restricts ranking to
    frames starting with it — "phase=" with mode='total' turns the diff
    into a per-phase CPU-share ratchet over the synthetic root frames."""
    base_counts, new_counts = _as_counts(base), _as_counts(new)
    weigh = self_weights if mode == "self" else total_weights
    bw, nw = weigh(base_counts), weigh(new_counts)
    base_total = max(sum(base_counts.values()), 1)
    new_total = max(sum(new_counts.values()), 1)
    movers: List[dict] = []
    for frame in set(bw) | set(nw):
        if only_prefix and not frame.startswith(only_prefix):
            continue
        b, n = bw.get(frame, 0), nw.get(frame, 0)
        b_pct = 100.0 * b / base_total
        n_pct = 100.0 * n / new_total
        delta = n_pct - b_pct
        if abs(delta) < min_delta_pct:
            continue
        movers.append({"frame": frame, "base_samples": b, "new_samples": n,
                       "base_pct": round(b_pct, 2),
                       "new_pct": round(n_pct, 2),
                       "delta_pct": round(delta, 2)})
    movers.sort(key=lambda m: -abs(m["delta_pct"]))
    return {"mode": mode, "base_total": base_total, "new_total": new_total,
            "min_delta_pct": min_delta_pct, "only_prefix": only_prefix,
            "movers": movers[:top],
            "suppressed": max(len(movers) - top, 0)}


def render_text(report: dict) -> str:
    lines = [f"# folded diff ({report['mode']} time): "
             f"base={report['base_total']} samples "
             f"new={report['new_total']} samples "
             f"(movers below {report['min_delta_pct']}pp hidden)"]
    if not report["movers"]:
        lines.append("(no movers above threshold)")
    for m in report["movers"]:
        lines.append(f"{m['delta_pct']:>+7.2f}pp  "
                     f"{m['base_pct']:>6.2f}% -> {m['new_pct']:>6.2f}%  "
                     f"{m['frame']}")
    if report["suppressed"]:
        lines.append(f"... {report['suppressed']} more movers truncated")
    return "\n".join(lines) + "\n"
