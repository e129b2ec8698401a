#!/usr/bin/env python
"""chaos_run — replay a chaos scenario against a live server through /fault.

A scenario file is JSON::

    {"steps": [
        {"op": "flag", "name": "fault_injection_enabled", "value": "true"},
        {"op": "arm", "point": "tpu.frame.drop", "mode": "oneshot",
         "after": 2},
        {"op": "sleep", "seconds": 0.5},
        {"op": "expect_fired", "point": "tpu.frame.drop", "min": 1},
        {"op": "disarm", "point": "tpu.frame.drop"},
        {"op": "disarm_all"}
    ]}

Every mutation goes through the server's own builtin services (/flags and
/fault), so a scenario exercises exactly what an operator can do with
curl — nothing here reaches into the process. ``expect_fired`` reads the
/fault registry snapshot and fails the run when a point fired fewer times
than expected, which is what makes a scenario usable as a CI assertion.

Usage::

    python -m brpc_tpu_torch.tools.chaos_run HOST:PORT SCENARIO.json
    python -m brpc_tpu_torch.tools.chaos_run HOST:PORT SCENARIO.json \\
        --dump-traces DIR

``--dump-traces`` pulls the server's sampled spans (``/rpcz?format=json``)
after the scenario finishes — pass/fail alike — and writes them under DIR
(``traces.json`` plus one ``trace_<id>.json`` per trace), ready for
``trace_view`` to render the chaos run's waterfalls.

Regression gate: record a scenario once with ``--save-baseline FILE``,
then later runs pass ``--diff-baseline FILE`` to compare the current
run's per-method phase timelines against the recording with
``brpc_tpu_torch.trace.diff`` — the run FAILS (rc 1) when any phase
regressed, naming which phase moved::

    python -m brpc_tpu_torch.tools.chaos_run H:P S.json \\
        --save-baseline base.json
    python -m brpc_tpu_torch.tools.chaos_run H:P S.json \\
        --diff-baseline base.json --diff-threshold 0.5 --diff-percentile 90
"""

from __future__ import annotations

import json
import os
import sys
import time
import urllib.parse

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


class ScenarioError(RuntimeError):
    """A step failed: non-2xx from the server or an unmet expectation."""


def _fetch(target: str, path: str) -> bytes:
    from brpc_tpu_torch.policy.http_protocol import http_fetch

    resp = http_fetch(target, "GET", path)
    if resp.status // 100 != 2:
        raise ScenarioError(f"GET {path} -> {resp.status}: "
                            f"{resp.body.decode(errors='replace').strip()}")
    return bytes(resp.body)


def _fault_state(target: str) -> dict:
    return json.loads(_fetch(target, "/fault"))


def run_scenario(target: str, path: str) -> dict:
    """Execute every step of the scenario at ``path`` against ``target``
    (a ``host:port`` string). Returns a summary dict; raises
    :class:`ScenarioError` on the first failed step."""
    with open(path) as f:
        scenario = json.load(f)
    steps = scenario["steps"] if isinstance(scenario, dict) else scenario
    executed = []
    for i, step in enumerate(steps):
        op = step.get("op", "")
        if op == "flag":
            q = urllib.parse.quote(str(step["value"]), safe="")
            _fetch(target, f"/flags/{step['name']}?setvalue={q}")
        elif op == "arm":
            kv = {k: v for k, v in step.items() if k != "op"}
            _fetch(target, "/fault/arm?" + urllib.parse.urlencode(kv))
        elif op == "disarm":
            _fetch(target, "/fault/disarm?"
                   + urllib.parse.urlencode({"point": step["point"]}))
        elif op == "disarm_all":
            _fetch(target, "/fault/disarm_all")
        elif op == "sleep":
            time.sleep(float(step.get("seconds", 0.1)))
        elif op == "expect_fired":
            want = int(step.get("min", 1))
            rows = {r["point"]: r for r in _fault_state(target)["points"]}
            row = rows.get(step["point"])
            fired = row["fired"] if row else 0
            if fired < want:
                raise ScenarioError(
                    f"step {i}: expected {step['point']} fired >= {want}, "
                    f"saw {fired}")
        else:
            raise ScenarioError(f"step {i}: unknown op {op!r}")
        executed.append(op)
    return {"target": target, "steps": len(executed), "ops": executed}


def dump_traces(target: str, out_dir: str) -> int:
    """Save every sampled span on the server under ``out_dir``: the raw
    /rpcz export as traces.json and one trace_<id>.json per trace.
    Returns the number of traces written."""
    doc = json.loads(_fetch(target, "/rpcz?format=json"))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "traces.json"), "w") as f:
        json.dump(doc, f, indent=2)
    by_trace = {}
    for span in doc.get("spans", []):
        by_trace.setdefault(span.get("trace_id", "unknown"),
                            []).append(span)
    for tid, spans in by_trace.items():
        with open(os.path.join(out_dir, f"trace_{tid}.json"), "w") as f:
            json.dump({"trace_id": tid, "spans": spans}, f, indent=2)
    return len(by_trace)


def save_baseline(target: str, path: str) -> int:
    """Snapshot /rpcz?format=json to ``path`` as a diff baseline.
    Returns the number of spans saved."""
    doc = json.loads(_fetch(target, "/rpcz?format=json"))
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
    return len(doc.get("spans", []))


def diff_baseline(target: str, path: str, *, threshold: float,
                  percentile: float, min_delta_us: float) -> int:
    """Compare this run's phase timelines against the baseline at
    ``path``. Prints the report; returns the number of regressions."""
    from brpc_tpu_torch.trace import diff as _diff

    base = _diff.load_profiles(path)
    new = _diff.profiles_from_spans(
        json.loads(_fetch(target, "/rpcz?format=json")).get("spans", []))
    regs = _diff.diff_profiles(base, new, q=percentile,
                               threshold=threshold,
                               min_delta_us=min_delta_us)
    sys.stdout.write(_diff.render_report(base, new, regs, percentile))
    return len(regs)


def _pop_opt(args: list, name: str, default=None):
    """Extract ``name VALUE`` from args (None when absent)."""
    if name not in args:
        return default
    i = args.index(name)
    if i + 1 >= len(args):
        print(__doc__, file=sys.stderr)
        raise SystemExit(2)
    value = args[i + 1]
    del args[i:i + 2]
    return value


def main(argv) -> int:
    args = list(argv[1:])
    dump_dir = _pop_opt(args, "--dump-traces")
    base_out = _pop_opt(args, "--save-baseline")
    base_in = _pop_opt(args, "--diff-baseline")
    threshold = float(_pop_opt(args, "--diff-threshold", "0.30"))
    percentile = float(_pop_opt(args, "--diff-percentile", "99")) / 100.0
    min_delta = float(_pop_opt(args, "--diff-min-delta-us", "2000"))
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    target, scenario = args
    rc = 0
    try:
        summary = run_scenario(target, scenario)
    except ScenarioError as e:
        print(f"chaos_run: FAILED: {e}", file=sys.stderr)
        rc = 1
    if dump_dir is not None:
        # traces are most valuable on failure — dump regardless of rc
        try:
            n = dump_traces(target, dump_dir)
            print(f"chaos_run: dumped {n} traces to {dump_dir}")
        except (ScenarioError, OSError, ValueError) as e:
            print(f"chaos_run: trace dump failed: {e}", file=sys.stderr)
            rc = rc or 1
    if base_out is not None:
        try:
            n = save_baseline(target, base_out)
            print(f"chaos_run: baseline of {n} spans saved to {base_out}")
        except (ScenarioError, OSError, ValueError) as e:
            print(f"chaos_run: baseline save failed: {e}", file=sys.stderr)
            rc = rc or 1
    if base_in is not None:
        try:
            regs = diff_baseline(target, base_in, threshold=threshold,
                                 percentile=percentile,
                                 min_delta_us=min_delta)
            if regs:
                print(f"chaos_run: FAILED: {regs} phase regression(s) vs "
                      f"{base_in}", file=sys.stderr)
                rc = rc or 1
        except (ScenarioError, OSError, ValueError) as e:
            print(f"chaos_run: baseline diff failed: {e}", file=sys.stderr)
            rc = rc or 1
    if rc == 0:
        print(f"chaos_run: OK ({summary['steps']} steps against "
              f"{summary['target']})")
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv))
