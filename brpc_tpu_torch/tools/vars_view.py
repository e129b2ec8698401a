#!/usr/bin/env python
"""vars_view — terminal sparklines for /vars series rings.

Input is the ``/vars?series=json`` payload, from a live server or a file::

    python -m brpc_tpu_torch.tools.vars_view --fetch 127.0.0.1:8000 \\
        --name 'rpc_method_*'
    curl -s host:port/vars?series=json | \\
        python -m brpc_tpu_torch.tools.vars_view -
    python -m brpc_tpu_torch.tools.vars_view snapshot.json --tier minute

Each matching var renders one line: a unicode sparkline over the chosen
tier (second by default) plus min/max/last. ``--watch`` clears the screen
and refreshes every ``--interval`` seconds (live fetch only).

Fleet mode: repeat ``--fetch`` for several members (or point one --fetch
at a fleet observer and glob ``cluster_*``). Each var then renders one
sparkline row per member side by side plus a ``=merged`` row computed with
the same op-correct semantics the fleet observer uses (the merge op rides
the payload's ``vars`` map: Adder counters sum, latencies weight by the
sibling qps series, percentiles take the max)::

    python -m brpc_tpu_torch.tools.vars_view --fetch hostA:8000 \\
        --fetch hostB:8000 --name 'rpc_method_*'
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import os
import sys
import time
import urllib.request

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SPARKS = "▁▂▃▄▅▆▇█"
TIERS = ("second", "minute", "hour")


def sparkline(values) -> str:
    if not values:
        return ""
    lo = min(values)
    hi = max(values)
    span = (hi - lo) or 1
    return "".join(
        SPARKS[int((v - lo) / span * (len(SPARKS) - 1))] for v in values)


def _fmt(value, is_float: bool) -> str:
    if is_float:
        return f"{value:.4g}"
    return str(int(value))


def render(doc: dict, name_glob: str, tier: str) -> str:
    series = doc.get("series", doc)  # accept both wrapped and bare dumps
    out = []
    workers = doc.get("workers", 0)
    if workers:
        out.append(f"# workers={workers}")
    names = [n for n in sorted(series) if fnmatch.fnmatchcase(n, name_glob)]
    if not names:
        return "no vars match\n"
    width = max(len(n) for n in names)
    for name in names:
        sd = series[name]
        values = sd.get(tier, [])
        is_float = sd.get("float", False)
        lo = min(values) if values else 0
        hi = max(values) if values else 0
        last = sd.get("last", 0)
        out.append(
            f"{name:<{width}} {sparkline(values)} "
            f"min={_fmt(lo, is_float)} max={_fmt(hi, is_float)} "
            f"last={_fmt(last, is_float)}")
    return "\n".join(out) + "\n"


def _merge_rows(name: str, docs: dict, tier: str):
    """Element-wise merge of one var's tier across member docs, using the
    fleet merge core + the op each member stamped in its ``vars`` map."""
    from brpc_tpu_torch.fleet.merge import (OP_WAVG_QPS, merge_values,
                                            qps_weight_name)

    columns = []   # (member, values, weight)
    op = "avg"
    for member, doc in docs.items():
        series = doc.get("series", doc)
        sd = series.get(name)
        if not sd:
            continue
        rec = (doc.get("vars") or {}).get(name)
        if rec:
            op = rec[0]
        weight = 1.0
        if op == OP_WAVG_QPS:
            wrec = (doc.get("vars") or {}).get(qps_weight_name(name))
            if wrec:
                weight = float(wrec[2])
        columns.append((member, list(sd.get(tier, [])), weight))
    if not columns:
        return [], [], "avg"
    length = min(len(v) for _, v, _ in columns)
    weights = [w for _, _, w in columns]
    merged = [merge_values(op,
                           [float(v[len(v) - length + i]) for _, v, _
                            in columns], weights)
              for i in range(length)]
    return columns, merged, op


def render_fleet(docs: dict, name_glob: str, tier: str) -> str:
    """Per-member sparklines side by side + the op-merged row per var.
    ``docs``: member addr -> /vars?series=json payload."""
    names = set()
    for doc in docs.values():
        series = doc.get("series", doc)
        names.update(n for n in series
                     if fnmatch.fnmatchcase(n, name_glob))
    if not names:
        return "no vars match on any member\n"
    label_w = max(len(m) for m in docs) + 2
    out = [f"# members={len(docs)}: {' '.join(sorted(docs))}"]
    for name in sorted(names):
        columns, merged, op = _merge_rows(name, docs, tier)
        out.append(f"{name}  [{op}]")
        for member, values, _w in columns:
            lo = min(values) if values else 0
            hi = max(values) if values else 0
            out.append(f"  {member:<{label_w}} {sparkline(values)} "
                       f"min={lo:g} max={hi:g} last={values[-1] if values else 0:g}")
        if merged:
            out.append(f"  {'=merged':<{label_w}} {sparkline(merged)} "
                       f"min={min(merged):g} max={max(merged):g} "
                       f"last={merged[-1]:g}")
    return "\n".join(out) + "\n"


def fetch(host_port: str, name_glob: str, timeout: float = 5.0) -> dict:
    url = f"http://{host_port}/vars?series=json&name={name_glob}"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input", nargs="?", default=None,
                    help="series=json file, or - for stdin")
    ap.add_argument("--fetch", metavar="HOST:PORT", action="append",
                    default=None,
                    help="fetch live from a server's /vars?series=json "
                         "(repeat for fleet mode: merged per-member rows)")
    ap.add_argument("--name", default="*", help="var name glob")
    ap.add_argument("--tier", default="second", choices=TIERS)
    ap.add_argument("--watch", action="store_true",
                    help="refresh loop (with --fetch)")
    ap.add_argument("--interval", type=float, default=1.0)
    args = ap.parse_args(argv)

    if args.fetch is None and args.input is None:
        ap.error("need an input file, -, or --fetch host:port")
    if args.watch and args.fetch is None:
        ap.error("--watch needs --fetch")

    while True:
        if args.fetch is not None and len(args.fetch) > 1:
            docs = {hp: fetch(hp, args.name) for hp in args.fetch}
            body = render_fleet(docs, args.name, args.tier)
        else:
            if args.fetch is not None:
                doc = fetch(args.fetch[0], args.name)
            elif args.input == "-":
                doc = json.loads(sys.stdin.read())
            else:
                with open(args.input) as f:
                    doc = json.load(f)
            body = render(doc, args.name, args.tier)
        if args.watch:
            sys.stdout.write("\x1b[2J\x1b[H")
        sys.stdout.write(body)
        sys.stdout.flush()
        if not args.watch:
            return 0
        time.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main())
