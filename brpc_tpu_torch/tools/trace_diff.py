#!/usr/bin/env python
"""trace_diff — which PHASE moved between two runs of the same workload.

Aligns recorded vs replayed (or baseline vs current) phase timelines
per-method at a percentile and reports regressions like::

    execute p99 +180% on EchoService.Echo (210us -> 590us, n=40/40)

BASELINE and CURRENT each accept:

- an rpc_dump v2 file or a directory of ``*.dump`` files (records carry
  the server span's settled phases);
- an ``/rpcz?format=json`` export file (chaos_run --dump-traces output);
- a live ``host:port`` — fetched as ``/rpcz?format=json`` over HTTP.

Exit code 0 = no regression, 1 = regression(s), 2 = usage error.

Examples:
    python -m brpc_tpu_torch.tools.trace_diff /tmp/dumps replay-rpcz.json
    python -m brpc_tpu_torch.tools.trace_diff baseline.json \\
        127.0.0.1:8000 --threshold 0.5
    python -m brpc_tpu_torch.tools.trace_diff record/ replay/ \\
        --percentile 90 --json

The CLI is :func:`brpc_tpu_torch.trace.diff.main`, which
``python -m brpc_tpu_torch.trace.diff`` also runs.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from brpc_tpu_torch.trace import diff as _diff  # noqa: E402


def main(argv=None) -> int:
    return _diff.main(argv, prog="trace_diff")


if __name__ == "__main__":
    raise SystemExit(main())
