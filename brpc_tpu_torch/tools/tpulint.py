#!/usr/bin/env python
"""tpulint — static invariant checks for the brpc_tpu_torch tree.

Usage:
    python -m brpc_tpu_torch.tools.tpulint [paths...]  # default: the package
    python -m brpc_tpu_torch.tools.tpulint --list-rules
    python -m brpc_tpu_torch.tools.tpulint --rule monotonic-clock \\
        brpc_tpu_torch/trace
    python -m brpc_tpu_torch.tools.tpulint --format json brpc_tpu_torch/

Exit code 0 when every finding is suppressed or absent, 1 otherwise, 2 for
an unknown rule. Suppress a single line with
``# tpulint: disable=<rule>[,<rule>...]`` on that line or a comment line
directly above it.

The CLI is :func:`brpc_tpu_torch.analysis.__main__.main`, which
``python -m brpc_tpu_torch.analysis`` also runs.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from brpc_tpu_torch.analysis.__main__ import main, run  # noqa: E402,F401

if __name__ == "__main__":
    run()
