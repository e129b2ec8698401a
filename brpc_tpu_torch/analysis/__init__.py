"""Static analysis + opt-in runtime checking for brpc_tpu_torch's invariants.

The framework's correctness story rests on a handful of conventions that
no unit test can pin down exhaustively: poller callbacks never block,
every acquired block credit reaches a release on all paths, phase marks
ride the monotonic clock, lock nesting stays acyclic, no JAX name creeps
into the port, and every metric/flag is registered exactly once.
``tpulint`` (``python -m brpc_tpu_torch.analysis``, :mod:`core` and
:mod:`rules`) enforces those mechanically over the AST;
:mod:`runtime_check` validates at runtime what static analysis can't
(actual lock acquisition order, actual credit balance), opt-in via
``BRPC_TPU_CHECK=1``.

This package is intentionally dependency-free (stdlib only): the linter
runs without torch, and :func:`poller_context` must be importable from
hot modules without dragging analysis machinery into their import time.
"""

from brpc_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    LintResult,
    format_findings,
    list_rules,
    run_lint,
)
from brpc_tpu_torch.analysis.markers import poller_context  # noqa: F401
