"""Source markers for brpc_tpu_torch's invariants.

Only :func:`markers.poller_context` is ported: hot-path modules mark
their event-dispatcher callbacks with it. The reference's lint engine
(``analysis/core.py``, ``tools/tpulint.py``'s rule set) and its opt-in
runtime checker (``analysis/runtime_check.py``) come with the slice that
ports the rules or a caller of the checker (ROADMAP Queue 1 item 2(b)).
"""

from brpc_tpu_torch.analysis.markers import poller_context  # noqa: F401
