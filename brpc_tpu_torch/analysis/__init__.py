"""Source markers for brpc_tpu_torch's invariants.

:func:`markers.poller_context` marks the event-dispatcher callbacks of
the hot-path modules, and :mod:`runtime_check` is the opt-in runtime
checker (``BRPC_TPU_CHECK=1``: lock order, and the tunnel's credit and
borrowed-block ledger) that ``tpu/transport.py`` reports into. The
reference's lint engine (``analysis/core.py``, ``tools/tpulint.py``'s rule
set) waits for the tools (ROADMAP Queue 1 item 2(b)).
"""

from brpc_tpu_torch.analysis.markers import poller_context  # noqa: F401
