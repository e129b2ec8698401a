"""Thread-role registry and per-thread phase markers for the sampler.

The statistical profiler (profiling/sampler.py) reads stacks of *other*
threads via ``sys._current_frames()``; to attribute a sample it needs two
facts the frame graph cannot tell it:

- **role** — what kind of thread this is (poller/worker/timer/healer/...),
  registered once at thread creation by the spawning code, and
- **phase** — which RPC span phase the thread is executing *right now*
  (parse/execute/respond/send/credit_wait/...), stamped around the phase
  boundaries by ``rpc/server_processing.py``, ``tpu/transport.py`` and
  ``batch/runtime.py``.

Both live in plain dicts keyed by thread ident: writes are single dict
stores under the GIL (atomic, no lock), reads from the sampler race
benignly — a stale phase misattributes at most one 1/hz sample. A
``threading.local`` would not work here because the sampler must read the
marker from *outside* the marked thread.

This module intentionally imports nothing beyond ``threading`` so the hot
dispatch paths can stamp phases without dragging in the sampler machinery.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

get_ident = threading.get_ident

# role vocabulary (free-form strings are accepted; these are the ones the
# framework registers)
ROLE_POLLER = "poller"      # event dispatcher / native poller / shm cut loop
ROLE_WORKER = "worker"      # fiber workers (user code runs here)
ROLE_TIMER = "timer"        # fiber timer thread
ROLE_HEALER = "healer"      # tunnel heal / health-check probes
ROLE_BATCH = "batch"        # device-lane batch dispatch
ROLE_SAMPLER = "sampler"    # bvar sampler + the profiler itself
ROLE_USER = "user"          # anything unregistered (main thread, app threads)

_roles: Dict[int, str] = {}
_phases: Dict[int, str] = {}

# process-wide role prefix: shard worker processes set "worker:<i>/" once
# at startup so every role they register — and the unregistered default —
# carries the worker identity when folded stacks are merged parent-side
_role_prefix = ""


def set_role_prefix(prefix: str) -> None:
    global _role_prefix
    _role_prefix = prefix


# ------------------------------------------------------------------- roles
def register_current_thread(role: str) -> None:
    """Tag the calling thread with a role; call first thing in run()."""
    _roles[get_ident()] = _role_prefix + role


def unregister_current_thread() -> None:
    ident = get_ident()
    _roles.pop(ident, None)
    _phases.pop(ident, None)


def role_of(ident: int) -> str:
    role = _roles.get(ident)
    return role if role is not None else _role_prefix + ROLE_USER


def threads_by_role() -> Dict[str, int]:
    """Live-thread counts keyed by role (for /status vitals)."""
    counts: Dict[str, int] = {}
    for th in threading.enumerate():
        role = _roles.get(th.ident, ROLE_USER) if th.ident else ROLE_USER
        counts[role] = counts.get(role, 0) + 1
    return counts


# ------------------------------------------------------------------ phases
def set_phase(name: Optional[str]) -> Optional[str]:
    """Stamp the calling thread's current span phase; returns the previous
    marker so nested sections can restore it (None clears)."""
    ident = get_ident()
    prev = _phases.get(ident)
    if name is None:
        if prev is not None:
            del _phases[ident]
    else:
        _phases[ident] = name
    return prev


def phase_of(ident: int) -> Optional[str]:
    return _phases.get(ident)


class phase:
    """Context manager for non-hot-path sites: ``with phase("send"): ...``
    (the dispatch fast paths call set_phase directly to skip the object)."""

    __slots__ = ("_name", "_prev")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        self._prev = set_phase(self._name)
        return self

    def __exit__(self, *exc):
        set_phase(self._prev)
        return False


# ----------------------------------------------------------------- hygiene
def prune(live_idents) -> None:
    """Drop registry entries for dead thread idents (idents are reused by
    the OS; the sampler calls this with sys._current_frames() keys, which
    cover every live thread)."""
    live = set(live_idents)
    for d in (_roles, _phases):
        for ident in [i for i in d if i not in live]:
            d.pop(ident, None)


def reset_for_test() -> None:
    global _role_prefix
    _roles.clear()
    _phases.clear()
    _role_prefix = ""
