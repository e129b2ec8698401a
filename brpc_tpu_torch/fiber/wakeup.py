"""Adaptive spin-then-park wakeup discipline (reference bthread/butex.cpp
wait-free wakeup + the spin loop ahead of futex_wait in bthread mutexes).

Every blocking primitive in the small-RPC path (butex, the tunnel's
PeerWindow, the endpoint-ready gate, the event dispatcher's select) pays a
park/unpark round trip per message at low depth — on this lane that is a
condition-variable sleep plus a scheduler wakeup, several hundred
microseconds of the 64B echo's millisecond. A waiter that *spins briefly
first* wins that round trip back whenever the wake arrives within the spin
window (the common case under pipelined load).

Spinning is only a win when wakes actually arrive fast, so the budget is
adaptive per wait-site: a spin that observes the wake before exhausting its
budget grows the budget (up to a cap); a spin that exhausts it and parks
anyway shrinks it toward a small floor. On a box where spins never win
(single core, idle link) the budget collapses to the floor — a handful of
``time.sleep(0)`` yields, microseconds — so parking stays the steady state
and the spin is a cheap probe, not a burn.

Every spin iteration yields the GIL (``time.sleep(0)``): the waker is
usually another thread of this very interpreter, and a non-yielding loop
would hold it off for a full switch interval.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict

from brpc_tpu_torch.metrics.reducer import Adder
from brpc_tpu_torch.metrics.status import PassiveStatus

# global wakeup counters (one set across all sites — the per-site signal
# lives in each AdaptiveSpin's budget, exposed via stats())
g_wakeup_spins = Adder("g_wakeup_spins")            # spin iterations burned
g_wakeup_spin_wins = Adder("g_wakeup_spin_wins")    # wake seen while spinning
g_wakeup_spin_losses = Adder("g_wakeup_spin_losses")  # budget spent, parked
g_wakeup_parks = Adder("g_wakeup_parks")            # fell through to a park


class AdaptiveSpin:
    """One wait-site's spin budget: iterations to burn before parking.

    Thread-safety: budget updates are racy by design (plain int store under
    the GIL); the budget is a heuristic, not an invariant, and a lost
    update merely delays adaptation by one round.
    """

    __slots__ = ("name", "budget", "floor", "ceiling")

    def __init__(self, name: str, initial: int = 32, floor: int = 4,
                 ceiling: int = 4096):
        self.name = name
        self.budget = initial
        self.floor = floor
        self.ceiling = ceiling

    # ------------------------------------------------------------- policy
    def note_win(self) -> None:
        """The wake arrived inside the spin window: spinning pays here."""
        b = self.budget
        self.budget = min(self.ceiling, b + (b >> 1) + 1)
        g_wakeup_spin_wins.put(1)

    def note_loss(self) -> None:
        """Budget exhausted without a wake: decay toward the probe floor."""
        self.budget = max(self.floor, self.budget >> 1)
        g_wakeup_spin_losses.put(1)
        g_wakeup_parks.put(1)

    # -------------------------------------------------------------- spinning
    def spin(self, satisfied: Callable[[], bool]) -> bool:
        """Burn up to ``budget`` yielding iterations waiting for
        ``satisfied()``; True if it held before the budget ran out.
        The caller parks on False (counted as a park here)."""
        spins = 0
        # bounded by the adaptive spin budget snapshot taken here
        for _ in range(self.budget):
            if satisfied():
                g_wakeup_spins.put(spins)
                self.note_win()
                return True
            spins += 1
            time.sleep(0)  # yield the GIL to the prospective waker
        if spins:
            g_wakeup_spins.put(spins)
        self.note_loss()
        return False


# ----------------------------------------------------------------- registry
_instances: Dict[str, AdaptiveSpin] = {}
_instances_lock = threading.Lock()


def get_spin(name: str, **kwargs) -> AdaptiveSpin:
    """The shared AdaptiveSpin for a named wait-site (create on first use)."""
    inst = _instances.get(name)
    if inst is None:
        with _instances_lock:
            inst = _instances.get(name)
            if inst is None:
                inst = AdaptiveSpin(name, **kwargs)
                _instances[name] = inst
    return inst


def budgets() -> Dict[str, int]:
    """Current adaptive budget per wait-site (for /tpu + tests)."""
    with _instances_lock:
        return {name: s.budget for name, s in sorted(_instances.items())}


def stats() -> Dict[str, object]:
    """Snapshot for the /tpu builtin and tests."""
    return {
        "spins": g_wakeup_spins.get_value(),
        "spin_wins": g_wakeup_spin_wins.get_value(),
        "spin_losses": g_wakeup_spin_losses.get_value(),
        "parks": g_wakeup_parks.get_value(),
        "budgets": budgets(),
    }


g_wakeup_spin_budgets = PassiveStatus(budgets).expose("g_wakeup_spin_budgets")
