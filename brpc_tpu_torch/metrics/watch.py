"""Declarative watch rules over series rings.

A WatchRule names an exposed variable and a condition over its one-second
series tier — ``threshold`` (the latest sample vs a bound), ``delta`` (change
across the last ``window_s`` seconds) or ``rate`` (change per second over the
window). Rules are evaluated inside the sampler tick, right after the series
sweep, via a :attr:`SeriesRegistry.post_tick_hooks` hook — no extra thread,
no extra clock.

Each rule is a tiny state machine: ``no_data`` → ``ok`` ⇄ ``firing``. The
condition must hold for ``for_ticks`` consecutive ticks to fire (debounce)
and stay false for ``clear_ticks`` ticks to clear, so a single spiky sample
can't flap a rule. Transitions bump ``g_watch_transitions``, update the
``/watch`` builtin, and emit a short structured span (service ``watch``) so
firings land in the span DB, ``/rpcz`` and OTLP export.

``install_default_rules()`` pre-wires the canonical failure signal over the
variables the port exports: the server's deadline-expiry rate.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from brpc_tpu_torch.metrics.reducer import Adder
from brpc_tpu_torch.metrics.series import SeriesRegistry, global_series
from brpc_tpu_torch.metrics.status import PassiveStatus

STATE_NO_DATA = "no_data"
STATE_OK = "ok"
STATE_FIRING = "firing"

_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b,
}

KIND_THRESHOLD = "threshold"
KIND_DELTA = "delta"
KIND_RATE = "rate"


class WatchRule:
    """One named condition over a variable's 1-second series tier."""

    def __init__(self, name: str, var: str, kind: str, op: str, value: float,
                 window_s: int = 10, for_ticks: int = 1, clear_ticks: int = 3,
                 value_fn: Optional[Callable[[], float]] = None):
        if kind not in (KIND_THRESHOLD, KIND_DELTA, KIND_RATE):
            raise ValueError(f"unknown watch kind {kind!r}")
        if op not in _OPS:
            raise ValueError(f"unknown watch op {op!r}")
        if window_s < 1 or for_ticks < 1 or clear_ticks < 1:
            raise ValueError("window_s/for_ticks/clear_ticks must be >= 1")
        self.name = name
        self.var = var
        self.kind = kind
        self.op = op
        self.value = value
        # reloadable bound: when set, the comparison value is re-read every
        # tick (e.g. from a runtime flag), so /flags?setvalue= retunes the
        # rule without re-installing it; `value` stays as the fallback
        self.value_fn = value_fn
        self.window_s = window_s
        self.for_ticks = for_ticks
        self.clear_ticks = clear_ticks
        # state
        self.state = STATE_NO_DATA
        self.observed = 0.0        # the measured quantity at last evaluation
        self.true_streak = 0
        self.false_streak = 0
        self.transitions = 0
        self.last_transition_s = 0.0

    # ------------------------------------------------------------ evaluate
    def _measure(self, series) -> Optional[float]:
        # series tiers are identity-prefilled; use the real-sample count to
        # avoid reading fill as data
        have = min(series.count, len(series.second.data))
        if have < 1:
            return None
        ordered = series.second.ordered()
        if self.kind == KIND_THRESHOLD:
            return float(ordered[-1])
        span = min(self.window_s, have - 1)
        if span < 1:
            return None
        delta = float(ordered[-1]) - float(ordered[-1 - span])
        if self.kind == KIND_DELTA:
            return delta
        return delta / span  # rate: per-second change over the window

    def evaluate(self, registry: SeriesRegistry) -> Optional[str]:
        """Advance the state machine one tick. Returns the new state when a
        transition happened, else None."""
        series = registry.get(self.var)
        measured = self._measure(series) if series is not None else None
        if measured is None:
            if self.state == STATE_FIRING:
                # var disappeared mid-fire: treat as cleared
                return self._transition(STATE_NO_DATA)
            self.state = STATE_NO_DATA
            return None
        self.observed = measured
        cond = _OPS[self.op](measured, self.bound())
        if cond:
            self.true_streak += 1
            self.false_streak = 0
        else:
            self.false_streak += 1
            self.true_streak = 0
        if self.state != STATE_FIRING and self.true_streak >= self.for_ticks:
            return self._transition(STATE_FIRING)
        if self.state == STATE_FIRING and self.false_streak >= self.clear_ticks:
            return self._transition(STATE_OK)
        if self.state == STATE_NO_DATA:
            self.state = STATE_OK
        return None

    def _transition(self, new_state: str) -> str:
        self.state = new_state
        self.transitions += 1
        self.last_transition_s = time.time()  # tpulint: disable=monotonic-clock
        return new_state

    def bound(self) -> float:
        if self.value_fn is None:
            return self.value
        try:
            return float(self.value_fn())
        except Exception:
            return self.value

    def condition(self) -> str:
        return f"{self.kind}({self.var}, {self.window_s}s) " \
               f"{self.op} {self.bound():g}"

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "var": self.var,
            "kind": self.kind,
            "op": self.op,
            "value": self.bound(),
            "window_s": self.window_s,
            "state": self.state,
            "observed": self.observed,
            "transitions": self.transitions,
        }


g_watch_transitions = Adder("g_watch_transitions")


class WatchRegistry:
    """All rules + the post-tick evaluation hook."""

    def __init__(self):
        self._rules: Dict[str, WatchRule] = {}
        self._lock = threading.Lock()
        self._vars = []
        # called as hook(rule, new_state) on every state transition, after
        # the transition span — tail retention correlates in-flight traces
        # with firings through this. Hooks must not raise (guarded anyway)
        # and must not block: they run inside the sampler tick.
        self.transition_hooks: List[Callable[[WatchRule, str], None]] = []

    def add(self, rule: WatchRule) -> WatchRule:
        with self._lock:
            self._rules[rule.name] = rule
        return rule

    def remove(self, name: str) -> None:
        with self._lock:
            self._rules.pop(name, None)

    def rules(self) -> List[WatchRule]:
        with self._lock:
            return sorted(self._rules.values(), key=lambda r: r.name)

    def firing(self) -> List[WatchRule]:
        return [r for r in self.rules() if r.state == STATE_FIRING]

    def clear(self) -> None:
        """Test hook."""
        with self._lock:
            self._rules.clear()

    # ---------------------------------------------------------------- tick
    def evaluate_all(self, registry: SeriesRegistry) -> None:
        for rule in self.rules():
            transition = rule.evaluate(registry)
            if transition is not None:
                self._report(rule, transition)

    def _report(self, rule: WatchRule, new_state: str) -> None:
        g_watch_transitions.put(1)
        # a short span so the firing lands in the span DB + OTLP export
        try:
            from brpc_tpu_torch.trace.span import KIND_SERVER, Span, _gen_id
            tid = _gen_id()
            span = Span(tid, tid, 0, KIND_SERVER, "watch", rule.name)
            span.event(
                "watch_firing" if new_state == STATE_FIRING
                else "watch_cleared",
                rule=rule.name, var=rule.var, state=new_state,
                condition=rule.condition(), observed=rule.observed)
            span.end(error_code=1 if new_state == STATE_FIRING else 0)
        except Exception:
            pass
        for hook in list(self.transition_hooks):
            try:
                hook(rule, new_state)
            except Exception:
                pass

    # -------------------------------------------------------------exposure
    def expose_vars(self) -> None:
        """Expose g_watch_rules / g_watch_firing passive gauges (idempotent;
        re-exposes after a test's clear_registry() hid them)."""
        if self._vars and self._vars[0].name is not None:
            return
        self._vars = []
        rules_var = PassiveStatus(lambda: len(self.rules()))
        rules_var.prometheus_type = "gauge"
        firing_var = PassiveStatus(lambda: len(self.firing()))
        firing_var.prometheus_type = "gauge"
        self._vars = [rules_var.expose("g_watch_rules"),
                      firing_var.expose("g_watch_firing")]


_global_watch = WatchRegistry()
_hooked = False
_defaults_installed = False
_install_lock = threading.Lock()


def global_watch() -> WatchRegistry:
    return _global_watch


def ensure_watch_hooked(series: Optional[SeriesRegistry] = None) -> WatchRegistry:
    """Chain watch evaluation onto the series sweep (idempotent)."""
    global _hooked
    with _install_lock:
        if not _hooked:
            (series or global_series()).post_tick_hooks.append(
                _global_watch.evaluate_all)
            _hooked = True
        _global_watch.expose_vars()
    return _global_watch


def install_default_rules() -> None:
    """Pre-wire the canonical plane-health rule (idempotent)."""
    global _defaults_installed
    with _install_lock:
        if _defaults_installed:
            return
        _defaults_installed = True
    # the one canonical rule over a variable the port exports; the
    # reference's tunnel, shard, KV and serving-feature rules come back
    # with the slices that port their variables
    _global_watch.add(WatchRule(
        "deadline_expiry_rate", "g_server_deadline_expired", KIND_RATE,
        ">", 0.5, window_s=10, for_ticks=2, clear_ticks=5))
