"""SLO engine — declarative objectives, multi-window error-budget burn.

An :class:`SloObjective` states what "good" means for one method (or one
tenant's lane): a latency bound its p99 must stay under, and an error-rate
ceiling, each allowed to be violated at most an ``objective`` fraction of
the time. Every sampler tick the engine measures, over a fast and a slow
rolling window of the 1-second series:

- **latency burn** — the fraction of window seconds whose p99 sample broke
  the bound, divided by ``objective`` (burn 1.0 = spending budget exactly
  at the allowed rate, >1 = burning it down);
- **error burn** — errors/total over the window divided by ``objective``.

The per-window burn is the worse of the two. The headline
``g_slo_<name>_burn`` gauge is the **min of the fast and slow burns** —
the standard multi-window gate: the fast window must agree (it's really
happening now) *and* the slow window must agree (it's not a one-second
blip), which is what makes the paired ``slo_burn_<name>`` watch rule both
quick and flap-resistant. Bounds are reloadable via the
``slo_burn_threshold`` flag; objectives install declaratively through the
``slo_objectives`` flag or programmatically via :func:`global_slo`.

On a fleet observer the engine reads the scrape-merged series (cluster
view); standalone it reads the local registry. Either way evaluation runs
as a series post-tick hook writing a plain cached dict, and the exposed
``g_slo_*`` vars only read that cache — a var whose get_value touched the
series registry would deadlock inside the sweep's lock.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from brpc_tpu_torch import flags as _flags
from brpc_tpu_torch.fleet.merge import MergedVar
from brpc_tpu_torch.metrics.series import (
    SeriesRegistry,
    ensure_series_installed,
    global_series,
)
from brpc_tpu_torch.metrics.watch import (
    KIND_THRESHOLD,
    WatchRule,
    ensure_watch_hooked,
    global_watch,
)

slo_burn_threshold = _flags.define(
    "slo_burn_threshold", 1.0,
    "slo_burn_* watch rules fire when an objective's multi-window burn "
    "rate (min of fast and slow) exceeds this (reloadable: the rules "
    "read the flag at every tick)", validator=lambda v: v > 0)


def _slug(text: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_"
                   for c in text.strip().lower())


class SloObjective:
    """One declarative objective over a method's (or tenant lane's) vars."""

    def __init__(self, name: str, latency_var: str = "",
                 latency_bound_us: float = 0.0, errors_var: str = "",
                 total_var: str = "", objective: float = 0.01,
                 fast_window_s: int = 10, slow_window_s: int = 60,
                 tenant: str = ""):
        if not (0.0 < objective <= 1.0):
            raise ValueError(f"objective {objective!r} out of (0, 1]")
        if fast_window_s < 2 or slow_window_s < fast_window_s:
            raise ValueError("need slow_window_s >= fast_window_s >= 2")
        if not latency_var and not errors_var:
            raise ValueError("objective needs a latency_var or errors_var")
        self.name = _slug(name)
        self.latency_var = latency_var
        self.latency_bound_us = float(latency_bound_us)
        self.errors_var = errors_var
        self.total_var = total_var
        self.objective = float(objective)
        self.fast_window_s = int(fast_window_s)
        self.slow_window_s = int(slow_window_s)
        self.tenant = tenant

    @classmethod
    def from_spec(cls, entry: str) -> "SloObjective":
        """``name:key=value,key=value,...``. ``var=<stem>`` derives
        ``<stem>_latency_p99`` / ``<stem>_errors`` / ``<stem>_count`` (a
        LatencyRecorder stem, e.g. rpc_method_echoservice_echo); explicit
        latency_var/errors_var/total_var override. ``bound_ms``/``bound_us``
        set the latency bound; ``objective``, ``fast_s``, ``slow_s``,
        ``tenant`` map directly."""
        name, _, rest = entry.partition(":")
        if not name.strip():
            raise ValueError(f"slo spec entry without a name: {entry!r}")
        kv: Dict[str, str] = {}
        for piece in rest.split(","):
            piece = piece.strip()
            if not piece:
                continue
            if "=" not in piece:
                raise ValueError(f"slo spec piece without '=': {piece!r}")
            k, v = piece.split("=", 1)
            kv[k.strip()] = v.strip()
        stem = kv.get("var", "")
        latency_var = kv.get("latency_var",
                             f"{stem}_latency_p99" if stem else "")
        errors_var = kv.get("errors_var", f"{stem}_errors" if stem else "")
        total_var = kv.get("total_var", f"{stem}_count" if stem else "")
        bound_us = float(kv["bound_us"]) if "bound_us" in kv else \
            float(kv.get("bound_ms", 0)) * 1000.0
        return cls(name.strip(), latency_var=latency_var,
                   latency_bound_us=bound_us, errors_var=errors_var,
                   total_var=total_var,
                   objective=float(kv.get("objective", 0.01)),
                   fast_window_s=int(kv.get("fast_s", 10)),
                   slow_window_s=int(kv.get("slow_s", 60)),
                   tenant=kv.get("tenant", ""))

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "latency_var": self.latency_var,
            "latency_bound_us": self.latency_bound_us,
            "errors_var": self.errors_var,
            "total_var": self.total_var,
            "objective": self.objective,
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "tenant": self.tenant,
        }


class SloEngine:
    """Objectives + the post-tick burn evaluation."""

    def __init__(self):
        self._lock = threading.Lock()
        self._objectives: Dict[str, SloObjective] = {}
        self._vars: Dict[str, MergedVar] = {}
        # name -> {"burn", "burn_fast", "burn_slow", "budget_left", parts}
        # written only by evaluate(); the g_slo_* vars read it — never the
        # series registry (the sweep holds its lock while calling get_value)
        self._state: Dict[str, dict] = {}
        self._observer = None
        self._hooked = False

    # ---------------------------------------------------------- objectives
    def add(self, obj: SloObjective) -> SloObjective:
        with self._lock:
            self._objectives[obj.name] = obj
        self._expose(obj)
        self._install_rule(obj)
        return obj

    def remove(self, name: str) -> None:
        with self._lock:
            self._objectives.pop(name, None)
            self._state.pop(name, None)
        global_watch().remove(f"slo_burn_{name}")
        for key in ("burn", "burn_fast", "burn_slow", "budget_left"):
            var = self._vars.pop(f"g_slo_{name}_{key}", None)
            if var is not None:
                var.hide()

    def objectives(self) -> List[SloObjective]:
        with self._lock:
            return sorted(self._objectives.values(), key=lambda o: o.name)

    def clear(self) -> None:
        """Test hook: drop objectives, vars and their watch rules."""
        for obj in self.objectives():
            self.remove(obj.name)

    def attach_observer(self, observer) -> "SloEngine":
        """Evaluate from the observer's scrape-merged series (cluster
        view) instead of the local registry. None detaches."""
        self._observer = observer
        return self

    # ------------------------------------------------------------ exposure
    def _expose(self, obj: SloObjective) -> None:
        n = obj.name
        readers = {
            "burn": lambda: self._cached(n, "burn"),
            "burn_fast": lambda: self._cached(n, "burn_fast"),
            "burn_slow": lambda: self._cached(n, "burn_slow"),
            "budget_left": lambda: self._cached(n, "budget_left"),
        }
        helps = {
            "burn": f"multi-window burn rate of SLO {n} (min of fast and "
                    f"slow window burns; 1.0 = spending error budget at "
                    f"exactly the allowed rate)",
            "burn_fast": f"burn rate of SLO {n} over the fast "
                         f"{obj.fast_window_s}s window",
            "burn_slow": f"burn rate of SLO {n} over the slow "
                         f"{obj.slow_window_s}s window",
            "budget_left": f"remaining error-budget fraction of SLO {n} "
                           f"over the slow window (1 - burn_slow, floored "
                           f"at 0)",
        }
        for key, fn in readers.items():
            vname = f"g_slo_{n}_{key}"
            if vname in self._vars:
                continue
            self._vars[vname] = MergedVar(
                fn, "gauge", help_text=helps[key]).expose(vname)

    def _cached(self, name: str, key: str) -> float:
        state = self._state.get(name)
        default = 1.0 if key == "budget_left" else 0.0
        return float(state.get(key, default)) if state else default

    def _install_rule(self, obj: SloObjective) -> None:
        watch = global_watch()
        rule_name = f"slo_burn_{obj.name}"
        if any(r.name == rule_name for r in watch.rules()):
            return
        watch.add(WatchRule(
            rule_name, f"g_slo_{obj.name}_burn", KIND_THRESHOLD, ">",
            float(_flags.get("slo_burn_threshold")), window_s=10,
            for_ticks=2, clear_ticks=3,
            value_fn=lambda: _flags.get("slo_burn_threshold")))

    # ------------------------------------------------------------ evaluate
    def install(self, series: Optional[SeriesRegistry] = None) -> "SloEngine":
        """Chain burn evaluation onto the series sweep (idempotent),
        before the watch hook so rules read this tick's series."""
        if not self._hooked:
            self._hooked = True
            (series or global_series()).post_tick_hooks.insert(
                0, self.evaluate)
            ensure_series_installed()
        ensure_watch_hooked(series)
        return self

    def _samples(self, registry: SeriesRegistry, name: str,
                 window: int) -> Optional[List[float]]:
        """Last ``window`` real 1-second samples of one var, from the
        observer's merged view when attached, else the local registry."""
        if not name:
            return None
        if self._observer is not None:
            doc = self._observer.merged_series(name)
            if doc is None:
                return None
            sec = list(doc.get("second") or [])
            count = int(doc.get("count", len(sec)))
        else:
            vs = registry.get(name)
            if vs is None:
                return None
            sec = vs.second.ordered()
            count = vs.count
        have = min(count, len(sec))
        if have < 1:
            return None
        return [float(v) for v in sec[len(sec) - min(have, window):]]

    def _window_burn(self, registry: SeriesRegistry, obj: SloObjective,
                     window: int) -> dict:
        latency_burn = 0.0
        error_burn = 0.0
        lat = self._samples(registry, obj.latency_var, window) \
            if obj.latency_bound_us > 0 else None
        if lat:
            violations = sum(1 for v in lat if v > obj.latency_bound_us)
            latency_burn = (violations / len(lat)) / obj.objective
        errs = self._samples(registry, obj.errors_var, window)
        total = self._samples(registry, obj.total_var, window)
        if errs and total and len(errs) >= 2 and len(total) >= 2:
            err_delta = max(0.0, errs[-1] - errs[0])
            total_delta = max(0.0, total[-1] - total[0])
            if total_delta > 0:
                error_burn = (err_delta / total_delta) / obj.objective
        return {"latency_burn": latency_burn, "error_burn": error_burn,
                "burn": max(latency_burn, error_burn)}

    def evaluate(self, registry: SeriesRegistry) -> None:
        """Series post-tick hook: recompute every objective's burn cache."""
        for obj in self.objectives():
            fast = self._window_burn(registry, obj, obj.fast_window_s)
            slow = self._window_burn(registry, obj, obj.slow_window_s)
            self._state[obj.name] = {
                "burn_fast": fast["burn"],
                "burn_slow": slow["burn"],
                # multi-window gate: both windows must burn to alert
                "burn": min(fast["burn"], slow["burn"]),
                "budget_left": max(0.0, 1.0 - slow["burn"]),
                "fast": fast,
                "slow": slow,
            }

    # ---------------------------------------------------------------- view
    def to_dict(self) -> dict:
        rules = {r.name: r.to_dict() for r in global_watch().rules()
                 if r.name.startswith("slo_burn_")}
        out = []
        for obj in self.objectives():
            state = self._state.get(obj.name, {})
            out.append({
                **obj.to_dict(),
                "burn": state.get("burn", 0.0),
                "burn_fast": state.get("burn_fast", 0.0),
                "burn_slow": state.get("burn_slow", 0.0),
                "budget_left": state.get("budget_left", 1.0),
                "rule": rules.get(f"slo_burn_{obj.name}"),
            })
        return {"threshold": float(_flags.get("slo_burn_threshold")),
                "source": "fleet" if self._observer is not None else "local",
                "objectives": out}


_global_slo = SloEngine()


def global_slo() -> SloEngine:
    return _global_slo


def _apply_objectives_string(text: str) -> bool:
    """Validator for the ``slo_objectives`` flag: ``;``-separated
    :meth:`SloObjective.from_spec` entries, e.g.
    ``echo:var=rpc_method_echoservice_echo,bound_ms=50,objective=0.02``.
    Setting the flag installs the listed objectives on the global engine
    (an empty string is a no-op; remove via global_slo().remove())."""
    text = text.strip()
    if not text:
        return True
    try:
        parsed = [SloObjective.from_spec(entry)
                  for entry in text.split(";") if entry.strip()]
    except (ValueError, KeyError):
        return False
    engine = global_slo()
    engine.install()
    for obj in parsed:
        engine.add(obj)
    return True


_flags.define(
    "slo_objectives", "",
    "Install SLO objectives from a string: "
    "'name:var=<stem>,bound_ms=...,objective=...;...' (applied on set; "
    "see fleet/slo.py SloObjective.from_spec)",
    validator=_apply_objectives_string)
