"""Deterministic fault injection — named points, armed triggers, counters.

The transport and RPC core call :func:`hit` at named injection points
(``tpu.tunnel.kill``, ``rpc.handler.crash``, …). When nothing is armed the
call is a single global-int check, so the points cost nothing in
production. A chaos scenario arms a point with a trigger:

* ``oneshot`` — fire on the first matching hit, then disarm.
* ``always`` — fire on every matching hit (optionally capped by ``count``).
* ``after=N`` — let N matching hits pass untouched before the trigger
  starts firing (e.g. kill the vsock on the 9th DATA frame of a 16MB
  message).
* ``p=0.01`` — probabilistic: each eligible hit fires with probability p,
  and a firing additionally draws a grant from the shared metrics
  Collector budget (collector_max_samples_per_second), so background
  chaos can never outrun the process-wide sampling cap. Draw outcomes
  are observable via g_fault_p_skipped / g_fault_budget_denied.

Arming is scriptable three ways: directly from tests (:func:`arm`), over
HTTP from a running server (the ``/fault`` builtin service), and through
the reloadable ``fault_spec`` string flag (so ``/flags/fault_spec?setvalue=``
works too). All firing is additionally gated behind the reloadable master
flag ``fault_injection_enabled`` (default off).

What a fired fault *does* is decided by the call site: :func:`hit` only
returns the armed params dict (or None). Sites interpret keys like
``delay_ms`` (see :func:`maybe_sleep`), ``ftype``-style match filters live
in the trigger itself (``match_*`` keys on arm).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional

from brpc_tpu_torch import flags
from brpc_tpu_torch.metrics.reducer import Adder

flags.define("fault_injection_enabled", False,
             "Master gate for fault injection: armed points only fire "
             "while this is true.", reloadable=True)

g_fault_hits = Adder("g_fault_hits")
g_fault_fired = Adder("g_fault_fired")
g_fault_p_skipped = Adder("g_fault_p_skipped")        # p-draw missed
g_fault_budget_denied = Adder("g_fault_budget_denied")  # collector said no

_lock = threading.Lock()
_points: Dict[str, "FaultPoint"] = {}
_armed = 0  # lock-free fast-path gate: number of points with a live spec


class FaultSpec:
    """One armed trigger on one point."""

    __slots__ = ("mode", "after", "count", "match", "params", "p",
                 "skipped", "fired")

    def __init__(self, mode: str = "oneshot", after: int = 0,
                 count: int = 0, match: Optional[Dict[str, Any]] = None,
                 params: Optional[Dict[str, Any]] = None, p: float = 1.0):
        if mode not in ("oneshot", "always"):
            raise ValueError(f"unknown fault mode {mode!r} "
                             f"(expected oneshot|always)")
        self.mode = mode
        self.after = int(after)
        # oneshot is sugar for count=1; count=0 on 'always' means unbounded
        self.count = int(count) if count else (1 if mode == "oneshot" else 0)
        self.match = dict(match or {})
        self.params = dict(params or {})
        self.p = float(p)
        if not (0.0 < self.p <= 1.0):
            raise ValueError(f"fault p={p!r} out of range (0, 1]")
        self.skipped = 0
        self.fired = 0


class FaultPoint:
    __slots__ = ("name", "doc", "spec", "hits", "fired", "_fired_adder")

    def __init__(self, name: str, doc: str = ""):
        self.name = name
        self.doc = doc
        self.spec: Optional[FaultSpec] = None
        self.hits = 0   # evaluations while armed (incl. after-N skips)
        self.fired = 0  # lifetime fires
        self._fired_adder = Adder(
            "g_fault_fired_" + name.replace(".", "_").replace("-", "_"))


def register(name: str, doc: str = "") -> None:
    """Declare an injection point (idempotent; arming auto-registers too,
    so call order between site modules and chaos scripts doesn't matter)."""
    with _lock:
        pt = _points.get(name)
        if pt is None:
            _points[name] = FaultPoint(name, doc)
        elif doc and not pt.doc:
            pt.doc = doc


def arm(name: str, mode: str = "oneshot", after: int = 0, count: int = 0,
        match: Optional[Dict[str, Any]] = None, p: float = 1.0,
        **params) -> None:
    """Arm ``name``; replaces any previous spec on the point."""
    spec = FaultSpec(mode, after, count, match, params, p=p)
    global _armed
    with _lock:
        pt = _points.get(name)
        if pt is None:
            pt = _points[name] = FaultPoint(name)
        if pt.spec is None:
            _armed += 1
        pt.spec = spec


def disarm(name: str) -> bool:
    global _armed
    with _lock:
        pt = _points.get(name)
        if pt is None or pt.spec is None:
            return False
        pt.spec = None
        _armed -= 1
        return True


def disarm_all() -> int:
    global _armed
    with _lock:
        n = 0
        for pt in _points.values():
            if pt.spec is not None:
                pt.spec = None
                n += 1
        _armed = 0
        return n


def hit(name: str, **ctx) -> Optional[Dict[str, Any]]:
    """Evaluate injection point ``name`` at its call site.

    Returns the armed params dict when the fault fires, else None. ``ctx``
    keys are compared against the spec's match filter (armed as
    ``match_<key>``): a mismatch neither fires nor consumes the after-N
    window.
    """
    global _armed
    if not _armed:
        return None
    if not flags.get("fault_injection_enabled"):
        return None
    with _lock:
        pt = _points.get(name)
        spec = pt.spec if pt is not None else None
        if spec is None:
            return None
        for k, want in spec.match.items():
            if ctx.get(k) != want:
                return None
        pt.hits += 1
        g_fault_hits.put(1)
        if spec.skipped < spec.after:
            spec.skipped += 1
            return None
        if spec.count and spec.fired >= spec.count:  # exhausted; disarm
            pt.spec = None
            _armed -= 1
            return None
        if spec.p < 1.0:
            # probabilistic trigger: a missed draw neither fires nor
            # consumes the count; a won draw must also win a grant from
            # the shared Collector budget so sustained p-chaos stays under
            # collector_max_samples_per_second like every other sampler
            if random.random() >= spec.p:
                g_fault_p_skipped.put(1)
                return None
            from brpc_tpu_torch.metrics.collector import global_collector

            if not global_collector().ask_to_be_sampled():
                g_fault_budget_denied.put(1)
                return None
        spec.fired += 1
        pt.fired += 1
        if spec.count and spec.fired >= spec.count:
            pt.spec = None
            _armed -= 1
        params = dict(spec.params)
    g_fault_fired.put(1)
    pt._fired_adder.put(1)
    return params


def maybe_sleep(params: Optional[Dict[str, Any]]) -> float:
    """Site helper for delay/stall points: sleep ``delay_ms`` and return
    the seconds slept (0.0 when the fault didn't fire)."""
    if not params:
        return 0.0
    ms = float(params.get("delay_ms", 0) or 0)
    if ms <= 0:
        return 0.0
    time.sleep(ms / 1000.0)
    return ms / 1000.0


def snapshot() -> List[Dict[str, Any]]:
    """Registry state for /fault and tests."""
    with _lock:
        out = []
        for name in sorted(_points):
            pt = _points[name]
            row: Dict[str, Any] = {"point": name, "doc": pt.doc,
                                   "hits": pt.hits, "fired": pt.fired}
            if pt.spec is not None:
                s = pt.spec
                row["armed"] = {"mode": s.mode, "after": s.after,
                                "count": s.count, "fired": s.fired,
                                "p": s.p, "match": dict(s.match),
                                "params": dict(s.params)}
            out.append(row)
        return out


# ------------------------------------------------------------------ fault_spec
def _coerce(text: str) -> Any:
    low = text.strip().lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    try:
        return int(text, 0)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        return text


def parse_spec_kv(name: str, kv: Dict[str, str]) -> None:
    """Arm from a flat string->string mapping (HTTP query / flag entry):
    reserved keys mode/after/count/p, ``match_*`` keys become the match
    filter, everything else is a param."""
    mode = kv.get("mode", "oneshot")
    after = int(kv.get("after", 0))
    count = int(kv.get("count", 0))
    p = float(kv.get("p", 1.0))
    match = {k[len("match_"):]: _coerce(v) for k, v in kv.items()
             if k.startswith("match_")}
    params = {k: _coerce(v) for k, v in kv.items()
              if k not in ("mode", "after", "count", "point", "p")
              and not k.startswith("match_")}
    arm(name, mode=mode, after=after, count=count, match=match, p=p,
        **params)


def _apply_spec_string(text: str) -> bool:
    """Validator for the ``fault_spec`` flag. Each ``;``-separated entry is
    ``point:mode[:key=value...]`` — e.g.
    ``tpu.frame.drop:oneshot:after=2;tpu.ack.stall:always:delay_ms=50``.
    Setting the flag arms the listed points (an empty string is a no-op;
    disarm via /fault or fault.disarm_all())."""
    text = text.strip()
    if not text:
        return True
    try:
        for entry in text.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            parts = entry.split(":")
            name = parts[0].strip()
            if not name:
                return False
            kv: Dict[str, str] = {}
            if len(parts) > 1 and parts[1].strip():
                kv["mode"] = parts[1].strip()
            for piece in parts[2:]:
                if "=" not in piece:
                    return False
                k, v = piece.split("=", 1)
                kv[k.strip()] = v.strip()
            parse_spec_kv(name, kv)
    except (ValueError, KeyError):
        return False
    return True


flags.define("fault_spec", "",
             "Arm fault points from a string: 'point:mode[:k=v...];...' "
             "(e.g. tpu.frame.drop:oneshot:after=2). Applied on set.",
             validator=_apply_spec_string)
