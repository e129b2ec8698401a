"""Multi-tenant QoS: weighted fair-share admission + closed-loop overload.

The port of ``brpc_tpu/serving/qos.py``: host code only, the same
ledger, limiter and governor, installed by the port's engine
(``EngineConfig(qos=QosConfig(...))``) in front of its admission.

This module is the serving plane's answer to "an overload wave takes
every tenant down together". Three mechanisms compose, all actuating at
the same place — the engine's admission boundary:

- **TenantScheduler** — weighted fair share over the per-step
  ``token_budget``. Each tenant owns a FIFO lane and a virtual-time
  clock (stride scheduling: admitting ``cost`` prefill tokens advances
  the clock by ``cost / weight``); the scheduler always serves the
  backlogged tenant with the smallest clock, so token share converges to
  the weight ratio and an idle tenant's share redistributes to the
  backlogged ones for free. A returning tenant's clock is clamped up to
  the current virtual time — it competes again within one admission
  step, without a catch-up burst that would starve everyone else.
  Per-tenant queue caps shed EOVERCROWDED on the existing retriable
  path, and the deadline is re-checked at every admission boundary
  exactly as ``deadline_mono`` already is.

- **QosLimiter** — the closed loop: an AutoLimiter-style gradient/AIMD
  limiter (policy/limiters.py:60 ported to the serving path) driven by
  the observed queue-phase latency. The engine records every admitted
  sequence's queue wait into ``g_serving_qos_queue_wait``; the series
  rings sweep it once per second, and the sampler's post-tick hook
  (:meth:`QosGovernor.tick`) samples the ring and updates a dynamic
  admission ceiling: latency at the empty-queue floor grows the ceiling
  additively, latency above it shrinks the ceiling multiplicatively
  (``ceiling * clamp(min/avg, 0.5, 1.5) + 1``, the AutoLimiter
  gradient).

- **Priority-aware shedding** — when load exceeds the ceiling, the
  best-effort lanes (``priority < protected_priority``) shed first:
  new arrivals are rejected EOVERCROWDED at :meth:`admission_check`, and
  the governor's tick sheds already-queued best-effort work
  oldest-queued/lowest-priority first. The protected lane is only
  touched when the protected lane *alone* exceeds the ceiling.

Identity rides the wire on ``RequestMeta.tenant_id``/``priority``
(client Controller setters → both Python dispatch paths → ``cntl`` →
the engine), is recorded by rpc_dump and replayed by rpc_replay — so an
overload wave captured in production sheds the same tenants when
replayed.
"""

from __future__ import annotations

import collections
import re
import threading
import time
from typing import Callable, Deque, Dict, List, Optional

from brpc_tpu_torch import fault as _fault
from brpc_tpu_torch.metrics.latency_recorder import LatencyRecorder
from brpc_tpu_torch.metrics.reducer import Adder
from brpc_tpu_torch.metrics.status import PassiveStatus
from brpc_tpu_torch.rpc import errors

_fault.register("serving.qos.burst",
                "inflate a tenant's arrival rate at serving admission "
                "(factor=N clones each submit; match_tenant= filters)")

DEFAULT_TENANT = "default"

g_serving_qos_admitted = Adder("g_serving_qos_admitted")
g_serving_qos_shed = Adder("g_serving_qos_shed")
# queue-phase latency of the serving admission boundary (submit →
# admitted into the running batch) — the control SIGNAL: its series ring
# is what the governor samples each sampler tick
g_serving_qos_queue_wait = LatencyRecorder().expose("g_serving_qos_queue_wait")


def _fleet_qos(attr: str, reduce=sum, default=0.0):
    """Reduce a TenantScheduler property across live qos engines."""
    from brpc_tpu_torch.serving.engine import active_engines

    vals = [getattr(e.qos, attr)() for e in active_engines()
            if getattr(e, "qos", None) is not None]
    return reduce(vals) if vals else default


# fair-share occupancy: fraction of the dynamic admission ceiling the
# fleet's queued+running load occupies — > 1.0 means the closed loop is
# actively shedding down to the ceiling
g_serving_qos_occupancy = PassiveStatus(
    lambda: round(_fleet_qos("occupancy", reduce=max), 3)) \
    .expose("g_serving_qos_occupancy")
g_serving_qos_occupancy.prometheus_type = "gauge"
# starvation signal: the oldest queued wait (ms) across every tenant
# lane of every live qos engine — watched by serving_qos_starvation
g_serving_qos_max_wait_ms = PassiveStatus(
    lambda: round(_fleet_qos("oldest_wait_ms", reduce=max), 1)) \
    .expose("g_serving_qos_max_wait_ms")
g_serving_qos_max_wait_ms.prometheus_type = "gauge"

_VAR_SAFE = re.compile(r"[^A-Za-z0-9_]+")
_tenant_vars: Dict[str, Dict[str, Adder]] = {}
_tenant_vars_lock = threading.Lock()


def _vars_for_tenant(name: str) -> Dict[str, Adder]:
    """Per-tenant admitted/shed counters + queue-depth gauge, created
    once per tenant NAME process-wide (fleet-style, like g_serving_*) —
    never per request and never per engine, so the metric-churn rule's
    no-construction-on-the-request-path contract holds: tenants are
    registered at config time or on a lane's FIRST request only."""
    with _tenant_vars_lock:
        vars = _tenant_vars.get(name)
        if vars is None:
            safe = _VAR_SAFE.sub("_", name) or "_"
            depth = PassiveStatus(
                lambda n=name: int(_fleet_qos_depth(n))) \
                .expose(f"g_serving_qos_queue_depth_{safe}")
            depth.prometheus_type = "gauge"
            vars = _tenant_vars[name] = {
                "admitted": Adder(f"g_serving_qos_admitted_{safe}"),
                "shed": Adder(f"g_serving_qos_shed_{safe}"),
                "depth": depth,
            }
        return vars


def _fleet_qos_depth(tenant: str) -> int:
    from brpc_tpu_torch.serving.engine import active_engines

    return sum(e.qos.tenant_depth(tenant) for e in active_engines()
               if getattr(e, "qos", None) is not None)


class QosConfig:
    """Knobs for one engine's QoS plane."""

    def __init__(self, tenants: Optional[Dict[str, float]] = None,
                 default_weight: float = 1.0, queue_cap: int = 32,
                 protected_priority: int = 1,
                 ceiling_min: float = 2.0, ceiling_max: float = 256.0,
                 ceiling_start: float = 0.0, smoothing: float = 0.5):
        if default_weight <= 0:
            raise ValueError("default_weight must be > 0")
        if queue_cap < 1:
            raise ValueError("queue_cap must be >= 1")
        if not (ceiling_min >= 1 and ceiling_max >= ceiling_min):
            raise ValueError("need 1 <= ceiling_min <= ceiling_max")
        # tenant -> fair-share weight; unknown tenants auto-register at
        # default_weight on their first request
        self.tenants = dict(tenants or {})
        for t, w in self.tenants.items():
            if w <= 0:
                raise ValueError(f"tenant {t!r} weight must be > 0")
        self.default_weight = default_weight
        self.queue_cap = queue_cap
        # requests with priority >= protected_priority ride the protected
        # lane: shed only when the protected lane alone exceeds capacity
        self.protected_priority = protected_priority
        self.ceiling_min = ceiling_min
        self.ceiling_max = ceiling_max
        # 0 = start wide open (ceiling_max) and let the loop close in
        self.ceiling_start = ceiling_start or ceiling_max
        self.smoothing = smoothing


class QosLimiter:
    """Gradient/AIMD concurrency ceiling — policy/limiters.py's
    AutoLimiter shape, re-targeted from per-call inflight accounting to
    a once-per-tick update off the queue-wait series ring.

    ``observe`` keeps an exponentially-drifting minimum of the queue
    wait (the empty-queue service floor) and multiplies the ceiling by
    ``clamp(min/avg, 0.5, 1.5)``: waits at the floor grow the ceiling
    (additive +1 — the AIMD probe), waits above it shrink it toward
    what the hardware actually drains."""

    GRADIENT_MIN = 0.5
    GRADIENT_MAX = 1.5
    MIN_DRIFT = 1.01  # min-latency EMA decays upward 1%/tick

    def __init__(self, config: QosConfig):
        self.config = config
        self.ceiling = float(config.ceiling_start)
        self._min_wait_us = 0.0
        self._avg_wait_us = 0.0
        self.updates = 0

    def observe(self, queue_wait_us: float, inflight: int) -> float:
        """One control-loop update; returns the new ceiling."""
        cfg = self.config
        self.updates += 1
        if queue_wait_us <= 0.0:
            # idle tick (no admissions sampled): recover additively, but
            # only while load isn't pinned at the ceiling — an empty
            # sample under saturation means nothing got through, which
            # is not evidence of headroom
            if inflight < self.ceiling:
                self.ceiling = min(cfg.ceiling_max, self.ceiling + 1.0)
            return self.ceiling
        a = cfg.smoothing
        self._avg_wait_us = (queue_wait_us if self._avg_wait_us <= 0.0
                             else a * self._avg_wait_us
                             + (1.0 - a) * queue_wait_us)
        if self._min_wait_us <= 0.0:
            self._min_wait_us = self._avg_wait_us
        else:
            self._min_wait_us = min(self._min_wait_us * self.MIN_DRIFT,
                                    self._avg_wait_us)
        gradient = self._min_wait_us / self._avg_wait_us
        gradient = max(self.GRADIENT_MIN, min(self.GRADIENT_MAX, gradient))
        self.ceiling = max(cfg.ceiling_min,
                           min(cfg.ceiling_max,
                               self.ceiling * gradient + 1.0))
        return self.ceiling

    def snapshot(self) -> Dict[str, float]:
        return {"ceiling": round(self.ceiling, 1),
                "min_wait_us": round(self._min_wait_us, 1),
                "avg_wait_us": round(self._avg_wait_us, 1),
                "updates": self.updates}


class _Tenant:
    __slots__ = ("name", "weight", "cap", "vtime", "waiting",
                 "admitted_reqs", "admitted_tokens", "shed", "vars")

    def __init__(self, name: str, weight: float, cap: int):
        self.name = name
        self.weight = weight
        self.cap = cap
        self.vtime = 0.0
        self.waiting: Deque = collections.deque()
        self.admitted_reqs = 0
        self.admitted_tokens = 0
        self.shed = 0
        self.vars = _vars_for_tenant(name)


class TenantScheduler:
    """Weighted fair-share admission in front of the engine's
    ``_admit_locked``. All mutating calls run under the ENGINE's
    condition lock (the scheduler is part of the engine's queue state);
    read-only gauges tolerate racy reads."""

    def __init__(self, config: QosConfig, engine=None):
        self.config = config
        self.engine = engine
        self.limiter = QosLimiter(config)
        self._tenants: Dict[str, _Tenant] = {}
        # config-time registration so the per-tenant vars exist before
        # the first request (and the request path never constructs)
        for name in config.tenants:
            self.tenant(name)

    # ------------------------------------------------------------- tenants
    def tenant(self, name: str) -> _Tenant:
        name = name or DEFAULT_TENANT
        t = self._tenants.get(name)
        if t is None:
            weight = self.config.tenants.get(name,
                                             self.config.default_weight)
            t = self._tenants[name] = _Tenant(name, weight,
                                              self.config.queue_cap)
        return t

    def tenant_depth(self, name: str) -> int:
        t = self._tenants.get(name or DEFAULT_TENANT)
        return len(t.waiting) if t is not None else 0

    # ------------------------------------------------------------ admission
    def _running_load(self, protected_only: bool = False) -> int:
        if self.engine is None:
            return 0
        running = self.engine._running
        if not protected_only:
            return len(running)
        p = self.config.protected_priority
        return sum(1 for s in running
                   if getattr(s, "priority", 0) >= p)

    def total_depth(self) -> int:
        return sum(len(t.waiting) for t in self._tenants.values())

    def _protected_depth(self) -> int:
        p = self.config.protected_priority
        return sum(1 for t in self._tenants.values() for s in t.waiting
                   if s.priority >= p)

    def inflight(self) -> int:
        """Queued + running sequences — what the ceiling meters."""
        return self.total_depth() + self._running_load()

    def occupancy(self) -> float:
        return self.inflight() / max(self.limiter.ceiling, 1.0)

    def oldest_wait_ms(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        oldest = 0.0
        for t in self._tenants.values():
            if t.waiting:
                oldest = max(oldest, now - t.waiting[0].t_submit)
        return oldest * 1e3

    def admission_check(self, tenant_id: str, priority: int,
                        deadline_mono: float = 0.0,
                        now: Optional[float] = None) -> int:
        """The QoS admission predicate — deadline + tenant queue cap +
        limiter ceiling, in that order (cheapest evidence of death
        first). Returns 0 to admit, ERPCTIMEDOUT for an already-dead
        request, EOVERCROWDED (retriable) for a shed one. Consulted
        before ANY append to a waiting lane (:meth:`enqueue` runs it
        and the append as one decision)."""
        now = time.monotonic() if now is None else now
        if deadline_mono and now >= deadline_mono:
            return errors.ERPCTIMEDOUT
        t = self.tenant(tenant_id)
        if len(t.waiting) >= t.cap:
            self._note_shed(t)
            return errors.EOVERCROWDED
        ceiling = self.limiter.ceiling
        if self.inflight() >= ceiling:
            if priority >= self.config.protected_priority:
                # protected lane: shed only when the protected lane
                # ALONE exceeds the ceiling
                prot = (self._protected_depth()
                        + self._running_load(protected_only=True))
                if prot < ceiling:
                    return 0
            self._note_shed(t)
            return errors.EOVERCROWDED
        return 0

    def enqueue(self, seq) -> int:
        """Queue ``seq`` on its tenant's lane (engine lock held). The
        admission predicate is re-evaluated here — enqueue and check are
        one decision, so no append can bypass it."""
        code = self.admission_check(seq.tenant_id, seq.priority,
                                    getattr(seq.cntl, "deadline_mono", 0.0)
                                    if seq.cntl is not None else 0.0)
        if code != 0:
            return code
        t = self.tenant(seq.tenant_id)
        if not t.waiting:
            # returning from idle: clamp the clock up to the current
            # virtual time so the lane competes again immediately (share
            # reclaimed within one step) without a catch-up burst
            t.vtime = max(t.vtime, self._virtual_time())
        t.waiting.append(seq)
        return 0

    def _virtual_time(self) -> float:
        backlogged = [t.vtime for t in self._tenants.values() if t.waiting]
        if backlogged:
            return min(backlogged)
        return max((t.vtime for t in self._tenants.values()), default=0.0)

    # ------------------------------------------------------------ scheduling
    def peek(self, budget: int, cost_fn: Callable[[object], int]):
        """Head-of-line candidate: the backlogged tenant with the
        smallest virtual clock. Returns its head sequence when the
        prefill cost fits ``budget``, else None (the lane keeps its
        clock, so it is first in line for the NEXT step's full budget —
        the same no-starvation property the FIFO path had)."""
        best = None
        for t in self._tenants.values():
            if t.waiting and (best is None or t.vtime < best.vtime):
                best = t
        if best is None:
            return None
        head = best.waiting[0]
        if cost_fn(head) > budget:
            return None
        return head

    def drop(self, seq) -> None:
        """Remove a queued sequence without billing it (deadline death,
        shed): it never consumed share."""
        t = self._tenants.get(seq.tenant_id or DEFAULT_TENANT)
        if t is not None:
            try:
                t.waiting.remove(seq)
            except ValueError:
                pass

    def commit(self, seq, cost: int) -> None:
        """Bill an admission: pop from the lane, advance the tenant's
        clock by cost/weight (stride accounting), record the queue-phase
        wait the governor's loop closes on."""
        t = self.tenant(seq.tenant_id)
        try:
            t.waiting.remove(seq)
        except ValueError:
            pass
        cost = max(1, int(cost))
        t.vtime += cost / t.weight
        t.admitted_reqs += 1
        t.admitted_tokens += cost
        t.vars["admitted"].put(1)
        g_serving_qos_admitted.put(1)
        g_serving_qos_queue_wait.record(
            (time.monotonic() - seq.t_submit) * 1e6)

    def _note_shed(self, t: _Tenant) -> None:
        t.shed += 1
        t.vars["shed"].put(1)
        g_serving_qos_shed.put(1)

    # ------------------------------------------------------------- shedding
    def shed_victims(self, excess: int) -> List:
        """Pick up to ``excess`` queued sequences to shed (engine lock
        held): best-effort lanes first, lowest priority then
        oldest-queued within it; the protected lane only contributes
        when it alone still exceeds the ceiling after every best-effort
        lane is empty."""
        if excess <= 0:
            return []
        p = self.config.protected_priority
        queued = [s for t in self._tenants.values() for s in t.waiting]
        best_effort = sorted((s for s in queued if s.priority < p),
                             key=lambda s: (s.priority, s.t_submit))
        victims = best_effort[:excess]
        excess -= len(victims)
        if excess > 0:
            ceiling = self.limiter.ceiling
            prot = sorted((s for s in queued if s.priority >= p),
                          key=lambda s: (s.priority, s.t_submit))
            prot_load = len(prot) + self._running_load(protected_only=True)
            over = int(prot_load - ceiling)
            if over > 0:
                victims.extend(prot[:min(over, excess)])
        for s in victims:
            self.drop(s)
            self._note_shed(self.tenant(s.tenant_id))
        return victims

    # ---------------------------------------------------------- visibility
    def iter_waiting(self):
        for t in self._tenants.values():
            for s in t.waiting:
                yield s

    def snapshot(self) -> Dict[str, object]:
        total_tokens = sum(t.admitted_tokens
                           for t in self._tenants.values()) or 1
        return {
            "limiter": self.limiter.snapshot(),
            "inflight": self.inflight(),
            "occupancy": round(self.occupancy(), 3),
            "oldest_wait_ms": round(self.oldest_wait_ms(), 1),
            "protected_priority": self.config.protected_priority,
            "tenants": {
                t.name: {
                    "weight": t.weight,
                    "queued": len(t.waiting),
                    "admitted": t.admitted_reqs,
                    "admitted_tokens": t.admitted_tokens,
                    "token_share": round(t.admitted_tokens / total_tokens,
                                         3),
                    "shed": t.shed,
                    "vtime": round(t.vtime, 1),
                } for t in sorted(self._tenants.values(),
                                  key=lambda t: t.name)
            },
        }


class QosGovernor:
    """The sampler-tick half of the closed loop: installed on the series
    registry's post-tick hooks by the engine, so once per second —
    right after the rings swept — it samples the queue-wait ring,
    updates the gradient ceiling, and sheds queued work down to it."""

    VAR = "g_serving_qos_queue_wait_latency"

    def __init__(self, engine):
        self.engine = engine
        self.ticks = 0
        self.sheds = 0

    def __call__(self, registry) -> None:
        self.tick(registry=registry)

    def sample_queue_wait(self, registry) -> float:
        """Latest 1-second sample of the queue-wait latency ring (µs);
        0.0 when the ring has no real samples yet."""
        if registry is None:
            return 0.0
        series = registry.get(self.VAR)
        if series is None or series.count < 1:
            return 0.0
        return float(series.second.ordered()[-1])

    def tick(self, registry=None, sample_us: Optional[float] = None) -> None:
        """One control-loop iteration (tests drive this directly with an
        explicit ``sample_us``; production runs it off the sampler)."""
        engine = self.engine
        qos = engine.qos
        if qos is None:
            return
        self.ticks += 1
        if sample_us is None:
            sample_us = self.sample_queue_wait(registry)
        with engine._cv:
            inflight = qos.inflight()
            ceiling = qos.limiter.observe(sample_us, inflight)
            excess = qos.total_depth() + qos._running_load() - int(ceiling)
            victims = qos.shed_victims(excess) if excess > 0 else []
            self.sheds += len(victims)
        for seq in victims:
            engine._finish(seq, errors.EOVERCROWDED,
                           "qos: shed under sustained overload "
                           "(retriable)")
