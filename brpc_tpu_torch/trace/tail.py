"""Tail-based trace retention — keep the traces worth replaying.

Head sampling (``rpc_dump_ratio``) decides at *arrival*, so at ratio r it
keeps r of everything — including r of the slow/errored tail an operator
actually replays. Tail retention moves the decision to *settle* time, when
the span's latency, error code and the process's health are all known:

- **retain immediately** when the request errored, was QoS-shed
  (EOVERCROWDED / ELIMIT), or ran slower than
  ``rpc_dump_tail_slow_x`` × its method's live p99;
- **hold** everything else in a bounded deferred-decision ring for
  ``rpc_dump_tail_hold_s`` seconds — if a watch rule fires inside the
  window, the held traces around the firing are retained too
  (reason ``watch:<rule>``), which is exactly the context an incident
  post-mortem wants and head sampling statistically discards;
- expired holds are dropped unwritten.

Every commit still passes the ``rpc_dump_tail_max_per_sec`` token bucket
(same monotonic-bucket shape as RpcDumper's), so a latency storm can't turn
the retainer into its own overload. Records land in the normal v2 dump
stream with ``retained: "tail"`` + ``retention_reason`` stamped into the
extra blob, and the settled span carries the reason for the
``/rpcz?retained=tail`` filter.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Optional

from brpc_tpu_torch import flags as _flags
from brpc_tpu_torch.metrics.reducer import Adder
from brpc_tpu_torch.metrics.watch import STATE_FIRING, global_watch
from brpc_tpu_torch.rpc.errors import ELIMIT, EOVERCROWDED

rpc_dump_tail = _flags.define(
    "rpc_dump_tail", False,
    "tail-based trace retention: commit settled requests to rpc_dump "
    "when slow vs their method p99, errored, QoS-shed, or correlated "
    "with a firing watch rule (independent of the rpc_dump_ratio head "
    "sampler)", reloadable=True)
rpc_dump_tail_slow_x = _flags.define(
    "rpc_dump_tail_slow_x", 2.0,
    "retain a settled request whose latency exceeds this multiple of "
    "its method's live p99 (reloadable)", validator=lambda v: v > 0)
rpc_dump_tail_max_per_sec = _flags.define(
    "rpc_dump_tail_max_per_sec", 50,
    "token-bucket cap on tail-retained dump records per second "
    "(0 = uncapped)", validator=lambda v: v >= 0)
rpc_dump_tail_hold_s = _flags.define(
    "rpc_dump_tail_hold_s", 2.0,
    "seconds a settled, individually-unremarkable request is held for "
    "watch-rule correlation before being dropped unwritten (reloadable)",
    validator=lambda v: v > 0)
rpc_dump_tail_ring = _flags.define(
    "rpc_dump_tail_ring", 256,
    "capacity of the deferred-decision ring; the oldest held request is "
    "dropped when a newer one needs the slot", validator=lambda v: v > 0)

g_dump_tail_retained = Adder("g_dump_tail_retained")  # committed records
g_dump_tail_dropped = Adder("g_dump_tail_dropped")    # holds expired/evicted
g_dump_tail_shed = Adder("g_dump_tail_shed")          # token bucket said no

REASON_SLOW = "slow_p99"
REASON_ERROR = "error"
REASON_SHED = "qos_shed"


class TailRetainer:
    """Settle-time retention front of one server's RpcDumper."""

    def __init__(self, dumper):
        self._dumper = dumper
        self._lock = threading.Lock()
        # (deadline_mono_s, pending, span, error_code)
        self._ring: deque = deque()
        self._tokens = 1.0
        self._tokens_t = time.monotonic()
        self._closed = False
        self._hook = self._on_watch
        global_watch().transition_hooks.append(self._hook)

    # ------------------------------------------------------------- decide
    @staticmethod
    def enabled() -> bool:
        return bool(_flags.get("rpc_dump_tail"))

    def offer(self, pending: Dict[str, Any], span, error_code: int,
              method_p99_us: float) -> None:
        """Hand over a settled request for the retention decision.

        ``pending`` is the dict RpcDumper.begin() returned at dispatch;
        ownership transfers here — it is either committed or dropped."""
        if span is None or self._closed:
            return
        reason = self._reason(span, error_code, method_p99_us)
        if reason is None:
            # watch correlation: a rule already firing retains immediately
            firing = global_watch().firing()
            if firing:
                reason = f"watch:{firing[0].name}"
        if reason is not None:
            self._commit(pending, span, error_code, reason)
            self._sweep()
            return
        hold_s = float(_flags.get("rpc_dump_tail_hold_s"))
        cap = int(_flags.get("rpc_dump_tail_ring"))
        with self._lock:
            while len(self._ring) >= cap:
                self._ring.popleft()
                g_dump_tail_dropped.put(1)
            self._ring.append(
                (time.monotonic() + hold_s, pending, span, error_code))
        self._sweep()

    @staticmethod
    def _reason(span, error_code: int, method_p99_us: float) -> Optional[str]:
        if error_code in (EOVERCROWDED, ELIMIT):
            return REASON_SHED
        if error_code:
            return REASON_ERROR
        slow_x = float(_flags.get("rpc_dump_tail_slow_x"))
        if method_p99_us > 0 and span.latency_us > slow_x * method_p99_us:
            return REASON_SLOW
        return None

    # -------------------------------------------------------------- commit
    def _commit(self, pending: Dict[str, Any], span, error_code: int,
                reason: str) -> None:
        if not self._take_token():
            g_dump_tail_shed.put(1)
            return
        pending["retained"] = "tail"
        pending["retention_reason"] = reason
        self._dumper.commit(pending, span, error_code)
        span.retained_reason = reason
        g_dump_tail_retained.put(1)

    def _take_token(self) -> bool:
        cap = int(_flags.get("rpc_dump_tail_max_per_sec"))
        if cap <= 0:
            return True
        with self._lock:
            now = time.monotonic()
            self._tokens = min(float(cap),
                               self._tokens + (now - self._tokens_t) * cap)
            self._tokens_t = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def _sweep(self) -> None:
        """Expire holds past their correlation deadline."""
        now = time.monotonic()
        with self._lock:
            expired = 0
            while self._ring and self._ring[0][0] <= now:
                self._ring.popleft()
                expired += 1
        if expired:
            g_dump_tail_dropped.put(expired)

    # --------------------------------------------------- watch correlation
    def _on_watch(self, rule, new_state: str) -> None:
        """Transition hook: a rule starting to fire retains every held
        request in the correlation window — the traffic *around* the
        incident is the context a post-mortem replays."""
        if new_state != STATE_FIRING or self._closed:
            return
        with self._lock:
            held = list(self._ring)
            self._ring.clear()
        for _deadline, pending, span, error_code in held:
            self._commit(pending, span, error_code, f"watch:{rule.name}")

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        self._closed = True
        try:
            global_watch().transition_hooks.remove(self._hook)
        except ValueError:
            pass
        with self._lock:
            dropped = len(self._ring)
            self._ring.clear()
        if dropped:
            g_dump_tail_dropped.put(dropped)

    def state(self) -> Dict[str, Any]:
        with self._lock:
            held = len(self._ring)
        return {
            "enabled": self.enabled(),
            "held": held,
            "slow_x": float(_flags.get("rpc_dump_tail_slow_x")),
            "hold_s": float(_flags.get("rpc_dump_tail_hold_s")),
            "max_per_sec": int(_flags.get("rpc_dump_tail_max_per_sec")),
        }
