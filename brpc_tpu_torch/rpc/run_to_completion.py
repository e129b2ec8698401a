"""Run-to-completion dispatch — execute sub-quantum RPC work on the cut loop.

The reference runs usercode in the parsing bthread by default
(``usercode_inline``, input_messenger.cpp): for a handler that finishes in
microseconds, the queue->worker hop costs more than the work. Our Python
lane pays that hop twice per RPC (request dispatch on the server, response
completion on the client), and on the small-message path the two context
switches dominate the echo's latency.

This module decides, per parsed message, whether to run ``process()``
directly on the cut-loop/poller thread instead of ``start_background``:

* **Requests** run inline only when the method is *classified cheap*: the
  handler opted in (:func:`inline_eligible`) or the method's observed
  execution-time EMA — fed by the queued path — sits below ``rtc_cheap_us``.
  A message must also be small (body <= ``rtc_max_body``, no attachment).
* **Responses** (client side) run inline whenever small: completion is
  framework code — parse + wake the joiner — and user ``done`` callbacks
  are still offloaded to a fiber worker by the completion path (the
  dispatcher threads are marked ``brpc_no_user_code``).
* **The guard:** an inline run that exceeds ``rtc_budget_us`` demotes the
  method back to queued dispatch, stickily, and counts a demotion. The
  poller is protected from a mis-classified handler after its first
  overrun; auto-classification protects it from the first run (a method
  needs a cheap queued track record before it ever runs inline).

Everything that executes on the poller here is marked ``@poller_context``
so tpulint's no-blocking-in-poller rule covers this module's own code; the
*handler's* body is exactly what the runtime budget guard exists for.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from brpc_tpu_torch import flags
from brpc_tpu_torch.analysis.markers import poller_context
from brpc_tpu_torch.metrics.reducer import Adder

g_rtc_inline_requests = Adder("g_rtc_inline_requests")
g_rtc_inline_responses = Adder("g_rtc_inline_responses")
g_rtc_demotions = Adder("g_rtc_demotions")

# queued observations a method needs before auto-classification may
# promote it (an unknown handler never runs on the poller blind)
MIN_SAMPLES = 8
_EMA_ALPHA = 0.2
# consecutive budget overruns before a sticky demotion: on a shared core
# a single wall-clock outlier is usually preemption, not the handler
DEMOTE_AFTER = 3


def inline_eligible(fn):
    """Handler decorator: opt this method into run-to-completion dispatch
    without waiting for auto-classification. The budget guard still
    applies — an overrun demotes the method like any other."""
    fn.__rtc_inline__ = True
    return fn


class MethodClass:
    """Per-(service, method) run-to-completion classification state."""

    __slots__ = ("key", "ema_us", "samples", "hits", "demotions",
                 "demoted", "opted_in", "overruns")

    def __init__(self, key: Tuple[str, str]):
        self.key = key
        self.ema_us = 0.0
        self.samples = 0
        self.hits = 0
        self.demotions = 0
        self.demoted = False
        self.opted_in: Optional[bool] = None  # None = not yet resolved
        self.overruns = 0  # consecutive inline budget overruns

    def observe(self, us: float) -> None:
        # racy update under the GIL: a lost sample only delays the EMA
        if self.samples == 0:
            self.ema_us = us
        else:
            self.ema_us += _EMA_ALPHA * (us - self.ema_us)
        self.samples += 1


_classes: Dict[Tuple[str, str], MethodClass] = {}
_classes_lock = threading.Lock()


def _class_for(key: Tuple[str, str]) -> MethodClass:
    mc = _classes.get(key)
    if mc is None:
        with _classes_lock:
            mc = _classes.get(key)
            if mc is None:
                mc = MethodClass(key)
                _classes[key] = mc
    return mc


def _resolve_opt_in(server, key: Tuple[str, str]) -> bool:
    """Did the handler carry @inline_eligible? Resolved once per method."""
    if server is None:
        return False
    try:
        svc = server.find_service(key[0])
        entry = svc.find_method(key[1]) if svc is not None else None
        fn = getattr(entry, "fn", None) if entry is not None else None
        return bool(getattr(fn, "__rtc_inline__", False))
    except Exception:
        return False


# ------------------------------------------------------------------ dispatch
@poller_context
def dispatch(msg, server) -> bool:
    """Run ``msg`` to completion on the calling (cut-loop) thread if it
    qualifies; returns False when the caller should queue it instead.

    Only trpc_std traffic participates: other protocols either already
    process inline (frame protocols) or carry order/stateful semantics
    this path has not been audited for.
    """
    if msg.protocol.name != "trpc_std" or not flags.get("rtc_enable"):
        return False
    meta = msg.meta
    if meta.attachment_size or len(msg.body) > int(flags.get("rtc_max_body")):
        return False
    if meta.HasField("stream_settings"):
        # stream-create handshake: its response must commit to the wire
        # before any server-pushed stream frame, and a cut-thread run
        # could bank the response in a coalesced doorbell while TSTR
        # frames go direct on the main lane — keep it on the queued path
        return False
    if not meta.HasField("request"):
        # client-side completion: framework-only work (user done callbacks
        # offload via the brpc_no_user_code thread mark)
        g_rtc_inline_responses.put(1)
        _run(msg, server)
        return True
    req = meta.request
    mc = _class_for((req.service_name, req.method_name))
    if mc.demoted:
        return False
    if mc.opted_in is None:
        mc.opted_in = _resolve_opt_in(server, mc.key)
    if not mc.opted_in and (mc.samples < MIN_SAMPLES
                            or mc.ema_us > float(flags.get("rtc_cheap_us"))):
        return False
    t0 = time.perf_counter_ns()
    _run(msg, server)
    us = (time.perf_counter_ns() - t0) / 1000.0
    mc.observe(us)
    mc.hits += 1
    g_rtc_inline_requests.put(1)
    if us > float(flags.get("rtc_budget_us")):
        mc.overruns += 1
        if mc.overruns >= DEMOTE_AFTER:
            mc.demoted = True
            mc.demotions += 1
            g_rtc_demotions.put(1)
    else:
        mc.overruns = 0
    return True


@poller_context
def _run(msg, server) -> None:
    from brpc_tpu_torch.rpc.input_messenger import _process_one

    _process_one(msg, server)


def observe_queued(msg, server) -> None:
    """Queued-path execution wrapper: time the processing of small
    requests to feed auto-classification. Runs on a fiber worker."""
    from brpc_tpu_torch.rpc.input_messenger import _process_one

    meta = msg.meta
    if (msg.protocol.name == "trpc_std" and meta.HasField("request")
            and not meta.attachment_size
            and len(msg.body) <= int(flags.get("rtc_max_body"))):
        req = meta.request
        mc = _class_for((req.service_name, req.method_name))
        t0 = time.perf_counter_ns()
        _process_one(msg, server)
        mc.observe((time.perf_counter_ns() - t0) / 1000.0)
        return
    _process_one(msg, server)


# ------------------------------------------------------------------- surface
def method_stats() -> Dict[str, Dict[str, object]]:
    """Per-method snapshot for /tpu and tests."""
    with _classes_lock:
        items = list(_classes.items())
    return {
        f"{svc}.{mth}": {
            "ema_us": round(mc.ema_us, 1),
            "samples": mc.samples,
            "hits": mc.hits,
            "demotions": mc.demotions,
            "demoted": mc.demoted,
            "opted_in": bool(mc.opted_in),
        }
        for (svc, mth), mc in sorted(items)
    }


def stats() -> Dict[str, object]:
    return {
        "inline_requests": g_rtc_inline_requests.get_value(),
        "inline_responses": g_rtc_inline_responses.get_value(),
        "demotions": g_rtc_demotions.get_value(),
        "methods": method_stats(),
    }


def _reset_for_test() -> None:
    with _classes_lock:
        _classes.clear()
