"""Open-loop replay of a recorded Generate corpus through the port's RPC
front, with the QoS identity each record carries: the port's counterpart
of ``rpc_replay``'s pacing for one service, importing nothing of the JAX
package (``chip_smoke.py`` phase 4j replays the overload corpus with it).

:func:`load_corpus` reads a dump file or directory with the port's
``tools/rpc_replay.load_items`` and keeps, per Generate record, the
decoded ``GenerateRequest``, its arrival offset (from the first record),
and the recorded ``tenant`` / ``priority``. :func:`replay` fires each
record at ``offset / rate_mult`` after the start on its own Controller,
restamped with that tenant and priority, asynchronously (each call's
``done`` records it), and waits for every call. It returns per tenant
what ``rpc_replay``'s ``--json-out`` reports (sent, ok, fail, shed as
EOVERCROWDED, p50 / p99 latency in us over the calls that succeeded),
plus each record's outcome (its error code and tokens) and latency.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, List

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "..", ".."))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from brpc_tpu_torch.proto import serving_pb2  # noqa: E402
from brpc_tpu_torch.rpc import (Channel, ChannelOptions,  # noqa: E402
                                Controller, Stub, errors)
from brpc_tpu_torch.tools import rpc_replay  # noqa: E402

DESC = serving_pb2.DESCRIPTOR.services_by_name["LlmService"]


class Record:
    __slots__ = ("request", "offset_s", "tenant", "priority")

    def __init__(self, request, offset_s, tenant, priority):
        self.request = request
        self.offset_s = offset_s
        self.tenant = tenant
        self.priority = priority


def load_corpus(path: str) -> List[Record]:
    """Every Generate record under ``path``, in arrival order, as the
    port's ``rpc_replay.load_items`` decodes them."""
    items, _ = rpc_replay.load_items(path)
    return [Record(serving_pb2.GenerateRequest.FromString(it.payload),
                   it.offset_s, it.tenant, it.priority)
            for it in items if it.md.method_name == "Generate"]


def tenant_row(lats, codes):
    """rpc_replay's per-tenant fields over (latency us, error code)
    pairs."""
    ok = [l for l, c in zip(lats, codes) if c == 0]
    return {
        "sent": len(codes), "ok": len(ok),
        "fail": sum(1 for c in codes if c != 0),
        "shed": sum(1 for c in codes if c == errors.EOVERCROWDED),
        "p50_us": float(np.percentile(ok, 50)) if ok else 0.0,
        "p99_us": float(np.percentile(ok, 99)) if ok else 0.0,
    }


def replay(server: str, records: List[Record], rate_mult: float = 1.0,
           timeout_ms: int = 30000, wait_s: float = 300.0) -> Dict:
    """Fire ``records`` at their offsets over ``rate_mult``; returns
    ``{"tenants": {...}, "records": [(code, tokens), ...], "latency_us":
    [...], "wall_s", "start_s", "fired_s": [...]}``, the start and each
    record's send on ``time.perf_counter``'s clock (the host's monotonic
    clock, the same in every process)."""
    stub = Stub(Channel(ChannelOptions(timeout_ms=timeout_ms,
                                       max_retry=0)).init(server), DESC)
    n = len(records)
    lats = [0.0] * n
    fired = [0.0] * n
    codes = [None] * n
    tokens: List[List[int]] = [[] for _ in range(n)]
    lock = threading.Lock()
    done_ev = threading.Event()
    left = [n]

    def done_for(i, t0):
        def done(cntl):
            lat = (time.perf_counter() - t0) * 1e6
            with lock:
                lats[i] = lat
                codes[i] = cntl.error_code if cntl.failed() else 0
                if not cntl.failed():
                    tokens[i] = list(cntl._response.tokens)
                left[0] -= 1
                if left[0] == 0:
                    done_ev.set()
        return done

    start = time.perf_counter()
    for i, rec in enumerate(records):
        fire_at = start + rec.offset_s / rate_mult
        now = time.perf_counter()
        if fire_at > now:
            time.sleep(fire_at - now)
        cntl = Controller()
        cntl.tenant_id = rec.tenant
        cntl.priority = rec.priority
        fired[i] = time.perf_counter()
        stub.Generate(rec.request, controller=cntl,
                      done=done_for(i, fired[i]))
    if n and not done_ev.wait(wait_s):
        raise RuntimeError(f"replay stalled: {n - left[0]}/{n} answered")
    wall = time.perf_counter() - start
    tenants = {}
    for t in sorted({r.tenant for r in records}):
        idx = [i for i, r in enumerate(records) if r.tenant == t]
        tenants[t] = tenant_row([lats[i] for i in idx],
                                [codes[i] for i in idx])
    return {"tenants": tenants, "wall_s": wall,
            "records": list(zip(codes, tokens)), "latency_us": lats,
            "start_s": start, "fired_s": fired}
