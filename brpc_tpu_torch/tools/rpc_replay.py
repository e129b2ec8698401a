#!/usr/bin/env python
"""rpc_replay — replay rpc_dump traffic as a capacity probe
(counterpart of the reference tools/rpc_replay, grown past it).

Each dump record carries the original RpcMeta + serialized request body;
replay re-sends the body to the original service/method on a new target
through the full client stack (RawMessage passthrough — no message classes
needed).

Pacing is OPEN-LOOP: v2 records stamp their arrival wall-clock timestamps,
so the replay schedule preserves the recorded inter-arrival gaps divided
by ``--rate-mult N`` (2.0 = twice the recorded rate), and requests are
issued asynchronously under a bounded in-flight window — a slow server
stretches its own latencies, not the offered load. That is what makes an
N× replay a capacity probe rather than a closed loop that self-throttles.
``--qps`` overrides with a fixed-rate schedule; v1 dumps (no timestamps)
replay back-to-back under the in-flight cap.

Trace tagging: each replayed call reuses the recorded trace_id, with the
recorded client span as its parent — replayed server spans land in the
target's /rpcz under the SAME trace ids as their recorded counterparts,
so ``python -m brpc_tpu_torch.trace.diff`` can align the two runs
record-by-record.

Soak: ``--loop N`` repeats the schedule N times (0 = until ``--duration``
seconds elapse); a live ``qps/ok/fail/p50/p99`` readout prints every
``--report-interval`` seconds on stderr.

Examples:
    python -m brpc_tpu_torch.tools.rpc_replay --dump DIR \\
        --server 127.0.0.1:8000
    python -m brpc_tpu_torch.tools.rpc_replay --dump DIR \\
        --server tpu://h:p/0 --rate-mult 2 --loop 0 --duration 60
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from brpc_tpu_torch.metrics.latency_recorder import (  # noqa: E402
    LatencyRecorder)
from brpc_tpu_torch.policy import compress as _compress  # noqa: E402
from brpc_tpu_torch.rpc import (Channel, ChannelOptions,  # noqa: E402
                                Controller, MethodDescriptor)
from brpc_tpu_torch.rpc import errors as _errors  # noqa: E402
from brpc_tpu_torch.rpc.channel import RawMessage  # noqa: E402


class _ReplayItem:
    """One decoded dump record, ready to fire repeatedly."""

    __slots__ = ("md", "payload", "attachment", "trace_id",
                 "parent_span_id", "offset_s", "tenant", "priority")

    def __init__(self, md, payload, attachment, trace_id, parent_span_id,
                 tenant="", priority=0):
        self.md = md
        self.payload = payload
        self.attachment = attachment
        self.trace_id = trace_id
        self.parent_span_id = parent_span_id
        self.offset_s = 0.0
        self.tenant = tenant
        self.priority = priority


def load_items(dump_path: str):
    """Decode every dump record once: undo the attachment split and the
    compression (the dump stores the wire form) so the client stack can
    re-frame them. Returns (items, skipped)."""
    from brpc_tpu_torch.trace.rpc_dump import RpcDumpLoader

    items, skipped = [], 0
    recs = []
    for rec in RpcDumpLoader(dump_path):
        recs.append(rec)
    # open-loop pacing follows arrival order; records commit at settle so
    # the file order is completion order — re-sort by the arrival stamp
    recs.sort(key=lambda r: r.ts_us)
    t0 = next((r.ts_us for r in recs if r.ts_us > 0.0), 0.0)
    for rec in recs:
        meta, body = rec.meta, rec.body
        md = MethodDescriptor(meta.request.service_name,
                              meta.request.method_name,
                              request_class=None,
                              response_class=RawMessage)
        att = meta.attachment_size
        payload, attachment = (body[:-att], body[-att:]) if att else (body, b"")
        try:
            payload = _compress.decompress(payload, meta.compress_type)
        except Exception as e:
            skipped += 1
            print(f"undecodable record skipped: {e}", file=sys.stderr)
            continue
        item = _ReplayItem(md, payload, attachment, rec.trace_id,
                           rec.span_id,
                           tenant=str(rec.info.get("tenant", "")),
                           priority=int(rec.info.get("priority", 0)))
        if rec.ts_us > 0.0:
            item.offset_s = max(0.0, (rec.ts_us - t0) / 1e6)
        items.append(item)
    return items, skipped


class _TenantStats:
    """Per-tenant slice of the replay outcome: QoS sheds (EOVERCROWDED)
    counted apart from other failures so an overload replay can assert
    WHO got shed, not just how many calls failed."""

    __slots__ = ("sent", "ok", "fail", "shed", "recorder")

    def __init__(self):
        self.sent = 0
        self.ok = 0
        self.fail = 0
        self.shed = 0
        self.recorder = LatencyRecorder()

    def as_dict(self):
        r = self.recorder
        return {
            "sent": self.sent, "ok": self.ok, "fail": self.fail,
            "shed": self.shed,
            "p50_us": round(r.latency_percentile(0.5), 1) if self.ok else 0.0,
            "p99_us": round(r.latency_percentile(0.99), 1) if self.ok else 0.0,
        }


class _Stats:
    def __init__(self):
        self.lock = threading.Lock()
        self.sent = 0
        self.ok = 0
        self.fail = 0
        self.shed = 0
        self.recorder = LatencyRecorder()
        self.first_error = ""
        self.tenants = {}

    def _tenant(self, tenant: str) -> _TenantStats:
        ts = self.tenants.get(tenant)
        if ts is None:
            ts = self.tenants[tenant] = _TenantStats()
        return ts

    def mark_sent(self, tenant: str) -> None:
        with self.lock:
            self.sent += 1
            self._tenant(tenant).sent += 1

    def settle(self, cntl, latency_us: float, tenant: str = "") -> None:
        with self.lock:
            ts = self._tenant(tenant)
            if cntl.failed():
                self.fail += 1
                ts.fail += 1
                if cntl.error_code == _errors.EOVERCROWDED:
                    self.shed += 1
                    ts.shed += 1
                if not self.first_error:
                    self.first_error = (f"[E{cntl.error_code}] "
                                        f"{cntl.error_text()}")
            else:
                self.ok += 1
                ts.ok += 1
                self.recorder.record(latency_us)
                ts.recorder.record(latency_us)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dump", required=True, help="dump file or directory")
    p.add_argument("--server", required=True, help="host:port target")
    p.add_argument("--rate-mult", type=float, default=1.0,
                   help="scale the recorded inter-arrival gaps: 2.0 "
                        "replays at twice the recorded rate (default 1.0)")
    p.add_argument("--qps", type=float, default=0.0,
                   help="fixed-rate schedule overriding recorded gaps "
                        "(0 = use recorded timestamps)")
    p.add_argument("--loop", type=int, default=1,
                   help="times to replay the whole dump "
                        "(0 = loop until --duration)")
    p.add_argument("--duration", type=float, default=0.0,
                   help="stop after this many seconds (soak mode)")
    p.add_argument("--timeout-ms", type=int, default=1000)
    p.add_argument("--max-inflight", type=int, default=128,
                   help="bound on concurrently outstanding requests")
    p.add_argument("--report-interval", type=float, default=1.0,
                   help="seconds between live qps/latency readouts "
                        "(0 disables)")
    p.add_argument("--no-trace-tag", action="store_true",
                   help="do not reuse recorded trace ids on replayed calls")
    p.add_argument("--tenant-override", default=None,
                   help="replay every record under this QoS tenant instead "
                        "of the recorded one (synthetic-tenant probing)")
    p.add_argument("--priority-override", type=int, default=None,
                   help="replay every record at this QoS priority instead "
                        "of the recorded one")
    p.add_argument("--json-out", default=None,
                   help="write the final totals + per-tenant stats as JSON "
                        "to this file (machine-readable overload gate)")
    p.add_argument("--protocol", default="trpc_std")
    args = p.parse_args(argv)

    if args.rate_mult <= 0.0:
        print("--rate-mult must be > 0", file=sys.stderr)
        return 2
    items, skipped = load_items(args.dump)
    if not items:
        print(f"no replayable records in {args.dump}", file=sys.stderr)
        return 1
    if args.qps > 0.0:
        for i, item in enumerate(items):
            item.offset_s = i / args.qps
    else:
        for item in items:
            item.offset_s /= args.rate_mult

    channel = Channel(ChannelOptions(
        protocol=args.protocol, timeout_ms=args.timeout_ms,
        max_retry=0)).init(args.server)

    from brpc_tpu_torch.trace import span as _span

    stats = _Stats()
    inflight = threading.BoundedSemaphore(max(1, args.max_inflight))
    stop_evt = threading.Event()

    def reporter():
        last_sent = 0
        t0 = time.monotonic()
        last_t = t0
        while not stop_evt.wait(args.report_interval):
            now = time.monotonic()
            with stats.lock:
                sent, ok, fail = stats.sent, stats.ok, stats.fail
                p50 = stats.recorder.latency_percentile(0.5)
                p99 = stats.recorder.latency_percentile(0.99)
            qps = (sent - last_sent) / max(1e-9, now - last_t)
            print(f"t={now - t0:6.1f}s sent={sent} ok={ok} fail={fail} "
                  f"qps={qps:.0f} p50={p50 / 1000.0:.2f}ms "
                  f"p99={p99 / 1000.0:.2f}ms", file=sys.stderr)
            last_sent, last_t = sent, now

    if args.report_interval > 0:
        threading.Thread(target=reporter, name="replay-report",
                         daemon=True).start()

    def issue(item: _ReplayItem, pass_num: int) -> None:
        cntl = Controller()
        cntl.request_attachment = item.attachment
        # QoS identity rides with the replay: recorded tenant/priority by
        # default, overridable to probe synthetic tenants against a live
        # fair-share config
        tenant = (args.tenant_override if args.tenant_override is not None
                  else item.tenant)
        priority = (args.priority_override
                    if args.priority_override is not None
                    else item.priority)
        cntl.tenant_id = tenant
        cntl.priority = priority
        if item.trace_id and not args.no_trace_tag:
            # replayed span: same trace as the recording, hung under the
            # recorded client span so the stitched tree shows the pair
            sp = _span.Span(item.trace_id, _span._gen_id(),
                            item.parent_span_id, _span.KIND_CLIENT,
                            item.md.service_name, item.md.method_name)
            sp.annotate(f"replay pass={pass_num} "
                        f"rate_mult={args.rate_mult:g}")
            cntl.span = sp
        t_start = time.perf_counter_ns()

        def on_done(c):
            stats.settle(c, (time.perf_counter_ns() - t_start) / 1000.0,
                         tenant)
            inflight.release()

        stats.mark_sent(tenant)
        try:
            channel.call_method(item.md, RawMessage(item.payload),
                                response=RawMessage(), controller=cntl,
                                done=on_done)
        except Exception as e:
            inflight.release()
            with stats.lock:
                stats.fail += 1
                stats._tenant(tenant).fail += 1
                if not stats.first_error:
                    stats.first_error = str(e)

    start = time.monotonic()
    deadline = start + args.duration if args.duration > 0 else None
    pass_num = 0
    stopped = False
    while not stopped:
        pass_num += 1
        base = time.monotonic()
        for item in items:
            if deadline is not None and time.monotonic() >= deadline:
                stopped = True
                break
            fire_at = base + item.offset_s
            now = time.monotonic()
            if fire_at > now:
                time.sleep(fire_at - now)
            inflight.acquire()
            issue(item, pass_num)
        if args.loop > 0 and pass_num >= args.loop:
            break
        if args.loop == 0 and deadline is None:
            break  # loop-forever needs a duration to be finite
    # drain: reclaim every in-flight permit before summarizing
    for _ in range(max(1, args.max_inflight)):
        inflight.acquire()
    stop_evt.set()

    elapsed = time.monotonic() - start
    qps = stats.sent / max(1e-9, elapsed)
    print(f"replayed ok {stats.ok} failed {stats.fail} "
          f"shed {stats.shed} skipped {skipped} "
          f"passes {pass_num} elapsed {elapsed:.2f}s qps {qps:.0f}")
    if stats.ok:
        r = stats.recorder
        print(f"latency_avg_us {r.latency():.1f} "
              f"p50_us {r.latency_percentile(0.5):.1f} "
              f"p99_us {r.latency_percentile(0.99):.1f}")
    for name in sorted(stats.tenants):
        td = stats.tenants[name].as_dict()
        print(f"tenant {name or '-'} sent {td['sent']} ok {td['ok']} "
              f"shed {td['shed']} fail {td['fail']} "
              f"p50_us {td['p50_us']:.1f} p99_us {td['p99_us']:.1f}")
    if args.json_out:
        import json
        payload = {
            "sent": stats.sent, "ok": stats.ok, "fail": stats.fail,
            "shed": stats.shed, "skipped": skipped,
            "passes": pass_num, "elapsed_s": round(elapsed, 3),
            "qps": round(qps, 1),
            "p50_us": (round(stats.recorder.latency_percentile(0.5), 1)
                       if stats.ok else 0.0),
            "p99_us": (round(stats.recorder.latency_percentile(0.99), 1)
                       if stats.ok else 0.0),
            "tenants": {name: ts.as_dict()
                        for name, ts in sorted(stats.tenants.items())},
        }
        with open(args.json_out, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.write("\n")
    if stats.fail and stats.first_error:
        print(f"first_error {stats.first_error}", file=sys.stderr)
    return 0 if stats.fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
