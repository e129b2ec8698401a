"""Shard dispatch worker — one OS process owning a cid-slice of the lane.

Spawned by the parent's ShardPlane as ``python -m brpc_tpu_torch.shard.worker``
with a one-line JSON config on stdin. The worker attaches the two shm
doorbell rings by name, builds a dispatch-only Server (services from the
configured factory, no listener, no crash handler), and runs a
cut-loop-shaped main loop: pop raw TRPC frames off the in-ring, feed them
through the STOCK InputMessenger + server_processing stack (rtc fastpath
included — the fast-path machinery runs unchanged in here), and ship responses
back on the out-ring:

- small response  -> ``W_RESP`` (whole packet bytes; parent banks it into
  the coalesced doorbell fan-in write),
- bulk response   -> fill leased sub-window blocks (ONE memcpy, directly
  into client-visible registered memory) -> ``W_RESP_SEGS`` (indices +
  lengths only),
- giant response  -> spill to a fresh named shm segment -> ``W_RESP_SHM``
  (name + length; the parent streams it through the credit window and
  unlinks it). Handles cross the ring; payload bytes never ride a pipe.

Lifecycle: stdin EOF means the parent died — a watcher thread hard-exits
so no orphan survives a parent crash. ``R_QUIT`` is the orderly goodbye.
Every thread registers with the profiling registry under the
``worker:<i>/`` role prefix, so /hotspots/continuous stacks sampled here
(and shipped home as ``W_PROF`` folded lines) attribute to this worker.
"""

from __future__ import annotations

import json
import os
import struct
import sys
import threading
import time as _time
from typing import Dict, Optional

from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.shard import wire
from brpc_tpu_torch.shard.ring import ShardRing
from brpc_tpu_torch.shard.subwindow import SubWindow

_II = struct.Struct("!II")
_I = struct.Struct("!I")

# flags the parent mirrors into the worker (all reloadable): the dispatch
# stack in here must classify/inline exactly like the parent's would
_FLAG_ALLOWLIST = (
    "rtc_enable", "rtc_budget_us", "rtc_cheap_us", "rtc_max_body",
    "stream_body_min_bytes", "max_body_size", "shard_vars_interval_s",
    "var_series_enabled",
)

STATS_INTERVAL_S = 0.5
PROF_INTERVAL_S = 2.0
LEASE_REQ_MIN_INTERVAL_S = 0.05


class _WorkerEndpoint:
    """Worker-side state for one adopted tunnel endpoint: a duck vsock the
    RPC stack dispatches through, plus the credit sub-window (None on
    inline-only tunnels)."""

    __slots__ = ("ep_id", "epoch", "vsock", "sub", "last_lease_req")

    def __init__(self, ep_id: int, epoch: int, vsock, sub):
        self.ep_id = ep_id
        self.epoch = epoch
        self.vsock = vsock
        self.sub: Optional[SubWindow] = sub
        self.last_lease_req = 0.0


class WorkerVSocket:
    """Duck-typed stand-in for TpuTransportSocket on the worker side: the
    stock InputMessenger/server_processing stack reads and writes exactly
    this surface. ``write`` routes the packed response to the worker's
    out-ring instead of a ctrl socket."""

    def __init__(self, worker: "ShardWorker", server):
        self.worker = worker
        self.wep: Optional[_WorkerEndpoint] = None   # set right after ctor
        self.read_buf = IOBuf()
        self.pending_body = None
        self.preferred_protocol = None
        self.failed = False
        self.error_code = 0
        self.error_text = ""
        self.remote = None
        self.owner_server = server
        self.user_data = None
        self.in_bytes = 0
        self.out_bytes = 0
        self.in_messages = 0
        self.out_messages = 0
        self.last_active = _time.monotonic()

    # pending-id surface: workers see requests only, never call replies
    def add_pending_id(self, cid: int) -> None:
        pass

    def remove_pending_id(self, cid: int) -> bool:
        return False

    def write(self, data, id_wait: Optional[int] = None) -> int:
        packet = data if isinstance(data, IOBuf) else IOBuf(bytes(data))
        rc = self.worker.send_response(self.wep, packet)
        if rc == 0:
            self.out_messages += 1
            self.out_bytes += len(packet)
        return rc

    def set_failed(self, code: int, reason: str = "") -> None:
        # a bad forwarded frame poisons only itself: each R_MSG carries one
        # complete validated TRPC frame, so drop buffered state and keep
        # serving — the parent-side tunnel owns real failure semantics
        self.worker.parse_errors += 1
        self.error_code = code
        self.error_text = reason
        self.pending_body = None
        self.read_buf.clear()


class ShardWorker:
    def __init__(self, cfg: dict, in_ring: ShardRing, out_ring: ShardRing):
        self.cfg = cfg
        self.index = int(cfg["index"])
        self.gen = int(cfg.get("gen", 0))
        self.in_ring = in_ring          # parent -> worker
        self.out_ring = out_ring        # worker -> parent
        self._out_lock = threading.Lock()
        self._quit = False
        self.eps: Dict[int, _WorkerEndpoint] = {}
        self.dispatched = 0
        self.resp_inline = 0
        self.resp_segs = 0
        self.resp_shm = 0
        self.parse_errors = 0
        self.server = None
        self.messenger = None

    # ------------------------------------------------------------- bootstrap
    def build_server(self):
        from brpc_tpu_torch.policy import ensure_registered
        from brpc_tpu_torch.rpc.input_messenger import InputMessenger
        from brpc_tpu_torch.rpc.server import Server, ServerOptions

        ensure_registered()
        srv = Server(ServerOptions())
        factory = (self.cfg.get("factory")
                   or "brpc_tpu_torch.shard.testing:echo_services")
        mod_name, _, attr = factory.partition(":")
        import importlib

        mod = importlib.import_module(mod_name)
        for svc in getattr(mod, attr or "services")():
            srv.add_service(svc)
        # dispatch-only: no listener, no crash handler — just flip the
        # admission gate so process_rpc_request serves instead of ELOGOFF
        srv._running = True
        srv._logoff = False
        self.server = srv
        self.messenger = InputMessenger(server=srv)

    # ------------------------------------------------------------- out-ring
    def push_out(self, rtype: int, payload: bytes) -> bool:
        if len(payload) + 8 > self.out_ring.capacity:
            return False
        while True:
            with self._out_lock:
                if self.out_ring.push(rtype, payload):
                    return True
            if self._quit:
                return False
            _time.sleep(0.0005)  # parked until the collector drains a slot

    # -------------------------------------------------------- response path
    def send_response(self, wep: Optional[_WorkerEndpoint],
                      packet: IOBuf) -> int:
        if wep is None:
            return -1
        total = len(packet)
        head = packet.fetch(12)
        if len(head) < 12 or head[:4] != b"TRPC":
            return -1
        meta_size = int.from_bytes(head[4:8], "big")
        cid = wire.response_cid(packet.fetch(12 + meta_size), meta_size)
        from brpc_tpu_torch.tpu.transport import INLINE_MAX

        sub = wep.sub
        if total > INLINE_MAX and sub is not None:
            got = sub.take_now(-(-total // sub.block_size))
            if got is not None:
                return self._respond_segs(wep, cid, packet, total, got)
            self._maybe_request_lease(wep, -(-total // sub.block_size))
        if total + wire._IQ.size + 8 > self.out_ring.capacity // 4:
            return self._respond_shm(wep, cid, packet, total)
        self.resp_inline += 1
        ok = self.push_out(wire.W_RESP,
                           wire.encode_resp(wep.ep_id, cid,
                                            packet.tobytes()))
        return 0 if ok else -1

    def _respond_segs(self, wep, cid: int, packet: IOBuf, total: int,
                      got) -> int:
        sub = wep.sub
        bs = sub.block_size
        views = [memoryview(v) for v in packet.iter_blocks() if len(v)]
        segs = []
        sent = 0
        vi, voff = 0, 0
        buf = sub._shm.buf
        for idx in got:
            base = idx * bs
            blk_off = 0
            while blk_off < bs and sent < total:
                v = views[vi]
                take = min(bs - blk_off, len(v) - voff)
                buf[base + blk_off:base + blk_off + take] = \
                    v[voff:voff + take]
                blk_off += take
                voff += take
                sent += take
                if voff == len(v):
                    vi += 1
                    voff = 0
            segs.append((idx, blk_off))
            if sent >= total:
                break
        self.resp_segs += 1
        ok = self.push_out(wire.W_RESP_SEGS,
                           wire.encode_resp_segs(wep.ep_id, wep.epoch, cid,
                                                 segs))
        return 0 if ok else -1

    def _respond_shm(self, wep, cid: int, packet: IOBuf, total: int) -> int:
        """Giant-response escape: the packet doesn't fit the ring and no
        lease covers it — spill to a fresh named segment and ship the
        handle. The PARENT unlinks after streaming it out."""
        import secrets
        from multiprocessing import shared_memory as _shm

        from brpc_tpu_torch.shard.ring import _untrack

        name = f"brpctpu_torch_spill_{os.getpid():x}_{secrets.token_hex(4)}"
        seg = _shm.SharedMemory(name=name, create=True, size=max(total, 1))
        off = 0
        for v in packet.iter_blocks():
            seg.buf[off:off + len(v)] = v
            off += len(v)
        seg.close()
        _untrack(name)  # parent owns the unlink from here
        self.resp_shm += 1
        body = struct.pack("!IQQ", wep.ep_id, cid, total) + name.encode()
        ok = self.push_out(wire.W_RESP_SHM, body)
        if not ok:
            try:
                _shm.SharedMemory(name=name).unlink()
            except Exception:
                pass
            return -1
        return 0

    def _maybe_request_lease(self, wep, want: int) -> None:
        now = _time.monotonic()
        if now - wep.last_lease_req < LEASE_REQ_MIN_INTERVAL_S:
            return
        wep.last_lease_req = now
        with self._out_lock:
            self.out_ring.push(wire.W_LEASE_REQUEST,
                               wire.encode_want(wep.ep_id, max(want, 4)))

    # --------------------------------------------------------- in-ring side
    def handle(self, rtype: int, payload: bytes) -> None:
        if rtype == wire.R_MSG:
            ep_id, frame = wire.decode_msg(payload)
            wep = self.eps.get(ep_id)
            if wep is None:
                return
            wep.vsock.read_buf.append(frame)
            wep.vsock.in_bytes += len(frame)
            wep.vsock.last_active = _time.monotonic()
            self.dispatched += 1
            self.messenger.cut_messages(wep.vsock)
        elif rtype == wire.R_ATTACH:
            ep_id, epoch = _II.unpack_from(payload)
            info = json.loads(payload[_II.size:].decode())
            old = self.eps.pop(ep_id, None)
            if old is not None and old.sub is not None:
                old.sub.close()
            sub = None
            if info.get("pool"):
                try:
                    sub = SubWindow(info["pool"], int(info["bs"]),
                                    int(info["bc"]), epoch)
                except Exception:
                    sub = None   # cross-host tunnel: W_RESP fallback only
            vs = WorkerVSocket(self, self.server)
            wep = _WorkerEndpoint(ep_id, epoch, vs, sub)
            vs.wep = wep
            self.eps[ep_id] = wep
        elif rtype == wire.R_LEASE_GRANT:
            ep_id, epoch, idxs = wire.decode_indices(payload)
            wep = self.eps.get(ep_id)
            if wep is None or wep.sub is None \
                    or not wep.sub.grant(idxs, epoch):
                # unknown endpoint / stale epoch: bounce the credits home
                self.push_out(wire.W_LEASE_RETURN,
                              wire.encode_indices(ep_id, epoch, idxs))
        elif rtype == wire.R_LEASE_RECLAIM:
            ep_id, want = wire.decode_want(payload)
            wep = self.eps.get(ep_id)
            if wep is not None and wep.sub is not None:
                back = wep.sub.give_back(want)
                if back:
                    self.push_out(wire.W_LEASE_RETURN,
                                  wire.encode_indices(ep_id, wep.epoch,
                                                      back))
        elif rtype == wire.R_DETACH:
            wep = self.eps.pop(_I.unpack_from(payload)[0], None)
            if wep is not None and wep.sub is not None:
                wep.sub.close()
        elif rtype == wire.R_QUIT:
            self._quit = True

    # ------------------------------------------------------------ telemetry
    def _stats_json(self) -> bytes:
        eps = {}
        for ep_id, wep in self.eps.items():
            sub = wep.sub
            eps[str(ep_id)] = {
                "lease_free": sub.free_count() if sub else 0,
                "lease_granted": sub.granted_total if sub else 0,
                "lease_taken": sub.taken_total if sub else 0,
            }
        return json.dumps({
            "pid": os.getpid(),
            "gen": self.gen,
            "dispatched": self.dispatched,
            "resp_inline": self.resp_inline,
            "resp_segs": self.resp_segs,
            "resp_shm": self.resp_shm,
            "parse_errors": self.parse_errors,
            "ring_pushed": self.out_ring.pushed,
            "ring_full": self.out_ring.push_full,
            "eps": eps,
        }).encode()

    def _prof_lines(self, since: float) -> bytes:
        try:
            from brpc_tpu_torch.profiling.sampler import continuous

            cont = continuous()
            if cont is None:
                return b""
            prof = cont.query(from_ts=since)
            lines = prof.folded_lines(tag_role=True, tag_phase=True)
            lines.sort(key=lambda ln: -int(ln.rsplit(" ", 1)[1]))
            return "\n".join(lines[:40]).encode()
        except Exception:
            return b""

    # ------------------------------------------------------------ main loop
    def run(self) -> int:
        from brpc_tpu_torch.fiber import wakeup as _wakeup
        from brpc_tpu_torch.profiling import registry as _prof
        from brpc_tpu_torch.profiling.sampler import ensure_continuous_started

        _prof.register_current_thread("shard_cut")
        ensure_continuous_started()
        self.build_server()
        self.push_out(wire.W_READY, _I.pack(os.getpid()))
        spin = _wakeup.get_spin("shard_worker_ring", initial=64,
                                ceiling=2048)
        idle_sleep = 0.0
        last_stats = _time.monotonic()
        last_prof = last_stats
        last_vars = last_stats
        last_prof_ts = _time.time()
        from brpc_tpu_torch import flags as _flags
        from brpc_tpu_torch.shard.fleet import worker_snapshot
        vars_interval = float(_flags.get("shard_vars_interval_s"))
        while not self._quit:
            recs = self.in_ring.pop(64)
            if recs:
                idle_sleep = 0.0
                for rtype, payload in recs:
                    self.handle(rtype, payload)
            else:
                if not spin.spin(lambda: not self.in_ring.empty):
                    # escalate toward a 2ms floor: idle worker stays <1%
                    # CPU on the shared core, busy ring picked up in-spin
                    idle_sleep = min(0.002, idle_sleep + 0.0002)
                    _time.sleep(idle_sleep)
            now = _time.monotonic()
            if now - last_stats >= STATS_INTERVAL_S:
                last_stats = now
                with self._out_lock:
                    self.out_ring.push(wire.W_STATS, self._stats_json())
            if now - last_prof >= PROF_INTERVAL_S:
                last_prof = now
                lines = self._prof_lines(last_prof_ts)
                last_prof_ts = _time.time()
                if lines:
                    with self._out_lock:
                        self.out_ring.push(wire.W_PROF, lines)
            if now - last_vars >= vars_interval:
                last_vars = now
                try:
                    snap = worker_snapshot(self.index)
                except Exception:
                    snap = b""
                if snap:
                    with self._out_lock:
                        self.out_ring.push(wire.W_VARS, snap)
        for wep in self.eps.values():
            if wep.sub is not None:
                wep.sub.close()
        self.in_ring.close()
        self.out_ring.close()
        return 0


def _watch_parent() -> None:
    """Block on stdin until EOF (parent exited or closed our pipe), then
    hard-exit: an orphan worker must never outlive its plane. Raw os.read
    — not sys.stdin.buffer — so this daemon thread never holds the
    buffered-reader lock the interpreter wants back at shutdown."""
    try:
        while os.read(0, 65536):
            pass
    except Exception:
        pass
    os._exit(0)


def main() -> int:
    line = sys.stdin.buffer.readline()
    if not line:
        return 1
    cfg = json.loads(line.decode())
    watcher = threading.Thread(target=_watch_parent, name="shard-parent-eof",
                               daemon=True)
    watcher.start()
    from brpc_tpu_torch import flags as _flags
    from brpc_tpu_torch.profiling import registry as _prof

    _prof.set_role_prefix(f"worker:{cfg['index']}/")
    for name in _FLAG_ALLOWLIST:
        if name in cfg.get("flags", {}):
            try:
                _flags.set_flag(name, cfg["flags"][name])
            except Exception:
                pass
    in_ring = ShardRing.attach(cfg["in_ring"])
    out_ring = ShardRing.attach(cfg["out_ring"])
    return ShardWorker(cfg, in_ring, out_ring).run()


if __name__ == "__main__":
    sys.exit(main())
