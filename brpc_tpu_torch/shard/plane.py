"""ShardPlane — parent-side orchestration of the sharded dispatch plane.

One plane per Server (created at ``Server.start`` when
``tpu_shard_workers > 0``). It owns:

- **workers**: N ``brpc_tpu_torch.shard.worker`` processes, each wired up with a
  pair of shm SPSC rings (ring.py) created — and unlinked — by the parent;
- **routing**: ``shard_for(cid, n)`` hashes correlation ids to workers, so
  one call's request, retries, and response accounting all land on the
  same worker (cid-sharded tunnels);
- **the lane hook**: ``_EndpointLane.pump`` runs inside the parent's cut
  loop (input_messenger) and skims complete TRPC request frames off an
  adopted endpoint's read_buf BEFORE the parent parses them — the varint
  scan (wire.scan_request_meta) reads just enough meta to route; the
  request's Python-heavy parse/execute/respond happens in the worker;
- **doorbell fan-in**: one collector thread drains every worker's out-ring
  and banks small responses into ONE coalesced ctrl write per endpoint per
  drain round (``TpuEndpoint.fan_in_flush``), posts leased-block bulk
  responses (``post_worker_segments``), and services the lease protocol;
- **lifecycle**: a monitor thread hosts the ``worker.crash`` fault point,
  detects death, sends what the dead worker answered, runs in the parent
  the calls it never took off its ring and fans the reference's
  retriable EFAILEDSOCKET to those it took (``__init__``'s at-most-once
  note), reclaims its credit leases wholesale, bumps the plane generation, and
  respawns with backoff.

Anything the plane cannot forward (ring full, worker dead, bulk request,
non-TRPC bytes, streams) falls back to the parent's in-process dispatch —
sharding is an optimization, never a correctness gate.

The port's copy of the JAX package's ``shard/plane.py``: the ring records,
the lease protocol and the tunnel frames a worker's response rides are the
reference's byte for byte, so a client of either package talks to a
sharded server of the port. Workers are dispatch-only: they are spawned
with ``CUDA_VISIBLE_DEVICES`` defaulted to empty, so none of them can
create a CUDA context (a caller's own setting wins).
"""

from __future__ import annotations

import json
import os
import secrets
import struct
import subprocess
import sys
import threading
import time as _time
from typing import Dict, List, Optional

from brpc_tpu_torch import fault as _fault
from brpc_tpu_torch import flags as _flags
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.metrics.reducer import Adder
from brpc_tpu_torch.profiling import registry as _prof
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.shard import wire
from brpc_tpu_torch.shard.fleet import FleetVars
from brpc_tpu_torch.shard.ring import REC_OVERHEAD, ShardRing
from brpc_tpu_torch.shard.subwindow import LeaseManager

_II = struct.Struct("!II")
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

g_shard_forwarded = Adder("g_shard_forwarded")
g_shard_fallback = Adder("g_shard_fallback")
g_shard_fanin_flushes = Adder("g_shard_fanin_flushes")
g_shard_fanin_frames = Adder("g_shard_fanin_frames")
g_shard_worker_deaths = Adder("g_shard_worker_deaths")
g_shard_respawns = Adder("g_shard_respawns")


def shard_for(cid: int, n: int) -> int:
    """cid -> worker index, stable across processes and runs — routing
    stability is load-bearing: a retry re-issued with the same cid lands
    on the same worker.

    Full splitmix64 avalanche, not a bare multiplicative hash: real cids
    from a low-concurrency channel are ``version << 32`` (VersionedPool
    reuses slot 0, only the high-bits version advances), so any scheme
    that reads a fixed bit range of ``cid * K`` sees a constant — the
    original Knuth hash pinned every request of a sequential client to
    worker 0."""
    h = cid & 0xFFFFFFFFFFFFFFFF
    h ^= h >> 30
    h = (h * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    h ^= h >> 27
    h = (h * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    h ^= h >> 31
    return h % n


class WorkerHandle:
    """Parent-side record of one worker slot (survives respawns: the slot
    keeps its index, the process generation bumps)."""

    def __init__(self, index: int):
        self.index = index
        self.gen = 0
        self.proc: Optional[subprocess.Popen] = None
        self.in_ring: Optional[ShardRing] = None   # parent -> worker
        self.out_ring: Optional[ShardRing] = None  # worker -> parent
        self.alive = False          # READY seen, attaches broadcast
        self.spawned = False
        self.pid = 0
        self.respawns = 0
        # push_lock serializes ring pushes with the inflight map so a
        # worker-death snapshot can never miss a forwarded cid
        self.push_lock = threading.Lock()
        # drain_lock makes the out ring's one consumer: the collector, or
        # the monitor draining a dead worker's answers before it closes
        self.drain_lock = threading.Lock()
        # cid -> (ep_id, attempt, frame, end): the frame is kept so a call
        # the worker never took off its ring can run in the parent; end is
        # the in ring's cursor past the request's record
        self.inflight: Dict[int, tuple] = {}
        self.stats: dict = {}
        self.prof_lines: str = ""


class _ParentSender:
    """The response sink of an in-parent re-dispatch: a packet goes out on
    the tunnel endpoint (the ``send_response`` surface WorkerVSocket
    writes to)."""

    def __init__(self, ep):
        self.ep = ep
        self.parse_errors = 0

    def send_response(self, wep, packet: IOBuf) -> int:
        return self.ep.send_packet(packet)


class _EndpointLane:
    """Per-adopted-endpoint shard state; ``pump`` is the cut-loop hook."""

    __slots__ = ("plane", "ep", "ep_id", "attached_epoch", "lm",
                 "attached_workers", "_attach_body")

    def __init__(self, plane: "ShardPlane", ep, ep_id: int):
        self.plane = plane
        self.ep = ep
        self.ep_id = ep_id
        self.attached_epoch = -1
        self.lm: Optional[LeaseManager] = None
        # (index, gen) pairs that have seen this lane's current R_ATTACH —
        # forward() only targets these, so a worker can never receive an
        # R_MSG for an endpoint it does not know (guarded by _attach_lock)
        self.attached_workers: set = set()
        self._attach_body = b""

    # ------------------------------------------------------------- attach
    def _ensure_attached(self) -> bool:
        ep = self.ep
        if ep._failed or not ep.ready.is_set():
            return False
        if self.attached_epoch == ep.epoch:
            return True
        win = ep.window
        info = {"pool": win._shm.name if win is not None else "",
                "bs": win.block_size if win is not None else 0,
                "bc": win.block_count if win is not None else 0}
        body = _II.pack(self.ep_id, ep.epoch) + json.dumps(info).encode()
        plane = self.plane
        with plane._attach_lock:
            self.lm = LeaseManager(win, ep.epoch) if win is not None else None
            self.attached_epoch = ep.epoch
            self.attached_workers.clear()
            self._attach_body = body
            for w in plane.workers:
                if w.alive:
                    plane._attach_to_worker(w, self)
        return True

    # --------------------------------------------------------------- pump
    def pump(self, sock) -> int:
        """Skim complete, small, cid-addressed TRPC request frames off the
        endpoint's read_buf and forward them to workers. Runs on the cut
        loop inside its batch bracket: pop_front of a forwarded frame
        fires the borrowed blocks' release hooks HERE, so their credits
        coalesce into the batch's one FT_ACK exactly as in-process parsing
        would. Anything it declines stays for the in-process parser."""
        plane = self.plane
        if plane._stop.is_set() or self.ep._failed or sock.failed:
            return 0
        if not self._ensure_attached():
            return 0
        buf = sock.read_buf
        fmax = plane.forward_max
        count = 0
        while len(buf) >= 12:
            head = buf.fetch(12)
            if head[:4] != b"TRPC":
                break
            total = 12 + int.from_bytes(head[4:8], "big") \
                + int.from_bytes(head[8:12], "big")
            if total > fmax or len(buf) < total:
                break
            frame = buf.fetch(total)   # one copy; handles/bytes, no views
            meta_size = int.from_bytes(head[4:8], "big")
            info = wire.scan_request_meta(frame[12:12 + meta_size])
            if info is None:
                break
            has_req, cid, attempt, has_stream = info
            if not has_req or has_stream or cid == 0:
                break   # responses/streams/cid-less: in-process path
            w = plane.workers[shard_for(cid, len(plane.workers))]
            if not plane.forward(w, self, cid, attempt, frame):
                g_shard_fallback.put(1)
                plane.fallback += 1
                break
            buf.pop_front(total)
            sock.in_messages += 1
            count += 1
        return count


class ShardPlane:
    def __init__(self, server=None, workers: Optional[int] = None,
                 factory: Optional[str] = None):
        self.server = server
        n = int(_flags.get("tpu_shard_workers")) if workers is None \
            else workers
        self.n = max(1, n)
        self.factory = factory
        self.forward_max = int(_flags.get("tpu_shard_forward_max"))
        self.ring_bytes = int(_flags.get("tpu_shard_ring_mb")) * (1 << 20)
        self.respawn_max = int(_flags.get("tpu_shard_respawn_max"))
        self.respawn_backoff_ms = int(
            _flags.get("tpu_shard_respawn_backoff_ms"))
        self.rebalance_pct = int(_flags.get("tpu_shard_rebalance_pct"))
        self.workers: List[WorkerHandle] = [WorkerHandle(i)
                                            for i in range(self.n)]
        self.lanes: Dict[int, _EndpointLane] = {}
        self._next_ep = 0
        self._ep_lock = threading.Lock()
        self._attach_lock = threading.Lock()
        self._stop = threading.Event()
        self._shutdown_done = False
        self.generation = 0
        self.forwarded = 0
        self.fallback = 0
        self.fanin_batches = 0
        self.fanin_frames = 0
        self.redispatched = 0
        self.death_errors = 0
        self.fleet = FleetVars()
        for w in self.workers:
            self._spawn(w)
        self._collector_t = threading.Thread(
            target=self._collector, name="shard-collector", daemon=True)
        self._monitor_t = threading.Thread(
            target=self._monitor, name="shard-monitor", daemon=True)
        self._collector_t.start()
        self._monitor_t.start()

    # ------------------------------------------------------------ lifecycle
    def _spawn(self, w: WorkerHandle) -> None:
        token = secrets.token_hex(3)
        # a prefix of the port's own: the JAX package's plane names its
        # rings brpctpu_shard_*, and neither package's leak checks may
        # count the other's segments (the workers' spills likewise)
        base = (f"brpctpu_torch_shard_{os.getpid():x}_{w.index}_{w.gen}_"
                f"{token}")
        w.in_ring = ShardRing.create(base + "_i", self.ring_bytes)
        w.out_ring = ShardRing.create(base + "_o", self.ring_bytes)
        cfg = {
            "index": w.index,
            "gen": w.gen,
            "in_ring": w.in_ring.name,
            "out_ring": w.out_ring.name,
            "factory": self.factory,
            "flags": {name: _flags.get(name)
                      for name in ("rtc_enable", "rtc_budget_us",
                                   "rtc_cheap_us", "rtc_max_body",
                                   "stream_body_min_bytes",
                                   "max_body_size",
                                   "shard_vars_interval_s",
                                   "var_series_enabled")},
        }
        env = dict(os.environ)
        # dispatch-only workers never touch the card: no CUDA context
        # (hundreds of MiB of device memory and seconds at spawn)
        env.setdefault("CUDA_VISIBLE_DEVICES", "")
        # the worker imports this package from wherever the parent did
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PKG_ROOT, env.get("PYTHONPATH", "")) if p)
        w.proc = subprocess.Popen(
            [sys.executable, "-m", "brpc_tpu_torch.shard.worker"],
            stdin=subprocess.PIPE, stdout=subprocess.DEVNULL, env=env)
        w.proc.stdin.write(json.dumps(cfg).encode() + b"\n")
        w.proc.stdin.flush()
        w.spawned = True
        w.pid = w.proc.pid

    def wait_ready(self, timeout: float = 15.0) -> bool:
        """Block until every worker slot reported READY (tests/bench use
        this; serving does not — un-ready workers just mean fallback)."""
        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            if all(w.alive for w in self.workers):
                return True
            _time.sleep(0.02)
        return all(w.alive for w in self.workers)

    def adopt_endpoint(self, ep) -> Optional[_EndpointLane]:
        """Hook a server-side tunnel endpoint into the plane: its vsock
        gets a ``shard_lane`` the cut loop pumps through."""
        if self._stop.is_set() or getattr(ep, "role", "") != "server":
            return None
        with self._ep_lock:
            self._next_ep += 1
            lane = _EndpointLane(self, ep, self._next_ep)
            self.lanes[lane.ep_id] = lane
        ep.vsock.shard_lane = lane
        pv = ep._pri_vsock
        if pv is not None:
            pv.shard_lane = lane
        return lane

    # ------------------------------------------------------------ forwarding
    def forward(self, w: WorkerHandle, lane: _EndpointLane, cid: int,
                attempt: int, frame: bytes) -> bool:
        key = (w.index, w.gen)
        with w.push_lock:
            if not w.alive or key not in lane.attached_workers:
                return False
            if not w.in_ring.push(wire.R_MSG,
                                  wire.encode_msg(lane.ep_id, frame)):
                return False
            w.inflight[cid] = (lane.ep_id, attempt, frame,
                               w.in_ring.tail)
            # counted before the lock lets the collector take the answer
            self.forwarded += 1
            g_shard_forwarded.put(1)
        return True

    def _attach_to_worker(self, w: WorkerHandle, lane: _EndpointLane) -> None:
        """Push this lane's R_ATTACH (+ initial lease) to one worker.
        Caller holds _attach_lock; ring FIFO guarantees the worker sees
        ATTACH before any R_MSG forward() sends after we mark it."""
        with w.push_lock:
            if not w.in_ring.push(wire.R_ATTACH, lane._attach_body):
                return
            lane.attached_workers.add((w.index, w.gen))
        lm = lane.lm
        if lm is None:
            return
        # initial sub-window lease: half the window split across workers,
        # the other half stays with the parent's own send path
        want = max(1, lm.window.block_count // (2 * len(self.workers)))
        got = lm.grant(w.index, want, timeout=0.02)
        if got:
            with w.push_lock:
                ok = w.in_ring.push(
                    wire.R_LEASE_GRANT,
                    wire.encode_indices(lane.ep_id, lane.attached_epoch,
                                        got))
            if not ok:
                lm.ungrant(w.index, got)

    # ------------------------------------------------------------- collector
    def _collector(self) -> None:
        _prof.register_current_thread("shard_collector")
        idle = 0.0
        while not self._stop.is_set():
            n = self._drain_once()
            if n:
                idle = 0.0
            else:
                # escalate to a 2ms poll floor: idle plane <1% of the core
                idle = min(0.002, idle + 0.0002)
                self._stop.wait(idle)

    def _lane(self, ep_id: int) -> Optional[_EndpointLane]:
        lane = self.lanes.get(ep_id)
        if lane is None or lane.ep._failed:
            return None
        return lane

    def _drain_once(self) -> int:
        total = 0
        for w in self.workers:
            with w.drain_lock:
                total += self._drain_worker(w, 128)
        return total

    def _drain_worker(self, w: WorkerHandle, max_records: int) -> int:
        """Answer up to ``max_records`` of one worker's records. The
        caller holds ``w.drain_lock``."""
        ring = w.out_ring
        if ring is None:
            return 0
        recs = ring.pop(max_records)
        if not recs:
            return 0
        smalls: Dict[_EndpointLane, List[bytes]] = {}
        for rtype, payload in recs:
            try:
                self._handle_rec(w, rtype, payload, smalls)
            except Exception:
                pass   # one malformed record must not kill the drain
        for lane, frames in smalls.items():
            rc = lane.ep.fan_in_flush(frames)
            if rc == 0:
                self.fanin_batches += 1
                self.fanin_frames += len(frames)
                g_shard_fanin_flushes.put(1)
                g_shard_fanin_frames.put(len(frames))
        return len(recs)

    def _handle_rec(self, w: WorkerHandle, rtype: int, payload: bytes,
                    smalls: Dict[_EndpointLane, List[bytes]]) -> None:
        from brpc_tpu_torch.tpu.transport import INLINE_MAX

        if rtype == wire.W_RESP:
            ep_id, cid, pkt = wire.decode_resp(payload)
            with w.push_lock:
                w.inflight.pop(cid, None)
            lane = self._lane(ep_id)
            if lane is None:
                return
            if len(pkt) <= INLINE_MAX and lane.ep.peer_version >= 3:
                smalls.setdefault(lane, []).append(pkt)
            else:
                lane.ep.send_packet(IOBuf(pkt))
        elif rtype == wire.W_RESP_SEGS:
            ep_id, epoch, cid, segs = wire.decode_resp_segs(payload)
            with w.push_lock:
                w.inflight.pop(cid, None)
            lane = self._lane(ep_id)
            if lane is None or lane.lm is None:
                return
            # the credits leave the lease NOW (they ride to the client and
            # come home as FT_ACKs) — even if the post fails, the tunnel
            # fail path owns them, not the lease
            lane.lm.note_posted(w.index, [i for i, _ in segs])
            lane.ep.post_worker_segments(segs, epoch)
        elif rtype == wire.W_RESP_SHM:
            ep_id, cid, total = struct.unpack_from("!IQQ", payload)
            name = payload[20:].decode()
            with w.push_lock:
                w.inflight.pop(cid, None)
            data = self._read_spill(name, total)
            lane = self._lane(ep_id)
            if lane is not None and data is not None:
                lane.ep.send_packet(IOBuf(data))
        elif rtype == wire.W_LEASE_RETURN:
            ep_id, epoch, idxs = wire.decode_indices(payload)
            lane = self.lanes.get(ep_id)
            if lane is not None and lane.lm is not None \
                    and lane.attached_epoch == epoch:
                lane.lm.note_returned(w.index, idxs)
        elif rtype == wire.W_LEASE_REQUEST:
            ep_id, want = wire.decode_want(payload)
            self._service_lease_request(w, ep_id, want)
        elif rtype == wire.W_READY:
            self._on_worker_ready(w, struct.unpack_from("!I", payload)[0])
        elif rtype == wire.W_STATS:
            w.stats = json.loads(payload.decode())
        elif rtype == wire.W_PROF:
            w.prof_lines = payload.decode()
        elif rtype == wire.W_VARS:
            self.fleet.on_snapshot(w.index, payload)

    @staticmethod
    def _read_spill(name: str, total: int) -> Optional[bytes]:
        from multiprocessing import shared_memory as _shm

        try:
            seg = _shm.SharedMemory(name=name)
        except Exception:
            return None
        try:
            return bytes(seg.buf[:total])
        finally:
            try:
                seg.close()
                seg.unlink()
            except Exception:
                pass

    def _on_worker_ready(self, w: WorkerHandle, pid: int) -> None:
        w.pid = pid
        with self._attach_lock:
            for lane in list(self.lanes.values()):
                if lane.attached_epoch >= 0 and not lane.ep._failed:
                    self._attach_to_worker(w, lane)
            w.alive = True

    def _service_lease_request(self, w: WorkerHandle, ep_id: int,
                               want: int) -> None:
        lane = self._lane(ep_id)
        if lane is None or lane.lm is None:
            return
        got = lane.lm.grant(w.index, want, timeout=0.02)
        if got:
            with w.push_lock:
                ok = w.alive and w.in_ring.push(
                    wire.R_LEASE_GRANT,
                    wire.encode_indices(ep_id, lane.attached_epoch, got))
            if not ok:
                lane.lm.ungrant(w.index, got)
            return
        # window dry: occupancy has skewed — reclaim from the richest
        # sibling so the starved worker's next request can be granted
        self._rebalance(lane, exclude=w.index, want=want)

    def _rebalance(self, lane: _EndpointLane, exclude: int,
                   want: int) -> Optional[int]:
        """Ask the worker holding the most idle lease credits of this
        endpoint to give some back (R_LEASE_RECLAIM). Returns the chosen
        worker index, or None when nobody holds enough to matter."""
        lm = lane.lm
        if lm is None:
            return None
        richest, free = None, 0
        for cand in self.workers:
            if cand.index == exclude or not cand.alive:
                continue
            ep_stats = (cand.stats.get("eps") or {}).get(str(lane.ep_id))
            cand_free = int(ep_stats["lease_free"]) if ep_stats else \
                lm.leased_count(cand.index)
            if cand_free > free:
                richest, free = cand, cand_free
        # only reclaim when the sibling's idle share crosses the skew
        # threshold — constant reclaim churn under balanced load is worse
        # than a few W_RESP fallbacks
        threshold = max(1, lm.window.block_count * self.rebalance_pct
                        // (100 * max(1, len(self.workers))))
        if richest is None or free < threshold:
            return None
        with richest.push_lock:
            richest.in_ring.push(wire.R_LEASE_RECLAIM,
                                 wire.encode_want(lane.ep_id, want))
        return richest.index

    # --------------------------------------------------------------- monitor
    def _monitor(self) -> None:
        _prof.register_current_thread("shard_monitor")
        last_prune = _time.monotonic()
        while not self._stop.wait(0.02):
            for w in self.workers:
                if w.proc is None:
                    continue
                if _fault.hit("worker.crash", worker=w.index) is not None:
                    try:
                        w.proc.kill()
                    except Exception:
                        pass
                if w.proc.poll() is not None:
                    self._on_worker_death(w)
            now = _time.monotonic()
            if now - last_prune >= 1.0:
                last_prune = now
                self._prune_lanes()

    def _prune_lanes(self) -> None:
        dead = [ep_id for ep_id, lane in list(self.lanes.items())
                if lane.ep._failed]
        for ep_id in dead:
            with self._ep_lock:
                lane = self.lanes.pop(ep_id, None)
            if lane is None:
                continue
            for w in self.workers:
                if w.alive:
                    with w.push_lock:
                        w.in_ring.push(wire.R_DETACH,
                                       struct.pack("!I", ep_id))
            # the window died with the endpoint; leases are moot but the
            # ledger still wants its acquire/release books balanced
            if lane.lm is not None:
                lane.lm.release_all()

    def _on_worker_death(self, w: WorkerHandle) -> None:
        w.alive = False
        g_shard_worker_deaths.put(1)
        self.generation += 1
        with w.drain_lock:
            # what the worker answered before it died goes out first: a
            # call it ran is answered, never run again. One pop takes the
            # whole ring (no record is shorter than its header)
            if w.out_ring is not None:
                self._drain_worker(w, w.out_ring.capacity // REC_OVERHEAD)
            with w.push_lock:
                inflight = dict(w.inflight)
                w.inflight.clear()
                taken = w.in_ring.head if w.in_ring is not None else 0
            if w.in_ring is not None:
                w.in_ring.close()
                w.out_ring.close()
                w.in_ring = w.out_ring = None
        for lane in list(self.lanes.values()):
            lane.attached_workers = {k for k in lane.attached_workers
                                     if k[0] != w.index}
            if lane.lm is not None:
                lane.lm.reclaim_worker(w.index)
        # the unanswered cids: a request the worker never took off its
        # ring never ran, so the parent runs it (in-process dispatch is
        # the plane's fallback for whatever it cannot forward). One it
        # took may have run: it gets the reference's retriable
        # EFAILEDSOCKET, which the Channel retries only as far as the
        # caller's max_retry allows. A plane shutting down fans the error
        # to all of them.
        frames: Dict[int, List[bytes]] = {}
        for cid, (ep_id, attempt, frame, end) in sorted(inflight.items()):
            lane = self._lane(ep_id)
            if lane is None:
                continue
            if self._stop.is_set() or end <= taken:
                self.death_errors += 1
                self._fan_error(lane.ep, cid, attempt)
            else:
                frames.setdefault(ep_id, []).append(frame)
        for ep_id, fs in frames.items():
            self.redispatched += len(fs)
            threading.Thread(target=self._redispatch,
                             args=(self.lanes[ep_id], fs),
                             name="shard-redispatch", daemon=True).start()
        try:
            w.proc.stdin.close()
        except Exception:
            pass
        w.proc = None
        w.spawned = False
        if self._stop.is_set() or w.respawns >= self.respawn_max:
            return
        w.respawns += 1
        g_shard_respawns.put(1)
        _time.sleep(self.respawn_backoff_ms * w.respawns / 1000.0)
        w.gen += 1
        self._spawn(w)

    def _redispatch(self, lane: _EndpointLane, frames: List[bytes]) -> None:
        """Run a dead worker's forwarded request frames through the
        parent's own dispatch stack; each response goes out on the lane's
        endpoint as any parent response does."""
        from brpc_tpu_torch.rpc.input_messenger import InputMessenger
        from brpc_tpu_torch.shard.worker import WorkerVSocket

        _prof.register_current_thread("shard_redispatch")
        sender = _ParentSender(lane.ep)
        vs = WorkerVSocket(sender, self.server)
        vs.wep = lane.ep_id
        messenger = InputMessenger(server=self.server)
        for frame in frames:
            vs.read_buf.append(frame)
            messenger.cut_messages(vs)

    @staticmethod
    def _fan_error(ep, cid: int, attempt: int) -> None:
        from brpc_tpu_torch.proto import rpc_meta_pb2
        from brpc_tpu_torch.rpc.protocol import find_protocol

        meta = rpc_meta_pb2.RpcMeta()
        meta.correlation_id = cid
        if attempt:
            meta.attempt_version = attempt
        meta.response.error_code = errors.EFAILEDSOCKET
        meta.response.error_text = "shard worker died; retry"
        pkt = find_protocol("trpc_std").pack_response(meta, b"")
        ep.send_packet(pkt)

    # -------------------------------------------------------------- shutdown
    def shutdown(self, timeout: float = 2.0) -> None:
        """Orderly teardown, called BEFORE the server closes its endpoints
        so every leased credit is home when the CreditLedger audits the
        windows at close."""
        if self._shutdown_done:
            return
        self._shutdown_done = True
        for lane in list(self.lanes.values()):
            lane.ep.vsock.shard_lane = None
            pv = lane.ep._pri_vsock
            if pv is not None:
                pv.shard_lane = None
        for w in self.workers:
            if w.alive and w.in_ring is not None:
                with w.push_lock:
                    w.in_ring.push(wire.R_QUIT, b"")
        # drain in-flight responses before stopping the collector loop
        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            if not any(w.proc is not None and w.proc.poll() is None
                       for w in self.workers):
                break
            _time.sleep(0.01)
        self._stop.set()
        self._collector_t.join(timeout=1.0)
        self._monitor_t.join(timeout=1.0)
        self._drain_once()
        self.fleet.hide_all()
        for lane in list(self.lanes.values()):
            if lane.lm is not None:
                lane.lm.release_all()
        for w in self.workers:
            if w.proc is not None:
                try:
                    w.proc.stdin.close()
                except Exception:
                    pass
                try:
                    w.proc.wait(timeout=1.0)
                except Exception:
                    try:
                        w.proc.kill()
                        w.proc.wait(timeout=1.0)
                    except Exception:
                        pass
                w.proc = None
            w.alive = False
            if w.in_ring is not None:
                w.in_ring.close()
                w.out_ring.close()
                w.in_ring = w.out_ring = None

    # ------------------------------------------------------------ state view
    def state_dict(self) -> dict:
        """The /tpu builtin's ``shard`` section."""
        workers = []
        for w in self.workers:
            st = w.stats or {}
            lease_free = sum(int(e.get("lease_free", 0))
                             for e in (st.get("eps") or {}).values())
            lease_held = 0
            for lane in list(self.lanes.values()):
                if lane.lm is not None:
                    lease_held += lane.lm.leased_count(w.index)
            workers.append({
                "index": w.index,
                "pid": w.pid,
                "role": f"worker:{w.index}",
                "alive": w.alive,
                "gen": w.gen,
                "respawns": w.respawns,
                "inflight_cids": len(w.inflight),
                "lease_held": lease_held,
                "lease_free": lease_free,
                "dispatched": int(st.get("dispatched", 0)),
                "resp_inline": int(st.get("resp_inline", 0)),
                "resp_segs": int(st.get("resp_segs", 0)),
            })
        return {
            "workers_configured": self.n,
            "generation": self.generation,
            "forwarded": self.forwarded,
            "fallback": self.fallback,
            "fanin_batches": self.fanin_batches,
            "fanin_frames": self.fanin_frames,
            "redispatched": self.redispatched,
            "death_errors": self.death_errors,
            "endpoints": len(self.lanes),
            "workers": workers,
        }

    def worker_folded_lines(self) -> List[str]:
        """Latest W_PROF folded-stack lines from every worker (already
        role-tagged ``worker:<i>/...`` by the registry prefix) for the
        /hotspots/continuous merge."""
        out: List[str] = []
        for w in self.workers:
            if w.prof_lines:
                out.extend(ln for ln in w.prof_lines.splitlines() if ln)
        return out
