"""Cross-process tpu:// transport — the graft's RDMA-endpoint analog.

Two processes, each owning its accelerator devices, exchange RPC traffic
through (a) a TCP *bootstrap/control* connection and (b) *registered block
pools* — shared-memory staging areas playing the role of the RDMA
registered memory region / PJRT pinned-host buffers. The design follows the
reference RdmaEndpoint blueprint point for point (SURVEY §3.5/§5.8):

  reference (rdma_endpoint.cpp)          this module
  -------------------------------------  -----------------------------------
  TCP handshake exchanging GID/QPN       HELLO/HELLO_ACK frames exchanging
    (:127-130)                             device ordinal + pool name/geometry
  registered block pool (block_pool.cpp) BlockPool: shm segment cut into
                                           fixed-size pinned-host blocks
  post_send of IOBuf blocks              sender memcpys into *peer* pool
                                           blocks, posts a DATA frame
  explicit-ACK sliding window            ACK frames return block credits;
    (rdma_endpoint.h:256-261)              senders park on the credit window
  CQ events -> EventDispatcher           control frames ride the normal
    (rdma_endpoint.h:201)                  Socket/EventDispatcher loop
  same InputMessenger parsing as TCP     reassembled bytes feed the virtual
    (input_messenger.cpp:416)              socket's read_buf -> cut_messages

The tunnel is a byte stream: DATA frames carry ordered chunks of it, so an
RPC packet larger than the window streams through a bounded number of
blocks (credit flow control), and ANY registered protocol — trpc_std, h2,
redis — rides the tpu transport unchanged, because delivery goes through
the very same InputMessenger cut loop as TCP bytes. The "virtual socket"
trick is the reference's own (a brpc Stream IS a fake Socket, stream.cpp).

Cross-host (DCN) fallback: when the peer's shm pool cannot be attached
(different host), the endpoint degrades to inline DATA frames over the
control connection — same framing, no shm, window = TCP backpressure.

The handshake, window accounting and virtual-socket delivery are
transport-independent.

The port's copy of ``brpc_tpu/tpu/transport.py``: the wire format (TPUC
frames, the HELLO body, DATA/ACK bodies) is the JAX package's byte for
byte, so a process of either package dials the other. The sharded
dispatch plane's hooks (a worker pool posting leased blocks) are not
ported with it (ROADMAP Queue 1 item 2(b)).
"""

from __future__ import annotations

import functools
import json
import os
import secrets
import struct
import threading
import time as _time
from collections import deque
from multiprocessing import shared_memory as _shm
from typing import Dict, List, Optional, Tuple

from brpc_tpu_torch import fault as _fault
from brpc_tpu_torch import flags as _flags
from brpc_tpu_torch.analysis import runtime_check as _rc
from brpc_tpu_torch.analysis.markers import poller_context
from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.butil.resource_pool import VersionedPool
from brpc_tpu_torch.fiber import call_id as _cid
from brpc_tpu_torch.fiber import wakeup as _wakeup
from brpc_tpu_torch.metrics.reducer import Adder
from brpc_tpu_torch.profiling import registry as _prof
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.protocol import (
    PARSE_BAD,
    PARSE_NOT_ENOUGH_DATA,
    PARSE_TRY_OTHERS,
    ParsedMessage,
    Protocol,
)
from brpc_tpu_torch.trace import span as _trace

CTRL_MAGIC = b"TPUC"
CTRL_HDR = "!4sBI"            # magic, frame type, body length
CTRL_HDR_SIZE = struct.calcsize(CTRL_HDR)

FT_HELLO = 1      # client -> server: my pool + target device
FT_HELLO_ACK = 2  # server -> client: my pool + my device
FT_DATA = 3       # ordered chunk of the tunnel byte stream
FT_ACK = 4        # return block credits
FT_BYE = 5        # orderly shutdown
# priority lane (v3): a SECOND framed sub-stream on the same ctrl socket.
# Frame-granular interleave with FT_DATA is safe — the receiver demuxes by
# frame type into a separate virtual socket — so a small latency-sensitive
# packet never queues behind the quanta of a 16MB main-lane send. Only
# correlation-addressed traffic (TRPC magic) may ride it; order-sensitive
# byte streams (HTTP, TSTR stream frames) stay on the main lane.
FT_DATA_PRI = 6

# every stream frame carries the tunnel's window generation (epoch): after
# a re-handshake rebuilds the pools, DATA/ACK frames still in flight from
# the previous epoch reference blocks of the torn-down window — the epoch
# guard discards them instead of mis-crediting the new one
DATA_BODY_HDR = "!III"        # epoch, inline_len, nsegs
DATA_BODY_HDR_SIZE = struct.calcsize(DATA_BODY_HDR)
SEG_FMT = "!II"               # block index, length
_SEG_SIZE = struct.calcsize(SEG_FMT)

DEFAULT_BLOCK_SIZE = 256 * 1024
# 16 MB window per direction. The window no longer has to hold a whole
# bulk message: once a protocol cracks a header it registers a streaming
# pending-body cursor, so borrowed blocks are consumed — and their FT_ACK
# credits returned — mid-message, a few blocks after they arrive. A 16 MB
# sweep message therefore cycles through the 8 MB borrow budget (half the
# window) instead of overflowing it; the 320-block (80 MB) window the
# pre-streaming code needed to avoid copy-and-ACK collapse is pinned shm
# we no longer pay for. bench_tpu_sweep asserts both halves of this:
# 16 MB entries stay ≤10% copied AND peak borrowed-outstanding stays
# under this window.
DEFAULT_BLOCK_COUNT = 64


def clamp_geometry(bs: int, bc: int):
    """Sane bounds for a negotiated pool geometry (a peer must not be able
    to demand an absurd registration; dataplane.cpp tpu_clamp_geometry is
    the native mirror)."""
    bs = bs or DEFAULT_BLOCK_SIZE
    bc = bc or DEFAULT_BLOCK_COUNT
    bs = max(16 << 10, min(4 << 20, bs))
    bs = (bs + 4095) & ~4095
    bc = max(4, min(512, bc))
    while bs * bc > (512 << 20) and bc > 4:
        bc //= 2
    return bs, bc
INLINE_MAX = 16 * 1024        # small messages skip the block pool entirely
MAX_SEGS_PER_FRAME = 32       # wire-format cap on segments per DATA frame
# send pipelining quantum: acquire/fill/post this many blocks (1 MB) per
# frame so the ctrl write of frame k overlaps the memcpy into frame k+1's
# blocks, and a large message never parks waiting for more credits than
# one frame needs (the old loop demanded up to MAX_SEGS_PER_FRAME at once)
SEND_PIPELINE_SEGS = 4
# v2: epoch (window generation) in HELLO/DATA/ACK
# v3: FT_DATA_PRI priority lane + coalesced doorbells (both gated on the
#     peer advertising >= 3, so a v2 peer never sees a frame type or
#     batched write pattern it cannot parse)
HANDSHAKE_VERSION = 3

# device-fabric traffic counters (the /vars view of the "ICI NIC");
# named Adders self-expose, so /vars and the Prometheus exporter see them
g_tunnel_in_bytes = Adder("g_tunnel_in_bytes")
g_tunnel_out_bytes = Adder("g_tunnel_out_bytes")
# zero-copy receive accounting: payload bytes appended into the virtual
# socket as BORROWED registered-block views (credit deferred to consumption)
# vs bytes COPIED out of blocks (borrow cap hit, or no exporter support) —
# the borrowed/copied split is the receive path's zero-copy proof
g_tunnel_borrowed_bytes = Adder("g_tunnel_borrowed_bytes")
g_tunnel_copied_bytes = Adder("g_tunnel_copied_bytes")
# FT_ACK frames actually written vs credits they carried (batching ratio)
g_tunnel_ack_frames = Adder("g_tunnel_ack_frames")
g_tunnel_ack_credits = Adder("g_tunnel_ack_credits")
# recovery accounting: frames discarded by the epoch guard, tunnels rebuilt
# by the healer, dial attempts that failed, and end-of-body credit flushes
g_tunnel_stale_epoch_frames = Adder("g_tunnel_stale_epoch_frames")
g_tunnel_reconnects = Adder("g_tunnel_reconnects")
g_tunnel_reconnect_failures = Adder("g_tunnel_reconnect_failures")
g_tunnel_eob_wakeups = Adder("g_tunnel_eob_wakeups")
# credit flow-control stalls: a send quantum found the peer window empty
# and parked on acquire (the stall count is the "why was this RPC slow"
# headline; the wait total divided by it is the mean ACK round-trip under
# pressure). Both also accumulate per-endpoint for /tpu.
g_tunnel_credit_stalls = Adder("g_tunnel_credit_stalls")
g_tunnel_credit_wait_us = Adder("g_tunnel_credit_wait_us")
# in-band server-side window rebuilds (client re-HELLO on a live bootstrap)
g_tunnel_epoch_restarts = Adder("g_tunnel_epoch_restarts")
# priority lane + coalesced doorbell accounting (v3 fast path)
g_tunnel_pri_tx_frames = Adder("g_tunnel_pri_tx_frames")
g_tunnel_pri_rx_frames = Adder("g_tunnel_pri_rx_frames")
g_tunnel_pri_bytes = Adder("g_tunnel_pri_bytes")
# doorbell flushes = combined ctrl writes; frames = response frames they
# carried (frames/flushes is the coalescing ratio, like the ACK one)
g_tunnel_doorbell_flushes = Adder("g_tunnel_doorbell_flushes")
g_tunnel_doorbell_frames = Adder("g_tunnel_doorbell_frames")

# chaos injection points threaded through this module (see fault/core.py
# and docs/fault-injection.md; zero-cost while disarmed)
_fault.register("tpu.send.delay", "sleep delay_ms before shipping a packet")
_fault.register("tpu.tunnel.kill",
                "fail the bootstrap socket at a DATA frame post "
                "(the vsock dies mid-message)")
_fault.register("tpu.frame.drop", "swallow one DATA frame (stream hole)")
_fault.register("tpu.frame.corrupt",
                "XOR a byte (params: offset) in a DATA frame")
_fault.register("tpu.frame.truncate",
                "cut `bytes` off a DATA frame's tail")
_fault.register("tpu.ack.drop", "swallow an FT_ACK (peer credits leak)")
_fault.register("tpu.ack.stall", "sleep delay_ms before writing an FT_ACK")
_fault.register("tpu.handshake.fail",
                "server refuses the next HELLO with an error HELLO_ACK")

# high-water mark of blocks lent to the parse path at once (any endpoint in
# this process): with streaming consume this must sit well below the window
# even while a multi-window message is in flight — bench_tpu_sweep asserts it
_borrow_peak_lock = threading.Lock()
_borrow_peak_blocks = 0


def _note_borrow_peak(outstanding: int) -> None:
    global _borrow_peak_blocks
    if outstanding > _borrow_peak_blocks:
        with _borrow_peak_lock:
            if outstanding > _borrow_peak_blocks:
                _borrow_peak_blocks = outstanding


def borrowed_peak_blocks() -> int:
    return _borrow_peak_blocks


def reset_borrowed_peak() -> None:
    """The peak is a monotonic high-water mark; chaos suites reset it
    between scenarios to assert that recovery re-converges to a bounded
    borrow footprint (the teardown-leak check)."""
    global _borrow_peak_blocks
    with _borrow_peak_lock:
        _borrow_peak_blocks = 0


from brpc_tpu_torch.metrics.status import PassiveStatus as _PassiveStatus  # noqa: E402

g_tunnel_borrowed_peak_blocks = _PassiveStatus(
    borrowed_peak_blocks).expose("g_tunnel_borrowed_peak_blocks")


# names created by THIS process (owner keeps resource_tracker registration)
_owned_pools = set()


def _cleanup_owned_pools() -> None:
    for name in list(_owned_pools):
        try:
            seg = _shm.SharedMemory(name=name)
            seg.close()
            seg.unlink()
        except Exception:
            # segment already gone: drop the stale tracker registration
            # too, or its shutdown scan warns about a "leaked" segment it
            # can no longer find
            try:
                from multiprocessing import resource_tracker

                resource_tracker.unregister(
                    "/" + name.lstrip("/"), "shared_memory")
            except Exception:
                pass
        _owned_pools.discard(name)


import atexit as _atexit  # noqa: E402

_atexit.register(_cleanup_owned_pools)


def _maybe_untrack(name: str) -> None:
    """Python's resource_tracker thinks every attached segment is ours to
    unlink at exit; only the owner unlinks. (3.13's track=False, by hand.)
    Same-process loopback attaches share the owner's tracker entry — leave
    those registered or the owner's unlink would double-unregister."""
    if name in _owned_pools:
        return
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister("/" + name.lstrip("/"), "shared_memory")
    except Exception:
        pass


# pools whose close was requested while borrowed views were still exported
# (or whose shm close raced a view's dealloc cascade): retried when another
# pool is created and at exit — the segment name is unlinked at exit either
# way via _owned_pools
_deferred_close_pools: List["BlockPool"] = []
_deferred_close_lock = threading.Lock()


def _sweep_deferred_pools() -> None:
    with _deferred_close_lock:
        pending = list(_deferred_close_pools)
    for pool in pending:
        pool._try_finish_close()


_atexit.register(_sweep_deferred_pools)


class BlockPool:
    """Our receive staging area — the registered memory region we advertise
    to the peer (reference rdma/block_pool.cpp). The PEER writes request/
    response bytes into these blocks; the receive path BORROWS views over
    them into the virtual socket's read buffer and returns the credit only
    when the parse path has consumed the bytes (export-tracked), falling
    back to copy-and-ACK under window pressure."""

    def __init__(self, block_size: int = DEFAULT_BLOCK_SIZE,
                 block_count: int = DEFAULT_BLOCK_COUNT):
        _sweep_deferred_pools()
        self.block_size = block_size
        self.block_count = block_count
        self.name = f"brpctpu_{os.getpid():x}_{secrets.token_hex(4)}"
        self._shm = _shm.SharedMemory(
            create=True, size=block_size * block_count, name=self.name)
        _owned_pools.add(self.name)
        self._lock = threading.Lock()
        self._exports = 0          # borrowed views currently alive
        self._close_pending = False
        self._closed = False
        if _rc.ACTIVE:
            _rc.ledger.track_pool(self, label="block_pool", owner=self.name)

    def view(self, idx: int, length: int) -> memoryview:
        if not (0 <= idx < self.block_count and 0 <= length <= self.block_size):
            raise ValueError(f"bad block ref ({idx},{length})")
        off = idx * self.block_size
        return memoryview(self._shm.buf)[off:off + length]

    # ------------------------------------------------------- borrow tracking
    def add_export(self) -> None:
        if _rc.ACTIVE:
            _rc.ledger.export_added(self)
        with self._lock:
            self._exports += 1

    def drop_export(self) -> None:
        if _rc.ACTIVE:
            _rc.ledger.export_dropped(self)
        with self._lock:
            self._exports -= 1
            retry = self._close_pending and self._exports <= 0 \
                and not self._closed
        if retry:
            self._try_finish_close()

    @property
    def exports(self) -> int:
        with self._lock:
            return self._exports

    # ----------------------------------------------------------------- close
    def close(self) -> None:
        """Request close. The segment NAME is unlinked right here — POSIX
        keeps the mapping alive for every process that already attached, and
        unlinking eagerly removes this process's resource_tracker
        registration while the interpreter is still healthy (a deferred
        unlink raced tracker shutdown and left a spurious leaked-shm
        UserWarning in bench tails). Only the unmap is deferred to the last
        drop_export (an shm segment cannot unmap under a live buffer
        export)."""
        with self._lock:
            if self._closed or self._close_pending:
                return
            self._close_pending = True
            busy = self._exports > 0
        self._unlink_name()
        if busy:
            with _deferred_close_lock:
                _deferred_close_pools.append(self)
            return
        self._try_finish_close()

    def _unlink_name(self) -> None:
        try:
            self._shm.unlink()   # also unregisters from resource_tracker
        except Exception:
            pass
        _owned_pools.discard(self.name)

    def _try_finish_close(self) -> None:
        with self._lock:
            if self._closed or self._exports > 0:
                return
        try:
            self._shm.close()
        except BufferError:
            # a view's dealloc cascade is still holding the export (the
            # release hook runs BEFORE the buffer ref is dropped): leave it
            # on the deferred list — the next sweep/drop_export finishes
            with _deferred_close_lock:
                if self not in _deferred_close_pools:
                    _deferred_close_pools.append(self)
            return
        except Exception:
            pass
        with self._lock:
            self._closed = True
        with _deferred_close_lock:
            if self in _deferred_close_pools:
                _deferred_close_pools.remove(self)


# shared adaptive spin budgets for the transport's two hot waits (see
# fiber/wakeup.py): credit-window refills and endpoint-ready handshakes
_window_spin = _wakeup.get_spin("tpu_window")
_ready_spin = _wakeup.get_spin("tpu_ready", initial=16, ceiling=512)


class PeerWindow:
    """The sender-side view of the peer's block pool: an attached mapping
    plus the credit free-list (reference sliding window,
    rdma_endpoint.h:256-261). acquire() parks the sender when the window is
    exhausted; ACK frames release() credits and wake it."""

    def __init__(self, name: str, block_size: int, block_count: int):
        self._shm = _shm.SharedMemory(name=name)
        _maybe_untrack(name)
        self.block_size = block_size
        self.block_count = block_count
        self._free = deque(range(block_count))
        self._cond = threading.Condition()
        self._closed = False
        if _rc.ACTIVE:
            _rc.ledger.track_window(self, block_count,
                                    label="peer_window", owner=name)

    def acquire(self, want: int, timeout: float = 30.0) -> Optional[List[int]]:
        """Return 1..want block indices, parking until at least one is free.
        None on timeout/close (window wedged — peer stopped consuming)."""
        if not self._free and not self._closed:
            # adaptive spin before the locked park: under streaming-parse
            # credit return the refill usually lands within the spin
            # budget, and winning here skips the full park/notify round
            prev_ph = _prof.set_phase("credit_wait")
            try:
                _window_spin.spin(lambda: bool(self._free) or self._closed)
            finally:
                _prof.set_phase(prev_ph)
        deadline = _time.monotonic() + timeout
        with self._cond:
            while not self._free and not self._closed:
                left = deadline - _time.monotonic()
                if left <= 0:
                    return None
                prev_ph = _prof.set_phase("credit_wait")
                try:
                    self._cond.wait(left)
                finally:
                    _prof.set_phase(prev_ph)
            if self._closed:
                return None
            take = min(want, len(self._free))
            got = [self._free.popleft() for _ in range(take)]
        if _rc.ACTIVE:
            _rc.ledger.window_acquired(self, len(got))
        return got

    def release(self, indices) -> None:
        indices = list(indices)
        if _rc.ACTIVE:
            _rc.ledger.window_released(self, len(indices))
        with self._cond:
            self._free.extend(indices)
            self._cond.notify_all()

    def close(self) -> None:
        if _rc.ACTIVE:
            _rc.ledger.window_closed(self)
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        try:
            self._shm.close()
        except Exception:
            pass


def _pack_frame(ftype: int, body: bytes = b"") -> bytes:
    return struct.pack(CTRL_HDR, CTRL_MAGIC, ftype, len(body)) + body


def _retriable(code: int) -> int:
    """Map a tunnel-death code onto the retryable set: an RPC whose socket
    died under it did not observably execute, so channel retry /
    BackupRequestPolicy may re-issue it on the healed tunnel instead of
    surfacing a terminal error."""
    return (code if code in errors.DEFAULT_RETRYABLE
            else errors.EFAILEDSOCKET)


class TpuTransportSocket:
    """The virtual socket (reference: 'a Stream IS a fake Socket'). Exposes
    the Socket surface the RPC stack uses — write/pending-ids/set_failed on
    the client side, write/owner_server on the server side — while the bytes
    actually move through the endpoint's block pools."""

    def __init__(self, endpoint: "TpuEndpoint"):
        self.endpoint = endpoint
        self.read_buf = IOBuf()
        self.preferred_protocol = None
        # streaming parse: the in-flight PendingBodyCursor the cut loop is
        # feeding (see rpc/protocol.py) — THIS slot is what lets credits
        # return mid-message on the tunnel
        self.pending_body = None
        self.failed = False
        self.error_code = 0
        self.error_text = ""
        self.remote: Optional[EndPoint] = None
        self.owner_server = None
        self.user_data = None
        self.in_bytes = 0
        self.out_bytes = 0
        self.in_messages = 0
        self.out_messages = 0
        self.last_active = _time.monotonic()
        self._pending_ids = set()
        self._pending_lock = threading.Lock()
        self.socket_id = _vsock_pool.insert(self)

    # ------------------------------------------------------------ pending ids
    def add_pending_id(self, cid: int) -> None:
        with self._pending_lock:
            self._pending_ids.add(cid)

    def remove_pending_id(self, cid: int) -> bool:
        """True iff the entry was present (caller owns its error delivery)."""
        with self._pending_lock:
            if cid in self._pending_ids:
                self._pending_ids.discard(cid)
                return True
            return False

    # ------------------------------------------------------------- write path
    def write(self, data, id_wait: Optional[int] = None) -> int:
        if self.failed:
            if id_wait is not None:
                _cid.id_error(id_wait, errors.EFAILEDSOCKET)
            return errors.EFAILEDSOCKET
        packet = data if isinstance(data, IOBuf) else IOBuf(bytes(data))
        if id_wait is not None:
            self.add_pending_id(id_wait)
        self.last_active = _time.monotonic()
        # the owning RPC's span (parked by the issuing thread): the send
        # pipeline below annotates credit stalls / quanta onto it
        rc = self.endpoint.send_packet(packet, span=_trace.current_span())
        if rc == 0:
            self.out_messages += 1
        elif id_wait is not None:
            self.remove_pending_id(id_wait)
        return rc

    # ---------------------------------------------------------------- failure
    def set_failed(self, code: int, reason: str = "") -> None:
        if code == errors.OK:
            code = errors.EFAILEDSOCKET
        if self.failed:
            return
        self.failed = True
        self.error_code = code
        self.error_text = reason
        self.pending_body = None  # half-fed body dies with the tunnel
        _vsock_pool.remove(self.socket_id)
        with self._pending_lock:
            pending = list(self._pending_ids)
            self._pending_ids.clear()
        # in-flight calls are failed with a RETRIABLE code, never stranded:
        # the channel's retry policy re-issues them, and _select_socket's
        # re-dial lands them on the healed tunnel
        fan = _retriable(code)
        for cid in pending:
            _cid.id_error(cid, fan)
        self.endpoint.fail(code, reason, from_vsock=True)

    def close(self) -> None:
        self.set_failed(errors.EFAILEDSOCKET, "closed locally")

    def __repr__(self) -> str:
        state = "failed" if self.failed else "ok"
        return f"TpuTransportSocket(remote={self.remote}, {state})"


_vsock_pool: VersionedPool = VersionedPool()


class TpuEndpoint:
    """Per-connection transport state hung on the bootstrap Socket
    (reference RdmaEndpoint inside Socket, rdma_endpoint.h)."""

    def __init__(self, ctrl_sock, role: str, server=None,
                 target_ordinal: int = 0,
                 block_size: int = DEFAULT_BLOCK_SIZE,
                 block_count: int = DEFAULT_BLOCK_COUNT,
                 epoch: int = 0):
        self.ctrl = ctrl_sock
        self.role = role                  # "client" | "server"
        self.server = server              # owning Server (server role)
        self.target_ordinal = target_ordinal
        # window generation: the dialer proposes it in HELLO, the server
        # adopts it, every DATA/ACK frame carries it — stale frames from a
        # torn-down epoch are discarded, not mis-credited
        self.epoch = epoch
        # set only after a successful dial registers this endpoint in
        # _remote_sockets: tunnels that die mid-handshake (or fake-ctrl
        # test endpoints) never kick the background healer
        self._heal_enabled = False
        self._dial_ep: Optional[EndPoint] = None
        if role == "server":
            # window negotiation: the receive pool is created at HELLO
            # time, mirroring the dialer's geometry (reference negotiates
            # queue geometry in its handshake, rdma_endpoint.cpp:127-130)
            self.recv_pool = None
        else:
            self.recv_pool = BlockPool(*clamp_geometry(block_size,
                                                       block_count))
        self.window: Optional[PeerWindow] = None
        self.inline_only = False          # cross-host fallback
        self.peer_ordinal = -1
        self.ready = threading.Event()
        self._send_lock = _rc.tracked_lock("TpuEndpoint._send_lock")
        self._failed = False
        self._fail_lock = _rc.tracked_lock("TpuEndpoint._fail_lock")
        # ---- deferred-credit accounting (zero-copy receive) ----
        # RLock: a borrowed block's release hook can fire from a dealloc
        # cascade triggered on a thread already inside the ack machinery
        self._ack_lock = _rc.tracked_lock("TpuEndpoint._ack_lock",
                                          threading.RLock())
        self._ack_pending: List[int] = []   # credits awaiting one FT_ACK
        self._ack_hold = 0                  # >0: a cut batch is open, defer
        self._borrowed_outstanding = 0      # blocks lent to the parse path
        self._released_total = 0            # lifetime releases (diagnostics)
        # per-endpoint credit-pressure tallies (mutated under _send_lock;
        # the /tpu builtin reads them racily, which is fine for a gauge)
        self.credit_stalls = 0
        self.credit_wait_us = 0.0
        # v3 fast path: peer's handshake version gates the priority lane
        # and doorbell coalescing (0 until HELLO/HELLO_ACK lands)
        self.peer_version = 0
        self._pri_vsock: Optional["TpuTransportSocket"] = None
        self._pri_lock = threading.Lock()
        # coalesced doorbell: small response frames produced ON the cut
        # thread while its batch bracket is open are banked here and flush
        # with the batch's FT_ACK as one ctrl write (_db_thread is the cut
        # thread's ident while a bracket is open, 0 otherwise)
        self._db_frames: List[tuple] = []   # [(views, total), ...]
        self._db_thread = 0
        self._db_first_ns = 0
        self.pri_tx_frames = 0
        self.pri_rx_frames = 0
        self.doorbell_flushes = 0
        self.doorbell_frames = 0
        self.vsock = TpuTransportSocket(self)
        # coalesce credit returns across a dispatcher poll batch: the
        # messenger brackets its cut loop with these hooks on both the
        # bootstrap socket (outer TPUC frames) and the virtual socket
        # (inner tunneled-protocol messages)
        self.vsock.cut_batch_hook = self
        ctrl_sock.cut_batch_hook = self
        if role == "server":
            self.vsock.owner_server = server
            from brpc_tpu_torch.rpc.input_messenger import InputMessenger

            self._messenger = server._messenger if server is not None \
                else InputMessenger()
        else:
            from brpc_tpu_torch.rpc.input_messenger import InputMessenger

            self._messenger = InputMessenger()
        # bootstrap death must tear down the tunnel and error pending RPCs
        ctrl_sock.on_failed_hook = lambda code, reason: self.fail(code, reason)

    # ------------------------------------------------------------- state view
    def state_dict(self) -> dict:
        """Racy-but-consistent-enough snapshot for the /tpu builtin: window
        occupancy, borrow pressure, credit stalls, epoch — everything an
        operator needs to explain a wedged or slow tunnel."""
        win = self.window
        pool = self.recv_pool
        with self._ack_lock:
            borrowed = self._borrowed_outstanding
            acks_pending = len(self._ack_pending)
            released = self._released_total
        return {
            "role": self.role,
            "remote": str(self.vsock.remote) if self.vsock.remote else "",
            "epoch": self.epoch,
            "ready": self.ready.is_set(),
            "failed": self._failed,
            "inline_only": self.inline_only,
            "peer_ordinal": self.peer_ordinal,
            "window_total": win.block_count if win is not None else 0,
            "window_free": len(win._free) if win is not None else 0,
            "borrowed_outstanding": borrowed,
            "recv_pool_exports": pool.exports if pool is not None else 0,
            "acks_pending": acks_pending,
            "credits_released_total": released,
            "credit_stalls": self.credit_stalls,
            "credit_wait_us": int(self.credit_wait_us),
            "in_bytes": self.vsock.in_bytes,
            "out_bytes": self.vsock.out_bytes,
            "in_messages": self.vsock.in_messages,
            "out_messages": self.vsock.out_messages,
            "peer_version": self.peer_version,
            "pri_tx_frames": self.pri_tx_frames,
            "pri_rx_frames": self.pri_rx_frames,
            "doorbell_flushes": self.doorbell_flushes,
            "doorbell_frames": self.doorbell_frames,
        }

    # --------------------------------------------------------------- handshake
    def _hello_body(self, ordinal: int, err: str = "") -> bytes:
        pool = self.recv_pool
        body = {
            "v": HANDSHAKE_VERSION,
            "pool": pool.name if pool is not None else "",
            "bs": pool.block_size if pool is not None else 0,
            "bc": pool.block_count if pool is not None else 0,
            "ordinal": ordinal,
            "pid": os.getpid(),
            "gen": self.epoch,
        }
        if err:
            body["err"] = err
        return json.dumps(body).encode()

    def send_hello(self) -> None:
        self.ctrl.write(_pack_frame(
            FT_HELLO, self._hello_body(self.target_ordinal)))

    def _attach_peer(self, info: dict) -> None:
        try:
            self.window = PeerWindow(info["pool"], info["bs"], info["bc"])
        except Exception:
            # different host (or pool gone): inline-frame fallback over DCN
            self.window = None
            self.inline_only = True
        self.peer_ordinal = int(info.get("ordinal", -1))
        self.peer_version = int(info.get("v", 1))

    def on_hello(self, body: bytes) -> None:
        """Server side: attach the client's pool, reply with ours. The ACK
        advertises the device WE front (the RDMA handshake exchanges each
        side's own GID/QPN) — and a dial addressed to a device this server
        does not front is refused, not silently served."""
        info = json.loads(body.decode())
        requested = int(info.get("ordinal", 0))
        gen = int(info.get("gen", 0))
        f = _fault.hit("tpu.handshake.fail")
        if f is not None:
            self.epoch = gen
            self.ctrl.write(_pack_frame(FT_HELLO_ACK, self._hello_body(
                requested,
                err=str(f.get("reason") or "fault injected handshake "
                                           "refusal"))))
            self.fail(errors.EREQUEST, "fault injected handshake refusal")
            return
        if self.ready.is_set():
            # repeat HELLO on a live bootstrap: the dialer is rebuilding
            # its tunnel in place under a higher generation — restart the
            # stream; a stale/duplicate HELLO from the old epoch is noise
            if gen <= self.epoch:
                g_tunnel_stale_epoch_frames.put(1)
                return
            self.epoch = gen  # before teardown: old borrows' release
            # hooks see the epoch mismatch and queue no credits
            self._restart_epoch()
        else:
            self.epoch = gen
        if self.recv_pool is None:
            # mirror the dialer's window geometry for our receive pool
            self.recv_pool = BlockPool(*clamp_geometry(
                int(info.get("bs", 0) or 0), int(info.get("bc", 0) or 0)))
        bound = getattr(self.server, "_tpu_ordinal", -1) \
            if self.server is not None else -1
        if bound >= 0 and requested != bound:
            self.ctrl.write(_pack_frame(FT_HELLO_ACK, self._hello_body(
                bound, err=f"server fronts device {bound}, "
                           f"dial requested {requested}")))
            self.fail(errors.EREQUEST, "device ordinal mismatch")
            return
        self._attach_peer(info)
        self.target_ordinal = requested
        peer_host = self.ctrl.remote.host if self.ctrl.remote else "?"
        self.vsock.remote = EndPoint.from_tpu(peer_host, requested)
        self.ctrl.write(_pack_frame(
            FT_HELLO_ACK,
            self._hello_body(bound if bound >= 0 else requested)))
        self.ready.set()

    def on_hello_ack(self, body: bytes) -> None:
        """Client side: attach the server's pool; tunnel is up."""
        info = json.loads(body.decode())
        gen = int(info.get("gen", self.epoch))
        if gen != self.epoch:
            # an ACK for a handshake this endpoint never sent (old epoch)
            g_tunnel_stale_epoch_frames.put(1)
            return
        err = info.get("err")
        if err:
            self.fail(errors.EHOSTDOWN, f"handshake refused: {err}")
            return
        self._attach_peer(info)
        self.ready.set()

    def _restart_epoch(self) -> None:
        """Server side of an in-band re-handshake: drop this stream's
        half-parsed state and window attachments so the new HELLO rebuilds
        them fresh. self.epoch is already the NEW generation, so borrowed
        views dropped here release without queueing stale credits, and
        old-epoch frames still in flight bounce off the epoch guard."""
        g_tunnel_epoch_restarts.put(1)
        with self._ack_lock:
            self._ack_pending.clear()
            self._db_frames.clear()
        self.vsock.pending_body = None
        self.vsock.read_buf.clear()   # releases old borrowed views
        pv = self._pri_vsock
        if pv is not None:
            pv.pending_body = None
            pv.read_buf.clear()
        if self.window is not None:
            self.window.close()
            self.window = None
        if self.recv_pool is not None:
            self.recv_pool.close()    # deferred while exports remain
            self.recv_pool = None
        self.inline_only = False

    # -------------------------------------------------------------- send path
    def send_packet(self, packet: IOBuf, span=None) -> int:
        """Ship one RPC packet's bytes through the tunnel. Chunks bigger
        than the window stream through it (credit flow control); the
        receiver reassembles from its read_buf, so frame boundaries are
        invisible to protocols. Bytes are copied ONCE — straight from the
        packet's IOBuf blocks into the peer's registered blocks (the
        reference posts IOBuf blocks to the QP the same way,
        rdma_endpoint.h:89 CutFromIOBufList).

        ``span``: the owning RPC's trace span (or None when unsampled) —
        receives the ``send_us``/``credit_wait_us`` phase marks and
        credit-stall / send-quantum events."""
        if self._failed:
            return errors.EFAILEDSOCKET
        _fault.maybe_sleep(_fault.hit("tpu.send.delay"))
        views = [memoryview(v) for v in packet.iter_blocks() if len(v)]
        total = sum(len(v) for v in views)
        if span is not None:
            t0 = _time.monotonic_ns()
            cw0 = span.phases.get("credit_wait_us", 0.0)
        # v3 small-packet fast lane: a whole correlation-addressed TRPC
        # packet at most INLINE_MAX must never queue behind the quanta of a
        # bulk main-lane send. Only TRPC magic qualifies — order-sensitive
        # byte streams (TSTR frames, h2) stay on the main lane.
        pri_ok = (0 < total <= INLINE_MAX and self.peer_version >= 3
                  and len(views[0]) >= 4 and bytes(views[0][:4]) == b"TRPC")
        if pri_ok and self._db_thread == threading.get_ident():
            # produced ON the cut thread inside its open batch bracket
            # (run-to-completion response): bank the frame — it flushes
            # with the batch's FT_ACK as ONE coalesced doorbell write
            hold_us = int(_flags.get("tpu_doorbell_coalesce_us"))
            if hold_us > 0:
                now = _time.monotonic_ns()
                if not self._db_frames:
                    self._db_first_ns = now
                self._db_frames.append((views, total))
                self.vsock.out_bytes += total
                if (now - self._db_first_ns) // 1000 >= hold_us:
                    # age bound: a long cut batch must not hold responses
                    # past the configured latency budget — flush frames
                    # early, keep banking credits to batch end
                    frames, self._db_frames = self._db_frames, []
                    self._db_first_ns = 0
                    return self._flush_doorbell(frames, [])
                return 0
        on_main_lane = True
        if pri_ok:
            on_main_lane = self._send_lock.acquire(blocking=False)
        else:
            self._send_lock.acquire()
        # profiler phase marker: samples landing in the copy/frame loops
        # attribute to "send"; credit stalls re-stamp "credit_wait" inside
        prev_ph = _prof.set_phase("send")
        if on_main_lane:
            try:
                if self._failed:
                    return errors.EFAILEDSOCKET
                try:
                    if total <= INLINE_MAX or self.window is None:
                        rc, partial = self._send_inline(views, total)
                    else:
                        rc, partial = self._send_blocks(views, total, span)
                except Exception:
                    if self._failed:
                        # fail() released the shm mapping under our feet
                        # (concurrent BYE/teardown) — a clean error, not a
                        # crash
                        return errors.EFAILEDSOCKET
                    raise
            finally:
                self._send_lock.release()
                _prof.set_phase(prev_ph)
        else:
            # main lane mid-bulk-send: divert to the priority sub-stream
            # (frame-granular interleave on the ctrl socket is safe — the
            # receiver demuxes FT_DATA_PRI into a separate virtual socket)
            try:
                rc, partial = self._send_pri(views, total), False
            finally:
                _prof.set_phase(prev_ph)
        if rc == 0:
            self.vsock.out_bytes += total
        if span is not None:
            # send_us excludes the credit waits accrued inside this packet
            # so the phase marks stay additive (waits are their own phase)
            elapsed = (_time.monotonic_ns() - t0) / 1000.0
            waited = span.phases.get("credit_wait_us", 0.0) - cw0
            span.add_phase("send_us", max(0.0, elapsed - waited))
        if rc != 0 and partial:
            # frames of this packet already reached the peer's byte stream:
            # the stream is desynced for good — kill the tunnel, never let
            # a later packet be parsed against the truncated one
            self.fail(rc, "mid-packet send failure desynced tunnel stream")
        return rc

    def _write_data_frame(self, frame) -> int:
        """Post one DATA frame on the ctrl socket, applying the armed
        frame-level faults: kill (the vsock dies exactly as if the
        bootstrap took an RST mid-message), drop (stream hole), corrupt
        (bit flip), truncate (short tail)."""
        if _fault.hit("tpu.tunnel.kill") is not None:
            self.ctrl.set_failed(errors.EFAILEDSOCKET,
                                 "fault injected tunnel kill")
            return errors.EFAILEDSOCKET
        if _fault.hit("tpu.frame.drop") is not None:
            return 0  # pretend posted: the peer's byte stream has a hole
        f = _fault.hit("tpu.frame.corrupt")
        if f is not None:
            raw = bytearray(frame.tobytes() if isinstance(frame, IOBuf)
                            else bytes(frame))
            pos = min(int(f.get("offset", CTRL_HDR_SIZE)), len(raw) - 1)
            raw[pos] ^= 0xFF
            frame = bytes(raw)
        f = _fault.hit("tpu.frame.truncate")
        if f is not None:
            raw = frame.tobytes() if isinstance(frame, IOBuf) \
                else bytes(frame)
            frame = raw[:max(0, len(raw) - int(f.get("bytes", 1)))]
        return self.ctrl.write(frame)

    def _send_inline(self, views, total: int):
        """Returns (rc, partial): partial=True once any frame was posted."""
        if total == 0:
            return 0, False
        if total <= INLINE_MAX:
            # single-frame case: build one contiguous bytes object instead
            # of an IOBuf — a small echo pays this framing cost twice per
            # RPC and bytes.join beats block-list assembly at these sizes
            frame = b"".join(
                (struct.pack(CTRL_HDR, CTRL_MAGIC, FT_DATA,
                             DATA_BODY_HDR_SIZE + total),
                 struct.pack(DATA_BODY_HDR, self.epoch, total, 0),
                 *views))
            rc = self._write_data_frame(frame)
            if rc != 0:
                return rc, False
            g_tunnel_out_bytes.put(total)
            return 0, False
        # chunk so a huge DCN-fallback payload can't build one giant frame
        chunk = DEFAULT_BLOCK_SIZE
        vi, voff = 0, 0
        left = total
        while left > 0:
            parts = []
            need = min(chunk, left)
            part_len = need
            while need:
                v = views[vi]
                take = min(need, len(v) - voff)
                parts.append(v[voff:voff + take])
                voff += take
                need -= take
                if voff == len(v):
                    vi += 1
                    voff = 0
            frame = IOBuf()
            frame.append(struct.pack(CTRL_HDR, CTRL_MAGIC, FT_DATA,
                                     DATA_BODY_HDR_SIZE + part_len))
            frame.append(struct.pack(DATA_BODY_HDR, self.epoch, part_len, 0))
            for p in parts:
                frame.append(p)
            rc = self._write_data_frame(frame)
            if rc != 0:
                return rc, left != total
            g_tunnel_out_bytes.put(part_len)
            left -= part_len
        return 0, False

    def _send_blocks(self, views, total: int, span=None):
        """Returns (rc, partial): partial=True once any frame was posted.

        Two-stage pipelined loop: acquire EXACTLY the blocks the next frame
        will fill (never speculative extras that must be released back),
        fill them, post the frame, repeat. Posting per SEND_PIPELINE_SEGS
        blocks instead of per message means the peer starts parsing frame k
        while we memcpy into frame k+1's blocks — and with the receiver's
        streaming cursor consuming mid-message, the credits for frame k are
        often back before the last frame is filled, so a multi-window
        message flows through a small window without stalling."""
        win = self.window
        bs = win.block_size
        sent = 0
        vi, voff = 0, 0
        while sent < total:
            # exact acquire: ceil-divide what is left, capped at the
            # pipelining quantum — every acquired block WILL carry bytes
            need = min(-(-(total - sent) // bs), SEND_PIPELINE_SEGS)
            # a stall = the window had zero credits when we asked (the
            # acquire below then parks until the peer's FT_ACK arrives, so
            # the measured wait IS one credit round-trip under pressure)
            stalled = not win._free
            t_acq = _time.monotonic_ns() if (stalled or span is not None) \
                else 0
            got = win.acquire(need)
            if stalled or span is not None:
                wait_us = (_time.monotonic_ns() - t_acq) / 1000.0
                if span is not None:
                    span.add_phase("credit_wait_us", wait_us)
                if stalled:
                    self.credit_stalls += 1
                    self.credit_wait_us += wait_us
                    g_tunnel_credit_stalls.put(1)
                    g_tunnel_credit_wait_us.put(int(wait_us))
                    if span is not None:
                        span.event("credit_stall", wait_us=round(wait_us, 1),
                                   need=need,
                                   got=0 if got is None else len(got))
            if got is None:
                # window wedged or closed
                return errors.EOVERCROWDED, sent > 0
            segs = []
            try:
                for idx in got:
                    # fill this registered block from consecutive source
                    # views — one memcpy per (view, block) intersection,
                    # no flatten
                    blk_off = 0
                    base = idx * bs
                    buf = win._shm.buf
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
                body = struct.pack(DATA_BODY_HDR, self.epoch, 0, len(segs))
                body += b"".join(struct.pack(SEG_FMT, i, ln)
                                 for i, ln in segs)
                rc = self._write_data_frame(_pack_frame(FT_DATA, body))
            except BaseException:
                # none of these credits reached the peer's byte stream, so
                # the peer will never ACK them back — returning them here
                # is the only thing standing between one bad memcpy (or a
                # torn pipe raising out of the frame write) and a window
                # that is permanently `need` credits smaller
                win.release(list(got))
                raise
            if rc != 0:
                # the frame never entered the peer's byte stream — return
                # the acquired credits, else they leak forever (the peer
                # can't ACK blocks it never saw) and the window wedges
                win.release([i for i, _ in segs])
                return rc, sent > sum(ln for _, ln in segs)
            qbytes = sum(ln for _, ln in segs)
            g_tunnel_out_bytes.put(qbytes)
            if span is not None:
                span.event("send_quantum", blocks=len(segs), bytes=qbytes,
                           sent=sent, total=total)
        return 0, False

    def _send_pri(self, views, total: int) -> int:
        """Post one whole small packet as a single FT_DATA_PRI frame.
        Needs no _send_lock: the ctrl socket's write path appends a whole
        call's views atomically, so pri frames interleave with main-lane
        FT_DATA at frame granularity only."""
        frame = b"".join(
            (struct.pack(CTRL_HDR, CTRL_MAGIC, FT_DATA_PRI,
                         DATA_BODY_HDR_SIZE + total),
             struct.pack(DATA_BODY_HDR, self.epoch, total, 0),
             *views))
        rc = self._write_data_frame(frame)
        if rc == 0:
            self.pri_tx_frames += 1
            g_tunnel_pri_tx_frames.put(1)
            g_tunnel_pri_bytes.put(total)
            g_tunnel_out_bytes.put(total)
        return rc

    # -------------------------------------------------------------- recv path
    @poller_context
    def on_data(self, body: IOBuf) -> None:
        """Runs inline on the dispatcher parse loop — append stream bytes in
        arrival order, cut complete messages (processing itself fans out to
        fiber workers in cut_messages). ZERO-COPY: the frame body arrives as
        an IOBuf cut from the bootstrap socket's read chain; inline payload
        moves into the virtual socket's read_buf as refs, and block segments
        are appended as BORROWED views over the registered pool — the ACK
        credit is deferred until the parse path has actually consumed the
        bytes (the borrowed view's release hook), batched across the poll
        batch into one FT_ACK. Under window pressure (a message larger than
        the borrow budget sits unparseable in read_buf) segments degrade to
        copy-and-ACK so the peer's sender can never deadlock against our
        parser (the eager-copy behavior this path replaced)."""
        if self._failed:
            return
        if len(body) < DATA_BODY_HDR_SIZE:
            self.fail(errors.EREQUEST, "short DATA frame")
            return
        epoch, inline_len, nsegs = struct.unpack(
            DATA_BODY_HDR, body.fetch(DATA_BODY_HDR_SIZE))
        body.pop_front(DATA_BODY_HDR_SIZE)
        if epoch != self.epoch:
            # a frame from a previous window generation (in flight across
            # a re-handshake): its block refs point into the torn-down
            # pool — discard, never credit
            g_tunnel_stale_epoch_frames.put(1)
            return
        if len(body) < inline_len + nsegs * _SEG_SIZE:
            self.fail(errors.EREQUEST, "truncated DATA frame")
            return
        pool = self.recv_pool
        if nsegs and pool is None:
            # block refs before the HELLO created our pool: protocol abuse
            self.fail(errors.EREQUEST, "DATA before HELLO")
            return
        vsock = self.vsock
        got = 0
        if inline_len:
            # refs move from the bootstrap socket's chain; no payload copy
            body.cutn_into(inline_len, vsock.read_buf)
            got += inline_len
        if nsegs:
            seg_vals = struct.unpack(f"!{2 * nsegs}I",
                                     body.fetch(nsegs * _SEG_SIZE))
            # borrow budget: never lend more than half the window to the
            # parse path — the other half keeps cycling via copy-and-ACK so
            # a message bigger than the window still streams through
            # (test_payload_larger_than_window_streams)
            borrow_limit = max(1, pool.block_count // 2)
            copied_acks: List[int] = []
            for k in range(nsegs):
                idx, ln = seg_vals[2 * k], seg_vals[2 * k + 1]
                try:
                    view = pool.view(idx, ln)
                except ValueError:
                    self.fail(errors.EREQUEST, "bad block ref in DATA")
                    return
                with self._ack_lock:
                    borrow = self._borrowed_outstanding < borrow_limit
                    if borrow:
                        self._borrowed_outstanding += 1
                        _note_borrow_peak(self._borrowed_outstanding)
                if borrow:
                    pool.add_export()
                    if vsock.read_buf.append_user_data(
                            view,
                            release=functools.partial(self._credit_released,
                                                      idx, pool, epoch)):
                        g_tunnel_borrowed_bytes.put(ln)
                    else:
                        # environment forced a copy; release already ran
                        g_tunnel_copied_bytes.put(ln)
                else:
                    # window pressure: copy out and return credit eagerly
                    vsock.read_buf.append(bytes(view))
                    copied_acks.append(idx)
                    g_tunnel_copied_bytes.put(ln)
                got += ln
            if copied_acks:
                self._queue_acks(copied_acks)
        vsock.in_bytes += got
        vsock.last_active = _time.monotonic()
        g_tunnel_in_bytes.put(got)
        self._messenger.cut_messages(vsock)

    def _pri_lane_sock(self) -> "TpuTransportSocket":
        """Lazy second virtual socket backing the priority sub-stream.
        Correlation ids are SHARED with the main lane (a response may
        arrive on either), so both vsocks resolve one pending set."""
        pv = self._pri_vsock
        if pv is None:
            with self._pri_lock:
                pv = self._pri_vsock
                if pv is None:
                    pv = TpuTransportSocket(self)
                    pv._pending_ids = self.vsock._pending_ids
                    pv._pending_lock = self.vsock._pending_lock
                    pv.priority_lane = True
                    pv.remote = self.vsock.remote
                    pv.owner_server = self.vsock.owner_server
                    pv.cut_batch_hook = self
                    self._pri_vsock = pv
        return pv

    @poller_context
    def on_data_pri(self, body: IOBuf) -> None:
        """Priority-lane receive: inline-only frames each carrying one
        whole small packet, demuxed into a separate virtual socket so
        their parse never waits behind the main lane's partially-arrived
        bulk body."""
        if self._failed:
            return
        if len(body) < DATA_BODY_HDR_SIZE:
            self.fail(errors.EREQUEST, "short PRI frame")
            return
        epoch, inline_len, nsegs = struct.unpack(
            DATA_BODY_HDR, body.fetch(DATA_BODY_HDR_SIZE))
        body.pop_front(DATA_BODY_HDR_SIZE)
        if epoch != self.epoch:
            g_tunnel_stale_epoch_frames.put(1)
            return
        if nsegs or len(body) < inline_len:
            # pri frames are inline-only by contract: block refs here mean
            # a desynced or hostile peer
            self.fail(errors.EREQUEST, "malformed PRI frame")
            return
        pv = self._pri_lane_sock()
        body.cutn_into(inline_len, pv.read_buf)
        pv.in_bytes += inline_len
        pv.last_active = _time.monotonic()
        self.pri_rx_frames += 1
        g_tunnel_pri_rx_frames.put(1)
        g_tunnel_in_bytes.put(inline_len)
        self._messenger.cut_messages(pv)

    # ------------------------------------------------- deferred batched acks
    def _credit_released(self, idx: int, pool: BlockPool, epoch: int) -> None:
        """Release hook of one borrowed block: runs exactly once, whenever
        the last view over the block dies (parser consumed the bytes, or
        teardown dropped them). The pool and epoch are BOUND at borrow
        time: after a re-handshake swapped the pools, a late release must
        drop its export on the OLD pool (letting its deferred close
        finish) and must NOT queue a credit into the new window."""
        with self._ack_lock:
            self._borrowed_outstanding -= 1
            self._released_total += 1
            dead = self._failed or epoch != self.epoch
        if not dead:
            self._queue_acks((idx,))
        pool.drop_export()

    def _queue_acks(self, indices) -> None:
        with self._ack_lock:
            self._ack_pending.extend(indices)
            if self._ack_hold > 0 or self._failed:
                return
            acks = self._ack_pending
            self._ack_pending = []
        self._write_ack(acks)

    @poller_context
    def _write_ack(self, acks: List[int]) -> None:
        if not acks:
            return
        # chaos injection point: stalling the ACK path *is* the experiment
        # (zero-cost no-op unless a test arms tpu.ack.stall)
        _fault.maybe_sleep(_fault.hit("tpu.ack.stall"))  # tpulint: disable=no-blocking-in-poller
        if _fault.hit("tpu.ack.drop") is not None:
            return  # credits vanish: the peer's window wedges until heal
        body = struct.pack(f"!{len(acks) + 2}I", self.epoch, len(acks),
                           *acks)
        g_tunnel_ack_frames.put(1)
        g_tunnel_ack_credits.put(len(acks))
        if self.ctrl.write(_pack_frame(FT_ACK, body)) != 0:
            # a lost ACK permanently leaks the peer's credits — the
            # stream contract is broken, tear the tunnel down
            self.fail(errors.EFAILEDSOCKET, "ACK write failed")

    # messenger cut-batch bracket: while a poll batch is being cut, credit
    # returns accumulate and flush as ONE FT_ACK at batch end; responses
    # the batch's run-to-completion handlers produced (banked in
    # send_packet) ride the same doorbell write
    def cut_batch_begin(self) -> None:
        with self._ack_lock:
            self._ack_hold += 1
            if self._ack_hold == 1:
                # only this thread can match the ident in send_packet, so
                # the racy read there is safe
                self._db_thread = threading.get_ident()

    @poller_context
    def cut_batch_end(self) -> None:
        with self._ack_lock:
            self._ack_hold -= 1
            if self._ack_hold > 0:
                return
            self._db_thread = 0
            frames = self._db_frames
            if frames:
                self._db_frames = []
                self._db_first_ns = 0
            if self._failed or (not self._ack_pending and not frames):
                return
            acks = self._ack_pending
            self._ack_pending = []
        if frames:
            self._flush_doorbell(frames, acks)
        else:
            # ack-only batch: the legacy single-FT_ACK path (keeps the
            # tpu.ack.* fault hooks meaningful)
            self._write_ack(acks)

    @poller_context
    def _flush_doorbell(self, frames, acks) -> int:
        """ONE ctrl write carrying the batch's banked response frames (as
        FT_DATA_PRI) plus its FT_ACK — the coalesced doorbell. Under load
        a poll batch of N cheap requests costs one syscall instead of
        N responses + 1 ack."""
        parts = []
        for views, total in frames:
            parts.append(struct.pack(CTRL_HDR, CTRL_MAGIC, FT_DATA_PRI,
                                     DATA_BODY_HDR_SIZE + total))
            parts.append(struct.pack(DATA_BODY_HDR, self.epoch, total, 0))
            parts.extend(views)
            self.pri_tx_frames += 1
            g_tunnel_pri_tx_frames.put(1)
            g_tunnel_pri_bytes.put(total)
            g_tunnel_out_bytes.put(total)
        if acks:
            body = struct.pack(f"!{len(acks) + 2}I", self.epoch, len(acks),
                               *acks)
            parts.append(struct.pack(CTRL_HDR, CTRL_MAGIC, FT_ACK,
                                     len(body)))
            parts.append(body)
            g_tunnel_ack_frames.put(1)
            g_tunnel_ack_credits.put(len(acks))
        self.doorbell_flushes += 1
        self.doorbell_frames += len(frames) + (1 if acks else 0)
        g_tunnel_doorbell_flushes.put(1)
        g_tunnel_doorbell_frames.put(len(frames) + (1 if acks else 0))
        rc = self._write_data_frame(b"".join(parts))
        if rc != 0:
            # banked responses (and credits) never reached the peer: the
            # stream contract is broken for both lanes
            self.fail(errors.EFAILEDSOCKET, "doorbell flush failed")
        return rc

    @poller_context
    def cut_body_complete(self) -> None:
        """End-of-body wakeup (the ROADMAP follow-on to streaming parse):
        a pending-body cursor just finished, which means the cut loop is
        holding a complete bulk message whose final borrowed blocks were
        released at feed time — flush the banked credits NOW, bypassing
        the cut-batch hold, so a peer sender parked on the window wakes
        immediately instead of waiting for the batch-end ACK."""
        with self._ack_lock:
            if self._failed or not self._ack_pending:
                return
            acks = self._ack_pending
            self._ack_pending = []
        g_tunnel_eob_wakeups.put(1)
        self._write_ack(acks)

    @poller_context
    def on_ack(self, body: bytes) -> None:
        vals = struct.unpack(f"!{len(body) // 4}I", body[:len(body) & ~3])
        if len(vals) < 2:
            return
        epoch, n = vals[0], vals[1]
        if epoch != self.epoch:
            # credits for blocks of a torn-down window generation
            g_tunnel_stale_epoch_frames.put(1)
            return
        if self.window is not None and n:
            self.window.release(vals[2:2 + n])

    # ---------------------------------------------------------------- failure
    def fail(self, code: int, reason: str = "", from_vsock: bool = False) -> None:
        with self._fail_lock:
            if self._failed:
                return
            self._failed = True
        self.ready.set()
        # credits pending return die with the tunnel: the peer's window is
        # being torn down too, and an ACK write would race the ctrl close
        # (banked doorbell responses die the same way — their calls are
        # errored through the shared pending-id set below)
        with self._ack_lock:
            self._ack_pending.clear()
            self._db_frames.clear()
        if not from_vsock:
            self.vsock.set_failed(code, reason)
        pv = self._pri_vsock
        if pv is not None:
            if not pv.failed:
                pv.set_failed(code, reason)
            pv.pending_body = None
            pv.read_buf.clear()
        # drop un-parsed borrowed views NOW (outside any ack lock): their
        # release hooks fire inside this clear() — each exactly once, with
        # _failed already set so no ACK is queued — which usually leaves the
        # pool export-free so the close below can unmap immediately. Views
        # still held by in-flight message bodies release later; the pool
        # defers its unmap until the last of those drops. A half-fed
        # streaming cursor holds claimed bytes only (its sources were
        # dropped at feed time) — clear the slot so nothing dispatches it.
        self.vsock.pending_body = None
        self.vsock.read_buf.clear()
        if self.window is not None:
            self.window.close()
        if self.recv_pool is not None:  # server may die pre-HELLO
            self.recv_pool.close()
        if not self.ctrl.failed:
            self.ctrl.set_failed(code if code else errors.EFAILEDSOCKET,
                                 f"tpu tunnel down: {reason}")
        # self-heal: a client tunnel that once completed its handshake
        # re-dials in the background (fresh HELLO, new window generation)
        # so retried RPCs land on a live socket instead of paying the
        # dial. Orderly close()/BYE clears _heal_enabled first.
        heal_ep = self._dial_ep if self._heal_enabled else None
        if heal_ep is not None:
            self._heal_enabled = False
            try:
                from brpc_tpu_torch import flags as _flags

                if _flags.get("tpu_tunnel_auto_heal"):
                    _healer_for((heal_ep.host, heal_ep.port,
                                 heal_ep.device_ordinal)).kick(heal_ep)
            except Exception:
                pass

    def close(self) -> None:
        self._heal_enabled = False  # orderly shutdown: nothing to heal
        if _rc.ACTIVE and self.window is not None:
            # orderly close must find the window whole — credits for the
            # final frames may still be riding the ctrl socket as ACKs, so
            # give them a bounded moment to land before the verdict
            _rc.ledger.window_teardown(self.window, wait=2.0)
        try:
            self.ctrl.write(_pack_frame(FT_BYE))
        except Exception:
            pass
        self.fail(errors.EFAILEDSOCKET, "closed locally")


class TpuCtrlProtocol(Protocol):
    """The control-plane protocol: registered like any other, so a plain
    Server accepts tpu tunnel connections with zero special-casing — the
    TPUC magic routes here, HELLO upgrades the connection to a TpuEndpoint
    (the reference's AppConnect handshake-then-switch pattern,
    rdma_endpoint.cpp ProcessHandshakeAtServer)."""

    name = "tpu_ctrl"
    magic = CTRL_MAGIC
    stateful = True        # parse() wants the socket (endpoint state)
    inline_process = True  # frame order IS stream byte order

    MAX_FRAME = 16 * 1024 * 1024

    def parse(self, buf: IOBuf, sock=None) -> Tuple[int, Optional[ParsedMessage]]:
        if len(buf) < CTRL_HDR_SIZE:
            head = buf.fetch(min(len(buf), 4))
            if head and not CTRL_MAGIC.startswith(head):
                return PARSE_TRY_OTHERS, None
            return PARSE_NOT_ENOUGH_DATA, None
        magic, ftype, blen = struct.unpack(CTRL_HDR, buf.fetch(CTRL_HDR_SIZE))
        if magic != CTRL_MAGIC:
            return PARSE_TRY_OTHERS, None
        if not (FT_HELLO <= ftype <= FT_DATA_PRI) or blen > self.MAX_FRAME:
            return PARSE_BAD, None
        if len(buf) < CTRL_HDR_SIZE + blen:
            from brpc_tpu_torch.rpc.protocol import (PendingBodyCursor,
                                                     can_stream_body,
                                                     stream_body_min)

            if (ftype == FT_DATA and blen >= stream_body_min()
                    and can_stream_body(sock)):
                # large inline DATA frame (DCN fallback) arriving in
                # pieces: stage the body through a ref-moving cursor
                # (claim=False — these bytes carry no deferred credits)
                # instead of re-probing the growing read_buf every burst
                buf.pop_front(CTRL_HDR_SIZE)
                cursor = PendingBodyCursor(
                    self, blen,
                    finish=lambda cur: ParsedMessage(self, FT_DATA,
                                                     cur.body()),
                    claim=False)
                cursor.feed(buf)
                sock.pending_body = cursor
            return PARSE_NOT_ENOUGH_DATA, None
        buf.pop_front(CTRL_HDR_SIZE)
        # zero-copy crack: the body rides through as moved refs over the
        # socket's read chain — on_data cuts the inline payload straight
        # into the virtual socket and fetches only the tiny headers
        return 0, ParsedMessage(self, ftype, buf.cutn(blen))

    def process(self, msg: ParsedMessage, server) -> None:
        sock = msg.socket
        ftype = msg.meta
        ep: Optional[TpuEndpoint] = getattr(sock, "_tpu_endpoint", None)
        if ftype == FT_HELLO:
            if ep is None:
                ep = TpuEndpoint(sock, role="server", server=server)
                sock._tpu_endpoint = ep
                sock.user_data = ep
                if server is not None:
                    server._register_tpu_endpoint(ep)
            ep.on_hello(msg.body.tobytes())
            return
        if ep is None:
            sock.set_failed(errors.EREQUEST, "tpu ctrl frame before HELLO")
            return
        if ftype == FT_HELLO_ACK:
            ep.on_hello_ack(msg.body.tobytes())
        elif ftype == FT_DATA:
            ep.on_data(msg.body)   # IOBuf: payload bytes are never flattened
        elif ftype == FT_DATA_PRI:
            ep.on_data_pri(msg.body)
        elif ftype == FT_ACK:
            ep.on_ack(msg.body.tobytes())
        elif ftype == FT_BYE:
            ep._heal_enabled = False  # peer's shutdown is orderly
            ep.fail(errors.EFAILEDSOCKET, "peer sent BYE")


# ---------------------------------------------------------------------------
# client-side connection management (the SocketMap of the tunnel world)
# ---------------------------------------------------------------------------
_remote_sockets: Dict[Tuple[str, int, int], TpuTransportSocket] = {}
_remote_lock = threading.Lock()


class TunnelHandshakeRefused(ConnectionError):
    """The peer answered HELLO with an error body (wrong ordinal, fault
    armed): retrying the identical dial cannot succeed, so the healer
    surfaces it immediately (still feeding the circuit breaker) instead of
    burning its backoff budget on it."""


class TunnelHealer:
    """Per-(host, port, ordinal) reconnect state: single-dialer election,
    a monotonically increasing window generation, exponential backoff
    between attempts, and a circuit breaker so an endpoint that repeatedly
    fails re-handshake is isolated like any TCP peer (reference
    circuit_breaker.cpp)."""

    def __init__(self, key: Tuple[str, int, int]):
        from brpc_tpu_torch.rpc.circuit_breaker import CircuitBreaker

        self.key = key
        self._cond = threading.Condition()
        self._dialing = False
        self._bg_alive = False
        self._gen = 0
        # EMA-based tripping needs tens of samples; handshake probes are
        # rare, so trip on a short consecutive-failure streak instead
        self.breaker = CircuitBreaker(min_samples=3, fail_streak_trip=3)
        self.last_error = ""

    def _isolated(self) -> bool:
        from brpc_tpu_torch import flags as _flags

        return _flags.get("circuit_breaker_enabled") and self.breaker.isolated

    # ------------------------------------------------------------------ dial
    def connect(self, ep: EndPoint, timeout: float) -> TpuTransportSocket:
        """Return a healthy vsock for ``ep``, dialing with exponential
        backoff within ``timeout``. One thread dials at a time; the rest
        park on the condition and pick up the winner's socket."""
        from brpc_tpu_torch import flags as _flags

        deadline = _time.monotonic() + timeout
        backoff = _flags.get("tpu_reconnect_backoff_ms") / 1000.0
        backoff_max = _flags.get("tpu_reconnect_backoff_max_ms") / 1000.0
        while True:
            with _remote_lock:
                vs = _remote_sockets.get(self.key)
            if vs is not None and not vs.failed:
                return vs
            if self._isolated():
                raise ConnectionError(
                    f"tpu endpoint {ep} isolated by circuit breaker "
                    f"(last error: {self.last_error})")
            with self._cond:
                if self._dialing:
                    left = deadline - _time.monotonic()
                    if left <= 0:
                        raise ConnectionError(
                            f"tpu reconnect to {ep} timed out waiting on "
                            f"the dialing thread")
                    self._cond.wait(min(left, 0.2))
                    continue
                self._dialing = True
            try:
                left = deadline - _time.monotonic()
                if left <= 0:
                    raise ConnectionError(f"tpu dial to {ep} timed out")
                try:
                    vs = self._dial_once(ep, left)
                except Exception as e:
                    self.breaker.on_call_end(errors.EHOSTDOWN)
                    g_tunnel_reconnect_failures.put(1)
                    self.last_error = str(e)
                    sp = _trace.current_span()
                    if sp is not None:
                        sp.event("tunnel_dial_failed", target=str(ep),
                                 gen=self._gen, error=str(e)[:120])
                    left = deadline - _time.monotonic()
                    if isinstance(e, TunnelHandshakeRefused) \
                            or left <= backoff:
                        raise
                    _time.sleep(min(backoff, left))
                    backoff = min(backoff * 2, backoff_max)
                    continue
                self.breaker.on_call_end(0)
                return vs
            finally:
                with self._cond:
                    self._dialing = False
                    self._cond.notify_all()

    def _dial_once(self, ep: EndPoint, timeout: float) -> TpuTransportSocket:
        from brpc_tpu_torch.rpc.event_dispatcher import global_dispatcher
        from brpc_tpu_torch.rpc.input_messenger import InputMessenger
        from brpc_tpu_torch.rpc.protocol import find_protocol
        from brpc_tpu_torch.rpc.socket import Socket

        with self._cond:
            self._gen += 1
            gen = self._gen
        boot = Socket.connect(EndPoint.from_ip_port(ep.host, ep.port),
                              global_dispatcher(),
                              timeout=min(timeout, 3.0))
        boot.preferred_protocol = find_protocol("tpu_ctrl")
        endpoint = TpuEndpoint(boot, role="client",
                               target_ordinal=max(ep.device_ordinal, 0),
                               epoch=gen)
        boot._tpu_endpoint = endpoint
        boot.user_data = endpoint
        endpoint.vsock.remote = ep
        endpoint._dial_ep = ep
        messenger = InputMessenger()
        boot._on_readable = messenger.make_on_readable(boot)
        boot.register_read()
        endpoint.send_hello()
        # spin-then-park: on a loopback/shm peer the HELLO_ACK round trip
        # is microseconds — winning the spin skips an Event park/notify
        _ready_spin.spin(endpoint.ready.is_set)
        if not endpoint.ready.wait(timeout):
            endpoint.fail(errors.EHOSTDOWN, "tpu handshake timeout")
            raise ConnectionError(f"tpu handshake with {ep} timed out")
        if endpoint.vsock.failed:
            text = endpoint.vsock.error_text
            if "handshake refused" in text:
                raise TunnelHandshakeRefused(
                    f"tpu handshake with {ep} failed: {text}")
            raise ConnectionError(
                f"tpu handshake with {ep} failed: {text}")
        with _remote_lock:
            cur = _remote_sockets.get(self.key)
            if cur is not None and not cur.failed:
                endpoint.close()
                return cur
            _remote_sockets[self.key] = endpoint.vsock
        endpoint._heal_enabled = True
        if gen > 1:
            g_tunnel_reconnects.put(1)
        sp = _trace.current_span()
        if sp is not None:
            # the dial happened on an RPC's critical path (healer-miss):
            # stamp it so the trace explains the latency spike
            sp.event("tunnel_dial", target=str(ep), gen=gen,
                     reconnect=gen > 1)
        return endpoint.vsock

    # ------------------------------------------------------------- state view
    def state_dict(self) -> dict:
        with self._cond:
            return {
                "gen": self._gen,
                "dialing": self._dialing,
                "bg_healing": self._bg_alive,
                "breaker_isolated": self.breaker.isolated,
                "last_error": self.last_error,
            }

    # ------------------------------------------------------- background heal
    def kick(self, ep: EndPoint) -> None:
        """Rebuild the tunnel off the RPC path so the next caller finds a
        live socket instead of paying the dial. At most one background
        healer per key; it gives up after tpu_reconnect_window_s (the next
        RPC or health probe re-dials on demand)."""
        with self._cond:
            if self._bg_alive:
                return
            self._bg_alive = True
        threading.Thread(
            target=self._bg_heal, args=(ep,), daemon=True,
            name=f"tpu-heal-{self.key[0]}:{self.key[1]}").start()

    def _bg_heal(self, ep: EndPoint) -> None:
        from brpc_tpu_torch import flags as _flags

        _prof.register_current_thread(_prof.ROLE_HEALER)
        try:
            self.connect(ep, _flags.get("tpu_reconnect_window_s"))
        except Exception:
            pass  # bounded give-up; failures already fed the breaker
        finally:
            with self._cond:
                self._bg_alive = False


_healers: Dict[Tuple[str, int, int], TunnelHealer] = {}


def _healer_for(key: Tuple[str, int, int]) -> TunnelHealer:
    with _remote_lock:
        h = _healers.get(key)
        if h is None:
            h = _healers[key] = TunnelHealer(key)
        return h


def tunnel_state() -> dict:
    """Process-wide tunnel snapshot for the /tpu builtin: every cached
    client endpoint (window occupancy, borrow/credit pressure, epoch) and
    every healer (generation, dialing/bg state, breaker). Server-side
    endpoints are appended by the builtin from ``server._tpu_endpoints``."""
    with _remote_lock:
        socks = dict(_remote_sockets)
        healers = dict(_healers)
    out = {
        "borrowed_peak_blocks": borrowed_peak_blocks(),
        "pri_lane": {
            "tx_frames": g_tunnel_pri_tx_frames.get_value(),
            "rx_frames": g_tunnel_pri_rx_frames.get_value(),
            "bytes": g_tunnel_pri_bytes.get_value(),
            "doorbell_flushes": g_tunnel_doorbell_flushes.get_value(),
            "doorbell_frames": g_tunnel_doorbell_frames.get_value(),
        },
        "client_endpoints": [],
        "healers": [],
    }
    for (host, port, ordinal), vs in sorted(socks.items()):
        d = vs.endpoint.state_dict()
        d["key"] = f"{host}:{port}/{ordinal}"
        out["client_endpoints"].append(d)
    for (host, port, ordinal), h in sorted(healers.items()):
        d = h.state_dict()
        d["key"] = f"{host}:{port}/{ordinal}"
        out["healers"].append(d)
    return out


def connect_tpu(ep: EndPoint, connect_timeout: float = 3.0) -> TpuTransportSocket:
    """Dial a remote tpu:// endpoint: TCP bootstrap, HELLO handshake, block
    pools attached — returns the virtual socket the client stack writes to.
    A failed cached tunnel is re-dialed through the endpoint's TunnelHealer
    (single-dialer, exponential backoff, circuit breaker, fresh window
    generation); a healthy cached tunnel returns immediately."""
    key = (ep.host, ep.port, ep.device_ordinal)
    with _remote_lock:
        vs = _remote_sockets.get(key)
        if vs is not None and not vs.failed:
            return vs
    return _healer_for(key).connect(ep, connect_timeout)
