"""native_transport — Python veneer over the C++ dataplane engine.

Division of labor (SURVEY §7 native mandate, re-derived for a hybrid stack):
the .so owns epoll loops, nonblocking sockets, TRPC/TSTR frame cutting and
registered native services (brpc_tpu_torch/native/dataplane.cpp); this module owns
policy — call-id completion, server dispatch, streams, retries — and moves
whole MESSAGES (never bytes) across the boundary:

  - ``NativeSocket``: the Socket surface (write / pending ids / set_failed)
    backed by ``dp_send``; what Channels and server responses write to.
  - ``NativeDataplane``: process singleton wrapping the runtime; a single
    poller thread drains the engine's event queue in batches and dispatches
    frames through the SAME ParsedMessage/process pipeline as the Python
    transport (input_messenger._process_one), so every protocol feature
    (spans, limiters, streams) behaves identically on either transport.
  - DETACHED connections (non-TRPC bytes on a native port: http dashboard,
    grpc, redis...) are adopted by the Python stack: the fd is wrapped in a
    regular Socket seeded with the buffered bytes and takes the normal
    InputMessenger path from then on.

Ordering guarantees relied on: the engine pushes ACCEPTED before the conn's
first frame and delivers each conn's frames in arrival order; the poller
processes inline_process protocols (stream frames) in poll order.

The port's copy of the JAX package's ``rpc/native_transport.py`` over the
port's own build of the engine (``brpc_tpu_torch/native``). The engine is
no optional accelerator here: when it cannot be built, ``get_dataplane``
raises instead of answering None. The engine's gRPC client lane
(``connect_grpc``: HEADERS and DATA packed in C++, trailers parsed there)
serves ``protocol="grpc"`` Channels, and ``bench_echo_native(grpc=True)``
runs the engine's C++ gRPC bench client; a gRPC connection that reaches a
native listener speaks to the engine's h2 server half, and a plain h2 one
(no ``application/grpc``) is detached to the port's ``GrpcProtocol``.
"""

from __future__ import annotations

import ctypes
import itertools
import logging
import socket as _socket
import struct
import threading
import time as _time
from typing import Dict, Optional, Set, Tuple

from brpc_tpu_torch.analysis.markers import poller_context
from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.butil.resource_pool import VersionedPool
from brpc_tpu_torch.fiber import call_id as _cid
from brpc_tpu_torch.fiber import runtime as _runtime
from brpc_tpu_torch.proto import rpc_meta_pb2
from brpc_tpu_torch.rpc import errors

log = logging.getLogger("brpc_tpu_torch.native_transport")

# event kinds (dataplane.cpp mirror)
EV_FRAME = 1
EV_FAILED = 2
EV_ACCEPTED = 3
EV_DETACHED = 4
EV_REQUEST = 5      # engine-parsed unary request (ReqLite struct + body)
EV_RESPONSE = 6     # engine-parsed unary response (RespLite struct + body)
EV_RESPONSE_ZC = 7  # zero-copy response: pool-block views + ack blob

# ReqLite / RespLite (dataplane.cpp mirrors, host endianness)
_REQ_STRUCT = struct.Struct("<QQQqqqiHH")  # cid,att_v,att,log,trace,span,to,sl,ml
_RESP_ATT = struct.Struct("<Q")           # att_size at offset 8
_RESP_HDR = 16
# dp_poll_packed record framing (dataplane.cpp kPackedHdr/kPackedPtrFlag)
_PACKED_HDR = struct.Struct("<iiQqQQ")    # kind,tag,conn,aux,mlen,blen
_PACKED_PTRS = struct.Struct("<QQQ")      # base,meta,body for big events
_PACKED_PTR_FLAG = 1 << 30

# Poll-batch boundary hook (brpc_tpu_torch.batch installs flush_poll_batch here):
# the packed poll loop calls it after each event batch, mirroring
# input_messenger's cut-loop call site, so requests parsed together (and
# handled inline under usercode_inline) batch together.
poll_batch_hook = None
_name_cache: dict = {}   # raw svc+method bytes -> decoded (svc, meth)
_flusher_tls = threading.local()  # threads that batch-flush queued sends

# fast-call correlation ids live far above the call_id pool's id space so
# the two completion routes can never collide on the wire
_fast_cid = itertools.count(1 << 40)


class FastCallRec:
    """In-flight fast-path call: the completion slot the poller fills.

    The fast lane (channel.py _fast_call <-> dp_call/dp_respond) replaces
    protobuf meta pack/parse + versioned call-id locks with a dict entry
    and an Event — the reference keeps this per-RPC machinery native
    (baidu_rpc_protocol.cpp ProcessRpcResponse); so do we."""

    __slots__ = ("event", "code", "text", "body", "att_size", "deadline",
                 "on_complete")

    def __init__(self):
        self.event: Optional[threading.Event] = None
        self.code = 0
        self.text = ""
        self.body = b""
        self.att_size = 0
        self.deadline = 0.0          # monotonic; async calls swept by poller
        self.on_complete = None      # async: callable(rec)

    def finish(self) -> None:
        cb = self.on_complete
        if cb is None:
            self.event.set()
        else:
            _runtime.start_background(cb, self)

class EngineSyncRec:
    """Stand-in record for a call whose caller is parked INSIDE the engine
    (dp_call_sync): completion paths that must run Python anyway (EV_FRAME
    donations, decompression, ZC tunnel reassembly, set_failed fan-out)
    fill the same fields as FastCallRec and finish() forwards the result
    to the parked C waiter via dp_sync_complete_py."""

    __slots__ = ("dp", "cid", "code", "text", "body", "att_size",
                 "deadline", "on_complete")

    def __init__(self, dp, cid: int):
        self.dp = dp
        self.cid = cid
        self.code = 0
        self.text = ""
        self.body = b""
        self.att_size = 0
        self.deadline = 0.0     # engine owns the deadline; sweeper skips
        self.on_complete = None

    def finish(self) -> None:
        t = self.text.encode() if self.text else b""
        body = self.body
        self.dp._lib.dp_sync_complete_py(
            self.dp._rt, self.cid, self.code, t, len(t), body, len(body),
            self.att_size, 0)


# error classes
DPE_OK = 0
DPE_EOF = 1
DPE_IO = 2
DPE_PROTOCOL = 3
DPE_OVERCROWDED = 4
DPE_NOTFOUND = 5
DPE_TIMEDOUT = 6

_DPE_TO_ERR = {
    DPE_EOF: errors.EFAILEDSOCKET,
    DPE_IO: errors.EFAILEDSOCKET,
    DPE_PROTOCOL: errors.EREQUEST,
    DPE_OVERCROWDED: errors.EOVERCROWDED,
    DPE_NOTFOUND: errors.EFAILEDSOCKET,
    DPE_TIMEDOUT: errors.ERPCTIMEDOUT,
}

_vsock_pool: VersionedPool = VersionedPool()
_sync_tls = threading.local()  # reusable dp_call_sync param block per thread
# SyncCallParams layout (dataplane.cpp): ins at 0, outs at 44, etext at 96
_SYNC_IN = struct.Struct("<QQqqqi")   # conn,cid,log,trace,span,timeout
_SYNC_OUT = struct.Struct("<iQQQQQQ")  # code,attempt,att,base,body,blen,elen
_SYNC_SIZE = 352
_RESPOND_IN = struct.Struct("<QQQiii")  # conn,cid,attempt,code,ctype,queue
_CALL_IN = struct.Struct("<QQqqqii")    # conn,cid,log,trace,span,to,queue


class NativeSocket:
    """A connection owned by the native engine, addressed by its conn id.

    Implements the surface the RPC stack needs from a socket; bytes move
    through dp_send / the engine's event queue."""

    def __init__(self, dataplane: "NativeDataplane", conn_id: int,
                 remote: Optional[EndPoint], is_server: bool):
        self._dp = dataplane
        self.conn_id = conn_id
        self.remote = remote
        self.peer_str = str(remote)  # hot path: one str() per conn, not RPC
        self.is_server_side = is_server
        self.read_buf = IOBuf()          # unused (engine cuts); kept for API
        self.preferred_protocol = None
        self.failed = False
        self.error_code = 0
        self.error_text = ""
        self.owner_server = None
        self.user_data = None
        self.in_bytes = 0
        self.out_bytes = 0
        self.in_messages = 0
        self.out_messages = 0
        self.last_active = _time.monotonic()
        self._sweep_msgs = 0  # engine-counter baseline for the idle sweep
        self._pending_ids: Set[int] = set()
        self._pending_lock = threading.Lock()
        self._fast_calls: Dict[int, FastCallRec] = {}  # cid -> rec
        self.on_failed_hook = None
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
        if id_wait is not None:
            self.add_pending_id(id_wait)
        if isinstance(data, IOBuf):
            rc, nbytes = self._dp.sendv_iobuf(self.conn_id, data)
        else:
            payload = bytes(data)
            nbytes = len(payload)
            rc = self._dp.send(self.conn_id, payload)
        if rc == DPE_OK:
            self.out_messages += 1
            self.out_bytes += nbytes
            self.last_active = _time.monotonic()
            return 0
        err = _DPE_TO_ERR.get(rc, errors.EFAILEDSOCKET)
        if id_wait is not None:
            self.remove_pending_id(id_wait)
        if rc in (DPE_EOF, DPE_IO, DPE_NOTFOUND):
            self.set_failed(err, f"native send failed ({rc})")
            if id_wait is not None:
                _cid.id_error(id_wait, err)
        return err

    # ---------------------------------------------------------------- failure
    def set_failed(self, code: int, reason: str = "") -> None:
        if code == errors.OK:
            code = errors.EFAILEDSOCKET
        with self._pending_lock:
            if self.failed:
                return
            self.failed = True
            self.error_code = code
            self.error_text = reason
            pending = list(self._pending_ids)
            self._pending_ids.clear()
        _vsock_pool.remove(self.socket_id)
        self._dp._drop_socket(self.conn_id)
        for cid in pending:
            _cid.id_error(cid, code)
        fast = self._fast_calls
        while fast:
            try:
                fcid, rec = fast.popitem()
            except KeyError:
                break
            rec.code = code
            rec.text = reason or "connection failed"
            rec.finish()
        hook = self.on_failed_hook
        if hook is not None:
            try:
                hook(code, reason)
            except Exception:
                log.exception("on_failed_hook")
        self._dp.close_conn(self.conn_id)

    def close(self) -> None:
        self.set_failed(errors.EFAILEDSOCKET, "closed locally")

    def __repr__(self) -> str:
        state = "failed" if self.failed else "ok"
        side = "server" if self.is_server_side else "client"
        return f"NativeSocket({side}, conn={self.conn_id}, " \
               f"remote={self.remote}, {state})"


class NativeDataplane:
    """Process-wide engine wrapper (use :func:`get_dataplane`)."""

    POLL_BATCH = 256
    POLL_BUF = 1 << 20  # packed-batch delivery buffer (dp_poll_packed)

    def __init__(self, nloops: int = 0):
        from brpc_tpu_torch import native

        lib = native.load_dataplane()  # raises when it cannot be built
        self._lib = lib
        if nloops <= 0:
            import os as _os

            nloops = max(2, min(4, (_os.cpu_count() or 4) // 2))
        self._rt = lib.dp_rt_create(nloops, 0)
        self._lock = threading.Lock()
        self._socks: Dict[int, NativeSocket] = {}
        self._servers: Dict[int, object] = {}       # listener id -> Server
        self._server_conns: Dict[int, Set[int]] = {}  # lid -> conn ids
        self._conn_lid: Dict[int, int] = {}
        # frames that arrived before register_socket (connect race)
        self._orphans: Dict[int, list] = {}
        # client connection sharing (the SocketMap of the native world)
        self._conn_map: Dict[Tuple[str, int], NativeSocket] = {}
        self._conn_pools: Dict[tuple, list] = {}  # pooled free lists
        self._conn_map_lock = threading.Lock()
        self._running = True
        self._proto_trpc = None
        self._proto_tstr = None
        self._poller = threading.Thread(target=self._poll_loop, daemon=True,
                                        name="brpc-native-poller")
        # user done callbacks must not run (and possibly block) on the
        # poller — controller defers them to fibers when it sees this flag
        self._poller.brpc_no_user_code = True
        self._poller.start()

    # --------------------------------------------------------------- engine
    def send(self, conn_id: int, payload: bytes) -> int:
        return self._lib.dp_send(self._rt, conn_id, payload, len(payload))

    def call(self, conn_id: int, service: bytes, method: bytes, cid: int,
             attempt: int, log_id: int, timeout_ms: int, payload: bytes,
             attachment: bytes, queue: bool, trace_id: int = 0,
             span_id: int = 0) -> int:
        """Request packet packed + written by the engine (no Python pb)."""
        return self._lib.dp_call(
            self._rt, conn_id, service, len(service), method, len(method),
            cid, attempt, log_id, trace_id, span_id, timeout_ms,
            payload, len(payload), attachment, len(attachment),
            1 if queue else 0)

    def call2(self, conn_id: int, service: bytes, method: bytes, cid: int,
              log_id: int, timeout_ms: int, payload: bytes,
              attachment: bytes, queue: bool, trace_id: int = 0,
              span_id: int = 0) -> int:
        """Async fast call; scalars cross in one reusable param block
        (CallParams in dataplane.cpp) instead of 17 marshalled args."""
        tls = _sync_tls
        cbuf = getattr(tls, "cbuf", None)
        if cbuf is None:
            cbuf = tls.cbuf = ctypes.create_string_buffer(48)
        _CALL_IN.pack_into(cbuf, 0, conn_id, cid, log_id, trace_id,
                           span_id, timeout_ms, 1 if queue else 0)
        return self._lib.dp_call2(
            self._rt, cbuf, service, len(service), method, len(method),
            payload, len(payload), attachment, len(attachment))

    def call_sync(self, conn_id: int, service: bytes, method: bytes,
                  cid: int, log_id: int, timeout_ms: int, payload: bytes,
                  attachment: bytes, trace_id: int = 0, span_id: int = 0):
        """Blocking fast call parked in the engine (GIL released for the
        whole wait). Returns (dpe_rc, app_code, error_text, body,
        att_size); dpe_rc != 0 means the transport failed or timed out.
        Parameters and results cross in ONE reusable struct buffer
        (SyncCallParams in dataplane.cpp) — two pointer args instead of
        23 marshalled scalars."""
        tls = _sync_tls
        pbuf = getattr(tls, "pbuf", None)
        if pbuf is None:
            pbuf = tls.pbuf = ctypes.create_string_buffer(_SYNC_SIZE)
        _SYNC_IN.pack_into(pbuf, 0, conn_id, cid, log_id, trace_id,
                           span_id, timeout_ms)
        rc = self._lib.dp_call_sync2(
            self._rt, pbuf, service, len(service), method, len(method),
            payload, len(payload), attachment, len(attachment))
        (code, attempt, att_size, base, body, blen,
         elen) = _SYNC_OUT.unpack_from(pbuf, 44)
        if rc != 0:
            text = pbuf.raw[96:96 + elen].decode("utf-8", "replace") \
                if elen else ""
            return (rc, 0, text, b"", 0)
        b = ctypes.string_at(body, blen) if blen else b""
        if base:
            self._lib.dp_free(base)
        text = pbuf.raw[96:96 + elen].decode("utf-8", "replace") \
            if code and elen else ""
        return (0, code, text, b, att_size)

    def respond(self, conn_id: int, cid: int, attempt: int, code: int,
                text: bytes, payload: bytes, attachment: bytes,
                queue: bool, compress_type: int = 0) -> int:
        """Response packet packed + written by the engine (no Python pb).
        Scalars cross in one reusable struct buffer (RespondParams)."""
        tls = _sync_tls
        rbuf = getattr(tls, "rbuf", None)
        if rbuf is None:
            rbuf = tls.rbuf = ctypes.create_string_buffer(40)
        _RESPOND_IN.pack_into(rbuf, 0, conn_id, cid, attempt, code,
                              compress_type, 1 if queue else 0)
        return self._lib.dp_respond2(
            self._rt, rbuf, text, len(text), payload, len(payload),
            attachment, len(attachment))

    def flush_all(self) -> None:
        self._lib.dp_flush_all(self._rt)

    def sendv_iobuf(self, conn_id: int, buf: IOBuf) -> Tuple[int, int]:
        """Write an IOBuf's ref chain without flattening: each ref that spans
        a whole bytes object crosses as a pointer (zero copy); odd segments
        degrade to a per-segment copy; >64 segments flatten entirely."""
        parts = []
        total = 0
        for mv in buf.iter_blocks():
            n = mv.nbytes
            if not n:
                continue
            total += n
            obj = getattr(mv, "obj", None)
            if type(obj) is bytes and n == len(obj):
                parts.append(obj)
            else:
                parts.append(bytes(mv))
        if not parts:
            return DPE_OK, 0
        if len(parts) > 64:
            flat = b"".join(parts)
            return self._lib.dp_send(self._rt, conn_id, flat, len(flat)), total
        n = len(parts)
        bufs = (ctypes.c_char_p * n)(*parts)
        lens = (ctypes.c_uint64 * n)(*[len(p) for p in parts])
        return self._lib.dp_sendv(self._rt, conn_id, bufs, lens, n), total

    def close_conn(self, conn_id: int) -> None:
        self._lib.dp_conn_close(self._rt, conn_id)

    def listen(self, server, host: str, port: int,
               tpu_ordinal: int = -1, fastpath: bool = False) -> Tuple[int, int]:
        """Returns (listener_id, bound_port); raises OSError on failure.
        tpu_ordinal >= 0 makes accepted TPUC handshakes native tunnels;
        fastpath=True makes the engine deliver parsed EV_REQUEST events
        for plain unary requests (meta-free Python dispatch)."""
        lid = self._lib.dp_listen(self._rt, host.encode(), port)
        if lid < 0:
            raise OSError(-lid, f"dp_listen({host}:{port})")
        if tpu_ordinal >= 0:
            self._lib.dp_listener_set_tpu(self._rt, lid, tpu_ordinal)
        if fastpath:
            self._lib.dp_listener_set_fastpath(self._rt, lid, 1)
        bound = self._lib.dp_listen_port(self._rt, lid)
        with self._lock:
            self._servers[lid] = server
            self._server_conns[lid] = set()
        return lid, bound

    def stop_listening(self, lid: int) -> None:
        """Close the listener only — existing connections keep serving
        (graceful-stop contract; reference Server::Stop)."""
        self._lib.dp_listener_close(self._rt, lid)

    def teardown_listener(self, lid: int) -> None:
        """Drop the listener's registry entries and close its connections
        (Server.join after in-flight work drained)."""
        self._lib.dp_unregister_listener_echoes(self._rt, lid)
        with self._lock:
            self._servers.pop(lid, None)
            conn_ids = list(self._server_conns.pop(lid, ()))
        for cid_ in conn_ids:
            sock = self._socks.get(cid_)
            if sock is not None:
                sock.close()
            else:
                self.close_conn(cid_)

    def close_listener(self, lid: int) -> None:
        self.stop_listening(lid)
        self.teardown_listener(lid)

    def register_echo(self, lid: int, service: str, method: str,
                      max_concurrency: int = 0) -> None:
        """Native services are LISTENER-scoped: one server's C++ fast path
        must never answer another server's traffic in the same process."""
        self._lib.dp_register_echo(self._rt, lid, service.encode(),
                                   method.encode())
        if max_concurrency:
            self._lib.dp_svc_set_limit(self._rt, lid, service.encode(),
                                       method.encode(), max_concurrency)

    def set_listener_logoff(self, lid: int, on: bool) -> None:
        self._lib.dp_listener_set_logoff(self._rt, lid, 1 if on else 0)

    def svc_stats(self, lid: int, service: str, method: str):
        """Native method status: dict(requests, errors, latency_avg_us,
        latency_max_us, concurrency) or None."""
        req = ctypes.c_uint64()
        errs = ctypes.c_uint64()
        lat_sum = ctypes.c_uint64()
        lat_max = ctypes.c_uint64()
        conc = ctypes.c_int32()
        rc = self._lib.dp_svc_stats(
            self._rt, lid, service.encode(), method.encode(),
            ctypes.byref(req), ctypes.byref(errs), ctypes.byref(lat_sum),
            ctypes.byref(lat_max), ctypes.byref(conc))
        if rc != 0:
            return None
        n = req.value
        return {
            "requests": n,
            "errors": errs.value,
            "latency_avg_us": (lat_sum.value / n / 1000.0) if n else 0.0,
            "latency_max_us": lat_max.value / 1000.0,
            "concurrency": conc.value,
        }

    def connect(self, ep: EndPoint, timeout_ms: int = 3000) -> NativeSocket:
        err = ctypes.c_int(0)
        conn = self._lib.dp_connect(self._rt, (ep.host or "127.0.0.1").encode(),
                                    ep.port, timeout_ms, ctypes.byref(err))
        if not conn:
            raise ConnectionError(
                f"native connect to {ep} failed: errno={err.value}")
        sock = NativeSocket(self, conn, ep, is_server=False)
        self.register_socket(conn, sock)
        # parsed EV_RESPONSE completions for plain unary responses
        self._lib.dp_conn_set_fastpath(self._rt, conn, 1)
        return sock

    def connect_tpu(self, ep: EndPoint, timeout_ms: int = 3000,
                    block_size: int = 0,
                    block_count: int = 0) -> NativeSocket:
        """Dial a tpu:// endpoint through the engine: TCP bootstrap + TPUC
        handshake + shm block pools, all native (the RDMA-analog lane of
        tpu/transport.py with the data path in C++). block_size/count
        request the window geometry; the server mirrors it (0 = defaults)."""
        err = ctypes.c_int(0)
        conn = self._lib.dp_connect_tpu2(
            self._rt, (ep.host or "127.0.0.1").encode(), ep.port,
            max(ep.device_ordinal, 0), timeout_ms, block_size, block_count,
            ctypes.byref(err))
        if not conn:
            raise ConnectionError(
                f"native tpu connect to {ep} failed: errno={err.value}")
        sock = NativeSocket(self, conn, ep, is_server=False)
        self.register_socket(conn, sock)
        self._lib.dp_conn_set_fastpath(self._rt, conn, 1)
        return sock

    def connect_grpc(self, ep: EndPoint,
                     timeout_ms: int = 3000) -> NativeSocket:
        """Dial a grpc/h2 endpoint through the engine: dp_call/dp_call_sync
        on the conn are translated to HEADERS+DATA h2 frames natively (the
        h2 hot path lives in dataplane.cpp)."""
        err = ctypes.c_int(0)
        conn = self._lib.dp_connect_grpc(
            self._rt, (ep.host or "127.0.0.1").encode(), ep.port,
            timeout_ms, ctypes.byref(err))
        if not conn:
            raise ConnectionError(
                f"native grpc connect to {ep} failed: errno={err.value}")
        sock = NativeSocket(self, conn, ep, is_server=False)
        self.register_socket(conn, sock)
        self._lib.dp_conn_set_fastpath(self._rt, conn, 1)
        return sock

    def get_or_connect(self, ep: EndPoint, timeout_ms: int = 3000,
                       grpc: bool = False) -> NativeSocket:
        """Shared client connection per endpoint ("single" type). grpc
        conns never share a socket with trpc_std ones (different wire)."""
        is_tpu = ep.is_tpu()
        key = (ep.host or "127.0.0.1", ep.port,
               ep.device_ordinal if is_tpu else -1,
               "grpc" if grpc else "")
        with self._conn_map_lock:
            sock = self._conn_map.get(key)
            if sock is not None and not sock.failed:
                return sock
        if grpc:
            sock = self.connect_grpc(ep, timeout_ms)
        elif is_tpu:
            sock = self.connect_tpu(ep, timeout_ms)
        else:
            sock = self.connect(ep, timeout_ms)
        with self._conn_map_lock:
            cur = self._conn_map.get(key)
            if cur is not None and not cur.failed:
                sock.close()
                return cur
            self._conn_map[key] = sock
            return sock

    # --------------------------------------------- pooled / short conns
    # (reference channel.h:90-95 connection types on the native lane;
    # return discipline mirrors rpc/socket_map.py — ambiguous checkouts
    # close instead of pooling so stale responses can't be replayed)
    POOL_MAX_IDLE = 32

    def get_pooled(self, ep: EndPoint,
                   timeout_ms: int = 3000) -> NativeSocket:
        is_tpu = ep.is_tpu()
        key = (ep.host or "127.0.0.1", ep.port,
               ep.device_ordinal if is_tpu else -1)
        with self._conn_map_lock:
            pool = self._conn_pools.setdefault(key, [])
            while pool:
                sock = pool.pop()
                if not sock.failed:
                    sock._brpc_pool_key = key
                    return sock
        sock = self.connect_tpu(ep, timeout_ms) if is_tpu \
            else self.connect(ep, timeout_ms)
        sock._brpc_pool_key = key
        return sock

    def return_pooled(self, sock: NativeSocket, reusable: bool) -> None:
        key = getattr(sock, "_brpc_pool_key", None)
        if key is None:
            return
        sock._brpc_pool_key = None
        if not reusable or sock.failed:
            if not sock.failed:
                sock.close()
            return
        with self._conn_map_lock:
            pool = self._conn_pools.setdefault(key, [])
            if len(pool) < self.POOL_MAX_IDLE:
                pool.append(sock)
                return
        sock.close()

    def connect_short(self, ep: EndPoint,
                      timeout_ms: int = 3000) -> NativeSocket:
        sock = self.connect_tpu(ep, timeout_ms) if ep.is_tpu() \
            else self.connect(ep, timeout_ms)
        sock._brpc_short = True
        return sock

    # ------------------------------------------------------------- registry
    def register_socket(self, conn_id: int, sock: NativeSocket) -> None:
        with self._lock:
            self._socks[conn_id] = sock
            orphans = self._orphans.pop(conn_id, None)
        if orphans:
            for ev_tuple in orphans:
                self._dispatch_replayed(sock, ev_tuple)

    def _drop_socket(self, conn_id: int) -> None:
        with self._lock:
            self._socks.pop(conn_id, None)
            lid = self._conn_lid.pop(conn_id, None)
            if lid is not None:
                conns = self._server_conns.get(lid)
                if conns is not None:
                    conns.discard(conn_id)

    def lookup(self, conn_id: int) -> Optional[NativeSocket]:
        with self._lock:
            return self._socks.get(conn_id)

    def conn_stats(self, conn_id: int):
        """(in_bytes, out_bytes, in_msgs, out_msgs) straight from the
        engine — counts traffic the Python side never sees (C++-answered
        native services). None for unknown conns."""
        outs = [ctypes.c_uint64() for _ in range(4)]
        rc = self._lib.dp_conn_stats(self._rt, conn_id,
                                     *[ctypes.byref(o) for o in outs])
        if rc != 0:
            return None
        return tuple(o.value for o in outs)

    def server_socks(self, server) -> list:
        """Snapshot of this server's live engine conns (lock discipline
        stays in one place — /connections and the idle sweep use this)."""
        with self._lock:
            return [s for s in self._socks.values()
                    if s.owner_server is server]

    # ------------------------------------------------------------ poll loop
    def _protocols(self):
        if self._proto_trpc is None:
            from brpc_tpu_torch.policy import ensure_registered
            from brpc_tpu_torch.rpc.protocol import find_protocol

            ensure_registered()
            self._proto_trpc = find_protocol("trpc_std")
            self._proto_tstr = find_protocol("trpc_stream")
        return self._proto_trpc, self._proto_tstr

    @poller_context
    def _poll_loop(self) -> None:
        """Packed batch loop (VERDICT r3 #1): ONE ctypes call returns a
        whole batch of events inlined into a reusable buffer; the loop
        parses records with struct.unpack_from on a memoryview — per-event
        ctypes field reads, string_at pairs, and dp_free crossings are
        gone for small events. Big events arrive as pointer records and
        keep the zero-copy donation semantics."""
        from brpc_tpu_torch.profiling import registry as _prof

        _prof.register_current_thread(_prof.ROLE_POLLER)
        _flusher_tls.on = True
        global _fp_fn
        if _fp_fn is None:
            from brpc_tpu_torch.rpc.server_processing import fast_process_request

            _fp_fn = fast_process_request
        fpr = _fp_fn
        lib = self._lib
        rt = self._rt
        buf = ctypes.create_string_buffer(self.POLL_BUF)
        mv = memoryview(buf)
        hdr = _PACKED_HDR.unpack_from
        ptrs = _PACKED_PTRS.unpack_from
        string_at = ctypes.string_at
        last_sweep = _time.monotonic()
        while self._running:
            nbytes = lib.dp_poll_packed(rt, buf, self.POLL_BUF, 200,
                                        self.POLL_BATCH)
            off = 0
            while off < nbytes:
                kind, tag, conn_id, aux, mlen, blen = hdr(mv, off)
                off += 40
                base = 0
                if kind & _PACKED_PTR_FLAG:
                    kind &= ~_PACKED_PTR_FLAG
                    base, mptr, bptr = ptrs(mv, off)
                    off += 24
                    meta_b = string_at(mptr, mlen) if mlen else b""
                    body_b = string_at(bptr, blen) if blen else b""
                else:
                    end = off + mlen
                    meta_b = bytes(mv[off:end])
                    body_b = bytes(mv[end:end + blen]) if blen else b""
                    off = end + blen
                try:
                    if kind == EV_REQUEST:
                        item = self._crack_fast_request(conn_id, meta_b,
                                                        body_b)
                        if item is not None:
                            nulls = item[0]._null_methods
                            if nulls and (item[2], item[3]) in nulls:
                                # null-service control: raw body echo,
                                # zero policy (register_null_method)
                                self.respond(conn_id, item[4], item[5],
                                             0, b"", item[11], b"", True)
                            elif item[0].options.usercode_inline:
                                # reference default: user code runs in the
                                # parsing thread; responses batch-flush
                                fpr(item)
                            else:
                                # fiber per request — blocking handlers
                                # stay concurrent (slow-path semantics)
                                _runtime.start_background(
                                    _fast_process_request, item)
                    elif kind == EV_RESPONSE:
                        self._on_fast_response(conn_id, aux, tag, meta_b,
                                               body_b)
                    elif kind == EV_RESPONSE_ZC:
                        self._on_fast_response_zc(conn_id, aux, tag,
                                                  meta_b)
                    else:
                        self._dispatch(kind, tag, conn_id, aux, meta_b,
                                       body_b)
                except Exception:
                    log.exception("native event dispatch failed (kind=%d)",
                                  kind)
                finally:
                    if base:
                        lib.dp_free(base)
            if nbytes:
                hook = poll_batch_hook
                if hook is not None:
                    hook()  # batch queues flush at the event-batch boundary
                lib.dp_flush_all(rt)  # queued inline responses go out now
            now = _time.monotonic()
            if now - last_sweep > 0.1:
                last_sweep = now
                self._sweep_fast_timeouts(now)

    # ------------------------------------------------------- fast-path events
    def _crack_fast_request(self, conn_id, meta_b, body):
        """EV_REQUEST -> dispatch tuple (engine already parsed the meta)."""
        sock = self._socks.get(conn_id)  # GIL-atomic read, hot path
        if sock is None:
            return None  # conn already failed/removed; nobody to answer
        server = sock.owner_server
        if server is None:
            return None
        (cid, attempt, att_size, log_id, trace_id, span_id, timeout_ms,
         svc_len, meth_len) = _REQ_STRUCT.unpack_from(meta_b)
        svc_off = _REQ_STRUCT.size
        # cache key INCLUDES the packed svc_len/meth_len fields (the 4
        # bytes before the names): same concatenation with a different
        # split must not collide
        names = meta_b[svc_off - 4:svc_off + svc_len + meth_len]
        cached = _name_cache.get(names)
        if cached is None:
            svc = names[4:4 + svc_len].decode("utf-8", "replace")
            meth = names[4 + svc_len:].decode("utf-8", "replace")
            if len(_name_cache) < 4096:
                _name_cache[names] = (svc, meth)
        else:
            svc, meth = cached
        sock.in_messages += 1
        sock.in_bytes += len(meta_b) + len(body)
        sock.last_active = _time.monotonic()
        return (server, sock, svc, meth, cid, attempt, att_size, log_id,
                trace_id, span_id, timeout_ms, body)

    def _on_fast_response(self, conn_id, cid, tag, meta_b, body_b) -> None:
        sock = self._socks.get(conn_id)
        rec = sock._fast_calls.pop(cid, None) if sock is not None else None
        if rec is not None:
            rec.code = tag
            if tag and len(meta_b) > _RESP_HDR:
                rec.text = meta_b[_RESP_HDR:].decode("utf-8", "replace")
            rec.att_size = _RESP_ATT.unpack_from(meta_b, 8)[0]
            rec.body = body_b
            sock.in_messages += 1
            sock.in_bytes += len(meta_b) + len(body_b)
            rec.finish()
            return
        if sock is None:
            return
        # a slow-path (full Controller) call completed on a fast conn:
        # rebuild the RpcMeta and take the normal completion route
        meta = rpc_meta_pb2.RpcMeta()
        meta.correlation_id = cid
        meta.attempt_version = int.from_bytes(meta_b[0:8], "little")
        meta.attachment_size = _RESP_ATT.unpack_from(meta_b, 8)[0]
        meta.response.error_code = tag
        if tag and len(meta_b) > _RESP_HDR:
            meta.response.error_text = meta_b[_RESP_HDR:].decode(
                "utf-8", "replace")
        self._process_frame(sock, 0, None, body_b, prebuilt_meta=meta)

    def _on_fast_response_zc(self, conn_id, cid, tag, meta_b) -> None:
        """Zero-copy tunnel response: the payload sits in our registered
        pool blocks. Python consumers need contiguous bytes, so copy the
        views out (ONE copy — the stream-reassembly copy was skipped
        engine-side), then return the credits via dp_tpu_ack."""
        attempt, att_size = struct.unpack_from("<QQ", meta_b, 0)
        nv = struct.unpack_from("<I", meta_b, _RESP_HDR)[0]
        off = _RESP_HDR + 4
        parts = []
        for _ in range(nv):
            p, ln = struct.unpack_from("<QQ", meta_b, off)
            off += 16
            if ln:
                parts.append(ctypes.string_at(p, ln))
        alen = struct.unpack_from("<I", meta_b, off)[0]
        ack = meta_b[off + 4:off + 4 + alen]
        etext = meta_b[off + 4 + alen:].decode("utf-8", "replace")
        # credits go back the moment the bytes are copied out
        self._lib.dp_tpu_ack(self._rt, conn_id, ack, alen)
        body = b"".join(parts)
        sock = self._socks.get(conn_id)
        rec = sock._fast_calls.pop(cid, None) if sock is not None else None
        if rec is not None:
            rec.code = tag
            rec.text = etext if tag else ""
            rec.att_size = att_size
            rec.body = body
            sock.in_messages += 1
            sock.in_bytes += len(body)
            rec.finish()
            return
        if sock is None:
            return
        meta = rpc_meta_pb2.RpcMeta()
        meta.correlation_id = cid
        meta.attempt_version = attempt
        meta.attachment_size = att_size
        meta.response.error_code = tag
        if tag:
            meta.response.error_text = etext
        self._process_frame(sock, 0, None, body, prebuilt_meta=meta)

    def _sweep_fast_timeouts(self, now: float) -> None:
        """Async fast calls have no per-call timer (that is the point);
        the poller sweeps deadlines coarsely instead. Sync calls time out
        in their own wait and are skipped here."""
        with self._lock:
            socks = list(self._socks.values())
        for sock in socks:
            fast = sock._fast_calls
            if not fast:
                continue
            for fcid, rec in list(fast.items()):
                if rec.on_complete is None or not rec.deadline \
                        or now < rec.deadline:
                    continue
                if fast.pop(fcid, None) is not None:
                    rec.code = errors.ERPCTIMEDOUT
                    rec.text = "fast-call deadline exceeded"
                    rec.finish()

    def _dispatch(self, kind, tag, conn_id, aux, meta_b, body_b) -> None:
        if kind == EV_FRAME:
            sock = self.lookup(conn_id)
            if sock is None:
                with self._lock:
                    if conn_id not in self._socks:
                        self._orphans.setdefault(conn_id, []).append(
                            ("frame", tag, meta_b, body_b))
                        self._gc_orphans()
                        return
                    sock = self._socks[conn_id]
            self._process_frame(sock, tag, meta_b, body_b)
        elif kind == EV_ACCEPTED:
            peer = meta_b.decode("utf-8", "replace") if meta_b else "?:0"
            self._on_accepted(conn_id, int(aux), peer)
        elif kind == EV_FAILED:
            reason = meta_b.decode("utf-8", "replace") if meta_b else ""
            sock = self.lookup(conn_id)
            if sock is None:
                with self._lock:
                    if conn_id not in self._socks:
                        self._orphans.setdefault(conn_id, []).append(
                            ("failed", tag, reason, None))
                        self._gc_orphans()
                        return
                    sock = self._socks[conn_id]
            sock.set_failed(_DPE_TO_ERR.get(tag, errors.EFAILEDSOCKET),
                            f"native: {reason}")
        elif kind == EV_DETACHED:
            self._on_detached(conn_id, int(aux), meta_b)

    def _dispatch_replayed(self, sock: NativeSocket, ev_tuple) -> None:
        kind = ev_tuple[0]
        if kind == "frame":
            self._process_frame(sock, ev_tuple[1], ev_tuple[2], ev_tuple[3])
        elif kind == "failed":
            sock.set_failed(
                _DPE_TO_ERR.get(ev_tuple[1], errors.EFAILEDSOCKET),
                f"native: {ev_tuple[2]}")

    def _gc_orphans(self) -> None:
        # bounded: orphan stashes only exist in the dp_connect ->
        # register_socket window; cap hard against leaks
        if len(self._orphans) > 1024:
            self._orphans.clear()

    def _process_frame(self, sock: NativeSocket, tag: int, meta_b,
                       body_b: bytes, prebuilt_meta=None) -> None:
        from brpc_tpu_torch.rpc.input_messenger import _process_one
        from brpc_tpu_torch.rpc.protocol import ParsedMessage

        trpc, tstr = self._protocols()
        try:
            if prebuilt_meta is not None:
                meta = prebuilt_meta
                proto = trpc
            elif tag == 1:
                meta = rpc_meta_pb2.StreamFrameMeta.FromString(meta_b)
                proto = tstr
            else:
                meta = rpc_meta_pb2.RpcMeta.FromString(meta_b)
                proto = trpc
        except Exception:
            sock.set_failed(errors.EREQUEST, "bad meta from native engine")
            return
        msg = ParsedMessage(proto, meta, IOBuf(body_b))
        msg.socket = sock
        sock.in_messages += 1
        sock.in_bytes += (len(meta_b) if meta_b else 0) + len(body_b)
        sock.last_active = _time.monotonic()
        cid = proto.claim_cid(msg)
        if cid is not None:
            sock.remove_pending_id(cid)
            if sock._fast_calls:
                # big (>=64KB donated) or compressed responses to FAST calls
                # arrive as full frames — complete the fast record here
                rec = sock._fast_calls.pop(cid, None)
                if rec is not None:
                    m = msg.meta
                    rec.code = m.response.error_code
                    rec.text = m.response.error_text
                    body = msg.body.tobytes()
                    if m.compress_type:
                        from brpc_tpu_torch.policy import compress as _compress

                        try:
                            att = b""
                            if m.attachment_size:
                                att = body[len(body) - m.attachment_size:]
                                body = body[:len(body) - m.attachment_size]
                            body = _compress.decompress(body, m.compress_type)
                            body += att
                            rec.att_size = m.attachment_size
                        except Exception as e:
                            rec.code = errors.ERESPONSE
                            rec.text = f"decompress: {e}"
                    else:
                        rec.att_size = m.attachment_size
                    rec.body = body
                    rec.finish()
                    return
        server = sock.owner_server
        if proto.inline_process or cid is not None:
            # stream frames need poll order; RESPONSES are just deserialize +
            # call-id wakeup — completing inline here saves a fiber handoff
            # per RPC (the reference likewise processes the last message of
            # a burst inline, input_messenger.cpp:194)
            _process_one(msg, server)
        else:
            _runtime.start_background(_process_one, msg, server)

    def _on_accepted(self, conn_id: int, lid: int, peer: str) -> None:
        with self._lock:
            server = self._servers.get(lid)
        if server is None:
            self.close_conn(conn_id)
            return
        host, _, port = peer.rpartition(":")
        try:
            remote = EndPoint.from_ip_port(host or "?", int(port or 0))
        except Exception:
            remote = None
        sock = NativeSocket(self, conn_id, remote, is_server=True)
        sock.owner_server = server
        with self._lock:
            self._conn_lid[conn_id] = lid
            conns = self._server_conns.get(lid)
            if conns is not None:
                conns.add(conn_id)
        self.register_socket(conn_id, sock)

    def _on_detached(self, conn_id: int, fd: int, leftover: bytes) -> None:
        """Adopt a non-TRPC connection into the Python stack (http/grpc/...).

        The engine stopped polling the fd; wrap it in a regular Socket,
        seed the buffered bytes, and let InputMessenger route by protocol."""
        from brpc_tpu_torch.rpc.event_dispatcher import pick_dispatcher
        from brpc_tpu_torch.rpc.socket import Socket

        with self._lock:
            nat = self._socks.pop(conn_id, None)
            lid = self._conn_lid.pop(conn_id, None)
            if lid is not None:
                conns = self._server_conns.get(lid)
                if conns is not None:
                    conns.discard(conn_id)
            server = self._servers.get(lid) if lid is not None else None
        if server is None and nat is not None:
            server = nat.owner_server
        if server is None or not getattr(server, "is_running", False):
            # client-side conn whose peer speaks non-TRPC bytes: fail the
            # socket so pending calls error now instead of timing out
            if nat is not None:
                nat.set_failed(errors.ERESPONSE,
                               "peer sent non-TRPC bytes on native conn")
            try:
                _socket.socket(fileno=fd).close()
            except OSError:
                pass
            return
        try:
            pysock = _socket.socket(fileno=fd)
            pysock.setblocking(False)
        except OSError:
            return
        server.adopt_connection(pysock, initial_bytes=leftover,
                                dispatcher=pick_dispatcher())

    # -------------------------------------------------------------- teardown
    def shutdown(self) -> None:
        if not self._running:
            return
        self._running = False
        self._poller.join(timeout=2)
        self._lib.dp_rt_shutdown(self._rt)


# lazy hook into the server-side fast dispatch (import cycle: server
# machinery imports this module at load time)
_fp_fn = None


def _fast_process_request(item) -> None:
    global _fp_fn
    if _fp_fn is None:
        from brpc_tpu_torch.rpc.server_processing import fast_process_request

        _fp_fn = fast_process_request
    _fp_fn(item)


def on_flusher_thread() -> bool:
    """True on threads that end every batch with dp_flush_all (the poller
    and the fast dispatcher) — queued sends are safe there."""
    return getattr(_flusher_tls, "on", False)


_dataplane: Optional[NativeDataplane] = None
_dataplane_lock = threading.Lock()


def get_dataplane() -> NativeDataplane:
    """The process-wide engine, built and started on first use; raises
    ``native.NativeBuildError`` when the C++ core cannot be built."""
    global _dataplane
    with _dataplane_lock:
        if _dataplane is None:
            _dataplane = NativeDataplane()
        return _dataplane


def bench_echo_native(host: str, port: int, *, conns: int = 8, depth: int = 4,
                      payload: int = 16, duration_ms: int = 2000,
                      service: str = "EchoService", method: str = "Echo",
                      tpu: bool = False, grpc: bool = False):
    """Run the C++ pipelined echo bench client (the framework's native lane
    end to end — the analog of the reference's C++ bench binaries,
    example/multi_threaded_echo_c++/client.cpp). ``tpu=True`` dials the
    TPUC shm tunnel (the rdma_performance analog); ``grpc=True`` speaks
    grpc-over-h2 end to end in the engine. Returns a dict of
    qps/gbps/p50_us/p99_us/p999_us; raises when the engine cannot be
    built."""
    from brpc_tpu_torch import native

    lib = native.load_dataplane()
    mode = 2 if grpc else (1 if tpu else 0)
    outs = [ctypes.c_double() for _ in range(5)]
    rc = lib.dp_bench_echo2(host.encode(), port, mode, conns,
                            depth, payload, duration_ms, service.encode(),
                            method.encode(),
                            *[ctypes.byref(o) for o in outs])
    if rc != 0:
        raise RuntimeError(f"dp_bench_echo failed: rc={rc}")
    keys = ("qps", "gbps", "p50_us", "p99_us", "p999_us")
    return dict(zip(keys, (o.value for o in outs)))
