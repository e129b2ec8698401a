"""TpuSocket — the Socket contract over a CUDA card, in process.

The port of ``brpc_tpu/tpu/tpusocket.py``. Where a TCP Socket's wire is
the NIC, a TpuSocket's wire is the card: a ``tpu://host/n`` call (no
port) runs its method in this process on ``cuda:n``, and the response
wakes the RPC's call id exactly like a response arriving off the network.
The whole client state machine (call ids, attempt versions, timeouts,
retries) is reused unchanged.

Methods are registered as device methods; ``EchoService.Echo`` ships by
default: the payload goes host -> card, through the hand-written copy
kernel (``bench_kernels.hbm_copy``, ``csrc/copy.cu``), and card -> host,
synchronously. ``DeviceDataService``'s methods register themselves from
``tpu/device_lane.py``. A ``tpu://host:port/n`` target dials the
cross-process tunnel instead (``tpu/transport.py``).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from brpc_tpu_torch import fault as _fault
from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.butil.resource_pool import VersionedPool
from brpc_tpu_torch.fiber import call_id as _cid
from brpc_tpu_torch.fiber.execution_queue import ExecutionQueue
from brpc_tpu_torch.metrics.reducer import Adder
from brpc_tpu_torch.proto import rpc_meta_pb2
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.protocol import ParsedMessage

# device-side traffic counters (the /vars view of the "ICI NIC")
g_tpu_in_bytes = Adder("g_tpu_in_bytes")
g_tpu_out_bytes = Adder("g_tpu_out_bytes")

_fault.register("tpu.device.crash",
                "raise inside a registered device method (loopback path); "
                "the caller sees EINTERNAL, the socket survives")


class DeviceMethodRegistry:
    """Methods addressable on a device: 'Service.Method' -> handler.

    handler(device, meta, payload: bytes, attachment: bytes)
        -> (error_code, response_payload: bytes, attachment_out: bytes)
    """

    def __init__(self):
        self._methods: Dict[str, Callable] = {}
        self._lock = threading.Lock()

    def register(self, service: str, method: str, handler: Callable) -> None:
        with self._lock:
            self._methods[f"{service}.{method}"] = handler

    def find(self, service: str, method: str) -> Optional[Callable]:
        with self._lock:
            return self._methods.get(f"{service}.{method}")


_registry = DeviceMethodRegistry()


def register_device_method(service: str, method: str, handler: Callable) -> None:
    _registry.register(service, method, handler)


# --------------------------------------------------------------------------
# default device programs
# --------------------------------------------------------------------------
def _device_echo(device, meta, payload: bytes, attachment: bytes):
    """EchoService.Echo on a card: payload + attachment go host -> card,
    through one copy kernel launch, and back.

    Synchronous, as the JAX package's echo is: the response is on the
    host when the method returns, so nothing on the card outlives the
    call. The bytes are staged through pageable host memory. Bulk
    callers belong on the device-resident lane (tpu/device_lane.py),
    whose copies never come back to the host."""
    import torch

    from brpc_tpu_torch.proto import echo_pb2
    from brpc_tpu_torch.tpu import bench_kernels

    req = echo_pb2.EchoRequest()
    req.ParseFromString(payload)
    blob = req.payload + attachment
    if not blob:
        resp = echo_pb2.EchoResponse(message=req.message)
        return errors.OK, resp.SerializeToString(), b""
    host = torch.from_numpy(np.frombuffer(blob, dtype=np.uint8).copy())
    if device.type == "cuda":
        with torch.cuda.device(device):
            back = bench_kernels.hbm_copy(host.to(device)).cpu()
    else:
        back = bench_kernels.hbm_copy(host)
    blob_out = back.numpy().tobytes()
    payload_out = blob_out[: len(req.payload)]
    att_out = blob_out[len(req.payload):]
    resp = echo_pb2.EchoResponse(message=req.message, payload=payload_out)
    return errors.OK, resp.SerializeToString(), att_out


_registry.register("EchoService", "Echo", _device_echo)


# --------------------------------------------------------------------------
# the socket
# --------------------------------------------------------------------------
class TpuSocket:
    """Implements the subset of the Socket contract the client stack uses:
    write(packet, id_wait), pending-id bookkeeping, set_failed, stats."""

    def __init__(self, remote: EndPoint):
        from brpc_tpu_torch.tpu.mesh import resolve_device

        self.remote = remote
        self.device = resolve_device(remote)
        self.failed = False
        self.error_code = 0
        self.error_text = ""
        self.in_bytes = 0
        self.out_bytes = 0
        self.in_messages = 0
        self.out_messages = 0
        self._pending_ids = set()
        self._pending_lock = threading.Lock()
        # ordered executor = the device's submission queue (one method
        # at a time per socket)
        self._queue = ExecutionQueue(self._run_batch)
        self.socket_id = _tpu_socket_pool.insert(self)

    # ---------------------------------------------------- socket contract
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

    def write(self, data, id_wait: Optional[int] = None) -> int:
        if self.failed:
            if id_wait is not None:
                _cid.id_error(id_wait, errors.EFAILEDSOCKET)
            return errors.EFAILEDSOCKET
        packet = data if isinstance(data, IOBuf) else IOBuf(bytes(data))
        n = len(packet)
        self.out_bytes += n
        g_tpu_out_bytes.put(n)
        if id_wait is not None:
            self.add_pending_id(id_wait)
        self._queue.execute(packet)
        return 0

    def set_failed(self, code: int, reason: str = "") -> None:
        if code == errors.OK:
            code = errors.EFAILEDSOCKET  # never fail "successfully"
        if self.failed:
            return
        self.failed = True
        self.error_code = code
        self.error_text = reason
        _tpu_socket_pool.remove(self.socket_id)
        with _sockets_lock:
            _sockets.pop((self.remote.host, self.remote.device_ordinal), None)
        with self._pending_lock:
            pending = list(self._pending_ids)
            self._pending_ids.clear()
        from brpc_tpu_torch.tpu.transport import _retriable

        fan = _retriable(code)
        for cid in pending:
            _cid.id_error(cid, fan)

    def close(self) -> None:
        self.set_failed(errors.EFAILEDSOCKET, "closed locally")

    # ------------------------------------------------------- the datapath
    def _run_batch(self, batch) -> None:
        if batch is None:
            return
        for packet in batch:
            self._run_one(packet)

    def _run_one(self, packet: IOBuf) -> None:
        from brpc_tpu_torch.policy.trpc_std import TrpcStdProtocol
        from brpc_tpu_torch.rpc.controller import handle_response_message
        from brpc_tpu_torch.rpc.protocol import find_protocol

        proto = find_protocol("trpc_std") or TrpcStdProtocol()
        rc, msg = proto.parse(packet)
        if msg is None:
            return
        self.in_messages += 1
        meta = msg.meta
        handler = _registry.find(meta.request.service_name,
                                 meta.request.method_name)
        payload, attachment = TrpcStdProtocol.split_attachment(msg)
        err_text = ""
        if handler is None:
            code, resp_payload, att_out = errors.ENOMETHOD, b"", b""
            err_text = (f"no device method {meta.request.service_name}."
                        f"{meta.request.method_name}")
        else:
            try:
                if _fault.hit("tpu.device.crash") is not None:
                    raise RuntimeError("fault injected device crash")
                code, resp_payload, att_out = handler(
                    self.device, meta, payload, attachment)
            except Exception as e:
                code, resp_payload, att_out = errors.EINTERNAL, b"", b""
                err_text = f"device method raised: {e}"
        # build the response exactly as a remote peer would
        rmeta = rpc_meta_pb2.RpcMeta()
        rmeta.response.error_code = code
        if code != errors.OK:
            rmeta.response.error_text = err_text
        rmeta.correlation_id = meta.correlation_id
        rmeta.attempt_version = meta.attempt_version
        rmeta.attachment_size = len(att_out)
        body = IOBuf()
        if resp_payload:
            body.append(resp_payload)
        if att_out:
            body.append(att_out)
        n = len(body)
        self.in_bytes += n
        g_tpu_in_bytes.put(n)
        resp_msg = ParsedMessage(msg.protocol, rmeta, body)
        resp_msg.socket = self
        handle_response_message(resp_msg)


_tpu_socket_pool: VersionedPool = VersionedPool()
_sockets: Dict[Tuple[str, int], TpuSocket] = {}
_sockets_lock = threading.Lock()


def get_tpu_socket(ep: EndPoint, connect_timeout: float = 3.0):
    """Shared per-device socket (the SocketMap of the device world).

    Routing: ``tpu://host:port/ordinal`` (port set) is a REMOTE device — a
    peer process serving that chip; dial the cross-process tunnel
    (tpu/transport.py). ``tpu://host/ordinal`` (no port) is a local chip of
    this process; calls run as device programs in-process (the loopback
    fast path, like the reference short-circuiting 127.0.0.1).

    ``connect_timeout`` bounds a remote (re)dial — callers with a per-call
    deadline pass the smaller of the two budgets so a dead tunnel fails
    the call instead of outliving it."""
    if ep.port:
        from brpc_tpu_torch.tpu.transport import connect_tpu

        return connect_tpu(ep, connect_timeout=connect_timeout)
    key = (ep.host, ep.device_ordinal)
    with _sockets_lock:
        sock = _sockets.get(key)
        if sock is None or sock.failed:
            sock = TpuSocket(ep)
            _sockets[key] = sock
        return sock
