"""Device-resident payloads held by handle, on torch tensors.

The port of ``brpc_tpu/tpu/device_lane.py``: the serving plane's weights
and KV pools, and RPC payloads, live on the card and are named by small
integer handles, so the host orchestrates and never holds a copy; data
moves on the device.

- :class:`DispatchCounter` / ``step_dispatch``: the fused-launch and
  host-sync ledger the engine audits per decode step.
- :class:`DeviceStore`: handle -> tensor registry for one device, with
  the data plane's on-device ops: ``copy`` (one copy, or a transient one
  queued for the dispatcher thread), ``copy_coalesced`` (k transient
  copies queued in one call), ``pump`` (the echo loop with a dependent
  checksum), ``fence`` and ``stats``. Every copy is the hand-written
  kernel of ``csrc/copy.cu`` (:mod:`brpc_tpu_torch.tpu.bench_kernels`).
- :class:`DeviceDataService`: a ``Service`` of the port's RPC server
  (any transport: TCP, the ``tpu://`` tunnel) with Put / Copy / Pump /
  Get / Free / Stats over a store, speaking the messages of
  ``proto/device_lane.proto`` (tables of the port's message runtime; no
  protobuf). The same methods are registered as device methods of the
  in-process ``tpu://host/n`` lane (tpu/tpusocket.py), whose calls go
  through :func:`_tpusock_call` into the same service.
- The ``g_device_*`` Adders: bytes resident and moved, fused launches and
  ops, host syncs, across every store of the process.
- :func:`resolve_device`: the one place that picks the device. ``None``
  means the card; without one it raises, it never carries on on the CPU.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from brpc_tpu_torch import errors
from brpc_tpu_torch.metrics.reducer import Adder
from brpc_tpu_torch.proto import device_lane_pb2
from brpc_tpu_torch.rpc.server import Service
from brpc_tpu_torch.tpu import bench_kernels

g_device_resident_bytes = Adder("g_device_resident_bytes")
g_device_moved_bytes = Adder("g_device_moved_bytes")
g_device_fused_launches = Adder("g_device_fused_launches")
g_device_fused_ops = Adder("g_device_fused_ops")
g_device_host_syncs = Adder("g_device_host_syncs")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for the CPU. Raises when the card is wanted and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class DispatchCounter:
    """Fused-launch / host-sync ledger for step-level dispatch coalescing.

    The engine's contract is that one decode step costs ONE logical
    launch plus ONE host materialization, whatever the batch size. The
    model notes every launch and host sync here and the engine asserts
    the per-step delta under an armed ledger; the store's copies note
    theirs too, so the data plane's op rate is read from the same
    numbers."""

    def __init__(self):
        self._lock = threading.Lock()
        self.launches = 0
        self.ops = 0
        self.host_syncs = 0

    def note_launch(self, n_ops: int = 1) -> None:
        with self._lock:
            self.launches += 1
            self.ops += n_ops
        g_device_fused_launches.put(1)
        g_device_fused_ops.put(n_ops)

    def note_host_sync(self) -> None:
        with self._lock:
            self.host_syncs += 1
        g_device_host_syncs.put(1)

    def snapshot(self) -> Tuple[int, int, int]:
        with self._lock:
            return self.launches, self.ops, self.host_syncs

    @staticmethod
    def delta(before: Tuple[int, int, int],
              after: Tuple[int, int, int]) -> Tuple[int, int, int]:
        return tuple(a - b for a, b in zip(after, before))


# process-wide counter the serving step loop reports into
step_dispatch = DispatchCounter()

_MAX_COALESCED = 4096   # copy_coalesced's count clamp
_MAX_PUMP_ROUNDS = 100000
_PUMP_LANES = 2048      # pump views its payload as int32 [rows, 2048]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class DeviceStore:
    """handle -> device tensor registry for one device.

    Every launch the store makes (put, copy, pump, the dispatcher's
    batches) goes on one stream, the device's default stream, so a tensor
    freed after its copy was queued is reused by the caching allocator
    only after that copy has run."""

    def __init__(self, device=None):
        self._device = resolve_device(device)
        self._stream = (torch.cuda.default_stream(self._device)
                        if self._device.type == "cuda" else None)
        self._lock = threading.Lock()
        self._next = 1
        self._arrays: Dict[int, torch.Tensor] = {}
        # transient copy outputs: held long enough to be fence-able, then
        # dropped, so sustained traffic does not grow residency
        self._transient = collections.deque(maxlen=bench_kernels.MAX_BATCH)
        # transient copies queue here; a dispatcher thread issues them
        # as batched launches
        self._dq = collections.deque()
        self._dq_cv = threading.Condition()
        self._dq_thread: Optional[threading.Thread] = None
        self._dq_busy = False
        # the last failed batch's error, raised by the next fence()
        self._dq_error: Optional[Exception] = None
        self._resident_bytes = 0
        self._moved_bytes = 0

    @property
    def device(self) -> torch.device:
        return self._device

    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _register(self, arr: torch.Tensor, n: int, moved: int = 0) -> int:
        with self._lock:
            h = self._next
            self._next += 1
            self._arrays[h] = arr
            self._resident_bytes += n
            self._moved_bytes += moved
        g_device_resident_bytes.put(n)
        if moved:
            g_device_moved_bytes.put(moved)
        return h

    def _add_moved(self, n: int) -> None:
        with self._lock:
            self._moved_bytes += n
        g_device_moved_bytes.put(n)

    # ------------------------------------------------------------ data plane
    def put(self, data: bytes) -> Tuple[int, int]:
        """Stage bytes onto the device (the one host->device crossing);
        returns (handle, nbytes)."""
        host = torch.from_numpy(np.frombuffer(data, dtype=np.uint8).copy())
        with self._on_stream():
            arr = host.to(self._device)
        return self._register(arr, len(data)), len(data)

    def copy(self, handle: int,
             transient: bool = False) -> Optional[Tuple[int, int]]:
        """On-device copy through the copy kernel (queued, not waited
        for): the data-plane op RPCs orchestrate. Returns (new handle,
        nbytes). ``transient=True`` queues the copy for the dispatcher
        thread and keeps its output only in a bounded ring: returns (0,
        nbytes)."""
        arr = self.lookup(handle)
        if arr is None:
            return None
        n = _nbytes(arr)
        if transient:
            self._enqueue([arr])
            self._add_moved(2 * n)
            return 0, n
        with self._on_stream():
            out = bench_kernels.hbm_copy(arr.reshape(-1)).view(arr.shape)
        step_dispatch.note_launch(1)
        # read + write through device memory
        return self._register(out, n, moved=2 * n), n

    def copy_coalesced(self, handle: int,
                       count: int) -> Optional[Tuple[int, int]]:
        """Queue ``count`` (clamped to [1, 4096]) transient copies of one
        handle in ONE call: the dispatcher thread runs them as batched
        launches of up to 32 copies each. Returns (0, bytes queued)."""
        arr = self.lookup(handle)
        if arr is None:
            return None
        count = max(1, min(int(count), _MAX_COALESCED))
        n = _nbytes(arr)
        self._enqueue([arr] * count)
        self._add_moved(2 * n * count)
        return 0, n * count

    def pump(self, handle: int, rounds: int) -> Optional[Tuple[int, int]]:
        """``rounds`` (clamped to [1, 100000]) echo round trips over the
        payload's first whole rows, viewed as int32 [rows, 2048], through
        ``echo_loop_probe``; the checksum is read back to the host, the one
        sync, and depends on the last copy. Returns (checksum,
        moved_bytes), or None for an unknown handle or a payload shorter
        than one row (8192 bytes)."""
        arr = self.lookup(handle)
        if arr is None:
            return None
        rounds = max(1, min(int(rounds), _MAX_PUMP_ROUNDS))
        n = _nbytes(arr)
        rows = max(1, n // 4 // _PUMP_LANES)
        use = rows * _PUMP_LANES * 4
        if use > n:
            return None
        x2d = arr.reshape(-1).view(torch.uint8)[:use].view(torch.int32) \
            .view(rows, _PUMP_LANES)
        with self._on_stream():
            checksum = int(bench_kernels.echo_loop_probe(x2d, rounds))
        moved = 4 * rounds * use  # 2 copies x (read + write) per round
        self._add_moved(moved)
        return checksum, moved

    def get(self, handle: int) -> Optional[bytes]:
        arr = self.lookup(handle)
        if arr is None:
            return None
        with self._on_stream():
            host = arr.detach().cpu()
        return host.contiguous().view(torch.uint8).numpy().tobytes()

    def lookup(self, handle: int) -> Optional[torch.Tensor]:
        """The device tensor behind a handle (no host copy)."""
        with self._lock:
            return self._arrays.get(handle)

    def adopt(self, arr: torch.Tensor) -> Tuple[int, int]:
        """Register an already-resident tensor under a fresh handle (no
        host crossing): the KV pools park here."""
        if arr.device != self._device:
            raise ValueError(f"tensor on {arr.device}, store on "
                             f"{self._device}")
        n = _nbytes(arr)
        return self._register(arr, n), n

    def replace(self, handle: int, arr: torch.Tensor) -> bool:
        """Swap the tensor behind a live handle; the handle stays the
        stable name across steps."""
        with self._lock:
            old = self._arrays.get(handle)
            if old is None:
                return False
            self._arrays[handle] = arr
            delta = _nbytes(arr) - _nbytes(old)
            self._resident_bytes += delta
        if delta:
            g_device_resident_bytes.put(delta)
        return True

    def free(self, handle: int) -> bool:
        with self._lock:
            arr = self._arrays.pop(handle, None)
            if arr is not None:
                self._resident_bytes -= _nbytes(arr)
        if arr is None:
            return False
        g_device_resident_bytes.put(-_nbytes(arr))
        return True

    # ------------------------------------------------- transient dispatcher
    def _enqueue(self, arrs) -> None:
        with self._dq_cv:
            if self._dq_thread is None:
                self._dq_thread = threading.Thread(
                    target=self._dispatch_loop, daemon=True,
                    name="brpc-device-dispatch")
                self._dq_thread.start()
            self._dq.extend(arrs)
            self._dq_cv.notify()

    def _dispatch_loop(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        while True:
            with self._dq_cv:
                while not self._dq:
                    self._dq_busy = False
                    self._dq_cv.notify_all()  # fence waiters
                    self._dq_cv.wait()
                self._dq_busy = True
                batch = list(self._dq)
                self._dq.clear()
            try:
                self._dispatch(batch)
            except Exception as exc:
                # the thread must survive (a dead dispatcher with
                # _dq_busy=True wedges every fence() forever); the dropped
                # batch loses its transient outputs, its launches go
                # uncounted, and the next fence() raises its error
                logging.getLogger("brpc_tpu_torch").exception(
                    "device dispatch batch failed (dropped)")
                with self._dq_cv:
                    self._dq_error = exc

    def _dispatch(self, batch) -> None:
        """Group the queued tensors by (shape, dtype) and copy each group
        in chunks of the largest power of two <= min(left, 32), one launch
        per chunk."""
        groups: Dict[tuple, list] = {}
        for a in batch:
            groups.setdefault((tuple(a.shape), a.dtype), []).append(a)
        with self._on_stream():
            for arrs in groups.values():
                i = 0
                while i < len(arrs):
                    left = min(len(arrs) - i, bench_kernels.MAX_BATCH)
                    k = 1 << (left.bit_length() - 1)
                    outs = bench_kernels.hbm_copy_batched(arrs[i:i + k])
                    step_dispatch.note_launch(k)
                    self._transient.extend(outs)
                    i += k

    def fence(self) -> None:
        """Block until the dispatcher has issued every queued copy and
        every launch on the device has retired. Raises if a batch queued
        since the last fence failed and was dropped."""
        with self._dq_cv:
            while self._dq or self._dq_busy:
                self._dq_cv.wait(0.01)
            error, self._dq_error = self._dq_error, None
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        if error is not None:
            raise RuntimeError("a queued device copy batch failed and was "
                               "dropped") from error

    def stats(self) -> Tuple[int, int, int]:
        """(handles, resident bytes, bytes moved through device memory)."""
        with self._lock:
            return (len(self._arrays), self._resident_bytes,
                    self._moved_bytes)


_stores: Dict[torch.device, DeviceStore] = {}
_store_lock = threading.Lock()


def global_store(device=None) -> DeviceStore:
    """The process-wide store of ``device`` (the card by default)."""
    dev = resolve_device(device)
    with _store_lock:
        store = _stores.get(dev)
        if store is None:
            store = _stores[dev] = DeviceStore(dev)
        return store


class DeviceDataService(Service):
    """Device-resident payload service over the port's RPC stack (full
    policy path; any transport): payload bytes ride attachments exactly
    once (Put / Get); Copy and Pump move data on the device."""

    DESCRIPTOR = device_lane_pb2.DESCRIPTOR.services_by_name[
        "DeviceDataService"]

    def __init__(self, store: Optional[DeviceStore] = None):
        super().__init__()
        self.store = store if store is not None else global_store()

    def Put(self, cntl, request, done):
        handle, n = self.store.put(cntl.request_attachment)
        return device_lane_pb2.DeviceHandle(handle=handle, nbytes=n)

    def Copy(self, cntl, request, done):
        # request.nbytes == -1: one transient copy (bounded ring, handle
        # 0); request.nbytes == -k (k > 1): k transient copies in ONE RPC
        if request.nbytes < -1:
            out = self.store.copy_coalesced(request.handle, -request.nbytes)
        else:
            out = self.store.copy(request.handle,
                                  transient=request.nbytes == -1)
        if out is None:
            cntl.set_failed(errors.ENOMETHOD,
                            f"no device handle {request.handle}")
            return device_lane_pb2.DeviceHandle()
        h, n = out
        return device_lane_pb2.DeviceHandle(handle=h, nbytes=n)

    def Pump(self, cntl, request, done):
        out = self.store.pump(request.handle, request.rounds)
        if out is None:
            cntl.set_failed(errors.ENOMETHOD,
                            f"no pumpable device handle {request.handle}")
            return device_lane_pb2.PumpResult()
        checksum, moved = out
        return device_lane_pb2.PumpResult(checksum=checksum, moved_bytes=moved)

    def Get(self, cntl, request, done):
        data = self.store.get(request.handle)
        if data is None:
            cntl.set_failed(errors.ENOMETHOD,
                            f"no device handle {request.handle}")
            return device_lane_pb2.DeviceHandle()
        cntl.response_attachment = data
        return device_lane_pb2.DeviceHandle(handle=request.handle, nbytes=len(data))

    def Free(self, cntl, request, done):
        ok = self.store.free(request.handle)
        return device_lane_pb2.DeviceHandle(handle=request.handle if ok else 0)

    def Stats(self, cntl, request, done):
        if request.fence:
            self.store.fence()
        count, resident, moved = self.store.stats()
        return device_lane_pb2.DeviceStats(handles=count, resident_bytes=resident,
                                    moved_bytes=moved)


class _InProcessCntl:
    """The controller surface the service methods use."""

    def __init__(self, attachment: bytes):
        self.request_attachment = attachment
        self.response_attachment = b""
        self.error = None

    def set_failed(self, code: int, text: str = "") -> None:
        self.error = (code, text)


# one service per device (its method table is built once, not per call)
_tpusock_svcs: Dict[torch.device, DeviceDataService] = {}


def _tpusock_call(device, meta, payload: bytes, attachment: bytes,
                  method: str):
    """One in-process call of ``method`` on ``global_store(device)``'s
    service: ``payload`` is the serialized request. Returns (error code,
    serialized response, response attachment); a failed call returns
    (code, b"", b"")."""
    store = global_store(device)
    with _store_lock:
        svc = _tpusock_svcs.get(store.device)
        if svc is None or svc.store is not store:
            svc = _tpusock_svcs[store.device] = DeviceDataService(store)
    entry = svc.find_method(method)
    req = entry.request_class()
    req.ParseFromString(payload)
    cntl = _InProcessCntl(attachment)
    resp = entry.fn(cntl, req, None)
    if cntl.error is not None:
        return cntl.error[0], b"", b""
    return 0, resp.SerializeToString(), cntl.response_attachment


def _register_tpusocket_methods() -> None:
    from brpc_tpu_torch.tpu.tpusocket import register_device_method

    for m in ("Put", "Copy", "Pump", "Get", "Free", "Stats"):
        register_device_method(
            "DeviceDataService", m,
            lambda device, meta, p, a, _m=m: _tpusock_call(device, meta,
                                                           p, a, _m))


_register_tpusocket_methods()
