"""Device-resident payloads held by handle, on torch tensors.

The port of ``brpc_tpu/tpu/device_lane.py``: the serving plane's weights
and KV pools live on the card and are named by small integer handles, so
the host orchestrates and never holds a copy.

- :class:`DispatchCounter` / ``step_dispatch``: the fused-launch and
  host-sync ledger the engine audits per decode step.
- :class:`DeviceStore`: handle -> tensor registry for one device.
- :func:`resolve_device`: the one place that picks the device. ``None``
  means the card; without one it raises, it never carries on on the CPU.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch


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
    the per-step delta under an armed ledger."""

    def __init__(self):
        self._lock = threading.Lock()
        self.launches = 0
        self.ops = 0
        self.host_syncs = 0

    def note_launch(self, n_ops: int = 1) -> None:
        with self._lock:
            self.launches += 1
            self.ops += n_ops

    def note_host_sync(self) -> None:
        with self._lock:
            self.host_syncs += 1

    def snapshot(self) -> Tuple[int, int, int]:
        with self._lock:
            return self.launches, self.ops, self.host_syncs

    @staticmethod
    def delta(before: Tuple[int, int, int],
              after: Tuple[int, int, int]) -> Tuple[int, int, int]:
        return tuple(a - b for a, b in zip(after, before))


# process-wide counter the serving step loop reports into
step_dispatch = DispatchCounter()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class DeviceStore:
    """handle -> device tensor registry for one device."""

    def __init__(self, device=None):
        self._device = resolve_device(device)
        self._lock = threading.Lock()
        self._next = 1
        self._arrays: Dict[int, torch.Tensor] = {}
        self._resident_bytes = 0

    @property
    def device(self) -> torch.device:
        return self._device

    def put(self, data: bytes) -> Tuple[int, int]:
        """Stage bytes onto the device (the one host->device crossing);
        returns (handle, nbytes)."""
        host = torch.from_numpy(np.frombuffer(data, dtype=np.uint8).copy())
        arr = host.to(self._device)
        with self._lock:
            h = self._next
            self._next += 1
            self._arrays[h] = arr
            self._resident_bytes += len(data)
        return h, len(data)

    def get(self, handle: int) -> Optional[bytes]:
        with self._lock:
            arr = self._arrays.get(handle)
        if arr is None:
            return None
        return arr.detach().cpu().contiguous().view(torch.uint8) \
            .numpy().tobytes()

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
        with self._lock:
            h = self._next
            self._next += 1
            self._arrays[h] = arr
            self._resident_bytes += n
        return h, n

    def replace(self, handle: int, arr: torch.Tensor) -> bool:
        """Swap the tensor behind a live handle; the handle stays the
        stable name across steps."""
        with self._lock:
            old = self._arrays.get(handle)
            if old is None:
                return False
            self._arrays[handle] = arr
            self._resident_bytes += _nbytes(arr) - _nbytes(old)
        return True

    def free(self, handle: int) -> bool:
        with self._lock:
            arr = self._arrays.pop(handle, None)
            if arr is not None:
                self._resident_bytes -= _nbytes(arr)
        return arr is not None

    def fence(self) -> None:
        """Block until every launch queued on the device has retired."""
        if self._device.type != "cuda":
            return
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self._device))
        ev.synchronize()

    def stats(self) -> Tuple[int, int, int]:
        """(handles, resident bytes, moved bytes). Nothing moves on the
        device until the copy kernel is ported, so moved stays 0."""
        with self._lock:
            return len(self._arrays), self._resident_bytes, 0


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
