"""device_stream — streaming RPC wired to the device lane.

The port of ``brpc_tpu/tpu/device_stream.py``: a stream whose payload
lives on the card. After the FIRST hop (host bytes -> device memory via
``DeviceStore.put``, or data born on the device), the stream's DATA
frames carry 16-byte HANDLE RECORDS, not payload — the bytes never
transit Python again. The credit window counts the device bytes the
records name (``StreamOptions.measure``), so ``window_bytes`` bounds
DEVICE-POOL OCCUPANCY: a producer stalls exactly when the consumer's card
holds `window` bytes of unconsumed blocks.

Reference counterpart: stream.cpp:318 AppendIfNotFull /
SetRemoteConsumed:354 / SendFeedback:631 — the same cumulative-consumed
credit protocol, with device occupancy as the unit.

Usage (consumer side owns the card):

    svc = DeviceStreamEchoService(store)     # accept + consume on-device
    server.add_service(svc)

    # producer side
    sid = open_device_stream(server_addr, window_bytes=64 << 20)
    h, n = store.put(chunk)                  # the one host->device crossing
    send_handle(sid, h, n)                   # 16B record; credits = n

The bundled consumer "echoes" each block through an on-device copy
(``DeviceStore.copy(transient=True)``: the dispatcher's batched copy
kernel, ``csrc/copy.cu``) and frees it, then credits flow back. Across
processes the producer stages its blocks in the consumer's store through
``DeviceDataService.Put`` and streams the handles it returned.
"""

from __future__ import annotations

import struct
import threading
from typing import Callable, List, Optional

from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc.server import Service
from brpc_tpu_torch.rpc.stream import (StreamOptions, get_stream,
                                       stream_accept, stream_create,
                                       stream_write)

RECORD = struct.Struct("<QQ")  # (handle, device nbytes)

ECHO_DESC = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]


def record_measure(data: bytes) -> int:
    """Credit weight of one frame: the device bytes its records name."""
    total = 0
    for off in range(0, len(data) - RECORD.size + 1, RECORD.size):
        total += RECORD.unpack_from(data, off)[1]
    return total


def pack_record(handle: int, nbytes: int) -> bytes:
    return RECORD.pack(handle, nbytes)


def send_handle(stream_id: int, handle: int, nbytes: int,
                timeout: Optional[float] = None) -> int:
    """Stream one device block by reference. Blocks while the receiver
    holds `window` bytes of unconsumed device blocks (credit flow)."""
    return stream_write(stream_id, pack_record(handle, nbytes),
                        timeout=timeout)


def device_stream_options(consume: Callable[[int, int], None],
                          window_bytes: int,
                          on_closed=None) -> StreamOptions:
    """Receiver-side options: each record is consumed on-device via
    ``consume(handle, nbytes)``; credits return as consumption happens
    (feedback pacing is the stream's own half-window rule)."""

    def on_received(sid: int, msgs: List[bytes]) -> None:
        for m in msgs:
            for off in range(0, len(m) - RECORD.size + 1, RECORD.size):
                h, n = RECORD.unpack_from(m, off)
                consume(h, n)
        # consumption is the expensive part here (an on-device op per
        # record), so per-batch feedback is noise — and exact credits
        # let the producer treat credit equality as completion
        st = get_stream(sid)
        if st is not None:
            st.flush_feedback()

    return StreamOptions(on_received=on_received, on_closed=on_closed,
                         window_bytes=window_bytes,
                         measure=record_measure)


class DeviceStreamEchoService(Service):
    """Accepts device streams on Echo (message == "device-stream"): each
    incoming block is consumed ON-DEVICE (a transient copy, device memory
    to device memory, never back through Python) and freed; credits flow
    back through the stream's feedback. The host orchestrates; the data
    plane is the card.
    """

    DESCRIPTOR = ECHO_DESC

    def __init__(self, store=None, free_after: bool = True):
        super().__init__()
        if store is None:
            from brpc_tpu_torch.tpu.device_lane import global_store

            store = global_store()
        self.store = store
        # benches stream the SAME resident block repeatedly: keep it
        self.free_after = free_after
        self.consumed_blocks = 0
        self.consumed_bytes = 0
        self.errors = 0
        self._lock = threading.Lock()

    def _consume(self, handle: int, nbytes: int) -> None:
        ok = self.store.copy(handle, transient=True) is not None
        if self.free_after:
            self.store.free(handle)
        with self._lock:
            if not ok:
                self.errors += 1
            else:
                self.consumed_blocks += 1
                self.consumed_bytes += nbytes

    def Echo(self, cntl, request, done):
        window = int(request.message.partition(":")[2] or 0) or (64 << 20)
        stream_accept(cntl, device_stream_options(self._consume, window))
        return echo_pb2.EchoResponse(message="device-stream-accepted")


def open_device_stream(server_addr: str, window_bytes: int = 64 << 20,
                       channel_options=None):
    """Producer side: open a device stream to a DeviceStreamEchoService.
    Returns the stream id (use send_handle / stream_close)."""
    from brpc_tpu_torch.rpc import Channel, Controller, Stub

    from brpc_tpu_torch.rpc.stream import stream_close

    opts = StreamOptions(window_bytes=window_bytes, measure=record_measure)
    sid = stream_create(opts)
    try:
        cntl = Controller()
        cntl.stream_id = sid
        ch = Channel(channel_options) if channel_options else Channel()
        ch.init(server_addr)
        stub = Stub(ch, ECHO_DESC)
        resp = stub.Echo(
            echo_pb2.EchoRequest(message=f"device-stream:{window_bytes}"),
            controller=cntl)
        if resp.message != "device-stream-accepted":
            raise RuntimeError(f"stream open rejected: {resp.message!r}")
    except BaseException:
        stream_close(sid)  # a failed open must not leak the pool entry
        raise
    return sid
