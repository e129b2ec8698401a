"""The port's device streams (brpc_tpu_torch.tpu.device_stream) through
the reference's ``tests/test_device_stream.py`` cases: handle records
ride the stream, the payload stays in the store (the port's CPU store
here, ``DeviceStore("cpu")``), the credit window bounds the device
bytes the consumer holds, and consumption is an on-device copy.

Then the record format and the JAX package's: a port producer streams to
a JAX consumer and a JAX producer to a port consumer over TCP, and a
port producer to a port consumer over the ``tpu://`` tunnel.
"""

import threading
import time

import numpy as np
import pytest

from brpc_tpu_torch.rpc import Server
from brpc_tpu_torch.rpc.stream import get_stream, stream_close
from brpc_tpu_torch.tpu.device_lane import DeviceStore
from brpc_tpu_torch.tpu.device_stream import (DeviceStreamEchoService,
                                        open_device_stream, pack_record,
                                        record_measure, send_handle)


@pytest.fixture(autouse=True)
def _close_new_tunnels():
    """Close the client tunnels a test dialed, in both packages, when it
    ends: a stale cached tunnel would otherwise outlive its server in
    this process and be found by a later test's cache lookup."""
    from brpc_tpu.tpu import transport as jax_tr
    from brpc_tpu_torch.tpu import transport as port_tr

    before = {tr: set(tr._remote_sockets) for tr in (jax_tr, port_tr)}
    yield
    for tr, keys in before.items():
        with tr._remote_lock:
            new = [(k, vs) for k, vs in tr._remote_sockets.items()
                   if k not in keys]
            for k, _ in new:
                del tr._remote_sockets[k]
        for _, vs in new:
            vs.endpoint.close()


@pytest.fixture()
def device_stream_server():
    store = DeviceStore("cpu")
    impl = DeviceStreamEchoService(store)
    server = Server().add_service(impl).start("127.0.0.1:0")
    yield server, impl, store
    server.stop()
    server.join(timeout=2)


class TestDeviceStream:
    def test_records_measure_hbm_bytes(self):
        rec = pack_record(7, 1 << 20) + pack_record(9, 4096)
        assert record_measure(rec) == (1 << 20) + 4096

    def test_blocks_flow_and_are_consumed_on_device(self,
                                                    device_stream_server):
        server, impl, store = device_stream_server
        sid = open_device_stream(str(server.listen_endpoint()),
                                 window_bytes=1 << 20)
        try:
            total = 0
            for i in range(8):
                data = bytes([i]) * 4096
                h, n = store.put(data)
                assert send_handle(sid, h, n) == 0
                total += n
            deadline = time.monotonic() + 5
            while impl.consumed_blocks < 8 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert impl.consumed_blocks == 8
            assert impl.consumed_bytes == total
            assert impl.errors == 0
            # consumed blocks were freed: residency returns to zero
            store.fence()
            count, resident, moved = store.stats()
            assert count == 0, (count, resident)
            # and the consume MOVED the bytes on-device (transient copy)
            assert moved >= total
        finally:
            stream_close(sid)

    def test_window_bounds_hbm_occupancy(self, device_stream_server):
        """The writer must stall when the receiver holds `window` bytes
        of unconsumed blocks — the §5.7 credit semantics with HBM
        occupancy as the unit."""
        server, impl, store = device_stream_server
        block = 256 * 1024
        window = 2 * block  # at most 2 unconsumed blocks in flight
        # gate consumption so blocks pile up at the receiver
        gate = threading.Event()
        orig_consume = impl._consume

        def gated_consume(h, n):
            gate.wait(10)
            orig_consume(h, n)

        impl._consume = gated_consume
        sid = open_device_stream(str(server.listen_endpoint()),
                                 window_bytes=window)
        try:
            sent = []

            def producer():
                for i in range(5):
                    h, n = store.put(bytes([i]) * block)
                    rc = send_handle(sid, h, n, timeout=20)
                    sent.append((time.monotonic(), rc))

            t = threading.Thread(target=producer)
            t.start()
            time.sleep(0.8)
            # window = 2 blocks -> writes 1..2 pass, write 3+ is parked
            # (the 3rd may pass the in-flight check edge; assert <= 3)
            n_before = len(sent)
            assert 2 <= n_before <= 3, sent
            gate.set()  # consumer drains; credits return; writer resumes
            t.join(timeout=20)
            assert len(sent) == 5 and all(rc == 0 for _, rc in sent), sent
            deadline = time.monotonic() + 5
            while impl.consumed_blocks < 5 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert impl.consumed_blocks == 5
        finally:
            stream_close(sid)

    def test_payload_integrity_through_hbm(self, device_stream_server):
        """End-to-end bit check: producer stages bytes, consumer copies
        on-device into a persistent handle, host verifies via get()."""
        server, impl, store = device_stream_server
        kept = []
        orig_consume = impl._consume

        def keeping_consume(h, n):
            out = store.copy(h)  # persistent copy, keeps the bytes
            kept.append(out[0])
            store.free(h)

        impl._consume = keeping_consume
        sid = open_device_stream(str(server.listen_endpoint()))
        try:
            payload = np.random.default_rng(3).integers(
                0, 256, size=65536, dtype=np.uint8).tobytes()
            h, n = store.put(payload)
            assert send_handle(sid, h, n) == 0
            deadline = time.monotonic() + 5
            while not kept and time.monotonic() < deadline:
                time.sleep(0.01)
            assert kept
            assert store.get(kept[0]) == payload
        finally:
            stream_close(sid)


# ---------------------------------------------------------------------------
# across packages and over the tunnel
# ---------------------------------------------------------------------------
def _wait(pred, seconds=10):
    deadline = time.monotonic() + seconds
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


@pytest.mark.parametrize("producer,consumer,address", [
    ("port", "jax", "127.0.0.1:0"),
    ("jax", "port", "127.0.0.1:0"),
    ("port", "port", "tpu://127.0.0.1:0/0"),
], ids=["port-to-jax-tcp", "jax-to-port-tcp", "port-to-port-tunnel"])
def test_records_cross_packages_and_the_tunnel(producer, consumer, address):
    import brpc_tpu.rpc as jax_rpc
    import brpc_tpu.rpc.stream as jax_stream
    import brpc_tpu.tpu.device_lane as jax_dl
    import brpc_tpu.tpu.device_stream as jax_ds
    import brpc_tpu_torch.rpc as port_rpc
    import brpc_tpu_torch.rpc.stream as port_stream
    import brpc_tpu_torch.tpu.device_lane as port_dl
    import brpc_tpu_torch.tpu.device_stream as port_ds

    sides = {"jax": (jax_rpc, jax_stream, jax_dl, jax_ds,
                     lambda: jax_dl.DeviceStore()),
             "port": (port_rpc, port_stream, port_dl, port_ds,
                      lambda: port_dl.DeviceStore("cpu"))}
    c_rpc, _, _, c_ds, c_store = sides[consumer]
    _, p_stream, _, p_ds, _ = sides[producer]
    store = c_store()
    impl = c_ds.DeviceStreamEchoService(store, free_after=False)
    server = c_rpc.Server().add_service(impl).start(address)
    datas = [np.random.default_rng(i).integers(
        0, 256, 4096 * (i + 1), dtype=np.uint8).tobytes() for i in range(4)]
    blocks = [store.put(d) for d in datas]
    sid = p_ds.open_device_stream(str(server.listen_endpoint()),
                                  window_bytes=1 << 20)
    try:
        for h, n in blocks:
            assert p_ds.send_handle(sid, h, n, timeout=20) == 0
        total = sum(n for _, n in blocks)
        st = p_stream.get_stream(sid)
        assert _wait(lambda: st._remote_consumed >= total)
        assert impl.consumed_blocks == 4 and impl.consumed_bytes == total
        assert impl.errors == 0
        store.fence()
        for (h, _), d in zip(blocks, datas):
            assert store.get(h) == d
        _, resident, moved = store.stats()
        assert resident == total and moved == 2 * total
    finally:
        p_stream.stream_close(sid)
        server.stop()
        server.join(timeout=2)
        store.fence()
