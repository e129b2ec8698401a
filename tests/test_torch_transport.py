"""The port's cross-process ``tpu://`` transport (brpc_tpu_torch.tpu.
transport) through every case of the reference's
``tests/test_tpu_transport.py``: the loopback tunnel, ordinal addressing,
credits returned exactly once (with a fake control socket), window
accounting, and two processes (tunnel failure and reconnect included).
Real sockets and shared-memory block pools, no mock transport.

Then the wire format: a JAX server and a port server, each in a child
process, answer a JAX Channel and a port Channel (all four pairings) at
64 B, 1 MiB and 16 MiB; the responses must be equal as bytes, which
holds only if the HELLO body and the DATA/ACK frames are the JAX
package's. Every server binds port 0; every shared-memory segment the
port creates is unlinked by the end of the module.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import (
    Channel,
    ChannelOptions,
    Controller,
    Server,
    ServerOptions,
    Service,
    Stub,
)

ECHO = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]


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


class EchoServiceImpl(Service):
    DESCRIPTOR = ECHO

    def Echo(self, cntl, request, done):
        cntl.response_attachment = cntl.request_attachment
        return echo_pb2.EchoResponse(message=request.message,
                                     payload=request.payload)


@pytest.fixture()
def tpu_server():
    server = Server(ServerOptions())
    server.add_service(EchoServiceImpl())
    server.start("tpu://127.0.0.1:0/0")
    yield server
    server.stop()
    server.join()


def _stub_for(server, timeout_ms=10000):
    channel = Channel(ChannelOptions(protocol="trpc_std",
                                     timeout_ms=timeout_ms))
    channel.init(str(server.listen_endpoint()))
    return Stub(channel, ECHO)


class TestTunnelLoopback:
    """Client and server roles in one process, but the full transport in
    between: TCP bootstrap, HELLO handshake, shm block pool, credits."""

    def test_endpoint_is_tpu_scheme(self, tpu_server):
        ep = tpu_server.listen_endpoint()
        assert ep.is_tpu() and ep.port != 0
        assert str(ep).startswith("tpu://")

    def test_small_inline_echo(self, tpu_server):
        stub = _stub_for(tpu_server)
        cntl = Controller()
        cntl.request_attachment = b"tail"
        r = stub.Echo(echo_pb2.EchoRequest(message="hello"), controller=cntl)
        assert r.message == "hello"
        assert cntl.response_attachment == b"tail"

    def test_block_path_roundtrip(self, tpu_server):
        stub = _stub_for(tpu_server)
        payload = bytes(range(256)) * (1024 * 1024 // 256)  # 1MB, patterned
        r = stub.Echo(echo_pb2.EchoRequest(message="big", payload=payload))
        assert r.payload == payload

    def test_payload_larger_than_window_streams(self, tpu_server):
        # 24MB > the 16MB credit window: must stream, not deadlock
        stub = _stub_for(tpu_server, timeout_ms=60000)
        payload = b"\xab" * (24 * 1024 * 1024)
        r = stub.Echo(echo_pb2.EchoRequest(message="huge", payload=payload))
        assert r.payload == payload

    def test_attachment_rides_blocks(self, tpu_server):
        stub = _stub_for(tpu_server)
        att = b"A" * (300 * 1024)  # bigger than one 256KB block
        cntl = Controller()
        cntl.request_attachment = att
        r = stub.Echo(echo_pb2.EchoRequest(message="m"), controller=cntl)
        assert cntl.response_attachment == att

    def test_concurrent_clients_interleave_safely(self, tpu_server):
        stub = _stub_for(tpu_server, timeout_ms=30000)
        errs = []

        def worker(i):
            try:
                payload = bytes([i]) * (512 * 1024 + i)
                for _ in range(3):
                    r = stub.Echo(echo_pb2.EchoRequest(message=str(i),
                                                       payload=payload))
                    assert r.payload == payload, f"worker {i} corrupted"
            except Exception as e:  # noqa: BLE001
                errs.append((i, e))

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not errs, errs

    def test_pipelined_async_calls(self, tpu_server):
        channel = Channel(ChannelOptions(protocol="trpc_std",
                                         timeout_ms=30000))
        channel.init(str(tpu_server.listen_endpoint()))
        stub = Stub(channel, ECHO)
        done_evt = threading.Event()
        results = []
        n = 20

        def make_done(i):
            def done(cntl):
                results.append((i, cntl.error_code,
                                cntl.response.message if cntl.response else ""))
                if len(results) == n:
                    done_evt.set()
            return done

        for i in range(n):
            stub.Echo(echo_pb2.EchoRequest(message=f"m{i}"),
                      done=make_done(i))
        assert done_evt.wait(30)
        assert sorted(m for _, code, m in results if code == 0) == \
            sorted(f"m{i}" for i in range(n))

    def test_server_stop_fails_pending_cleanly(self):
        server = Server(ServerOptions())

        # a SUBCLASS scopes the name override — patching the property on
        # the shared Service base renamed every later service in the
        # process (caught when BuiltinViewService started auto-mounting)
        class _SlowSvc(Service):
            @property
            def service_name(self):
                return "EchoService"

        svc = _SlowSvc()

        gate = threading.Event()

        def slow(cntl, request, done):
            gate.wait(5)
            return echo_pb2.EchoResponse(message="late")

        svc.add_method("Echo", slow, echo_pb2.EchoRequest,
                       echo_pb2.EchoResponse)
        server.add_service(svc)
        server.start("tpu://127.0.0.1:0/0")
        stub = _stub_for(server, timeout_ms=2000)
        cntl = Controller()
        finished = threading.Event()
        stub.Echo(echo_pb2.EchoRequest(message="x"), controller=cntl,
                  done=lambda _c: finished.set())
        time.sleep(0.2)
        server.stop()
        server.join(timeout=0.5)
        gate.set()
        assert finished.wait(5)
        # either the late response made it before teardown or the call
        # failed with a socket/timeout error — never a hang
        server.join()


class TestOrdinalAddressing:
    def test_wrong_ordinal_refused(self, tpu_server):
        # server fronts device 0; dialing /3 must be refused at handshake
        ep = tpu_server.listen_endpoint()
        bad = f"tpu://{ep.host}:{ep.port}/3"
        channel = Channel(ChannelOptions(protocol="trpc_std",
                                         timeout_ms=3000, max_retry=0))
        channel.init(bad)
        stub = Stub(channel, ECHO)
        from brpc_tpu_torch.rpc.channel import RpcError

        with pytest.raises((RpcError, ConnectionError)):
            stub.Echo(echo_pb2.EchoRequest(message="x"))
        # the right ordinal still works
        good_stub = _stub_for(tpu_server)
        assert good_stub.Echo(
            echo_pb2.EchoRequest(message="ok")).message == "ok"


class _FakeCtrl:
    """Stand-in bootstrap socket: records every frame the endpoint writes
    so tests can assert exactly which credits were ACKed, and when."""

    def __init__(self):
        self.frames = []          # raw bytes, one entry per write()
        self.failed = False
        self.remote = None
        self.error_code = 0
        self.error_text = ""
        self.on_failed_hook = None
        self.cut_batch_hook = None

    def write(self, data, id_wait=None):
        if self.failed:
            return 1
        self.frames.append(
            data.tobytes() if hasattr(data, "tobytes") else bytes(data))
        return 0

    def set_failed(self, code, reason=""):
        if self.failed:
            return
        self.failed = True
        self.error_code = code
        self.error_text = reason
        if self.on_failed_hook is not None:  # real Socket fires this too
            self.on_failed_hook(code, reason)


def _acked_indices(fake):
    """All block indices returned so far, one list per FT_ACK frame."""
    import struct

    from brpc_tpu_torch.tpu import transport as tr

    out = []
    for raw in fake.frames:
        magic, ftype, blen = struct.unpack_from(tr.CTRL_HDR, raw)
        if ftype == tr.FT_ACK:
            body = raw[tr.CTRL_HDR_SIZE:tr.CTRL_HDR_SIZE + blen]
            vals = struct.unpack(f"!{len(body) // 4}I", body)
            # v2 ACK body: (epoch, count, *indices)
            out.append(list(vals[2:2 + vals[1]]))
    return out


def _make_endpoint():
    from brpc_tpu_torch.policy import ensure_registered
    from brpc_tpu_torch.tpu import transport as tr

    ensure_registered()
    fake = _FakeCtrl()
    ep = tr.TpuEndpoint(fake, role="client", target_ordinal=0,
                        block_size=64 * 1024, block_count=8)
    return tr, fake, ep


def _trpc_response_packet(payload: bytes) -> bytes:
    """A complete, well-formed trpc_std RESPONSE for a correlation id that
    does not exist — the client stack parses and then quietly drops it,
    which is exactly the 'parser consumed the bytes' event."""
    from brpc_tpu_torch.policy.trpc_std import TrpcStdProtocol
    from brpc_tpu_torch.proto import rpc_meta_pb2

    meta = rpc_meta_pb2.RpcMeta()
    meta.correlation_id = 0x7FFF1234
    meta.response.error_code = 0
    return TrpcStdProtocol().pack_response(meta, payload).tobytes()


def _data_frame_body(segs, epoch=0):
    """DATA body referencing pool blocks: [(idx, ln), ...]. Fake-ctrl
    endpoints are built at epoch 0, so the default matches."""
    import struct

    from brpc_tpu_torch.tpu import transport as tr

    body = struct.pack(tr.DATA_BODY_HDR, epoch, 0, len(segs))
    for idx, ln in segs:
        body += struct.pack(tr.SEG_FMT, idx, ln)
    return body


class TestCreditReturnExactlyOnce:
    """Tentpole regression: a borrowed block's credit is released exactly
    once, only after the parser consumed the bytes — and teardown with
    borrows outstanding neither leaks credits nor double-releases."""

    def test_credit_deferred_until_parse_consumes(self):
        from brpc_tpu_torch.butil.iobuf import IOBuf, supports_block_ownership

        if not supports_block_ownership():
            pytest.skip("no block-ownership exporter in this environment")
        tr, fake, ep = _make_endpoint()
        try:
            pkt = _trpc_response_packet(b"\xcd" * 8192)
            half = len(pkt) // 2
            pool = ep.recv_pool
            # peer 'writes' the packet across two registered blocks
            pool._shm.buf[0:half] = pkt[:half]
            blk = pool.block_size
            pool._shm.buf[blk:blk + len(pkt) - half] = pkt[half:]

            # frame 1: only the first half — the parser cannot finish, so
            # NO credit may come back yet
            ep.on_data(IOBuf(_data_frame_body([(0, half)])))
            assert _acked_indices(fake) == []
            assert ep._borrowed_outstanding == 1
            assert ep._released_total == 0

            # frame 2: the rest — the message parses, its body is consumed
            # by the (unknown-cid) response path, credits flow back
            ep.on_data(IOBuf(_data_frame_body([(1, len(pkt) - half)])))
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                acked = [i for frame in _acked_indices(fake) for i in frame]
                if sorted(acked) == [0, 1]:
                    break
                time.sleep(0.01)
            acked = [i for frame in _acked_indices(fake) for i in frame]
            assert sorted(acked) == [0, 1], acked  # each EXACTLY once
            deadline = time.monotonic() + 5
            while ep._borrowed_outstanding and time.monotonic() < deadline:
                time.sleep(0.01)
            assert ep._borrowed_outstanding == 0
            assert ep._released_total == 2
        finally:
            ep.fail(0, "test done")

    def test_teardown_with_outstanding_borrow(self):
        from brpc_tpu_torch.butil.iobuf import IOBuf, supports_block_ownership

        if not supports_block_ownership():
            pytest.skip("no block-ownership exporter in this environment")
        tr, fake, ep = _make_endpoint()
        pkt = _trpc_response_packet(b"\xee" * 4096)
        pool = ep.recv_pool
        pool._shm.buf[0:64] = pkt[:64]   # incomplete head only
        ep.on_data(IOBuf(_data_frame_body([(0, 64)])))
        assert ep._borrowed_outstanding == 1
        assert _acked_indices(fake) == []

        frames_before = len(fake.frames)
        ep.fail(999, "test teardown")
        # the borrow was released exactly once by the teardown clear...
        assert ep._released_total == 1
        assert ep._borrowed_outstanding == 0
        # ...but its credit was NOT acked (peer is gone), and no ack frame
        # was written during/after teardown
        assert _acked_indices(fake) == []
        assert all(f[:4] == tr.CTRL_MAGIC[:4] for f in fake.frames)
        # the pool unmapped inline: no exports were left behind
        assert pool.exports == 0
        assert pool._closed

    def test_teardown_with_inflight_body_defers_pool_close(self):
        from brpc_tpu_torch.butil.iobuf import IOBuf, supports_block_ownership

        if not supports_block_ownership():
            pytest.skip("no block-ownership exporter in this environment")
        tr, fake, ep = _make_endpoint()
        pkt = _trpc_response_packet(b"\xaa" * 4096)
        pool = ep.recv_pool
        pool._shm.buf[0:64] = pkt[:64]
        ep.on_data(IOBuf(_data_frame_body([(0, 64)])))
        # simulate an in-flight message body still holding borrowed bytes
        held = ep.vsock.read_buf.cutn(64)
        ep.fail(999, "teardown with body in flight")
        assert ep._released_total == 0          # the borrow is still live
        assert pool.exports == 1
        assert not pool._closed                 # unmap deferred, not forced
        del held                                 # the fiber finishes
        assert ep._released_total == 1           # exactly once
        assert ep._borrowed_outstanding == 0
        assert pool.exports == 0
        tr._sweep_deferred_pools()               # retry outside the cascade
        assert pool._closed
        assert _acked_indices(fake) == []        # no credit ack after death

    def test_loopback_echo_is_zero_copy(self, tpu_server):
        """Acceptance: block-segment frames cross the receive path with
        ZERO full-payload copies — all segment bytes are borrowed, none
        copied (both directions of a loopback echo count here)."""
        from brpc_tpu_torch.butil.iobuf import supports_block_ownership
        from brpc_tpu_torch.tpu import transport as tr

        if not supports_block_ownership():
            pytest.skip("no block-ownership exporter in this environment")
        stub = _stub_for(tpu_server)
        payload = b"\x5a" * (1024 * 1024)
        stub.Echo(echo_pb2.EchoRequest(message="warm", payload=payload))
        borrowed0 = tr.g_tunnel_borrowed_bytes.get_value()
        copied0 = tr.g_tunnel_copied_bytes.get_value()
        r = stub.Echo(echo_pb2.EchoRequest(message="zc", payload=payload))
        assert r.payload == payload
        borrowed = tr.g_tunnel_borrowed_bytes.get_value() - borrowed0
        copied = tr.g_tunnel_copied_bytes.get_value() - copied0
        # request (server side) + response (client side) both ride blocks
        assert borrowed >= 2 * len(payload), (borrowed, copied)
        assert copied == 0, (borrowed, copied)


class TestWindowAccounting:
    def test_credits_return_after_traffic(self, tpu_server):
        stub = _stub_for(tpu_server)
        payload = b"z" * (2 * 1024 * 1024)
        for _ in range(5):
            r = stub.Echo(echo_pb2.EchoRequest(message="w", payload=payload))
            assert len(r.payload) == len(payload)
        # after all RPCs complete the client's view of the server window
        # must be full again (all credits returned)
        from brpc_tpu_torch.tpu import transport as tr

        # this server's tunnel (a worker's cache may hold others' tunnels)
        ep = tpu_server.listen_endpoint()
        with tr._remote_lock:
            vs = tr._remote_sockets[(ep.host, ep.port, ep.device_ordinal)]
        win = vs.endpoint.window
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            with win._cond:
                if len(win._free) == win.block_count:
                    break
            time.sleep(0.01)
        with win._cond:
            assert len(win._free) == win.block_count


_CHILD_SERVER = r"""
import sys
from __PKG__.proto import echo_pb2
from __PKG__.rpc import Server, ServerOptions, Service

class EchoServiceImpl(Service):
    DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]
    def Echo(self, cntl, request, done):
        cntl.response_attachment = cntl.request_attachment
        return echo_pb2.EchoResponse(message="from-child:" + request.message,
                                     payload=request.payload)

server = Server(ServerOptions())
server.add_service(EchoServiceImpl())
server.start("tpu://127.0.0.1:0/0")
print(f"LISTENING {server.listen_endpoint()}", flush=True)
sys.stdin.readline()   # parent closes stdin to stop us
server.stop(); server.join()
"""


def _start_child(pkg):
    """_CHILD_SERVER of ``pkg`` (brpc_tpu or brpc_tpu_torch) in a fresh
    interpreter; returns (process, endpoint)."""
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", _CHILD_SERVER.replace("__PKG__", pkg)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    line = proc.stdout.readline().strip()
    assert line.startswith("LISTENING "), (
        line, proc.stderr.read() if proc.poll() is not None else "")
    return proc, line.split(" ", 1)[1]


def _stop_child(proc):
    try:
        proc.stdin.close()
        proc.wait(10)
    except Exception:
        proc.kill()


class TestTwoProcesses:
    """THE acceptance test: Channel in this process, Server in a child
    process, RPC over tpu:// with payload through the shm block pool."""

    @pytest.fixture()
    def child_server(self):
        proc, endpoint = _start_child("brpc_tpu_torch")
        yield endpoint
        _stop_child(proc)

    def test_cross_process_echo(self, child_server):
        channel = Channel(ChannelOptions(protocol="trpc_std",
                                         timeout_ms=15000))
        channel.init(child_server)
        stub = Stub(channel, ECHO)
        r = stub.Echo(echo_pb2.EchoRequest(message="ping"))
        assert r.message == "from-child:ping"

    def test_cross_process_bulk_payload(self, child_server):
        channel = Channel(ChannelOptions(protocol="trpc_std",
                                         timeout_ms=30000))
        channel.init(child_server)
        stub = Stub(channel, ECHO)
        payload = bytes(range(256)) * (4 * 1024 * 1024 // 256)
        cntl = Controller()
        cntl.request_attachment = b"side-channel"
        r = stub.Echo(echo_pb2.EchoRequest(message="bulk", payload=payload),
                      controller=cntl)
        assert r.payload == payload
        assert cntl.response_attachment == b"side-channel"

    def test_cross_process_concurrent(self, child_server):
        channel = Channel(ChannelOptions(protocol="trpc_std",
                                         timeout_ms=30000))
        channel.init(child_server)
        stub = Stub(channel, ECHO)
        errs = []

        def worker(i):
            try:
                payload = bytes([i]) * (256 * 1024 * (1 + i % 3))
                r = stub.Echo(echo_pb2.EchoRequest(message=str(i),
                                                   payload=payload))
                assert r.payload == payload
                assert r.message == f"from-child:{i}"
            except Exception as e:  # noqa: BLE001
                errs.append((i, repr(e)))

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not errs, errs

    def test_tunnel_failure_errors_inflight_and_reconnects(self, child_server):
        channel = Channel(ChannelOptions(protocol="trpc_std",
                                         timeout_ms=10000, max_retry=0))
        channel.init(child_server)
        stub = Stub(channel, ECHO)
        # prove liveness first
        stub.Echo(echo_pb2.EchoRequest(message="alive"))
        from brpc_tpu_torch.rpc import errors as _errors
        from brpc_tpu_torch.tpu import transport as tr

        from brpc_tpu_torch.butil.endpoint import EndPoint

        ep = EndPoint.parse(child_server)
        with tr._remote_lock:
            vs = tr._remote_sockets[(ep.host, ep.port, ep.device_ordinal)]
        assert not vs.failed
        # a call id pending on the tunnel when it dies must get the socket
        # error through the error channel (reference Socket::SetFailed fanout)
        codes = []
        evt = threading.Event()
        from brpc_tpu_torch.fiber import call_id as _cid

        cid = _cid.id_create(
            data=None,
            on_error=lambda d, c, code: (codes.append(code),
                                         _cid.id_unlock_and_destroy(c),
                                         evt.set()))
        vs.add_pending_id(cid)
        vs.close()
        assert evt.wait(5)
        assert codes == [_errors.EFAILEDSOCKET]
        # ...and the next call transparently re-dials a fresh tunnel
        r = stub.Echo(echo_pb2.EchoRequest(message="recovered"))
        assert r.message == "from-child:recovered"


# ---------------------------------------------------------------------------
# the wire format: {JAX, port} Channel x {JAX, port} child server
# ---------------------------------------------------------------------------
import brpc_tpu.rpc as jax_rpc  # noqa: E402
import brpc_tpu_torch.rpc as port_rpc  # noqa: E402
from brpc_tpu.proto import echo_pb2 as jax_echo  # noqa: E402

CLIENTS = {"jax": (jax_rpc, jax_echo), "port": (port_rpc, echo_pb2)}
PACKAGES = {"jax": "brpc_tpu", "port": "brpc_tpu_torch"}
PAIRINGS = [(c, s) for c in ("jax", "port") for s in ("jax", "port")]


@pytest.fixture(scope="module")
def child_servers():
    procs = {side: _start_child(pkg) for side, pkg in PACKAGES.items()}
    yield {side: ep for side, (_, ep) in procs.items()}
    for proc, _ in procs.values():
        _stop_child(proc)


def _pairing_echo(client, endpoint, size):
    rpc, pb = CLIENTS[client]
    ch = rpc.Channel(rpc.ChannelOptions(protocol="trpc_std",
                                        timeout_ms=60000)).init(endpoint)
    stub = rpc.Stub(ch, pb.DESCRIPTOR.services_by_name["EchoService"])
    payload = np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    cntl = rpc.Controller()
    cntl.request_attachment = payload[::-1]
    resp = stub.Echo(pb.EchoRequest(message=f"m{size}", payload=payload),
                     controller=cntl)
    assert resp.payload == payload
    assert cntl.response_attachment == payload[::-1]
    return resp.SerializeToString(), cntl.response_attachment


@pytest.mark.parametrize("size", [64, 1 << 20, 16 << 20],
                         ids=["64B", "1MiB", "16MiB"])
def test_jax_and_port_pairings_exchange_equal_bytes(child_servers, size):
    out = {(c, s): _pairing_echo(c, child_servers[s], size)
           for c, s in PAIRINGS}
    first = out[PAIRINGS[0]]
    assert echo_pb2.EchoResponse.FromString(first[0]).message == \
        f"from-child:m{size}"
    for pairing, got in out.items():
        assert got == first, pairing


@pytest.mark.parametrize("client,server", PAIRINGS,
                         ids=[f"{c}-channel-{s}-server"
                              for c, s in PAIRINGS])
def test_each_pairing_rides_the_shared_memory_blocks(child_servers,
                                                     client, server):
    """A 1 MiB echo in each pairing: the response came back in borrowed
    blocks of the shared-memory pool, never in inline frames."""
    from brpc_tpu.tpu import transport as jax_tr
    from brpc_tpu_torch.tpu import transport as port_tr

    tr = jax_tr if client == "jax" else port_tr
    b0 = tr.g_tunnel_borrowed_bytes.get_value()
    _pairing_echo(client, child_servers[server], 1 << 20)
    assert tr.g_tunnel_borrowed_bytes.get_value() - b0 >= 1 << 20
    state = tr.tunnel_state()
    assert state["client_endpoints"]
    assert not any(e["inline_only"] for e in state["client_endpoints"])


def test_hello_body_and_frames_are_the_references():
    """The constants that make up the wire, equal to the JAX package's."""
    from brpc_tpu.tpu import transport as jax_tr
    from brpc_tpu_torch.tpu import transport as port_tr

    for name in ("CTRL_MAGIC", "CTRL_HDR", "FT_HELLO", "FT_HELLO_ACK",
                 "FT_DATA", "FT_ACK", "FT_BYE", "FT_DATA_PRI",
                 "DATA_BODY_HDR", "SEG_FMT", "DEFAULT_BLOCK_SIZE",
                 "DEFAULT_BLOCK_COUNT", "INLINE_MAX", "MAX_SEGS_PER_FRAME",
                 "HANDSHAKE_VERSION"):
        assert getattr(port_tr, name) == getattr(jax_tr, name), name
    for geo in [(0, 0), (1, 1), (5 << 20, 1000), (300000, 17)]:
        assert port_tr.clamp_geometry(*geo) == jax_tr.clamp_geometry(*geo)
    assert port_tr._pack_frame(port_tr.FT_ACK, b"\x00" * 8) == \
        jax_tr._pack_frame(jax_tr.FT_ACK, b"\x00" * 8)


def test_zz_no_shared_memory_segment_outlives_the_tunnels():
    """Runs last in this module: once the port's cached client tunnels
    close, every segment the port created in this process is unlinked."""
    from brpc_tpu_torch.tpu import transport as tr

    with tr._remote_lock:
        socks = list(tr._remote_sockets.values())
        tr._remote_sockets.clear()
    for vs in socks:
        vs.endpoint.close()
    tr._sweep_deferred_pools()
    assert not tr._owned_pools
    mine = f"brpctpu_{os.getpid():x}_"
    left = [n for n in os.listdir("/dev/shm") if n.startswith(mine)]
    from brpc_tpu.tpu import transport as jax_tr

    assert set(left) <= set(jax_tr._owned_pools), left


def test_tpu_lane_bench_runs_on_the_cpu():
    """``bench/tpu_lane.py --cpu`` (the card script's client and server,
    at the CPU's counts): every phase prints its row, the bulk sizes ride
    the borrowed blocks, and the server's dispatcher ran every transient
    copy the calls and the stream implied."""
    import json

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "brpc_tpu_torch/bench/tpu_lane.py", "--cpu"],
        cwd=repo, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    rows = {k: v for line in res.stdout.splitlines()
            if line.startswith("{") for k, v in json.loads(line).items()}
    assert sorted(rows) == ["data_plane", "served", "stream", "sweep"]
    sweep = rows["sweep"]
    assert sweep["copied_bytes"] == 0
    assert sweep["borrowed_bytes"] >= sweep["block_bytes_expected"] > 0
    assert sweep["borrowed_peak_blocks"] < sweep["window_blocks"]
    assert rows["served"]["stream_blocks"] == rows["stream"]["records"]
    assert rows["served"]["foreign_modules"] == []
