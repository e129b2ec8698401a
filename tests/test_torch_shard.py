"""The port's sharded dispatch plane (brpc_tpu_torch/shard) against the
JAX package's (brpc_tpu/shard), every case of ``tests/test_shard.py`` on
the port plus the cross-package checks.

Unit level: the shm SPSC ring survives wrap/full/reattach and a ring of
either package reads the other's records; the ring codecs, the RpcMeta
scanner and ``shard_for`` give the JAX functions' bytes and values on the
same numpy-seeded inputs. Lease level (the port's CreditLedger armed):
grant/take/fill/post, stale-epoch drops, explicit returns and worker-death
reclaim all leave the port's PeerWindow balanced. Integration level: echo
at workers 0 against 2, a 2-worker soak with no loss or duplication, leased
bulk responses, ``worker.crash`` recovering through respawn with a
generation bump, a dead worker's non-idempotent calls run at most once
(one it never took runs in the parent; one it took gets the retriable
EFAILEDSOCKET, run again only when the caller's max_retry asks), no
stale shared memory, the ``/tpu`` shard section, and a JAX-package
client over the tunnel to a port sharded server whose response bytes
equal the port client's. Every wait is bounded; each fixture stops
its server, restores the flags and leaves no ring segment behind.
"""

import glob
import os
import signal
import struct
import threading
import time

import numpy as np
import pytest

import brpc_tpu.rpc as jax_rpc
from brpc_tpu.proto import echo_pb2 as jax_echo
from brpc_tpu.proto import rpc_meta_pb2 as jax_meta
from brpc_tpu.shard import plane as jax_plane
from brpc_tpu.shard import ring as jax_ring
from brpc_tpu.shard import wire as jax_wire
from brpc_tpu_torch import errors, fault, flags
from brpc_tpu_torch.analysis import runtime_check as rc
from brpc_tpu_torch.proto import echo_pb2, rpc_meta_pb2
from brpc_tpu_torch.rpc import (
    Channel,
    ChannelOptions,
    Controller,
    RpcError,
    Server,
    ServerOptions,
    Stub,
)
from brpc_tpu_torch.shard import wire
from brpc_tpu_torch.shard.plane import shard_for
from brpc_tpu_torch.shard.ring import ShardRing
from brpc_tpu_torch.shard.subwindow import LeaseManager, SubWindow

ECHO = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]
FACTORY = "brpc_tpu_torch.shard.testing:echo_services"
READY_S = 30.0


def _shard_shm_segments(pids=()):
    """This process's plane rings (named after the parent's pid) and the
    spill segments of the workers ``pids`` (named after the worker's pid):
    another process's segments are not this test's to judge."""
    paths = glob.glob(f"/dev/shm/brpctpu_torch_shard_{os.getpid():x}_*")
    for pid in pids:
        paths += glob.glob(f"/dev/shm/brpctpu_torch_spill_{pid:x}_*")
    return {os.path.basename(p) for p in paths}


@pytest.fixture(autouse=True)
def _close_new_tunnels():
    """Close the client tunnels a test dialed, in both packages, so no
    cached tunnel outlives its server into a later test."""
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


@pytest.fixture(autouse=True)
def _leave_no_state():
    """Echo traffic here classifies EchoService.Echo as cheap in each
    package's run-to-completion table, which is keyed by name across the
    process: clear both after each test, so a later test's slow handler
    of that name is not run inline. And leave no watch rule of either
    package firing (a worker death, a tunnel torn down under a client)."""
    from brpc_tpu.rpc import run_to_completion as jax_rtc
    from brpc_tpu_torch.rpc import run_to_completion as port_rtc
    from tests.test_torch_kv_vars_watch import quiet_watches

    with quiet_watches():
        yield
    jax_rtc._reset_for_test()
    port_rtc._reset_for_test()


@pytest.fixture()
def shard_flags(monkeypatch):
    """tpu_shard_workers=2 for one test; always back to the 0 default.
    Every worker the test's planes spawn is noted, respawns included, so
    the leak check reads their spill segments and no other process's."""
    from brpc_tpu_torch.shard import plane as port_plane

    spawned = []
    spawn = port_plane.ShardPlane._spawn

    def noting(self, w):
        spawn(self, w)
        spawned.append(w.pid)

    monkeypatch.setattr(port_plane.ShardPlane, "_spawn", noting)
    flags.set_flag("tpu_shard_workers", 2)
    before = _shard_shm_segments()
    try:
        yield
    finally:
        flags.set_flag("tpu_shard_workers", 0)
        leaked = _shard_shm_segments(spawned) - before
        assert not leaked, f"stale shard shm segments: {sorted(leaked)}"


@pytest.fixture()
def checker():
    was_active = rc.ACTIVE
    rc.activate()
    try:
        yield rc
    finally:
        if was_active:
            rc.activate()
        else:
            rc.deactivate()


def _echo_server():
    from brpc_tpu_torch.shard.testing import ShardEchoService

    srv = Server(ServerOptions(shard_factory=FACTORY))
    srv.add_service(ShardEchoService())
    srv.start("tpu://127.0.0.1:0/0")
    return srv


def _counting_server():
    from brpc_tpu_torch.shard.testing import CountingEchoService

    srv = Server(ServerOptions(
        shard_factory="brpc_tpu_torch.shard.testing:counting_services"))
    srv.add_service(CountingEchoService())
    srv.start("tpu://127.0.0.1:0/0")
    return srv


def _call_into(stub, msg, out):
    try:
        out["message"] = stub.Echo(echo_pb2.EchoRequest(message=msg)).message
    except RpcError as e:
        out["error"] = e.error_code


def _runs(path, msg):
    """The pids that ran ``msg``'s handler, one per run."""
    if not path.exists():
        return []
    return [int(line.split()[1]) for line in path.read_text().splitlines()
            if line.split()[0] == msg]


def _stub_for(srv, timeout_ms=20000, max_retry=0):
    ch = Channel(ChannelOptions(protocol="trpc_std", timeout_ms=timeout_ms,
                                max_retry=max_retry))
    ch.init(str(srv.listen_endpoint()))
    return Stub(ch, ECHO)


def _stop(srv):
    srv.stop()
    srv.join()



# ------------------------------------------------------------------- ring
class TestShardRing:
    def _name(self, tag):
        return f"test_torch_shardring_{os.getpid():x}_{tag}"

    def test_push_pop_roundtrip_in_order(self):
        r = ShardRing.create(self._name("rt"), 64 * 1024)
        try:
            recs = [(i % 7 + 1, bytes([i & 0xFF]) * i) for i in range(40)]
            for t, p in recs:
                assert r.push(t, p)
            assert r.pop(max_records=100) == recs
            assert r.empty
            assert r.pushed == 40 and r.popped == 40
        finally:
            r.close()

    def test_full_ring_rejects_then_recovers(self):
        r = ShardRing.create(self._name("full"), 64 * 1024)
        try:
            payload = b"\xaa" * 4096
            n = 0
            while r.push(1, payload):
                n += 1
            assert n > 0
            assert r.push_full >= 1          # bounded: never blocks, never grows
            assert r.pop(max_records=1000) == [(1, payload)] * n
            assert r.push(2, b"again")       # space reclaimed after pop
            assert r.pop() == [(2, b"again")]
        finally:
            r.close()

    def test_wraparound_preserves_payloads(self):
        r = ShardRing.create(self._name("wrap"), 64 * 1024)
        try:
            for i in range(400):
                p = bytes([(i * 37) & 0xFF]) * (1000 + (i * 311) % 3000)
                assert r.push(3, p)
                got = r.pop()
                assert got == [(3, p)], f"record {i} corrupted"
        finally:
            r.close()

    def test_attach_by_name_sees_producer_records(self):
        name = self._name("attach")
        prod = ShardRing.create(name, 64 * 1024)
        try:
            cons = ShardRing.attach(name)
            try:
                assert prod.push(9, b"cross-process bytes")
                assert cons.pop() == [(9, b"cross-process bytes")]
                assert prod.free_bytes() == prod.capacity
            finally:
                cons.close()
        finally:
            prod.close()

    def test_owner_close_unlinks(self):
        name = self._name("unlink")
        r = ShardRing.create(name, 64 * 1024)
        r.close()
        with pytest.raises(FileNotFoundError):
            ShardRing.attach(name)

    @pytest.mark.parametrize("producer", ["port", "jax"])
    def test_rings_of_both_packages_share_one_layout(self, producer):
        """A ring created by one package and attached by the other carries
        the same records, seeded sizes and types, across many wraps."""
        rng = np.random.default_rng(20)
        mods = {"port": ShardRing, "jax": jax_ring.ShardRing}
        consumer = "jax" if producer == "port" else "port"
        name = self._name(f"x{producer}")
        prod = mods[producer].create(name, 64 * 1024)
        try:
            cons = mods[consumer].attach(name)
            try:
                for i in range(300):
                    n = int(rng.integers(0, 9000))
                    p = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                    t = int(rng.integers(1, 40))
                    assert prod.push(t, p)
                    assert cons.pop() == [(t, p)], f"record {i}"
                assert bytes(prod._shm.buf[:16]) == bytes(cons._shm.buf[:16])
            finally:
                cons.close()
        finally:
            prod.close()


# ------------------------------------------------------------------ codecs
def _seeded_indices(rng, n):
    return [int(x) for x in rng.integers(0, 1 << 20, n)]


class TestWireCodecs:
    def test_msg_roundtrip(self):
        assert wire.decode_msg(wire.encode_msg(7, b"FRAME")) == (7, b"FRAME")

    def test_indices_roundtrip(self):
        b = wire.encode_indices(3, 12, [0, 5, 63, 17])
        assert wire.decode_indices(b) == (3, 12, [0, 5, 63, 17])

    def test_want_roundtrip(self):
        assert wire.decode_want(wire.encode_want(4, 16)) == (4, 16)

    def test_resp_roundtrip(self):
        b = wire.encode_resp(2, 1 << 40, b"\x00packet")
        assert wire.decode_resp(b) == (2, 1 << 40, b"\x00packet")

    def test_resp_segs_roundtrip(self):
        segs = [(0, 262144), (63, 17)]
        b = wire.encode_resp_segs(1, 2, 99, segs)
        assert wire.decode_resp_segs(b) == (1, 2, 99, segs)

    def test_record_types_equal_the_reference(self):
        names = [n for n in dir(jax_wire) if n[:2] in ("R_", "W_")]
        assert names and all(getattr(wire, n) == getattr(jax_wire, n)
                             for n in names)

    def test_codecs_equal_the_reference_on_seeded_inputs(self):
        rng = np.random.default_rng(9)
        for _ in range(50):
            ep, epoch = (int(x) for x in rng.integers(0, 1 << 31, 2))
            cid = int(rng.integers(0, 1 << 62))
            frame = rng.integers(0, 256, int(rng.integers(0, 300)),
                                 dtype=np.uint8).tobytes()
            idx = _seeded_indices(rng, int(rng.integers(0, 40)))
            segs = [(i, int(rng.integers(1, 1 << 18))) for i in idx]
            want = int(rng.integers(0, 1 << 31))
            for enc, args in (("encode_msg", (ep, frame)),
                              ("encode_indices", (ep, epoch, idx)),
                              ("encode_want", (ep, want)),
                              ("encode_resp", (ep, cid, frame)),
                              ("encode_resp_segs", (ep, epoch, cid, segs))):
                got = getattr(wire, enc)(*args)
                assert got == getattr(jax_wire, enc)(*args), enc
                dec = enc.replace("encode", "decode")
                assert getattr(wire, dec)(got) == \
                    getattr(jax_wire, dec)(got), dec

    def test_scan_request_meta_reads_the_port_runtime(self):
        meta = rpc_meta_pb2.RpcMeta()
        meta.request.service_name = "EchoService"
        meta.request.method_name = "Echo"
        meta.correlation_id = 0xDEADBEEF
        meta.attempt_version = 2
        info = wire.scan_request_meta(meta.SerializeToString())
        assert info == (True, 0xDEADBEEF, 2, False)

    def test_scan_flags_streams_and_responses(self):
        meta = rpc_meta_pb2.RpcMeta()
        meta.request.service_name = "S"
        meta.stream_settings.stream_id = 5
        has_req, _, _, has_stream = wire.scan_request_meta(
            meta.SerializeToString())
        assert has_req and has_stream     # streams stay on the parent path
        resp = rpc_meta_pb2.RpcMeta()
        resp.response.error_code = 0
        resp.correlation_id = 11
        info = wire.scan_request_meta(resp.SerializeToString())
        assert info == (False, 11, 0, False)

    def test_scanner_rejects_garbage(self):
        assert wire.scan_request_meta(b"\xff\xff\xff\xff") is None

    def test_scan_equals_the_reference_over_both_runtimes(self):
        """The port's scan of its runtime's bytes equals the JAX scan of
        protobuf's bytes for the same seeded metas (the bytes are equal
        too), and both scanners agree on seeded garbage."""
        rng = np.random.default_rng(3)
        for i in range(60):
            cid = int(rng.integers(1, 1 << 63))
            attempt = int(rng.integers(1, 1 << 31))
            sid = int(rng.integers(1, 99))
            metas = []
            for mod in (rpc_meta_pb2, jax_meta):
                m = mod.RpcMeta()
                if i % 3 != 2:
                    m.request.service_name = f"S{i}"
                    m.request.method_name = "M"
                else:
                    m.response.error_code = i
                m.correlation_id = cid
                if i % 2:
                    m.attempt_version = attempt
                if i % 5 == 0:
                    m.stream_settings.stream_id = sid
                metas.append(m.SerializeToString())
            assert metas[0] == metas[1]
            assert wire.scan_request_meta(metas[0]) == \
                jax_wire.scan_request_meta(metas[1])
            junk = rng.integers(0, 256, int(rng.integers(1, 40)),
                                dtype=np.uint8).tobytes()
            assert wire.scan_request_meta(junk) == \
                jax_wire.scan_request_meta(junk)

    def test_response_cid_from_packed_response(self):
        from brpc_tpu_torch.policy import ensure_registered
        from brpc_tpu_torch.rpc.protocol import find_protocol

        ensure_registered()
        meta = rpc_meta_pb2.RpcMeta()
        meta.correlation_id = 424242
        meta.response.error_code = 0
        pkt = bytes(find_protocol("trpc_std").pack_response(meta, b"body"))
        _, meta_size, _ = struct.unpack_from("!4sII", pkt)
        assert wire.response_cid(pkt, meta_size) == 424242
        assert jax_wire.response_cid(pkt, meta_size) == 424242


# ----------------------------------------------------------------- routing
class TestRouting:
    def test_stable(self):
        for cid in (1, 2, 1 << 31, 0xFFFFFFFF):
            assert shard_for(cid, 4) == shard_for(cid, 4)

    def test_sequential_cids_spread_over_two_workers(self):
        hits = [0, 0]
        for cid in range(1, 2001):
            hits[shard_for(cid, 2)] += 1
        assert 0.35 < hits[0] / 2000 < 0.65, hits

    def test_versioned_cids_spread_over_two_workers(self):
        hits = [0, 0]
        for v in range(1, 4001, 2):
            hits[shard_for(v << 32, 2)] += 1
        assert 0.35 < hits[0] / 2000 < 0.65, hits

    def test_every_worker_reached(self):
        for n in (2, 3, 4, 7):
            seen = {shard_for(cid, n) for cid in range(1, 512)}
            assert seen == set(range(n)), (n, seen)
            seen = {shard_for(v << 32, n) for v in range(1, 129, 2)}
            assert seen == set(range(n)), ("versioned", n, seen)

    def test_shard_for_equals_the_reference_on_seeded_cids(self):
        rng = np.random.default_rng(11)
        cids = [int(c) for c in rng.integers(0, 1 << 63, 2000)]
        cids += [v << 32 for v in range(1, 200, 2)]
        for n in (1, 2, 3, 4, 7, 8):
            assert [shard_for(c, n) for c in cids] == \
                [jax_plane.shard_for(c, n) for c in cids]


# ------------------------------------------------------------------ leases
class TestCreditSubWindows:
    """LeaseManager/SubWindow against a real shm pool + the port's
    PeerWindow with its CreditLedger armed: every path hands the credits
    home."""

    BS, BC = 4096, 16

    @pytest.fixture()
    def window(self, checker):
        from multiprocessing import shared_memory as _shm

        from brpc_tpu_torch.tpu.transport import PeerWindow

        name = f"test_torch_shardlease_{os.getpid():x}"
        seg = _shm.SharedMemory(create=True, size=self.BS * self.BC,
                                name=name)
        win = PeerWindow(name, self.BS, self.BC)
        try:
            yield name, seg, win
        finally:
            win.close()
            try:
                seg.close()
                seg.unlink()
            except FileNotFoundError:
                pass

    def test_grant_take_fill_post_balances(self, checker, window):
        name, seg, win = window
        lm = LeaseManager(win, epoch=0)
        sub = SubWindow(name, self.BS, self.BC, epoch=0)
        try:
            got = lm.grant(widx=0, want=4)
            assert got and len(got) == 4
            assert lm.leased_count(0) == 4
            assert sub.grant(got, epoch=0)
            taken = sub.take_now(2)
            assert taken is not None and len(taken) == 2
            sub.fill(taken[0], b"\xcd" * 100, 100)
            base = taken[0] * self.BS
            assert bytes(seg.buf[base:base + 100]) == b"\xcd" * 100
            lm.note_posted(0, taken)
            win.release(taken)
            back = sub.give_back(self.BC)
            assert sorted(back) == sorted(set(got) - set(taken))
            lm.note_returned(0, back)
            assert lm.leased_count(0) == 0
            rc.ledger.assert_balanced()
        finally:
            sub.close()

    def test_take_now_never_blocks_or_splits(self, checker, window):
        name, _, win = window
        lm = LeaseManager(win, epoch=0)
        sub = SubWindow(name, self.BS, self.BC, epoch=0)
        try:
            got = lm.grant(0, 3)
            sub.grant(got, 0)
            t0 = time.monotonic()
            assert sub.take_now(5) is None          # all-or-nothing
            assert time.monotonic() - t0 < 0.05     # and never parks
            assert sub.take_misses == 1
            assert sub.free_count() == 3
            lm.note_returned(0, sub.give_back(3))
            rc.ledger.assert_balanced()
        finally:
            sub.close()

    def test_stale_epoch_grant_dropped(self, checker, window):
        name, _, win = window
        sub = SubWindow(name, self.BS, self.BC, epoch=3)
        try:
            assert not sub.grant([1, 2], epoch=2)
            assert sub.free_count() == 0
        finally:
            sub.close()

    def test_reclaim_on_worker_death_rebalances_to_sibling(self, checker,
                                                           window):
        _, _, win = window
        lm = LeaseManager(win, epoch=0)
        dead = lm.grant(widx=1, want=self.BC)
        assert len(dead) == self.BC
        assert lm.grant(widx=0, want=4, timeout=0.01) is None
        assert lm.grant_misses == 1
        assert lm.reclaim_worker(1) == self.BC
        assert lm.leased_count(1) == 0
        moved = lm.grant(widx=0, want=4)
        assert len(moved) == 4
        lm.release_all()
        rc.ledger.assert_balanced()

    def test_ungrant_returns_undelivered_credits(self, checker, window):
        _, _, win = window
        lm = LeaseManager(win, epoch=0)
        got = lm.grant(0, 4)
        lm.ungrant(0, got)
        assert lm.leased_count(0) == 0
        assert len(lm.grant(0, self.BC)) == self.BC
        lm.release_all()
        rc.ledger.assert_balanced()


# ------------------------------------------------------------- integration
class TestShardPlaneEndToEnd:
    """Equivalence, soak, bulk, chaos and clean-up on the port's plane."""

    def _wait_ledger_clean(self, timeout=5.0):
        from brpc_tpu_torch.tpu.transport import _sweep_deferred_pools

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            snap = rc.ledger.snapshot()
            if (not snap["violations"] and not snap["borrowed"]
                    and not any(snap["windows"].values())):
                break
            time.sleep(0.02)
        rc.ledger.assert_balanced(drain=_sweep_deferred_pools)

    def test_echo_equivalence_workers0_vs_2(self, shard_flags):
        """Same requests, byte-identical answers, shard plane on or off."""
        cases = [(f"m{i}", bytes([i]) * (i * 97)) for i in range(12)]

        def run(workers):
            flags.set_flag("tpu_shard_workers", workers)
            srv = _echo_server()
            try:
                plane = srv._shard_plane
                if workers:
                    assert plane is not None and plane.wait_ready(READY_S)
                else:
                    assert plane is None    # the 0 default is a strict no-op
                stub = _stub_for(srv)
                out = []
                for msg, payload in cases:
                    cntl = Controller()
                    cntl.request_attachment = payload
                    r = stub.Echo(echo_pb2.EchoRequest(message=msg,
                                                       payload=payload),
                                  controller=cntl)
                    out.append((r.SerializeToString(),
                                bytes(cntl.response_attachment)))
                if workers:
                    assert plane.forwarded == len(cases)
                    assert plane.fallback == 0
                return out
            finally:
                _stop(srv)

        assert run(0) == run(2)

    def test_two_worker_soak_no_lost_or_dup(self, shard_flags, checker):
        """4 client threads x 40 unique calls over 2 workers: every reply
        matches its request, both workers dispatched, zero fallbacks, and
        the armed CreditLedger balances at teardown."""
        srv = _echo_server()
        try:
            plane = srv._shard_plane
            assert plane.wait_ready(READY_S)
            stub = _stub_for(srv)
            errors_ = []

            def client(tid):
                try:
                    for i in range(40):
                        msg = f"t{tid}-{i}"
                        body = (msg.encode() * 9)[:200]
                        cntl = Controller()
                        cntl.request_attachment = body
                        r = stub.Echo(echo_pb2.EchoRequest(message=msg),
                                      controller=cntl)
                        assert r.message == msg, (r.message, msg)
                        assert bytes(cntl.response_attachment) == body
                except BaseException as e:  # noqa: BLE001
                    errors_.append(e)

            ts = [threading.Thread(target=client, args=(i,),
                                   name=f"soak-client-{i}")
                  for i in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(60)
            assert not any(t.is_alive() for t in ts)
            assert not errors_, errors_[:3]
            assert plane.forwarded == 160
            assert plane.fallback == 0
            deadline = time.monotonic() + 5.0    # W_STATS lags ~0.5s
            while time.monotonic() < deadline:
                per_worker = [w["dispatched"]
                              for w in plane.state_dict()["workers"]]
                if all(d > 0 for d in per_worker) \
                        and sum(per_worker) >= 160:
                    break
                time.sleep(0.05)
            assert all(d > 0 for d in per_worker), per_worker
            assert sum(per_worker) >= 160, per_worker
        finally:
            _stop(srv)
        self._wait_ledger_clean()

    def test_bulk_response_uses_leased_segments(self, shard_flags):
        """A 64KB echo flows back as W_RESP_SEGS: the worker fills leased
        client-pool blocks directly and the parent only posts indices."""
        srv = _echo_server()
        try:
            plane = srv._shard_plane
            assert plane.wait_ready(READY_S)
            stub = _stub_for(srv)
            payload = bytes(range(256)) * 256
            r = stub.Echo(echo_pb2.EchoRequest(message="bulk",
                                               payload=payload))
            assert r.payload == payload
            deadline = time.monotonic() + 5.0    # W_STATS lags ~0.5s
            while time.monotonic() < deadline:
                segs = sum(w["resp_segs"]
                           for w in plane.state_dict()["workers"])
                if segs:
                    break
                time.sleep(0.05)
            assert segs > 0, plane.state_dict()["workers"]
        finally:
            _stop(srv)

    def test_worker_crash_respawns_with_generation_bump(self, shard_flags):
        """``worker.crash`` chaos: the monitor reaps the corpse, fans
        retriable errors to its in-flight cids, reclaims its leases, and
        respawns it under a bumped generation — traffic keeps flowing."""
        from brpc_tpu_torch.shard import plane as port_plane

        flags.set_flag("fault_injection_enabled", True)
        deaths0 = port_plane.g_shard_worker_deaths.get_value()
        srv = _echo_server()
        try:
            plane = srv._shard_plane
            assert plane.wait_ready(READY_S)
            stub = _stub_for(srv, max_retry=3)
            for i in range(10):
                assert stub.Echo(
                    echo_pb2.EchoRequest(message=f"a{i}")).message == f"a{i}"
            pid0 = plane.workers[1].pid
            gen0 = plane.generation
            fault.arm("worker.crash", mode="oneshot", match={"worker": 1})
            deadline = time.monotonic() + 15.0
            while time.monotonic() < deadline and plane.generation == gen0:
                time.sleep(0.05)
            assert plane.generation > gen0, "worker death never observed"
            assert plane.wait_ready(READY_S), "respawn did not come back"
            w1 = plane.workers[1]
            assert w1.pid != pid0 and w1.gen == 1 and w1.respawns == 1
            assert port_plane.g_shard_worker_deaths.get_value() == deaths0 + 1
            for i in range(20):
                assert stub.Echo(
                    echo_pb2.EchoRequest(message=f"b{i}")).message == f"b{i}"
            assert plane.state_dict()["workers"][1]["inflight_cids"] == 0
        finally:
            fault.disarm_all()
            flags.set_flag("fault_injection_enabled", False)
            _stop(srv)

    def test_crash_during_a_soak_loses_nothing(self, shard_flags):
        """``worker.crash`` while 4 clients keep calling (max_retry 3, the
        reference test's setting): every call answers its own message.
        Of the dead worker's unanswered calls, those it never took run in
        the parent and those it took get the retriable EFAILEDSOCKET,
        which the port's Channel retries (the reference's Channel does
        not retry an error that arrives in a response: there they fail)."""
        flags.set_flag("fault_injection_enabled", True)
        srv = _echo_server()
        stop = threading.Event()
        errs, done = [], [0] * 4
        try:
            plane = srv._shard_plane
            assert plane.wait_ready(READY_S)
            stub = _stub_for(srv, max_retry=3)

            def client(tid):
                i = 0
                while not stop.is_set():
                    msg = f"c{tid}-{i}"
                    try:
                        r = stub.Echo(echo_pb2.EchoRequest(message=msg))
                        assert r.message == msg, (r.message, msg)
                    except BaseException as e:  # noqa: BLE001
                        errs.append(e)
                        return
                    i += 1
                    done[tid] = i

            ts = [threading.Thread(target=client, args=(i,),
                                   name=f"crash-soak-{i}")
                  for i in range(4)]
            for t in ts:
                t.start()
            time.sleep(0.3)
            gen0 = plane.generation
            fault.arm("worker.crash", mode="oneshot", match={"worker": 0})
            deadline = time.monotonic() + 15.0
            while time.monotonic() < deadline and plane.generation == gen0:
                time.sleep(0.02)
            time.sleep(0.5)
            stop.set()
            for t in ts:
                t.join(30)
            assert plane.generation == gen0 + 1
            assert not errs, errs[:3]
            assert all(done), done
            assert plane.wait_ready(READY_S)
            assert all(w["inflight_cids"] == 0
                       for w in plane.state_dict()["workers"])
        finally:
            stop.set()
            fault.disarm_all()
            flags.set_flag("fault_injection_enabled", False)
            _stop(srv)

    @pytest.mark.parametrize("max_retry", [0, 1])
    def test_a_call_the_dead_worker_took_runs_again_only_on_retry(
            self, shard_flags, tmp_path, monkeypatch, max_retry):
        """A non-idempotent call that a worker took off its ring and ran,
        killed before it answered: at max_retry 0 the caller gets the
        retriable EFAILEDSOCKET and the handler ran once (at most once);
        at max_retry 1 the Channel retries it, as the caller asked, and it
        ran twice."""
        runs = tmp_path / "runs"
        monkeypatch.setenv("BRPC_TPU_SHARD_RUNS", str(runs))
        srv = _counting_server()
        try:
            plane = srv._shard_plane
            assert plane.wait_ready(READY_S)
            stub = _stub_for(srv, max_retry=max_retry)
            gen, errors0 = plane.generation, plane.death_errors
            redispatched0 = plane.redispatched
            out = {}
            t = threading.Thread(target=_call_into,
                                 args=(stub, "slow-1", out),
                                 name="slow-call")
            t.start()
            pids = {w.pid: w for w in plane.workers}
            deadline = time.monotonic() + 15.0
            while time.monotonic() < deadline and not _runs(runs, "slow-1"):
                time.sleep(0.01)
            taker = _runs(runs, "slow-1")
            assert len(taker) == 1 and taker[0] in pids, taker
            os.kill(taker[0], signal.SIGKILL)
            t.join(30)
            assert not t.is_alive()
            assert plane.wait_ready(READY_S)
            assert plane.generation == gen + 1
            time.sleep(0.3)  # nothing more may run it
            ran = _runs(runs, "slow-1")
            if max_retry:
                assert out == {"message": "slow-1"}
                assert len(ran) == 2 and ran[0] == taker[0], ran
            else:
                assert out == {"error": errors.EFAILEDSOCKET}
                assert ran == taker
            assert plane.death_errors == errors0 + 1
            assert plane.redispatched == redispatched0
        finally:
            _stop(srv)

    def test_a_call_the_dead_worker_never_took_runs_once_in_the_parent(
            self, shard_flags, tmp_path, monkeypatch):
        """Both workers stopped (SIGSTOP), so a forwarded call waits in a
        ring no one reads; its worker is killed: the parent runs it,
        once, and the max_retry 0 caller gets its answer."""
        runs = tmp_path / "runs"
        monkeypatch.setenv("BRPC_TPU_SHARD_RUNS", str(runs))
        srv = _counting_server()
        try:
            plane = srv._shard_plane
            assert plane.wait_ready(READY_S)
            stub = _stub_for(srv, max_retry=0)
            redispatched0 = plane.redispatched
            stopped = [w.pid for w in plane.workers]
            for pid in stopped:
                os.kill(pid, signal.SIGSTOP)
            out = {}
            t = threading.Thread(target=_call_into,
                                 args=(stub, "once-1", out),
                                 name="once-call")
            try:
                t.start()
                deadline = time.monotonic() + 15.0
                taker = []
                while time.monotonic() < deadline and not taker:
                    taker = [w for w in plane.workers if w.inflight]
                    time.sleep(0.01)
                assert len(taker) == 1
                os.kill(taker[0].pid, signal.SIGKILL)
                t.join(30)
            finally:
                for pid in stopped:
                    try:
                        os.kill(pid, signal.SIGCONT)
                    except ProcessLookupError:
                        pass
            assert not t.is_alive()
            assert out == {"message": "once-1"}
            assert plane.wait_ready(READY_S)
            time.sleep(0.3)
            assert _runs(runs, "once-1") == [os.getpid()]
            assert plane.redispatched == redispatched0 + 1
        finally:
            _stop(srv)

    def test_shutdown_leaves_no_stale_shm(self, shard_flags):
        before = _shard_shm_segments()
        srv = _echo_server()
        plane = srv._shard_plane
        try:
            assert plane.wait_ready(READY_S)
            pids = [w.pid for w in plane.workers]
            stub = _stub_for(srv)
            assert stub.Echo(echo_pb2.EchoRequest(message="x")).message == "x"
            mid = _shard_shm_segments(pids)
            assert len(mid - before) >= 4    # 2 rings per worker while up
        finally:
            _stop(srv)
        assert _shard_shm_segments(pids) - before == set()
        for pid in pids:                     # and no worker outlives it
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)

    def test_workers_are_spawned_off_the_card(self, shard_flags):
        """Workers are dispatch-only: the plane spawns them with
        CUDA_VISIBLE_DEVICES defaulted to empty."""
        srv = _echo_server()
        try:
            plane = srv._shard_plane
            assert plane.wait_ready(READY_S)
            for w in plane.workers:
                with open(f"/proc/{w.pid}/environ", "rb") as f:
                    env = f.read().split(b"\0")
                want = os.environ.get("CUDA_VISIBLE_DEVICES", "")
                assert f"CUDA_VISIBLE_DEVICES={want}".encode() in env
                with open(f"/proc/{w.pid}/cmdline", "rb") as f:
                    assert b"brpc_tpu_torch.shard.worker" in f.read()
        finally:
            _stop(srv)

    def test_tpu_builtin_reports_shard_section(self, shard_flags):
        """/tpu?format=json carries the plane: per-worker pid/role/lease
        occupancy/respawn generation."""
        import json as _json

        from brpc_tpu_torch.builtin import services as _builtin

        srv = _echo_server()
        try:
            plane = srv._shard_plane
            assert plane.wait_ready(READY_S)
            stub = _stub_for(srv)
            assert stub.Echo(echo_pb2.EchoRequest(message="s")).message == "s"

            class _Http:
                path = "/tpu"
                query = {"format": "json"}

                def header(self, k, default=""):
                    return default

            status, _, body = _builtin.tpu_service(srv, _Http())
            assert status == 200
            shard = _json.loads(body)["shard"]
            assert shard["workers_configured"] == 2
            assert len(shard["workers"]) == 2
            for i, w in enumerate(shard["workers"]):
                assert w["index"] == i and w["alive"]
                assert w["pid"] > 0 and w["role"] == f"worker:{i}"
            _Http.query = {}
            status, _, text = _builtin.tpu_service(srv, _Http())
            assert status == 200 and "== shard plane ==" in text
        finally:
            _stop(srv)

    def test_jax_client_over_the_tunnel_to_a_port_sharded_server(
            self, shard_flags):
        """The JAX package's Channel dials the port's sharded tunnel: its
        unary echoes are answered by the port's workers, and the response
        bytes equal the port client's for the same requests."""
        srv = _echo_server()
        try:
            plane = srv._shard_plane
            assert plane.wait_ready(READY_S)
            ep = str(srv.listen_endpoint())
            rng = np.random.default_rng(5)
            cases = [(f"j{i}", rng.integers(0, 256, n, dtype=np.uint8)
                      .tobytes()) for i, n in
                     enumerate((0, 64, 4096, 20000, 65536))]
            port_stub = _stub_for(srv)
            jax_stub = jax_rpc.Stub(jax_rpc.Channel(jax_rpc.ChannelOptions(
                protocol="trpc_std", timeout_ms=20000)).init(ep),
                jax_echo.DESCRIPTOR.services_by_name["EchoService"])
            before = plane.forwarded
            for msg, payload in cases:
                got = jax_stub.Echo(jax_echo.EchoRequest(
                    message=msg, payload=payload))
                want = port_stub.Echo(echo_pb2.EchoRequest(
                    message=msg, payload=payload))
                assert got.payload == payload
                assert got.SerializeToString() == want.SerializeToString()
            assert plane.forwarded - before == 2 * len(cases)
            assert plane.fallback == 0
        finally:
            _stop(srv)
