"""The port's fast call path on its native engine, on the cases of
``tests/test_fastpath.py`` (engine-parsed EV_REQUEST/EV_RESPONSE events,
native request/response packing with dp_call/dp_respond, fast-call
records, native-service admission and status, the zero-copy tunnel
response; and the Python lane's adaptive spin, run-to-completion,
doorbell coalescing and priority lane), of ``tests/test_sync_park.py``
(sync callers parked in the engine) and the native cases of
``tests/test_conntypes.py`` (pooled and short connections on the engine).

The fast lane must be semantically indistinguishable from the full
Controller pipeline for plain unary RPCs; these tests pin that contract.
"""

import threading
import time

import pytest

from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Controller, Server,
                          ServerOptions, Service, Stub)
from brpc_tpu_torch.rpc.channel import MethodDescriptor, RpcError
from brpc_tpu_torch.rpc import errors

SVC = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]


class EchoImpl(Service):
    DESCRIPTOR = SVC

    def Echo(self, cntl, request, done):
        cntl.response_attachment = cntl.request_attachment
        return echo_pb2.EchoResponse(message=request.message,
                                     payload=request.payload)


def _fast_channel(ep, **kw):
    kw.setdefault("timeout_ms", 5000)
    ch = Channel(ChannelOptions(protocol="trpc_std",
                                native_transport=True, **kw))
    ch.init(str(ep))
    return ch


@pytest.fixture()
def native_server():
    srv = Server(ServerOptions(native_dataplane=True))
    srv.add_service(EchoImpl())
    srv.start("127.0.0.1:0")
    yield srv
    srv.stop()
    srv.join()


def test_fast_sync_echo(native_server):
    ch = _fast_channel(native_server.listen_endpoint())
    stub = Stub(ch, SVC)
    for i in range(10):
        r = stub.Echo(echo_pb2.EchoRequest(message=f"m{i}"))
        assert r.message == f"m{i}"


def test_null_method_control_answers_in_the_poll_loop(native_server):
    # the benchmark control: the raw request body comes back as the
    # response, and neither the Python handler nor any method status runs
    native_server.register_null_method("EchoService", "Echo")
    stub = Stub(_fast_channel(native_server.listen_endpoint()), SVC)
    for i in range(20):
        req = echo_pb2.EchoRequest(message=f"n{i}", payload=b"\x07" * i)
        r = stub.Echo(req)
        assert (r.message, r.payload) == (req.message, req.payload)
    entry = native_server.find_service("EchoService").find_method("Echo")
    assert entry.latency.count() == 0
    assert native_server.native_method_stats() == []


def test_fast_attachment_roundtrip(native_server):
    ch = _fast_channel(native_server.listen_endpoint())
    stub = Stub(ch, SVC)
    cntl = Controller()
    cntl.request_attachment = b"\x01\x02" * 500
    stub.Echo(echo_pb2.EchoRequest(message="a"), controller=cntl)
    assert cntl.response_attachment == b"\x01\x02" * 500
    assert cntl.latency_us > 0


def test_fast_big_response_via_donated_frame(native_server):
    # >=64KB responses arrive as donated EV_FRAME buffers; the fast record
    # must still complete through the frame path
    ch = _fast_channel(native_server.listen_endpoint())
    stub = Stub(ch, SVC)
    cntl = Controller()
    cntl.request_attachment = b"\xee" * (256 << 10)
    stub.Echo(echo_pb2.EchoRequest(message="big"), controller=cntl)
    assert cntl.response_attachment == b"\xee" * (256 << 10)


def test_fast_unknown_service_and_method(native_server):
    ch = _fast_channel(native_server.listen_endpoint())
    md = MethodDescriptor("NoSuchService", "Echo",
                          echo_pb2.EchoRequest, echo_pb2.EchoResponse)
    with pytest.raises(RpcError) as ei:
        ch.call_method(md, echo_pb2.EchoRequest(message="x"))
    assert ei.value.error_code == errors.ENOSERVICE
    md2 = MethodDescriptor("EchoService", "Nope",
                           echo_pb2.EchoRequest, echo_pb2.EchoResponse)
    with pytest.raises(RpcError) as ei:
        ch.call_method(md2, echo_pb2.EchoRequest(message="x"))
    assert ei.value.error_code == errors.ENOMETHOD


def test_fast_async_done(native_server):
    ch = _fast_channel(native_server.listen_endpoint())
    stub = Stub(ch, SVC)
    ev = threading.Event()
    seen = {}

    def done(cntl):
        seen["code"] = cntl.error_code
        seen["resp"] = cntl.response
        seen["att"] = cntl.response_attachment
        ev.set()

    stub.Echo(echo_pb2.EchoRequest(message="async"), done=done)
    assert ev.wait(5)
    assert seen["code"] == errors.OK
    assert seen["resp"].message == "async"


def test_fast_async_big_response_pointer_record(native_server):
    # an ASYNC caller with a >=64KB response: the donated EV_FRAME rides
    # dp_poll_packed as a POINTER record (not inlined) and must complete
    # the rec through _process_frame; also pins join-after-done semantics
    ch = _fast_channel(native_server.listen_endpoint())
    stub = Stub(ch, SVC)
    ev = threading.Event()
    seen = {}

    def done(cntl):
        seen["att"] = cntl.response_attachment
        seen["cntl"] = cntl
        ev.set()

    cntl = Controller()
    cntl.request_attachment = b"\xa5" * (512 << 10)
    stub.Echo(echo_pb2.EchoRequest(message="big"), controller=cntl,
              done=done)
    assert ev.wait(10)
    assert seen["att"] == b"\xa5" * (512 << 10)
    assert seen["cntl"].join(1)  # post-completion join returns immediately


def test_fast_concurrent_joiners_share_one_event():
    # two threads joining one in-flight async call must BOTH wake (the
    # lazy join-event install is guarded; a lost event would hang one)
    held = []
    entered = threading.Event()

    class Holder(Service):
        DESCRIPTOR = SVC

        def Echo(self, cntl, request, done):
            held.append(done)  # answer later from another thread
            entered.set()

    srv = Server(ServerOptions(native_dataplane=True))
    srv.add_service(Holder())
    srv.start("127.0.0.1:0")
    try:
        ch = _fast_channel(srv.listen_endpoint())
        stub = Stub(ch, SVC)
        cntl = Controller()
        stub.Echo(echo_pb2.EchoRequest(message="j"), controller=cntl,
                  done=lambda _c: None)
        assert entered.wait(5)
        results = []
        ts = [threading.Thread(target=lambda: results.append(
            cntl.join(10))) for _ in range(2)]
        for t in ts:
            t.start()
        time.sleep(0.2)  # both joiners parked on the lazy event
        held[0](echo_pb2.EchoResponse(message="late"))
        for t in ts:
            t.join(10)
        assert results == [True, True]
    finally:
        srv.stop()
        srv.join(timeout=5)


def test_fast_timeout_held_done(native_server):
    held = []

    class Holder(Service):
        DESCRIPTOR = SVC

        def Echo(self, cntl, request, done):
            held.append(done)  # never respond: client must time out
            return None

    srv2 = Server(ServerOptions(native_dataplane=True))
    srv2.add_service(Holder())
    srv2.start("127.0.0.1:0")
    try:
        ch = _fast_channel(srv2.listen_endpoint(), timeout_ms=300)
        stub = Stub(ch, SVC)
        t0 = time.monotonic()
        with pytest.raises(RpcError) as ei:
            stub.Echo(echo_pb2.EchoRequest(message="never"))
        assert ei.value.error_code == errors.ERPCTIMEDOUT
        assert time.monotonic() - t0 < 3.0
    finally:
        for d in held:
            d(None)
        srv2.stop()
        srv2.join()


def test_fast_async_timeout_swept(native_server):
    held = []

    class Holder(Service):
        DESCRIPTOR = SVC

        def Echo(self, cntl, request, done):
            held.append(done)
            return None

    srv2 = Server(ServerOptions(native_dataplane=True))
    srv2.add_service(Holder())
    srv2.start("127.0.0.1:0")
    try:
        ch = _fast_channel(srv2.listen_endpoint(), timeout_ms=200)
        stub = Stub(ch, SVC)
        ev = threading.Event()
        seen = {}

        def done(cntl):
            seen["code"] = cntl.error_code
            ev.set()

        stub.Echo(echo_pb2.EchoRequest(message="x"), done=done)
        # the poller's coarse deadline sweep must fire the timeout
        assert ev.wait(5)
        assert seen["code"] == errors.ERPCTIMEDOUT
    finally:
        for d in held:
            d(None)
        srv2.stop()
        srv2.join()


def test_fast_elogoff_after_stop(native_server):
    ch = _fast_channel(native_server.listen_endpoint(), max_retry=0)
    stub = Stub(ch, SVC)
    stub.Echo(echo_pb2.EchoRequest(message="warm"))
    native_server.stop()
    with pytest.raises(RpcError) as ei:
        stub.Echo(echo_pb2.EchoRequest(message="rejected"))
    # logoff either rejects at admission or (if teardown already closed
    # the conn) surfaces as a socket failure
    assert ei.value.error_code in (errors.ELOGOFF, errors.EFAILEDSOCKET)


def test_fast_method_concurrency_limit():
    release = threading.Event()
    entered = threading.Event()

    class Slow(Service):
        DESCRIPTOR = SVC

        def Echo(self, cntl, request, done):
            entered.set()
            held_done.append(done)
            return None  # respond later

    held_done = []
    srv = Server(ServerOptions(native_dataplane=True))
    svc = Slow()
    srv.add_service(svc)
    svc.find_method("Echo").max_concurrency = 1
    srv.start("127.0.0.1:0")
    try:
        ch = _fast_channel(srv.listen_endpoint(), max_retry=0,
                           timeout_ms=3000)
        stub = Stub(ch, SVC)
        ev = threading.Event()
        first = {}

        def done1(cntl):
            first["code"] = cntl.error_code
            ev.set()

        stub.Echo(echo_pb2.EchoRequest(message="one"), done=done1)
        assert entered.wait(5)
        with pytest.raises(RpcError) as ei:
            stub.Echo(echo_pb2.EchoRequest(message="two"))
        assert ei.value.error_code == errors.ELIMIT
        for d in held_done:
            d(echo_pb2.EchoResponse(message="late"))
        assert ev.wait(5)
        assert first["code"] == errors.OK
        release.set()
    finally:
        srv.stop()
        srv.join()


def test_fast_trace_propagation(native_server):
    # force sampling so the fast path carries trace ids natively
    from brpc_tpu_torch.metrics import collector as _collector
    from brpc_tpu_torch.trace import span as _span

    _span.reset_for_test()
    coll = _collector.global_collector()
    old_rate = coll._fixed_rate
    coll._fixed_rate = 10 ** 9
    coll._deny_until = 0.0
    try:
        ch = _fast_channel(native_server.listen_endpoint())
        stub = Stub(ch, SVC)
        r = stub.Echo(echo_pb2.EchoRequest(message="traced"))
        assert r.message == "traced"
        # the server span ends on its dispatch worker: wait for it, bounded
        deadline = time.monotonic() + 5
        while True:
            spans = _span.recent_spans(50)
            # client and server spans of the same trace must both exist
            client_spans = [s for s in spans if s.kind == _span.KIND_CLIENT
                            and s.method == "Echo"]
            server_spans = [s for s in spans if s.kind == _span.KIND_SERVER
                            and s.method == "Echo"]
            if (client_spans and server_spans) or \
                    time.monotonic() > deadline:
                break
            threading.Event().wait(0.02)
        kinds = {(s.kind, s.service) for s in spans}
        assert client_spans and server_spans, (kinds, spans)
        tids = {s.trace_id for s in client_spans}
        assert any(s.trace_id in tids for s in server_spans)
    finally:
        coll._fixed_rate = old_rate


def test_slow_path_call_on_fast_conn(native_server):
    # a full-Controller call (backup_request forces the slow path) on a
    # fast conn completes through the EV_RESPONSE reconstruct route
    ch = Channel(ChannelOptions(protocol="trpc_std", timeout_ms=5000,
                                native_transport=True,
                                backup_request_ms=60000))
    ch.init(str(native_server.listen_endpoint()))
    stub = Stub(ch, SVC)
    r = stub.Echo(echo_pb2.EchoRequest(message="slowlane"))
    assert r.message == "slowlane"


def test_native_echo_admission_and_stats():
    srv = Server(ServerOptions(native_dataplane=True))
    srv.add_service(EchoImpl())
    srv.start("127.0.0.1:0")
    srv.register_native_echo("EchoService", "Echo")
    try:
        ch = _fast_channel(srv.listen_endpoint(), max_retry=0)
        stub = Stub(ch, SVC)
        for i in range(5):
            r = stub.Echo(echo_pb2.EchoRequest(message=f"n{i}"))
            assert r.message == f"n{i}"
        stats = srv.native_method_stats()
        assert stats, "native method stats missing"
        _, _, st = stats[0]
        assert st["requests"] >= 5
        assert st["errors"] == 0
        assert st["latency_max_us"] >= 0.0
        # graceful stop: native admission answers ELOGOFF
        srv.stop()
        with pytest.raises(RpcError) as ei:
            stub.Echo(echo_pb2.EchoRequest(message="x"))
        assert ei.value.error_code in (errors.ELOGOFF, errors.EFAILEDSOCKET)
        if ei.value.error_code == errors.ELOGOFF:
            st2 = srv.native_method_stats()[0][2]
            assert st2["errors"] >= 1
    finally:
        srv.stop()
        srv.join()


def test_fast_usercode_inline_server():
    srv = Server(ServerOptions(native_dataplane=True, usercode_inline=True))
    srv.add_service(EchoImpl())
    srv.start("127.0.0.1:0")
    try:
        ch = _fast_channel(srv.listen_endpoint())
        stub = Stub(ch, SVC)
        for i in range(20):
            assert stub.Echo(echo_pb2.EchoRequest(message=str(i))).message \
                == str(i)
    finally:
        srv.stop()
        srv.join()


def test_fast_zero_copy_tunnel_response():
    # tpu:// native tunnel: big responses arrive as zero-copy pool views
    # (EV_RESPONSE_ZC) and the credits must flow back (repeat calls would
    # wedge if ACKs leaked)
    srv = Server(ServerOptions(native_dataplane=True))
    srv.add_service(EchoImpl())
    srv.start("tpu://127.0.0.1:0/0")
    try:
        ch = _fast_channel(srv.listen_endpoint(), timeout_ms=20000)
        stub = Stub(ch, SVC)
        blob = bytes(range(256)) * 1024  # 256KB, content-checkable
        for _ in range(12):  # > block count pressure: credits must recycle
            cntl = Controller()
            cntl.request_attachment = blob
            r = stub.Echo(echo_pb2.EchoRequest(message="zc"),
                          controller=cntl)
            assert r.message == "zc"
            assert cntl.response_attachment == blob
    finally:
        srv.stop()
        srv.join()


def test_native_echo_zero_copy_tunnel():
    srv = Server(ServerOptions(native_dataplane=True))
    srv.add_service(EchoImpl())
    srv.start("tpu://127.0.0.1:0/0")
    srv.register_native_echo("EchoService", "Echo")
    try:
        ch = _fast_channel(srv.listen_endpoint(), timeout_ms=20000)
        stub = Stub(ch, SVC)
        blob = b"\x5a" * (1 << 20)
        for _ in range(6):
            cntl = Controller()
            cntl.request_attachment = blob
            stub.Echo(echo_pb2.EchoRequest(message="n"), controller=cntl)
            assert cntl.response_attachment == blob
        st = srv.native_method_stats()[0][2]
        assert st["requests"] >= 6
    finally:
        srv.stop()
        srv.join()


def test_zero_copy_rejections_return_credits():
    # admission-rejected bulk requests must still ACK the donated blocks;
    # a credit leak would wedge the tunnel after ~window/block_count
    # rejections (regression for the round-3 review finding)
    srv = Server(ServerOptions(native_dataplane=True))
    srv.add_service(EchoImpl())
    srv.start("tpu://127.0.0.1:0/0")
    srv.register_native_echo("EchoService", "Echo")
    ch = _fast_channel(srv.listen_endpoint(), timeout_ms=8000, max_retry=0)
    stub = Stub(ch, SVC)
    blob = b"\x11" * (1 << 20)
    cntl = Controller()
    cntl.request_attachment = blob
    stub.Echo(echo_pb2.EchoRequest(message="warm"), controller=cntl)
    srv.stop()  # native admission now answers ELOGOFF
    try:
        rejected = 0
        conn_dead = False
        for _ in range(80):  # 80MB of donated blocks >> the 16MB window
            c2 = Controller()
            c2.request_attachment = blob
            try:
                stub.Echo(echo_pb2.EchoRequest(message="x"), controller=c2)
            except RpcError as e:
                if e.error_code == errors.ERPCTIMEDOUT:
                    pytest.fail("tunnel wedged: rejection leaked its "
                                "donated blocks' credits")
                if e.error_code == errors.ELOGOFF:
                    rejected += 1
                else:
                    conn_dead = True  # teardown variance: fail-fast is fine
                    break
        # every outcome must be prompt: a long run of ELOGOFFs proves the
        # credits recycled; a fast conn failure proves nothing hung
        assert conn_dead or rejected >= 40, (rejected, conn_dead)
    finally:
        srv.stop()
        srv.join()


def test_fast_retry_after_server_restart():
    srv = Server(ServerOptions(native_dataplane=True))
    srv.add_service(EchoImpl())
    srv.start("127.0.0.1:0")
    ep = srv.listen_endpoint()
    ch = _fast_channel(ep, timeout_ms=2000)
    stub = Stub(ch, SVC)
    assert stub.Echo(echo_pb2.EchoRequest(message="a")).message == "a"
    srv.stop()
    srv.join()
    # server gone: calls fail fast (retry budget burns on dead conns)
    with pytest.raises(RpcError):
        stub.Echo(echo_pb2.EchoRequest(message="b"))


# ======================================================================
# Pure-Python small-message fastpath (no native engine required): the
# adaptive spin wakeup, run-to-completion dispatch, coalesced doorbells,
# and the priority lane. These pin the PR's latency-stack semantics.
# ======================================================================

from brpc_tpu_torch import flags as _flags  # noqa: E402
from brpc_tpu_torch.fiber import wakeup as _wakeup  # noqa: E402
from brpc_tpu_torch.rpc import run_to_completion as _rtc  # noqa: E402


@pytest.fixture()
def rtc_reset():
    """Classification starts clean, and with no allocation tracing: a
    test elsewhere in the process (the JAX package's heap page,
    ``tests/test_profiling.py``) can leave tracemalloc on, which makes
    every handler here several times slower and the timing-based
    classification under test never calls the echo cheap. Tracing is
    put back as it was found."""
    import tracemalloc

    tracing = tracemalloc.is_tracing()
    frames = tracemalloc.get_traceback_limit()
    if tracing:
        tracemalloc.stop()
    _rtc._reset_for_test()
    yield
    _rtc._reset_for_test()
    if tracing:
        tracemalloc.start(frames)


# ------------------------------------------------------- adaptive spin
class TestAdaptiveSpin:
    def test_budget_grows_on_wins(self):
        s = _wakeup.AdaptiveSpin("t_grow", initial=8, floor=1, ceiling=64)
        assert s.spin(lambda: True)
        assert s.budget > 8
        for _ in range(20):
            s.spin(lambda: True)
        assert s.budget == 64  # clamped at the ceiling

    def test_budget_shrinks_to_floor_on_losses(self):
        s = _wakeup.AdaptiveSpin("t_shrink", initial=64, floor=2,
                                 ceiling=256)
        for _ in range(20):
            assert not s.spin(lambda: False)
        assert s.budget == 2  # halved down to the probe floor

    def test_win_inside_window_observed_mid_spin(self):
        s = _wakeup.AdaptiveSpin("t_mid", initial=32, floor=1, ceiling=64)
        calls = {"n": 0}

        def ready():
            calls["n"] += 1
            return calls["n"] >= 5  # wake arrives on the 5th probe

        assert s.spin(ready)
        assert s.budget > 32

    def test_stats_counters_move(self):
        before = _wakeup.stats()
        s = _wakeup.get_spin("t_stats", initial=4)
        s.spin(lambda: True)
        s.spin(lambda: False)
        after = _wakeup.stats()
        assert after["spin_wins"] >= before["spin_wins"] + 1
        assert after["spin_losses"] >= before["spin_losses"] + 1
        assert after["parks"] >= before["parks"] + 1
        assert "t_stats" in after["budgets"]


# -------------------------------------------------- run-to-completion
class TestRunToCompletion:
    def test_auto_classified_cheap_method_runs_inline(self, rtc_reset):
        srv = Server(ServerOptions())
        srv.add_service(EchoImpl())
        srv.start("127.0.0.1:0")
        try:
            ch = Channel(ChannelOptions(protocol="trpc_std",
                                        timeout_ms=5000))
            ch.init(str(srv.listen_endpoint()))
            stub = Stub(ch, SVC)
            # MIN_SAMPLES queued observations feed the EMA, then the
            # method is classified cheap and later calls run inline
            for i in range(_rtc.MIN_SAMPLES + 12):
                r = stub.Echo(echo_pb2.EchoRequest(message=f"c{i}"))
                assert r.message == f"c{i}"
            st = _rtc.method_stats()["EchoService.Echo"]
            assert st["samples"] >= _rtc.MIN_SAMPLES
            assert st["hits"] > 0, st
            assert not st["demoted"], st
            assert 0 < st["ema_us"] < float(_flags.get("rtc_cheap_us")), st
        finally:
            srv.stop()
            srv.join()

    def test_slow_opted_in_handler_is_demoted(self, rtc_reset):
        budget_s = float(_flags.get("rtc_budget_us")) / 1e6

        class SlowEcho(Service):
            DESCRIPTOR = SVC

            @_rtc.inline_eligible
            def Echo(self, cntl, request, done):
                time.sleep(budget_s * 2)  # always overruns the budget
                return echo_pb2.EchoResponse(message=request.message)

        srv = Server(ServerOptions())
        srv.add_service(SlowEcho())
        srv.start("127.0.0.1:0")
        try:
            ch = Channel(ChannelOptions(protocol="trpc_std",
                                        timeout_ms=10000))
            ch.init(str(srv.listen_endpoint()))
            stub = Stub(ch, SVC)
            for i in range(_rtc.DEMOTE_AFTER + 3):
                stub.Echo(echo_pb2.EchoRequest(message=f"s{i}"))
            st = _rtc.method_stats()["EchoService.Echo"]
            assert st["opted_in"], st
            # ran inline (opt-in skips the warmup), overran, got demoted
            assert st["hits"] >= _rtc.DEMOTE_AFTER, st
            assert st["demoted"], st
            assert st["demotions"] >= 1, st
            # demotion is sticky: later calls still answer correctly
            r = stub.Echo(echo_pb2.EchoRequest(message="after"))
            assert r.message == "after"
            assert _rtc.method_stats()["EchoService.Echo"]["hits"] \
                == st["hits"]
        finally:
            srv.stop()
            srv.join()

    def test_small_echo_identical_on_both_dispatch_paths(self, rtc_reset):
        """The run-to-completion lane must be semantically invisible:
        the same small echo answers identically with rtc on and off."""
        srv = Server(ServerOptions())
        srv.add_service(EchoImpl())
        srv.start("127.0.0.1:0")
        try:
            results = {}
            for enabled in (True, False):
                _flags.set_flag("rtc_enable", enabled)
                _rtc._reset_for_test()
                ch = Channel(ChannelOptions(protocol="trpc_std",
                                            timeout_ms=5000))
                ch.init(str(srv.listen_endpoint()))
                stub = Stub(ch, SVC)
                out = []
                for i in range(_rtc.MIN_SAMPLES + 4):
                    cntl = Controller()
                    cntl.request_attachment = b"att-%d" % i
                    r = stub.Echo(echo_pb2.EchoRequest(
                        message=f"d{i}", payload=b"\x7f" * 64),
                        controller=cntl)
                    out.append((r.message, bytes(r.payload),
                                bytes(cntl.response_attachment)))
                results[enabled] = out
            assert results[True] == results[False]
            # and the disabled run really stayed off the inline lane
            assert _rtc.method_stats().get(
                "EchoService.Echo", {}).get("hits", 0) == 0
        finally:
            _flags.set_flag("rtc_enable", True)
            srv.stop()
            srv.join()


# --------------------------------------- doorbells + credits (ledger)
class TestDoorbellCoalescing:
    def test_coalesced_doorbells_return_all_credits(self, rtc_reset):
        """BRPC_TPU_CHECK-armed run over the shm tunnel: banked doorbell
        responses and batched FT_ACKs must balance the credit window at
        teardown (a leaked credit wedges the tunnel; the ledger turns it
        into a hard failure)."""
        from brpc_tpu_torch.analysis import runtime_check as rc
        from brpc_tpu_torch.tpu import transport as T

        was_active = rc.ACTIVE
        rc.activate()
        srv = Server(ServerOptions())
        srv.add_service(EchoImpl())
        srv.start("tpu://127.0.0.1:0/0")
        try:
            ch = Channel(ChannelOptions(protocol="trpc_std",
                                        timeout_ms=20000))
            ch.init(str(srv.listen_endpoint()))
            stub = Stub(ch, SVC)
            flushes0 = T.g_tunnel_doorbell_flushes.get_value()
            # small echoes: past MIN_SAMPLES the server answers on the
            # cut thread and its responses ride coalesced doorbells
            for i in range(_rtc.MIN_SAMPLES + 24):
                r = stub.Echo(echo_pb2.EchoRequest(message=f"db{i}"))
                assert r.message == f"db{i}"
            # bulk calls force pool borrows, so ACK credits must cycle
            blob = b"\x3c" * (256 << 10)
            for _ in range(4):
                cntl = Controller()
                cntl.request_attachment = blob
                stub.Echo(echo_pb2.EchoRequest(message="bulk"),
                          controller=cntl)
                assert cntl.response_attachment == blob
            assert T.g_tunnel_doorbell_flushes.get_value() > flushes0
            assert T.g_tunnel_doorbell_frames.get_value() >= \
                T.g_tunnel_doorbell_flushes.get_value()
        finally:
            srv.stop()
            srv.join()
            try:
                # every borrowed block returned, every credit released
                rc.ledger.assert_balanced(drain=T._sweep_deferred_pools)
            finally:
                if was_active:
                    rc.activate()
                else:
                    rc.deactivate()


# ------------------------------------------------------ priority lane
class TestPriorityLane:
    def test_small_calls_survive_concurrent_16mb_send(self, rtc_reset):
        """While a 16MB echo streams through the tunnel, small calls keep
        completing (the priority lane / coalesced doorbells bypass the
        bulk send) and the tunnel reports priority-lane traffic."""
        from brpc_tpu_torch.tpu import transport as T

        srv = Server(ServerOptions())
        srv.add_service(EchoImpl())
        srv.start("tpu://127.0.0.1:0/0")
        try:
            ch = Channel(ChannelOptions(protocol="trpc_std",
                                        timeout_ms=60000))
            ch.init(str(srv.listen_endpoint()))
            stub = Stub(ch, SVC)
            for i in range(_rtc.MIN_SAMPLES + 2):  # warm the rtc lane
                stub.Echo(echo_pb2.EchoRequest(message=f"w{i}"))

            pri0 = (T.g_tunnel_pri_tx_frames.get_value()
                    + T.g_tunnel_doorbell_frames.get_value())
            blob = b"\x99" * (16 << 20)
            bulk_err = []

            def bulk():
                try:
                    cntl = Controller()
                    cntl.request_attachment = blob
                    stub.Echo(echo_pb2.EchoRequest(message="bulk"),
                              controller=cntl)
                    assert cntl.response_attachment == blob
                except BaseException as e:  # surfaced after join
                    bulk_err.append(e)

            t = threading.Thread(target=bulk)
            t.start()
            lats = []
            deadline = time.monotonic() + 30
            # in-process loopback can finish the bulk echo quickly: keep
            # going until a few small calls have landed either way
            while ((t.is_alive() or len(lats) < 5)
                   and time.monotonic() < deadline):
                t0 = time.perf_counter()
                r = stub.Echo(echo_pb2.EchoRequest(message="tiny"))
                lats.append(time.perf_counter() - t0)
                assert r.message == "tiny"
            t.join(60)
            assert not t.is_alive(), "16MB echo wedged"
            assert not bulk_err, bulk_err
            assert lats, "no small call completed during the bulk send"
            lats.sort()
            # generous single-core bound: the lane exists so a small call
            # never waits out the whole 16MB transfer
            assert lats[len(lats) // 2] < 5.0, lats
            pri1 = (T.g_tunnel_pri_tx_frames.get_value()
                    + T.g_tunnel_doorbell_frames.get_value())
            assert pri1 > pri0, "no priority-lane/doorbell frame moved"
        finally:
            srv.stop()
            srv.join()


# ---------------------------------------------------------------------------
#  Sync callers parked in the engine (tests/test_sync_park.py)
# ---------------------------------------------------------------------------
class _ParkEcho(Service):
    DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]

    def Echo(self, cntl, request, done):
        if request.message == "compress":
            cntl.compress_type = 1  # gzip response -> Python fallback
        if request.message == "slow":
            time.sleep(0.5)
        if request.message == "big":
            cntl.response_attachment = b"\xcd" * (1 << 20)
        return echo_pb2.EchoResponse(message=request.message,
                                     payload=request.payload)


@pytest.fixture()
def park_server():
    srv = Server(ServerOptions(native_dataplane=True))
    srv.add_service(_ParkEcho())
    srv.start("127.0.0.1:0")
    yield srv
    srv.stop()
    srv.join(timeout=5)


def _park_stub(ep, **kw):
    kw.setdefault("timeout_ms", 5000)
    opts = ChannelOptions(protocol="trpc_std", native_transport=True, **kw)
    ch = Channel(opts)
    ch.init(str(ep))
    return Stub(ch, echo_pb2.DESCRIPTOR.services_by_name["EchoService"])


class TestEngineParkedSync:
    def test_engine_completed_roundtrip(self, park_server):
        stub = _park_stub(park_server.listen_endpoint())
        r = stub.Echo(echo_pb2.EchoRequest(message="hi", payload=b"p" * 100))
        assert r.message == "hi" and r.payload == b"p" * 100

    def test_compressed_response_python_fallback(self, park_server):
        # server compresses -> frame needs Python policy -> the parked
        # waiter completes via dp_sync_complete_py
        stub = _park_stub(park_server.listen_endpoint())
        r = stub.Echo(echo_pb2.EchoRequest(message="compress",
                                           payload=b"z" * 5000))
        assert r.message == "compress" and r.payload == b"z" * 5000

    def test_big_response_buffer_steal(self, park_server):
        stub = _park_stub(park_server.listen_endpoint())
        c = Controller()
        stub.Echo(echo_pb2.EchoRequest(message="big"), controller=c)
        assert len(c.response_attachment) == (1 << 20)
        assert c.response_attachment[:3] == b"\xcd\xcd\xcd"

    def test_deadline_maps_to_rpc_timeout(self, park_server):
        stub = _park_stub(park_server.listen_endpoint(), timeout_ms=100,
                     max_retry=0)
        with pytest.raises(RpcError) as ei:
            stub.Echo(echo_pb2.EchoRequest(message="slow"))
        assert ei.value.error_code == errors.ERPCTIMEDOUT

    def test_concurrent_parked_callers(self, park_server):
        stub = _park_stub(park_server.listen_endpoint())
        fails = []
        barrier = threading.Barrier(5)

        def worker(i):
            barrier.wait()
            try:
                for k in range(30):
                    msg = f"t{i}-{k}"
                    r = stub.Echo(echo_pb2.EchoRequest(message=msg))
                    assert r.message == msg
            except BaseException as e:  # noqa: BLE001 — re-raised below
                fails.append(e)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(5)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        if fails:
            raise fails[0]

    def test_server_stop_wakes_parked_caller(self, park_server):
        stub = _park_stub(park_server.listen_endpoint(), timeout_ms=10000)
        out = {}

        def call():
            try:
                stub.Echo(echo_pb2.EchoRequest(message="slow"))
                out["r"] = "ok"
            except RpcError as e:
                out["r"] = e.error_code

        w = threading.Thread(target=call)
        w.start()
        time.sleep(0.1)
        park_server.stop()
        w.join(15)
        assert not w.is_alive(), "parked caller never woke"
        # graceful drain may complete it OR it errors — never hangs
        assert out.get("r") is not None


# ---------------------------------------------------------------------------
#  Connection types on the engine (tests/test_conntypes.py, native=True)
# ---------------------------------------------------------------------------
class CountingEcho(Service):
    DESCRIPTOR = SVC

    def __init__(self):
        super().__init__()
        self.seen_peers = set()
        self._lock = threading.Lock()

    def Echo(self, cntl, request, done):
        with self._lock:
            self.seen_peers.add(str(cntl.peer))
        if request.sleep_us:
            time.sleep(request.sleep_us / 1e6)
        cntl.response_attachment = cntl.request_attachment
        return echo_pb2.EchoResponse(message=request.message,
                                     payload=request.payload)


def _ct_server(native=False):
    srv = Server(ServerOptions(native_dataplane=native))
    svc = CountingEcho()
    srv.add_service(svc)
    srv.start("127.0.0.1:0")
    return srv, svc


def _ct_channel(ep, ctype, native=False, **kw):
    ch = Channel(ChannelOptions(protocol="trpc_std", timeout_ms=8000,
                                connection_type=ctype,
                                native_transport=native, **kw))
    ch.init(str(ep))
    return ch


@pytest.mark.parametrize("native", [True])
def test_pooled_reuses_sequentially(native):
    srv, svc = _ct_server(native)
    try:
        ch = _ct_channel(srv.listen_endpoint(), "pooled", native)
        stub = Stub(ch, SVC)
        for i in range(10):
            assert stub.Echo(echo_pb2.EchoRequest(message=str(i))).message \
                == str(i)
        # sequential calls check the same connection in and out: one peer
        assert len(svc.seen_peers) == 1, svc.seen_peers
    finally:
        srv.stop()
        srv.join(timeout=3)


@pytest.mark.parametrize("native", [True])
def test_pooled_grows_with_concurrency(native):
    srv, svc = _ct_server(native)
    try:
        ch = _ct_channel(srv.listen_endpoint(), "pooled", native)
        stub = Stub(ch, SVC)
        errs = []

        def worker():
            try:
                for _ in range(4):
                    stub.Echo(echo_pb2.EchoRequest(message="c",
                                                   sleep_us=30000))
            except Exception as e:  # pragma: no cover
                errs.append(e)

        ts = [threading.Thread(target=worker) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errs, errs
        # concurrent checkouts forced >1 connection, bounded by concurrency
        assert 2 <= len(svc.seen_peers) <= 4, svc.seen_peers
        # steady state: sequential traffic reuses the pool (no growth)
        before = set(svc.seen_peers)
        for _ in range(6):
            stub.Echo(echo_pb2.EchoRequest(message="s"))
        assert svc.seen_peers == before
    finally:
        srv.stop()
        srv.join(timeout=3)


@pytest.mark.parametrize("native", [True])
def test_short_dials_per_call(native):
    srv, svc = _ct_server(native)
    try:
        ch = _ct_channel(srv.listen_endpoint(), "short", native)
        stub = Stub(ch, SVC)
        for i in range(5):
            stub.Echo(echo_pb2.EchoRequest(message=str(i)))
        # every call came from a fresh source port
        assert len(svc.seen_peers) == 5, svc.seen_peers
        # and the connections do not linger server-side
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if srv.connection_count() <= 1:
                break
            time.sleep(0.05)
        assert srv.connection_count() <= 1
    finally:
        srv.stop()
        srv.join(timeout=3)


def test_pooled_attachment_roundtrip_native():
    # the bulk-throughput shape: pooled conns carrying 1MB attachments
    srv, svc = _ct_server(True)
    try:
        ch = _ct_channel(srv.listen_endpoint(), "pooled", True)
        stub = Stub(ch, SVC)
        blob = b"\x77" * (1 << 20)
        for _ in range(4):
            cntl = Controller()
            cntl.request_attachment = blob
            r = stub.Echo(echo_pb2.EchoRequest(message="big"),
                          controller=cntl)
            assert r.message == "big"
            assert cntl.response_attachment == blob
    finally:
        srv.stop()
        srv.join(timeout=3)


