"""The port's runtime invariant checker (brpc_tpu_torch.analysis.
runtime_check) through every case of the reference's
``tests/test_check_smoke.py``.

Unit level: the credit ledger catches overdraw, double release and leaks,
and the lock-order recorder catches opposite acquisition orders; each
ledger case runs the same calls on the JAX package's checker and the
port's, and the violations must be equal as strings. Integration level: a
16 MiB echo and a tunnel kill with recovery through the port's ``tpu://``
tunnel, with the port's checker armed, and the credit window balancing at
teardown.
"""

import threading
import time

import pytest

from brpc_tpu.analysis import runtime_check as jax_rc
from brpc_tpu_torch.analysis import runtime_check as rc
from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import (
    Channel,
    ChannelOptions,
    Server,
    ServerOptions,
    Service,
    Stub,
)

ECHO = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]


class EchoServiceImpl(Service):
    DESCRIPTOR = ECHO

    def Echo(self, cntl, request, done):
        cntl.response_attachment = cntl.request_attachment
        return echo_pb2.EchoResponse(message=request.message,
                                     payload=request.payload)


def _arm(mod, drain):
    """Arm one package's checker; the returned callable disarms it, or,
    in a session armed by ``BRPC_TPU_CHECK=1``, asserts what the test left
    behind and re-arms fresh."""
    was_active = mod.ACTIVE
    mod.activate()

    def restore():
        if was_active:
            mod.ledger.assert_balanced(drain=drain)
            mod.activate()
        else:
            mod.deactivate()
    return restore


@pytest.fixture()
def checker():
    """Arm the port's checker for one test; always disarm after."""
    from brpc_tpu_torch.tpu.transport import _sweep_deferred_pools

    restore = _arm(rc, _sweep_deferred_pools)
    try:
        yield rc
    finally:
        restore()


@pytest.fixture()
def both():
    """Arm both packages' checkers for one test."""
    from brpc_tpu.tpu.transport import _sweep_deferred_pools as jax_drain
    from brpc_tpu_torch.tpu.transport import _sweep_deferred_pools

    restores = [_arm(rc, _sweep_deferred_pools), _arm(jax_rc, jax_drain)]
    try:
        yield (jax_rc, rc)
    finally:
        for restore in restores:
            restore()


class _Obj:
    pass


def _balance_error(mod):
    """``assert_balanced``'s message, or None when it passes."""
    try:
        mod.ledger.assert_balanced()
    except AssertionError as e:
        return str(e)
    return None


def _same_on_both(mods, calls):
    """Run ``calls(mod)`` on each checker; returns the port's violations
    and balance verdict after asserting they equal the JAX checker's."""
    out = []
    for mod in mods:
        calls(mod)
        out.append((list(mod.ledger.violations), _balance_error(mod)))
    assert out[1] == out[0]
    return out[1]


# ------------------------------------------------------------- credit ledger
class TestCreditLedger:
    def test_balanced_window_passes(self, both):
        def calls(m):
            win = _Obj()
            m.ledger.track_window(win, 8, label="w", owner="t")
            m.ledger.window_acquired(win, 5)
            m.ledger.window_released(win, 5)
        assert _same_on_both(both, calls) == ([], None)

    def test_outstanding_credits_fail(self, both):
        wins = {}

        def calls(m):
            wins[m] = win = _Obj()
            m.ledger.track_window(win, 8, label="w", owner="t")
            m.ledger.window_acquired(win, 3)
        violations, err = _same_on_both(both, calls)
        assert violations == [] and "still holds 3" in err
        for m, win in wins.items():
            m.ledger.window_released(win, 3)
            m.ledger.assert_balanced()

    def test_overdraw_recorded(self, both):
        def calls(m):
            win = _Obj()
            m.ledger.track_window(win, 4, label="w", owner="t")
            m.ledger.window_acquired(win, 6)
        violations, _ = _same_on_both(both, calls)
        assert any("overdraw" in v for v in violations)
        for m in both:
            m.ledger.reset()

    def test_double_release_recorded(self, both):
        def calls(m):
            win = _Obj()
            m.ledger.track_window(win, 4, label="w", owner="t")
            m.ledger.window_acquired(win, 2)
            m.ledger.window_released(win, 2)
            m.ledger.window_released(win, 1)
        violations, _ = _same_on_both(both, calls)
        assert any("double-release" in v for v in violations)
        for m in both:
            m.ledger.reset()

    def test_failure_close_excuses_in_flight_credits(self, both):
        # a window torn down by tunnel death may carry credits the peer
        # will never ACK: close untracks without a verdict
        def calls(m):
            win = _Obj()
            m.ledger.track_window(win, 8, label="w", owner="t")
            m.ledger.window_acquired(win, 4)
            m.ledger.window_closed(win)
        assert _same_on_both(both, calls) == ([], None)

    def test_graceful_teardown_demands_whole_window(self, both):
        def calls(m):
            win = _Obj()
            m.ledger.track_window(win, 8, label="w", owner="t")
            m.ledger.window_acquired(win, 2)
            m.ledger.window_teardown(win, wait=0.05)
        violations, _ = _same_on_both(both, calls)
        assert any("graceful teardown" in v for v in violations)
        for m in both:
            m.ledger.reset()

    def test_borrow_leak_fails(self, both):
        pools = {}

        def calls(m):
            pools[m] = pool = _Obj()
            m.ledger.track_pool(pool, label="p", owner="t")
            m.ledger.export_added(pool)
        violations, err = _same_on_both(both, calls)
        assert violations == [] and "borrowed view" in err
        for m, pool in pools.items():
            m.ledger.export_dropped(pool)
            m.ledger.assert_balanced()

    def test_double_return_recorded(self, both):
        def calls(m):
            pool = _Obj()
            m.ledger.track_pool(pool, label="p", owner="t")
            m.ledger.export_added(pool)
            m.ledger.export_dropped(pool)
            m.ledger.export_dropped(pool)
        violations, _ = _same_on_both(both, calls)
        assert any("double-return" in v for v in violations)
        for m in both:
            m.ledger.reset()

    def test_untracked_objects_noop(self, both):
        # created before activation (no token): every ledger call no-ops
        def calls(m):
            win = _Obj()
            m.ledger.window_acquired(win, 99)
            m.ledger.window_released(win, 99)
            m.ledger.export_dropped(win)
        assert _same_on_both(both, calls) == ([], None)


# ----------------------------------------------------------------- lock order
class TestLockOrder:
    def test_opposite_orders_flagged_without_deadlock(self, checker):
        a = rc.tracked_lock("test.A")
        b = rc.tracked_lock("test.B")

        def ab():
            with a:
                with b:
                    pass

        def ba():
            with b:
                with a:
                    pass

        for fn in (ab, ba):
            t = threading.Thread(target=fn)
            t.start()
            t.join()
        assert any("cycle" in v and "test.A" in v
                   for v in rc.lock_order.violations)
        rc.lock_order.reset()

    def test_consistent_order_clean(self, checker):
        a = rc.tracked_lock("test.C")
        b = rc.tracked_lock("test.D")
        for _ in range(3):
            with a:
                with b:
                    pass
        assert not rc.lock_order.violations

    def test_reentrant_lock_not_a_cycle(self, checker):
        lk = rc.tracked_lock("test.R", threading.RLock())
        with lk:
            with lk:
                pass
        assert not rc.lock_order.violations

    def test_inactive_returns_raw_lock(self):
        was = rc.ACTIVE
        rc.ACTIVE = False
        try:
            lk = rc.tracked_lock("raw")
            assert isinstance(lk, type(threading.Lock()))
        finally:
            rc.ACTIVE = was


# ------------------------------------------- the tunnel with the ledger armed
@pytest.mark.chaos
class TestLedgerSmoke:
    """A 16 MiB echo and a tunnel kill through the port's tunnel with the
    port's ledger armed: the credits balance at teardown."""

    def _wait_clean(self, timeout=5.0):
        """ACKs for the tail of a message may still be in flight; poll the
        ledger to quiescence before the hard assert."""
        from brpc_tpu_torch.tpu.transport import _sweep_deferred_pools

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            snap = rc.ledger.snapshot()
            if (not snap["violations"] and not snap["borrowed"]
                    and not any(snap["windows"].values())):
                break
            time.sleep(0.02)
        rc.ledger.assert_balanced(drain=_sweep_deferred_pools)

    def _serve(self):
        server = Server(ServerOptions())
        server.add_service(EchoServiceImpl())
        server.start("tpu://127.0.0.1:0/0")
        channel = Channel(ChannelOptions(protocol="trpc_std",
                                         timeout_ms=60000))
        channel.init(str(server.listen_endpoint()))
        return server, Stub(channel, ECHO)

    def _close(self, server):
        """Stop the server and close the client tunnels dialed to it."""
        from brpc_tpu_torch.tpu import transport

        server.stop()
        server.join()
        port = server.listen_endpoint().port
        with transport._remote_lock:
            stale = [k for k in transport._remote_sockets if k[1] == port]
            socks = [transport._remote_sockets.pop(k) for k in stale]
        for vs in socks:
            vs.endpoint.close()

    def test_16mb_streaming_echo_balances(self, checker):
        server, stub = self._serve()
        try:
            # the tunnel was dialed with the checker armed: its windows,
            # pools and locks are tracked
            payload = b"\x5a" * (16 * 1024 * 1024)
            r = stub.Echo(echo_pb2.EchoRequest(message="big",
                                               payload=payload))
            assert r.payload == payload
            assert rc.ledger.snapshot()["windows"]
            self._wait_clean()
            assert not rc.lock_order.violations
        finally:
            self._close(server)

    def test_tunnel_kill_recovery_balances(self, checker):
        from brpc_tpu_torch import fault
        from brpc_tpu_torch import flags as _flags

        _flags.set_flag("fault_injection_enabled", "true")
        server, stub = self._serve()
        try:
            assert stub.Echo(
                echo_pb2.EchoRequest(message="warm")).message == "warm"
            # kill the tunnel mid 16 MiB streaming send: the dead epoch's
            # window untracks (its in-flight credits died with it), the
            # healed epoch's window must balance like any other
            fault.arm("tpu.tunnel.kill", after=8)
            payload = b"\xc7" * (16 * 1024 * 1024)
            r = stub.Echo(echo_pb2.EchoRequest(message="again",
                                               payload=payload))
            assert r.payload == payload
            self._wait_clean(timeout=8.0)
        finally:
            fault.disarm_all()
            _flags.set_flag("fault_injection_enabled", "false")
            self._close(server)
