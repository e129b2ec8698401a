"""The port's combo channels and admission/failure policies
(brpc_tpu_torch.rpc.combo_channels, policy/limiters, rpc/circuit_breaker,
rpc/health_check, policy/cluster_recover): every case of the JAX
package's ``tests/test_combo.py`` on the port, with the same assertions
and timeouts (reference pattern: brpc_channel_unittest.cpp:395-430 — N
sub-channels to loopback servers). The collective lowering runs under
``mesh.use_cpu(8)``, the port's counterpart of the conftest's 8 virtual
CPU devices. Beside them, the port's PartitionParser against the JAX
package's on the same tags.
"""

import threading
import time

import numpy as np
import pytest

from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import (
    Channel,
    ChannelOptions,
    Controller,
    MethodDescriptor,
    RpcError,
    Server,
    Service,
    Stub,
    errors,
)
from brpc_tpu_torch.rpc.combo_channels import (
    CallMapper,
    ParallelChannel,
    PartitionChannel,
    ResponseMerger,
    SelectiveChannel,
    SKIP,
    SubCall,
)

ECHO_DESC = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]
ECHO_MD = MethodDescriptor("EchoService", "Echo",
                           echo_pb2.EchoRequest, echo_pb2.EchoResponse)


class NamedEcho(Service):
    DESCRIPTOR = ECHO_DESC

    def __init__(self, name, fail=False):
        super().__init__()
        self.name = name
        self.fail = fail
        self.hits = 0

    def Echo(self, cntl, request, done):
        self.hits += 1
        if self.fail:
            raise RuntimeError("injected")
        return echo_pb2.EchoResponse(message=self.name)


def start_servers(*impls):
    servers = [Server().add_service(i).start("127.0.0.1:0") for i in impls]
    return servers


def stop_servers(servers):
    for s in servers:
        s.stop()
        s.join(timeout=2)


class TestParallelChannel:
    def test_fanout_and_merge(self):
        impls = [NamedEcho("a"), NamedEcho("b"), NamedEcho("c")]
        servers = start_servers(*impls)
        try:
            pc = ParallelChannel()
            for s in servers:
                pc.add_channel(Channel().init(str(s.listen_endpoint())))

            class ConcatMerger(ResponseMerger):
                def merge(self, response, sub):
                    response.message += sub.message
                    return 0

            pc2 = ParallelChannel()
            for s in servers:
                pc2.add_channel(Channel().init(str(s.listen_endpoint())),
                                response_merger=ConcatMerger())
            resp = pc2.call_method(ECHO_MD, echo_pb2.EchoRequest(message="x"))
            assert sorted(resp.message) == ["a", "b", "c"]
            assert all(i.hits == 1 for i in impls)
        finally:
            stop_servers(servers)

    def test_fail_limit(self):
        impls = [NamedEcho("ok"), NamedEcho("bad", fail=True)]
        servers = start_servers(*impls)
        try:
            pc = ParallelChannel(fail_limit=1)
            for s in servers:
                pc.add_channel(Channel().init(str(s.listen_endpoint())))
            with pytest.raises(RpcError) as ei:
                pc.call_method(ECHO_MD, echo_pb2.EchoRequest(message="x"))
            assert ei.value.error_code == errors.ETOOMANYFAILS
        finally:
            stop_servers(servers)

    def test_partial_failure_tolerated_by_default(self):
        impls = [NamedEcho("ok"), NamedEcho("bad", fail=True)]
        servers = start_servers(*impls)
        try:
            pc = ParallelChannel()  # default: succeed unless ALL fail
            for s in servers:
                pc.add_channel(Channel().init(str(s.listen_endpoint())))
            resp = pc.call_method(ECHO_MD, echo_pb2.EchoRequest(message="x"))
            assert resp.message == "ok"
        finally:
            stop_servers(servers)

    def test_call_mapper_skip_and_rewrite(self):
        impls = [NamedEcho("a"), NamedEcho("b")]
        servers = start_servers(*impls)
        try:
            class OnlyFirst(CallMapper):
                def map(self, idx, method, request, response):
                    if idx != 0:
                        return SKIP
                    return SubCall(method,
                                   echo_pb2.EchoRequest(message="rewritten"),
                                   echo_pb2.EchoResponse())

            pc = ParallelChannel()
            for s in servers:
                pc.add_channel(Channel().init(str(s.listen_endpoint())),
                               call_mapper=OnlyFirst())
            resp = pc.call_method(ECHO_MD, echo_pb2.EchoRequest(message="x"))
            assert resp.message == "a"
            assert impls[0].hits == 1 and impls[1].hits == 0
        finally:
            stop_servers(servers)

    def test_async_done(self):
        impls = [NamedEcho("a")]
        servers = start_servers(*impls)
        try:
            pc = ParallelChannel()
            pc.add_channel(Channel().init(str(servers[0].listen_endpoint())))
            ev = threading.Event()
            out = []

            def on_done(cntl):
                out.append(cntl.failed())
                ev.set()

            pc.call_method(ECHO_MD, echo_pb2.EchoRequest(message="x"),
                           done=on_done)
            assert ev.wait(5)
            assert out == [False]
        finally:
            stop_servers(servers)


class SlowEcho(Service):
    DESCRIPTOR = ECHO_DESC

    def __init__(self, name, delay_s=1.0):
        super().__init__()
        self.name = name
        self.delay_s = delay_s
        self.hits = 0

    def Echo(self, cntl, request, done):
        self.hits += 1
        time.sleep(self.delay_s)
        return echo_pb2.EchoResponse(message=self.name)


class TestParallelChannelLimits:
    """Reference semantics regressions (parallel_channel.cpp:223-235,
    parallel_channel.h:161-174)."""

    @pytest.fixture(autouse=True)
    def _cold_run_to_completion(self):
        """Run-to-completion classifies handlers by (service, method)
        name across the process: once other tests' fast EchoService.Echo
        traffic has classified the name cheap, a SlowEcho under the same
        name runs inline on an event dispatcher and stalls the other
        sub-calls' sockets on it for its whole sleep. These limits do
        not depend on that classification, so each starts cold."""
        from brpc_tpu_torch.rpc import run_to_completion as rtc

        rtc._reset_for_test()
        yield
        rtc._reset_for_test()

    def test_fail_limit_cancels_outstanding(self):
        # two instant failures + one slow success; fail_limit=2 must fail
        # the call immediately without waiting for the slow sub-call
        impls = [NamedEcho("bad1", fail=True), NamedEcho("bad2", fail=True),
                 SlowEcho("slow", delay_s=2.0)]
        servers = start_servers(*impls)
        try:
            pc = ParallelChannel(fail_limit=2)
            for s in servers:
                pc.add_channel(Channel().init(str(s.listen_endpoint())))
            cntl = Controller()
            cntl.timeout_ms = 10_000
            start = time.monotonic()
            with pytest.raises(RpcError) as ei:
                pc.call_method(ECHO_MD, echo_pb2.EchoRequest(message="x"),
                               controller=cntl)
            elapsed = time.monotonic() - start
            assert ei.value.error_code == errors.ETOOMANYFAILS
            assert elapsed < 1.5, f"waited for canceled sub-call: {elapsed}"
        finally:
            stop_servers(servers)

    def test_success_limit_finishes_early(self):
        impls = [NamedEcho("fast"), SlowEcho("slow1", delay_s=2.0),
                 SlowEcho("slow2", delay_s=2.0)]
        servers = start_servers(*impls)
        try:
            pc = ParallelChannel(success_limit=1)
            for s in servers:
                pc.add_channel(Channel().init(str(s.listen_endpoint())))
            cntl = Controller()
            cntl.timeout_ms = 10_000
            start = time.monotonic()
            resp = pc.call_method(ECHO_MD, echo_pb2.EchoRequest(message="x"),
                                  controller=cntl)
            elapsed = time.monotonic() - start
            assert resp.message == "fast"
            assert elapsed < 1.5, f"waited past success_limit: {elapsed}"
        finally:
            stop_servers(servers)

    def test_fail_limit_clamped_to_issued(self):
        # fail_limit > #channels must not turn an all-fail fan-out into a
        # silent empty success (reference clamps to ndone, .cpp:661-667)
        impls = [NamedEcho("b1", fail=True), NamedEcho("b2", fail=True)]
        servers = start_servers(*impls)
        try:
            pc = ParallelChannel(fail_limit=5)
            for s in servers:
                pc.add_channel(Channel().init(str(s.listen_endpoint())))
            with pytest.raises(RpcError) as ei:
                pc.call_method(ECHO_MD, echo_pb2.EchoRequest(message="x"))
            assert ei.value.error_code == errors.ETOOMANYFAILS
        finally:
            stop_servers(servers)

    def test_merger_fail_counts_against_fail_limit(self):
        impls = [NamedEcho("a"), NamedEcho("b")]
        servers = start_servers(*impls)
        try:
            class RejectAll(ResponseMerger):
                def merge(self, response, sub):
                    return ResponseMerger.FAIL

            pc = ParallelChannel()  # fail_limit = all
            for s in servers:
                pc.add_channel(Channel().init(str(s.listen_endpoint())),
                               response_merger=RejectAll())
            with pytest.raises(RpcError) as ei:
                pc.call_method(ECHO_MD, echo_pb2.EchoRequest(message="x"))
            assert ei.value.error_code == errors.ETOOMANYFAILS
        finally:
            stop_servers(servers)

    def test_merger_fail_all_fails_whole_call(self):
        impls = [NamedEcho("a"), NamedEcho("b"), NamedEcho("c")]
        servers = start_servers(*impls)
        try:
            class Poison(ResponseMerger):
                calls = 0

                def merge(self, response, sub):
                    Poison.calls += 1
                    if Poison.calls == 1:
                        return ResponseMerger.FAIL_ALL
                    return ResponseMerger.MERGED

            pc = ParallelChannel()  # default would tolerate one failure
            for s in servers:
                pc.add_channel(Channel().init(str(s.listen_endpoint())),
                               response_merger=Poison())
            with pytest.raises(RpcError) as ei:
                pc.call_method(ECHO_MD, echo_pb2.EchoRequest(message="x"))
            assert ei.value.error_code == errors.ETOOMANYFAILS
        finally:
            stop_servers(servers)


class TestSelectiveChannel:
    def test_prefers_healthy_channel(self):
        impls = [NamedEcho("good")]
        servers = start_servers(*impls)
        try:
            sc = SelectiveChannel()
            dead = Channel(ChannelOptions(max_retry=0,
                                          connect_timeout_ms=200))
            dead.init("127.0.0.1:1")
            sc.add_channel(dead)
            sc.add_channel(Channel().init(str(servers[0].listen_endpoint())))
            for _ in range(4):
                resp = sc.call_method(ECHO_MD,
                                      echo_pb2.EchoRequest(message="x"))
                assert resp.message == "good"
            # dead channel parked after its failures: traffic converges
            assert impls[0].hits >= 4
        finally:
            stop_servers(servers)

    def test_all_dead_fails(self):
        sc = SelectiveChannel(max_retry=1)
        dead = Channel(ChannelOptions(max_retry=0, connect_timeout_ms=100))
        dead.init("127.0.0.1:1")
        sc.add_channel(dead)
        with pytest.raises(RpcError):
            sc.call_method(ECHO_MD, echo_pb2.EchoRequest(message="x"))

    def test_failed_attempt_does_not_leak_into_response(self):
        """A failed attempt that partially filled its response must not
        contaminate the caller's response object (VERDICT r1 weak #5;
        reference isolates sub-call responses)."""
        from brpc_tpu_torch.rpc.channel import RpcError as _RpcError

        class GarbageThenFail:
            """Fake sub-channel: writes junk into the response, then fails."""

            def call_method(self, method, request, response=None,
                            controller=None, done=None):
                if response is not None:
                    response.message = "GARBAGE"
                cntl = controller or Controller()
                cntl.set_failed(errors.EINTERNAL, "injected partial fill")
                raise _RpcError(cntl)

        impls = [NamedEcho("good")]
        servers = start_servers(*impls)
        try:
            sc = SelectiveChannel()
            sc.add_channel(GarbageThenFail())
            sc.add_channel(Channel().init(str(servers[0].listen_endpoint())))
            caller_resp = echo_pb2.EchoResponse()
            out = sc.call_method(ECHO_MD, echo_pb2.EchoRequest(message="x"),
                                 response=caller_resp)
            assert caller_resp.message == "good"
            assert out.message == "good"
        finally:
            stop_servers(servers)


class TestPartitionChannel:
    def test_partitioned_fanout(self):
        impls = [NamedEcho("p0"), NamedEcho("p1")]
        servers = start_servers(*impls)
        try:
            url = (f"list://{servers[0].listen_endpoint()} 0/2,"
                   f"{servers[1].listen_endpoint()} 1/2")

            class ConcatMerger(ResponseMerger):
                def merge(self, response, sub):
                    response.message += sub.message
                    return 0

            pc = PartitionChannel()
            pc.init(url, partition_count=2)
            # swap default mergers for concat to observe both partitions
            pc._subs = [(ch, m, ConcatMerger()) for ch, m, _ in pc._subs]
            resp = pc.call_method(ECHO_MD, echo_pb2.EchoRequest(message="x"))
            assert sorted(resp.message.split("p")[1:]) == ["0", "1"]
            assert impls[0].hits == 1 and impls[1].hits == 1
        finally:
            stop_servers(servers)

    def test_wrong_partition_count_dropped(self):
        from brpc_tpu_torch.rpc.combo_channels import PartitionParser

        parser = PartitionParser()
        assert parser.parse("1/3") == (1, 3)
        assert parser.parse("junk") is None


class TestLimiters:
    def test_constant(self):
        from brpc_tpu_torch.policy.limiters import ConstantLimiter

        lim = ConstantLimiter(2)
        assert lim.on_request() and lim.on_request()
        assert not lim.on_request()
        lim.on_response(100, 0)
        assert lim.on_request()

    def test_auto_grows_on_healthy_latency(self):
        from brpc_tpu_torch.policy.limiters import AutoLimiter

        lim = AutoLimiter(initial=8, sample_window=16)
        for _ in range(200):
            if lim.on_request():
                lim.on_response(100.0, 0)
        assert lim.limit > 8  # stable latency -> limit grows

    def test_auto_shrinks_on_degraded_latency(self):
        from brpc_tpu_torch.policy.limiters import AutoLimiter

        lim = AutoLimiter(initial=64, sample_window=16)
        for _ in range(32):  # establish a fast floor
            lim.on_request()
            lim.on_response(100.0, 0)
        for _ in range(200):  # latency collapses
            if lim.on_request():
                lim.on_response(10_000.0, 0)
        assert lim.limit < 64

    def test_timeout_limiter_rejects_when_backlogged(self):
        from brpc_tpu_torch.policy.limiters import TimeoutLimiter

        lim = TimeoutLimiter(timeout_ms=1.0)
        lim._avg_latency_us = 10_000.0  # 10ms per request observed
        assert lim.on_request()  # queue empty: expected wait 0
        assert not lim.on_request()  # one queued x 10ms > 1ms budget

    def test_method_limiter_wireup(self):
        impl = NamedEcho("x")
        server = Server().add_service(impl).start("127.0.0.1:0")
        try:
            impl.find_method("Echo").set_limiter("constant:1")
            ch = Channel().init(str(server.listen_endpoint()))
            stub = Stub(ch, ECHO_DESC)
            assert stub.Echo(echo_pb2.EchoRequest(message="m")).message == "x"
        finally:
            server.stop()
            server.join(timeout=2)


class TestCircuitBreaker:
    def test_trips_on_error_burst_and_recovers(self):
        from brpc_tpu_torch.rpc.circuit_breaker import CircuitBreaker

        cb = CircuitBreaker(min_samples=10, base_isolation_s=0.05)
        for _ in range(20):
            cb.on_call_end(1)  # all errors
        assert cb.isolated
        time.sleep(0.08)
        assert not cb.isolated  # isolation expired: half-open

    def test_healthy_traffic_never_trips(self):
        from brpc_tpu_torch.rpc.circuit_breaker import CircuitBreaker

        cb = CircuitBreaker()
        for _ in range(1000):
            cb.on_call_end(0)
        assert not cb.isolated

    def test_repeat_offender_isolated_longer(self):
        from brpc_tpu_torch.rpc.circuit_breaker import CircuitBreaker

        cb = CircuitBreaker(min_samples=5, base_isolation_s=0.02)
        for _ in range(10):
            cb.on_call_end(1)
        first = cb._isolated_until - time.monotonic()
        time.sleep(0.03)
        for _ in range(10):
            cb.on_call_end(1)
        second = cb._isolated_until - time.monotonic()
        assert second > first

    def test_cluster_recover_guard(self):
        from brpc_tpu_torch.rpc.circuit_breaker import ClusterRecoverGuard

        g = ClusterRecoverGuard(threshold=0.5, interval_s=10)
        assert g.may_recover(1, 10)       # few isolated: free recovery
        assert g.may_recover(8, 10)       # mass isolation: first allowed
        assert not g.may_recover(8, 10)   # second rationed


class TestHealthCheck:
    def test_probe_revives_parked_node(self):
        from brpc_tpu_torch.butil.endpoint import EndPoint
        from brpc_tpu_torch.policy.load_balancers import RoundRobinLB, ServerNode
        from brpc_tpu_torch.rpc.health_check import HealthChecker

        impl = NamedEcho("alive")
        server = Server().add_service(impl).start("127.0.0.1:0")
        try:
            ep = server.listen_endpoint()
            lb = RoundRobinLB()
            lb.reset_servers([ServerNode(ep)])
            # park it artificially
            st = lb._node_state(ep)
            st.fail_streak = 3
            st.down_until = time.monotonic() + 60
            checker = HealthChecker(lb, interval_s=0.05)
            deadline = time.time() + 5
            while st.is_down and time.time() < deadline:
                time.sleep(0.05)
            assert not st.is_down
            checker.stop()
        finally:
            server.stop()
            server.join(timeout=2)

    def test_tcp_probe_dead_endpoint(self):
        from brpc_tpu_torch.butil.endpoint import EndPoint
        from brpc_tpu_torch.rpc.health_check import tcp_probe

        assert tcp_probe(EndPoint.parse("127.0.0.1:1"), timeout=0.3) is False


class TestDynamicPartitionChannel:
    """Capacity migration between partition schemes (reference
    partition_channel.h:136, dynpart_load_balancer.cpp)."""

    def _make(self, servers):
        from brpc_tpu_torch.rpc.combo_channels import DynamicPartitionChannel

        a, b = (str(s.listen_endpoint()) for s in servers)
        # two schemes live at once: 2-partition tier (1 server each) and a
        # 4-partition tier (the same two servers doubled up)
        url = (f"list://{a} 0/2,{b} 1/2,"
               f"{a} 0/4,{b} 1/4,{a} 2/4,{b} 3/4")

        class CountMerger(ResponseMerger):
            def merge(self, response, sub):
                response.message += "."
                return 0

        dpc = DynamicPartitionChannel()
        dpc.init(url, response_merger=CountMerger())
        return dpc

    def test_traffic_splits_by_capacity(self):
        impls = [NamedEcho("a"), NamedEcho("b")]
        servers = start_servers(*impls)
        try:
            dpc = self._make(servers)
            assert dpc.scheme_capacities() == {2: 2, 4: 4}
            fan_counts = set()
            for _ in range(60):
                resp = dpc.call_method(ECHO_MD,
                                       echo_pb2.EchoRequest(message="x"))
                fan_counts.add(len(resp.message))
            # both schemes must carry traffic (P[miss] <= (4/6)^60)
            assert fan_counts == {2, 4}, fan_counts
        finally:
            stop_servers(servers)

    def test_drain_finishes_migration(self, tmp_path):
        from brpc_tpu_torch.policy.naming import parse_server_item
        from brpc_tpu_torch.rpc.combo_channels import DynamicPartitionChannel

        impls = [NamedEcho("a"), NamedEcho("b")]
        servers = start_servers(*impls)
        try:
            a, b = (str(s.listen_endpoint()) for s in servers)
            both_tiers = (f"{a} 0/2\n{b} 1/2\n"
                          f"{a} 0/4\n{b} 1/4\n{a} 2/4\n{b} 3/4\n")
            ns_file = tmp_path / "cluster.lst"
            ns_file.write_text(both_tiers)

            class CountMerger(ResponseMerger):
                def merge(self, response, sub):
                    response.message += "."
                    return 0

            dpc = DynamicPartitionChannel()
            dpc.init(f"file://{ns_file}", response_merger=CountMerger())
            assert dpc.scheme_capacities() == {2: 2, 4: 4}
            # the old 2-partition tier drains: the naming FILE changes first
            # (so any periodic refresh agrees), then the update is pushed
            new_tier = f"{a} 0/4\n{b} 1/4\n{a} 2/4\n{b} 3/4\n"
            ns_file.write_text(new_tier)
            nodes = [parse_server_item(line)
                     for line in new_tier.splitlines()]
            dpc._listener().reset_servers(nodes)
            assert dpc.scheme_capacities() == {4: 4}
            for _ in range(10):
                resp = dpc.call_method(ECHO_MD,
                                       echo_pb2.EchoRequest(message="x"))
                assert len(resp.message) == 4  # always the 4-way fanout
        finally:
            stop_servers(servers)


class TestClusterRecover:
    def test_policy_sheds_proportionally(self):
        from brpc_tpu_torch.policy.cluster_recover import (
            DefaultClusterRecoverPolicy)

        pol = DefaultClusterRecoverPolicy(min_working_instances=4,
                                          hold_seconds=60)
        assert not pol.do_reject(0)  # not recovering yet -> no shedding
        pol.start_recover()
        verdicts = [pol.do_reject(1) for _ in range(400)]
        frac = sum(verdicts) / len(verdicts)
        assert 0.55 < frac < 0.95, frac   # expect ~75% shed at 1/4 capacity
        assert pol.recovering
        # full capacity back -> recovery over, nothing shed
        assert not pol.do_reject(4)
        assert not pol.recovering
        assert not pol.do_reject(1)

    def test_policy_stops_after_hold(self):
        from brpc_tpu_torch.policy.cluster_recover import (
            DefaultClusterRecoverPolicy)

        pol = DefaultClusterRecoverPolicy(min_working_instances=8,
                                          hold_seconds=0.1)
        pol.start_recover()
        pol.do_reject(2)
        time.sleep(0.15)
        pol.do_reject(2)          # usable stable for hold_seconds -> stop
        assert not pol.recovering

    def test_channel_integration(self):
        from brpc_tpu_torch.policy.load_balancers import (ServerNode,
                                                    create_load_balancer)

        impl = NamedEcho("up")
        (server,) = start_servers(impl)
        try:
            lb = create_load_balancer(
                "rr:min_working_instances=2 hold_seconds=120")
            assert lb.recover_policy is not None
            ch = Channel(ChannelOptions(timeout_ms=2000, max_retry=0))
            ch.init_with_lb(lb)
            stub = Stub(ch, ECHO_DESC)
            # empty cluster: EHOSTDOWN and recovery armed
            with pytest.raises(RpcError):
                stub.Echo(echo_pb2.EchoRequest(message="x"))
            assert lb.recover_policy.recovering
            # half capacity back: some calls shed with EREJECT, some pass
            lb.reset_servers([ServerNode(server.listen_endpoint())])
            outcomes = set()
            for _ in range(200):
                try:
                    stub.Echo(echo_pb2.EchoRequest(message="x"))
                    outcomes.add("ok")
                except RpcError as e:
                    assert e.error_code == errors.EREJECT, e
                    outcomes.add("shed")
                if outcomes == {"ok", "shed"}:
                    break
            assert outcomes == {"ok", "shed"}
            # full capacity: recovery ends, everything flows
            lb.reset_servers([ServerNode(server.listen_endpoint()),
                              ServerNode(server.listen_endpoint(),
                                         tag="dup")])
            time.sleep(0.05)  # let the ~10ms usable_count cache expire
            for _ in range(5):
                stub.Echo(echo_pb2.EchoRequest(message="x"))
            assert not lb.recover_policy.recovering
        finally:
            stop_servers([server])


@pytest.fixture
def cpu8():
    from brpc_tpu_torch.tpu import mesh as port_mesh

    port_mesh.use_cpu(8)
    yield
    port_mesh.use_cpu(0)


@pytest.mark.usefixtures("cpu8")
class TestCollectiveScheme:
    """The ParallelChannel->collective mapping is a CODE path. Same
    ParallelChannel, same CollectiveScheme, two executions: (a)
    all-device sub-channels -> ONE program over the port's mesh, (b)
    forced RPC fallback -> one CollectiveService.Apply per sub-channel
    through the device-method lane + host merge. Results must agree."""

    def _make(self, n, merge):
        import numpy as np

        from brpc_tpu_torch.rpc import Channel
        from brpc_tpu_torch.rpc.combo_channels import (CollectiveScheme,
                                                 ParallelChannel)

        pc = ParallelChannel()
        for i in range(n):
            pc.add_channel(Channel().init(f"tpu://localhost/{i}"))
        scheme = CollectiveScheme(
            "test.affine", fn=lambda s: s * 2.0 + 1.0, merge=merge)
        return pc, scheme

    @pytest.mark.parametrize("merge", ["gather", "sum"])
    def test_collective_equals_rpc_fallback(self, merge):
        import numpy as np

        rng = np.random.default_rng(11)
        x = rng.normal(size=(16, 8)).astype(np.float32)
        pc, scheme = self._make(8, merge)
        mesh = pc.device_mesh(scheme.axis_name)
        assert mesh is not None and mesh.shape[scheme.axis_name] == 8
        out_coll = np.asarray(pc.call_tensor(x, scheme))
        out_rpc = np.asarray(pc._call_tensor_rpc(x, scheme))
        assert out_coll.shape == out_rpc.shape
        np.testing.assert_allclose(out_coll, out_rpc, rtol=1e-6, atol=1e-6)
        # and both match the direct computation
        if merge == "gather":
            np.testing.assert_allclose(out_coll, x * 2.0 + 1.0, rtol=1e-6)
        else:
            expect = sum(np.split(x * 2.0 + 1.0, 8, axis=0))
            np.testing.assert_allclose(out_coll, expect, rtol=1e-6)

    def test_mixed_subchannels_fall_back(self):
        # one TCP sub-channel spoils device detection (mesh is None, so
        # call_tensor would take the per-sub-channel RPC path)
        from brpc_tpu_torch.rpc import Channel
        from brpc_tpu_torch.rpc.combo_channels import (CollectiveScheme,
                                                 ParallelChannel)

        pc = ParallelChannel()
        pc.add_channel(Channel().init("tpu://localhost/0"))
        pc.add_channel(Channel().init("127.0.0.1:9"))
        scheme = CollectiveScheme("test.affine2", fn=lambda s: s - 3.0)
        assert pc.device_mesh(scheme.axis_name) is None

    def test_duplicate_ordinals_rejected(self):
        from brpc_tpu_torch.rpc import Channel
        from brpc_tpu_torch.rpc.combo_channels import (CollectiveScheme,
                                                 ParallelChannel)

        pc = ParallelChannel()
        pc.add_channel(Channel().init("tpu://localhost/0"))
        pc.add_channel(Channel().init("tpu://localhost/0"))
        scheme = CollectiveScheme("test.affine3", fn=lambda s: s)
        assert pc.device_mesh(scheme.axis_name) is None


def test_partition_parser_equals_the_jax_packages():
    from brpc_tpu.rpc.combo_channels import PartitionParser as JaxParser
    from brpc_tpu_torch.rpc.combo_channels import PartitionParser

    rng = np.random.default_rng(13)
    tags = ["1/3", "0/2", "3/4", "junk", "", "/", "2/", "/5", "-1/3",
            "1/3/5", " 1/3", "x/y", "7/7", "0/0"]
    tags += [f"{a}/{b}" for a, b in rng.integers(-3, 40, size=(200, 2))]
    mine, theirs = PartitionParser(), JaxParser()
    assert [mine.parse(t) for t in tags] == [theirs.parse(t) for t in tags]


def test_tpu_probe_resolves_local_devices_and_dials_the_tunnel(monkeypatch):
    """The health checker's tpu:// probe: a local ordinal this process has
    is alive, one it lacks (or any, with no card and no ``use_cpu``) is
    not; a tunnel endpoint is alive once its TPUC handshake completes."""
    import torch

    from brpc_tpu_torch.butil.endpoint import EndPoint
    from brpc_tpu_torch.rpc.health_check import probe_for_endpoint, tpu_probe
    from brpc_tpu_torch.tpu import mesh as port_mesh

    local = EndPoint.parse("tpu://localhost/0")
    assert probe_for_endpoint(local) is tpu_probe
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prev = port_mesh.use_cpu(0)
    try:
        assert tpu_probe(local) is False          # no card, no use_cpu
        port_mesh.use_cpu(2)
        assert tpu_probe(local) is True
        assert tpu_probe(EndPoint.parse("tpu://localhost/5")) is False
        server = Server().add_service(NamedEcho("t")).start(
            "tpu://127.0.0.1:0/1")
        try:
            assert tpu_probe(server.listen_endpoint(), timeout=3.0) is True
        finally:
            server.stop()
            server.join(timeout=2)
    finally:
        port_mesh.use_cpu(prev)
