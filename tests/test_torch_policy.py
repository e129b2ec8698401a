"""The port's load balancers, naming services and load-balanced Channel
(brpc_tpu_torch.policy.load_balancers, policy/naming, rpc/channel): every
case of the JAX package's ``tests/test_policy.py`` on the port, with the
same assertions and timeouts (reference pattern:
test/brpc_load_balancer_unittest.cpp; cluster = channels to loopback
servers + file/list naming, brpc_channel_unittest.cpp:211). ``tpu://``
lists ``mesh.use_cpu(8)``'s eight positions, the port's counterpart of
the conftest's 8 virtual CPU devices. Beside them, parity with the JAX
package's balancers on the same inputs: ``c_hash`` maps 1,000 keys to
the same nodes, and ``rr`` and ``wrr`` pick the same sequences.
"""

import collections
import os
import time

import numpy as np
import pytest

from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.policy.load_balancers import (
    ConsistentHashingLB,
    LocalityAwareLB,
    RandomLB,
    RoundRobinLB,
    ServerNode,
    WeightedRoundRobinLB,
    create_load_balancer,
)
from brpc_tpu_torch.policy.naming import (
    ListNamingService,
    FileNamingService,
    parse_server_item,
    start_naming_service,
)
from brpc_tpu_torch.rpc import errors


def nodes(*specs):
    return [ServerNode(EndPoint.parse(s)) for s in specs]


class TestLoadBalancers:
    def test_rr_cycles(self):
        lb = RoundRobinLB()
        lb.reset_servers(nodes("127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"))
        picks = [str(lb.select_server()) for _ in range(6)]
        assert picks[:3] == picks[3:6]
        assert len(set(picks[:3])) == 3

    def test_random_member(self):
        lb = RandomLB()
        lb.reset_servers(nodes("127.0.0.1:1", "127.0.0.1:2"))
        for _ in range(20):
            assert str(lb.select_server()) in {"127.0.0.1:1", "127.0.0.1:2"}

    def test_empty_returns_none(self):
        assert RoundRobinLB().select_server() is None

    def test_wrr_respects_weights(self):
        lb = WeightedRoundRobinLB()
        lb.reset_servers([
            ServerNode(EndPoint.parse("127.0.0.1:1"), weight=3),
            ServerNode(EndPoint.parse("127.0.0.1:2"), weight=1),
        ])
        counts = collections.Counter(
            str(lb.select_server()) for _ in range(40))
        assert counts["127.0.0.1:1"] == 30
        assert counts["127.0.0.1:2"] == 10

    def test_la_prefers_fast(self):
        lb = LocalityAwareLB()
        lb.reset_servers(nodes("127.0.0.1:1", "127.0.0.1:2"))
        fast, slow = EndPoint.parse("127.0.0.1:1"), EndPoint.parse("127.0.0.1:2")
        for _ in range(50):
            lb.feedback(fast, errors.OK, 100)
            lb.feedback(slow, errors.OK, 10_000)
        counts = collections.Counter(str(lb.select_server())
                                     for _ in range(500))
        assert counts["127.0.0.1:1"] > counts["127.0.0.1:2"] * 5

    def test_failure_parks_node(self):
        lb = RoundRobinLB()
        lb.reset_servers(nodes("127.0.0.1:1", "127.0.0.1:2"))
        bad = EndPoint.parse("127.0.0.1:2")
        for _ in range(3):
            lb.feedback(bad, errors.EFAILEDSOCKET, 0)
        picks = {str(lb.select_server()) for _ in range(10)}
        assert picks == {"127.0.0.1:1"}

    def test_c_hash_sticky_and_minimal_move(self):
        lb = ConsistentHashingLB()
        lb.reset_servers(nodes(*[f"127.0.0.1:{p}" for p in range(1, 6)]))

        class C:
            def __init__(self, code):
                self.log_id = code

        before = {code: str(lb.select_server(C(code))) for code in range(200)}
        # same key -> same server, always
        for code in range(200):
            assert str(lb.select_server(C(code))) == before[code]
        # removing one server moves only its keys
        lb.reset_servers(nodes(*[f"127.0.0.1:{p}" for p in range(1, 5)]))
        moved = sum(
            1 for code in range(200)
            if str(lb.select_server(C(code))) != before[code])
        assert moved < 100  # ~1/5 expected, never a full reshuffle

    def test_registry(self):
        assert create_load_balancer("rr").name == "rr"
        with pytest.raises(ValueError):
            create_load_balancer("nope")


class TestNaming:
    def test_parse_item(self):
        n = parse_server_item("10.0.0.1:80 w=5 zoneA")
        assert n.weight == 5 and n.tag == "zoneA"
        assert str(n.endpoint) == "10.0.0.1:80"

    def test_list_ns(self):
        ns = ListNamingService("127.0.0.1:1,127.0.0.1:2 w=2")
        servers = ns.get_servers()
        assert len(servers) == 2 and servers[1].weight == 2

    def test_file_ns(self, tmp_path):
        f = tmp_path / "servers"
        f.write_text("127.0.0.1:1\n# comment\n127.0.0.1:2 w=3\n\n")
        ns = FileNamingService(str(f))
        servers = ns.get_servers()
        assert len(servers) == 2 and servers[1].weight == 3

    def test_tpu_ns(self):
        from brpc_tpu_torch.policy.naming import TpuNamingService
        from brpc_tpu_torch.tpu import mesh as port_mesh

        port_mesh.use_cpu(8)
        try:
            servers = TpuNamingService("localhost").get_servers()
        finally:
            port_mesh.use_cpu(0)
        assert len(servers) == 8  # the virtual pod
        assert all(s.endpoint.is_tpu() for s in servers)

    def test_watcher_pushes_updates(self, tmp_path):
        f = tmp_path / "servers"
        f.write_text("127.0.0.1:1\n")
        lb = RoundRobinLB()
        thread = start_naming_service(f"file://{f}", lb, interval_s=0.1)
        try:
            assert lb.server_count() == 1
            f.write_text("127.0.0.1:1\n127.0.0.1:2\n")
            deadline = time.time() + 5
            while lb.server_count() != 2 and time.time() < deadline:
                time.sleep(0.05)
            assert lb.server_count() == 2
        finally:
            thread.stop()

    def test_unknown_scheme(self):
        with pytest.raises(ValueError):
            start_naming_service("zk://x", RoundRobinLB())


class TestChannelWithLB:
    def test_rr_over_two_loopback_servers(self):
        """The reference's multi-node simulation: N real servers on loopback
        behind a list:// naming service (brpc_channel_unittest.cpp:211)."""
        from brpc_tpu_torch.proto import echo_pb2
        from brpc_tpu_torch.rpc import Channel, Server, Service, Stub

        class Impl(Service):
            DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]

            def __init__(self, name):
                super().__init__()
                self.name = name
                self.hits = 0

            def Echo(self, cntl, request, done):
                self.hits += 1
                return echo_pb2.EchoResponse(message=self.name)

        impls = [Impl("s1"), Impl("s2")]
        servers = [Server().add_service(i).start("127.0.0.1:0")
                   for i in impls]
        try:
            url = "list://" + ",".join(
                str(s.listen_endpoint()) for s in servers)
            ch = Channel().init(url, "rr")
            stub = Stub(ch, echo_pb2.DESCRIPTOR.services_by_name["EchoService"])
            got = {stub.Echo(echo_pb2.EchoRequest(message="x")).message
                   for _ in range(10)}
            assert got == {"s1", "s2"}
            assert impls[0].hits == 5 and impls[1].hits == 5
        finally:
            for s in servers:
                s.stop()
                s.join(timeout=2)

    def test_failover_to_healthy_server(self):
        from brpc_tpu_torch.proto import echo_pb2
        from brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, Service, Stub

        class Impl(Service):
            DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]

            def Echo(self, cntl, request, done):
                return echo_pb2.EchoResponse(message="alive")

        server = Server().add_service(Impl()).start("127.0.0.1:0")
        try:
            # one dead endpoint + one live one
            url = f"list://127.0.0.1:1,{server.listen_endpoint()}"
            ch = Channel(ChannelOptions(max_retry=3,
                                        connect_timeout_ms=200)).init(url, "rr")
            stub = Stub(ch, echo_pb2.DESCRIPTOR.services_by_name["EchoService"])
            for _ in range(4):
                assert stub.Echo(
                    echo_pb2.EchoRequest(message="x")).message == "alive"
        finally:
            server.stop()
            server.join(timeout=2)


class TestLaFidelity:
    """la must demonstrably SHIFT traffic away from a
    degraded replica, and punish in-flight load before feedback lands."""

    def test_la_shifts_from_slow_server(self):
        import time

        from brpc_tpu_torch.proto import echo_pb2
        from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Server, Service,
                                  Stub)

        counts = {"fast": 0, "slow": 0}

        def impl(tag, sleep_s):
            class Impl(Service):
                DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name[
                    "EchoService"]

                def Echo(self, cntl, request, done):
                    counts[tag] += 1
                    if sleep_s:
                        time.sleep(sleep_s)
                    return echo_pb2.EchoResponse(message=tag)

            return Impl()

        fast = Server().add_service(impl("fast", 0.0)).start("127.0.0.1:0")
        slow = Server().add_service(impl("slow", 0.02)).start("127.0.0.1:0")
        try:
            url = (f"list://{fast.listen_endpoint()},"
                   f"{slow.listen_endpoint()}")
            ch = Channel(ChannelOptions(timeout_ms=5000)).init(url, "la")
            stub = Stub(ch, echo_pb2.DESCRIPTOR.services_by_name[
                "EchoService"])
            for _ in range(150):
                stub.Echo(echo_pb2.EchoRequest(message="x"))
            total = counts["fast"] + counts["slow"]
            assert total == 150
            # 20ms vs ~0.3ms EWMA: the slow replica's share must collapse
            assert counts["slow"] < total * 0.35, counts
        finally:
            fast.stop()
            fast.join(timeout=2)
            slow.stop()
            slow.join(timeout=2)

    def test_la_punishes_inflight_before_feedback(self):
        from brpc_tpu_torch.policy.load_balancers import (LocalityAwareLB,
                                                    ServerNode)

        lb = LocalityAwareLB()
        a = EndPoint.from_ip_port("10.0.0.1", 1)
        b = EndPoint.from_ip_port("10.0.0.2", 2)
        lb.reset_servers([ServerNode(a), ServerNode(b)])
        # equal latency history; node A holds 15 unanswered calls
        lb._node_state(a).inflight = 15
        picks = {a: 0, b: 0}
        for _ in range(400):
            ep = lb.select_server()
            picks[ep] += 1
            lb._node_state(ep).inflight -= 1  # undo select's charge
        # ~16:1 punishment: A should receive well under a quarter
        assert picks[a] < 100, picks
        # feedback repays the charge and the split recovers
        st = lb._node_state(a)
        st.inflight = 0
        picks = {a: 0, b: 0}
        for _ in range(400):
            ep = lb.select_server()
            picks[ep] += 1
            lb._node_state(ep).inflight -= 1
        assert 120 < picks[a] < 280, picks


class TestAutoLimiterFidelity:
    """The gradient limiter must CONVERGE DOWN against an
    overload curve (latency inflating above the observed floor)."""

    def test_limit_shrinks_under_latency_inflation(self):
        from brpc_tpu_torch.policy.limiters import AutoLimiter

        lim = AutoLimiter(initial=256, min_limit=4, sample_window=16)
        # healthy phase establishes the latency floor
        for _ in range(4 * 16):
            assert lim.on_request()
            lim.on_response(1_000.0, 0)
        healthy_limit = lim.limit
        # overload: latency 12x the floor, windows keep landing
        for _ in range(12 * 16):
            if lim.on_request():
                lim.on_response(12_000.0, 0)
        assert lim.limit < healthy_limit * 0.5, (healthy_limit, lim.limit)
        assert lim.limit >= lim.min_limit
        # recovery: latency returns to the floor, the limit grows back
        shrunk = lim.limit
        for _ in range(12 * 16):
            if lim.on_request():
                lim.on_response(1_100.0, 0)
        assert lim.limit > shrunk, (shrunk, lim.limit)

    def test_limiter_sheds_real_overload(self):
        import threading
        import time

        from brpc_tpu_torch.proto import echo_pb2
        from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Server, Service,
                                  Stub)
        from brpc_tpu_torch.rpc.channel import RpcError

        conc = {"n": 0, "max": 0}
        lock = threading.Lock()

        class Impl(Service):
            DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]

            def Echo(self, cntl, request, done):
                with lock:
                    conc["n"] += 1
                    conc["max"] = max(conc["max"], conc["n"])
                    n = conc["n"]
                time.sleep(0.002 * n)  # latency grows with concurrency
                with lock:
                    conc["n"] -= 1
                return echo_pb2.EchoResponse(message="ok")

        svc = Impl()
        server = Server().add_service(svc).start("127.0.0.1:0")
        svc.find_method("Echo").set_limiter("auto")
        entry = svc.find_method("Echo")
        entry.limiter._limit = 64.0  # start far above healthy
        entry.limiter._sample_window = 16
        try:
            ch = Channel(ChannelOptions(timeout_ms=10000, max_retry=0)).init(
                str(server.listen_endpoint()))
            stub = Stub(ch, echo_pb2.DESCRIPTOR.services_by_name[
                "EchoService"])
            # healthy phase (sequential): the limiter learns its latency
            # floor before the storm inflates it
            for _ in range(40):
                stub.Echo(echo_pb2.EchoRequest(message="warm"))
            rejected = [0]

            def worker():
                for _ in range(25):
                    try:
                        stub.Echo(echo_pb2.EchoRequest(message="x"))
                    except RpcError as e:
                        if e.error_code == errors.ELIMIT:
                            rejected[0] += 1

            ts = [threading.Thread(target=worker) for _ in range(12)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            # the limit must have converged well below the inflated start
            assert entry.limiter.limit < 48, entry.limiter.limit
        finally:
            server.stop()
            server.join(timeout=2)


def _jax_and_port_lbs(name, specs):
    from brpc_tpu.butil.endpoint import EndPoint as JaxEndPoint
    from brpc_tpu.policy import load_balancers as jax_lbs

    from brpc_tpu_torch.policy import load_balancers as port_lbs

    out = []
    for ep_cls, lbs in ((JaxEndPoint, jax_lbs), (EndPoint, port_lbs)):
        lb = lbs.create_load_balancer(name)
        lb.reset_servers([lbs.ServerNode(ep_cls.parse(s), weight=w, tag=t)
                          for s, w, t in specs])
        out.append(lb)
    return out


def _seeded_specs(seed, n):
    rng = np.random.default_rng(seed)
    ports = rng.choice(np.arange(1, 65536), size=n, replace=False)
    return [(f"10.{rng.integers(256)}.{rng.integers(256)}.{rng.integers(256)}"
             f":{int(p)}", int(rng.integers(1, 6)), f"t{i}")
            for i, p in enumerate(ports)]


def test_c_hash_maps_keys_as_the_jax_package():
    class C:
        def __init__(self, code):
            self.log_id = code

    jax_lb, port_lb = _jax_and_port_lbs("c_hash", _seeded_specs(21, 7))
    keys = np.random.default_rng(22).integers(0, 1 << 62, size=1000)
    keys = [int(k) for k in keys]
    assert [str(port_lb.select_server(C(k))) for k in keys] == \
        [str(jax_lb.select_server(C(k))) for k in keys]


@pytest.mark.parametrize("name", ["rr", "wrr"])
def test_pick_sequence_equals_the_jax_packages(name):
    jax_lb, port_lb = _jax_and_port_lbs(name, _seeded_specs(23, 5))
    assert [str(port_lb.select_server()) for _ in range(200)] == \
        [str(jax_lb.select_server()) for _ in range(200)]



# ------------------------------------------------------------------ HTTP
# The reference's tests/test_naming_watch.py serves consul, the remote
# file and the app health page from its builtin HTTP services, which the
# port does not have yet; here a standard-library HTTP server on
# 127.0.0.1:0 serves the same bodies, and the cases are the reference's.
class _Agent:
    """A consul blocking-query surface, /cluster.lst and /apphealth."""

    def __init__(self):
        import http.server
        import threading

        self._lock = threading.Lock()
        self._changed = threading.Condition(self._lock)
        self._index = 1
        self._members = []           # (address, port, tag)
        self.files = {}              # path -> (status, body)
        agent = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                from urllib.parse import parse_qs, urlparse

                url = urlparse(self.path)
                if url.path.startswith("/v1/health/service/"):
                    want = int(parse_qs(url.query).get("index", ["0"])[0])
                    status, body, idx = 200, *agent._members_after(want)
                    headers = {"X-Consul-Index": str(idx)}
                else:
                    status, body = agent.files.get(url.path, (404, b""))
                    headers = {}
                self.send_response(status)
                for k, v in headers.items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def set_members(self, members) -> None:
        with self._lock:
            self._members = list(members)
            self._index += 1
            self._changed.notify_all()

    def _members_after(self, want_index, wait_s=5.0):
        import json

        deadline = time.monotonic() + wait_s
        with self._lock:
            while self._index == want_index:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._changed.wait(left)
            body = json.dumps([
                {"Service": {"Address": a, "Port": p,
                             "Tags": [t] if t else []}}
                for a, p, t in self._members]).encode()
            return body, self._index

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture()
def agent():
    a = _Agent()
    yield a
    a.close()


def _named_echo(name):
    from brpc_tpu_torch.proto import echo_pb2
    from brpc_tpu_torch.rpc import Service

    class Impl(Service):
        DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]

        def Echo(self, cntl, request, done):
            return echo_pb2.EchoResponse(message=name)

    return Impl()


class TestConsulWatch:
    def test_membership_change_under_load(self, agent):
        import threading

        from brpc_tpu_torch.proto import echo_pb2
        from brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, Stub

        servers = [Server().add_service(_named_echo(n)).start("127.0.0.1:0")
                   for n in ("s1", "s2")]
        try:
            eps = [s.listen_endpoint() for s in servers]
            agent.set_members([(eps[0].host, eps[0].port, "")])
            ch = Channel(ChannelOptions(timeout_ms=3000))
            ch.init(f"consul://127.0.0.1:{agent.port}/echo", "rr")
            stub = Stub(ch, echo_pb2.DESCRIPTOR.services_by_name[
                "EchoService"])
            assert stub.Echo(echo_pb2.EchoRequest(message="x")).message \
                == "s1"
            # live membership change under load: responses flip to the
            # new instance within the long-poll push latency
            seen, errs = set(), []
            stop = threading.Event()

            def load():
                while not stop.is_set():
                    try:
                        seen.add(stub.Echo(
                            echo_pb2.EchoRequest(message="x")).message)
                    except Exception as e:  # pragma: no cover
                        errs.append(e)
                        return
                    time.sleep(0.005)

            t = threading.Thread(target=load)
            t.start()
            try:
                agent.set_members([(eps[1].host, eps[1].port, "")])
                deadline = time.monotonic() + 3.0
                while "s2" not in seen and time.monotonic() < deadline:
                    time.sleep(0.02)
            finally:
                stop.set()
                t.join()
            assert not errs, errs
            assert "s2" in seen, seen
        finally:
            for s in servers:
                s.stop()
                s.join(timeout=2)

    def test_consul_nodes_equal_the_jax_packages(self, agent):
        from brpc_tpu.policy.naming import ConsulNamingService as JaxConsul
        from brpc_tpu_torch.policy.naming import ConsulNamingService

        agent.set_members([("10.0.0.1", 81, "0/2"), ("10.0.0.2", 82, ""),
                           ("", 83, "x"), ("10.0.0.4", 0, "")])
        path = f"127.0.0.1:{agent.port}/echo"
        mine = ConsulNamingService(path).get_servers()
        theirs = JaxConsul(path).get_servers()
        assert [(str(n.endpoint), n.weight, n.tag) for n in mine] == \
            [(str(n.endpoint), n.weight, n.tag) for n in theirs] == \
            [("10.0.0.1:81", 1, "0/2"), ("10.0.0.2:82", 1, "")]


class TestRemoteFile:
    def test_remotefile_list(self, agent):
        from brpc_tpu_torch.proto import echo_pb2
        from brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, Stub

        server = Server().add_service(_named_echo("rf")).start("127.0.0.1:0")
        try:
            agent.files["/cluster.lst"] = (
                200, f"{server.listen_endpoint()}\n".encode())
            ch = Channel(ChannelOptions(timeout_ms=3000))
            ch.init(f"remotefile://127.0.0.1:{agent.port}/cluster.lst", "rr")
            stub = Stub(ch, echo_pb2.DESCRIPTOR.services_by_name[
                "EchoService"])
            assert stub.Echo(echo_pb2.EchoRequest(message="x")).message \
                == "rf"
        finally:
            server.stop()
            server.join(timeout=2)


class TestAppLevelHealthCheck:
    def test_unhealthy_app_stays_parked(self, agent):
        """TCP alive but app erroring: the app-level probe keeps the node
        parked; flipping the app healthy un-parks it."""
        from brpc_tpu_torch.rpc.health_check import HealthChecker, http_probe

        agent.files["/apphealth"] = (503, b"warming")
        ep = EndPoint.from_ip_port("127.0.0.1", agent.port)
        lb = create_load_balancer("rr")
        lb.reset_servers([ServerNode(ep)])
        for _ in range(4):  # park the node via failure feedback
            lb.feedback(ep, errors.EFAILEDSOCKET, 1000.0)
        st = lb._node_state(ep)
        assert st.is_down
        checker = HealthChecker(lb, interval_s=0.05,
                                probe=http_probe("/apphealth", timeout=1.0))
        try:
            time.sleep(0.4)
            assert st.is_down  # TCP is up, app says 503 -> stays parked
            agent.files["/apphealth"] = (200, b"ok")
            deadline = time.monotonic() + 3.0
            while st.is_down and time.monotonic() < deadline:
                time.sleep(0.05)
            assert not st.is_down
        finally:
            checker.stop()
