"""Load balancers (reference load_balancer.h:35-100 + policy/*_load_balancer
.cpp, registered at global.cpp:384-392).

Carried-over design: the server list lives in DoublyBufferedData so selection
never locks against membership changes; ``feedback`` closes the loop for the
locality-aware balancer (latency EWMA) and the failure tracker (consecutive
errors park a node until its next probe — the health-check half lives in
rpc/health_check.py).

Names: rr, random, wrr, wr (weighted-random), la (locality-aware),
c_hash (consistent hashing).

The port's copy of ``brpc_tpu/policy/load_balancers.py``: the same
balancers, picks and hashes, over the port's ``butil`` and
``rpc/circuit_breaker.py``.
"""

from __future__ import annotations

import bisect
import hashlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from brpc_tpu_torch.butil.doubly_buffered import DoublyBufferedData
from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.butil.misc import fast_rand_less_than
from brpc_tpu_torch.rpc import errors


@dataclass
class ServerNode:
    endpoint: EndPoint
    weight: int = 1
    tag: str = ""

    def __hash__(self):
        return hash((self.endpoint, self.tag))


class _NodeState:
    """Per-node feedback state: latency EWMA, failure streak, and the EMA
    circuit breaker (rpc/circuit_breaker.py) for error-rate isolation."""

    __slots__ = ("latency_ewma_us", "fail_streak", "down_until", "breaker",
                 "inflight")

    def __init__(self):
        from brpc_tpu_torch.rpc.circuit_breaker import CircuitBreaker

        self.latency_ewma_us = 1000.0
        self.fail_streak = 0
        self.down_until = 0.0
        self.breaker = CircuitBreaker()
        # calls selected but not yet fed back (la punishes queueing: the
        # reference charges in-flight requests their expected latency,
        # locality_aware_load_balancer.cpp)
        self.inflight = 0

    def on_feedback(self, error_code: int, latency_us: float,
                    isolation_s: float = 2.0) -> None:
        self.breaker.on_call_end(error_code, latency_us)
        if self.inflight > 0:
            self.inflight -= 1
        if error_code == errors.OK:
            self.fail_streak = 0
            self.latency_ewma_us += 0.2 * (latency_us - self.latency_ewma_us)
        else:
            self.fail_streak += 1
            if self.fail_streak >= 3:
                # park the node; naming refresh / health check revives it
                self.down_until = time.monotonic() + isolation_s

    @property
    def is_down(self) -> bool:
        if time.monotonic() < self.down_until:
            return True
        from brpc_tpu_torch import flags as _flags

        return (self.breaker.isolated
                and _flags.get("circuit_breaker_enabled"))


class LoadBalancer:
    name = "base"

    def __init__(self):
        self._servers: DoublyBufferedData[List[ServerNode]] = (
            DoublyBufferedData(list))
        self._state: Dict[EndPoint, _NodeState] = {}
        self._state_lock = threading.Lock()
        # cluster-recover policy (policy/cluster_recover.py); set via the
        # LB spec string ("rr:min_working_instances=3 hold_seconds=2")
        self.recover_policy = None
        self._usable_cache = (0.0, 0)  # (expires_monotonic, count)

    # ---------------------------------------------------------- membership
    def reset_servers(self, nodes: List[ServerNode]) -> None:
        nodes = list(nodes)

        def apply(lst):
            lst.clear()
            lst.extend(nodes)

        self._servers.modify(apply)
        with self._state_lock:
            for n in nodes:
                self._state.setdefault(n.endpoint, _NodeState())

    def add_server(self, node: ServerNode) -> None:
        self._servers.modify(lambda lst: lst.append(node))
        with self._state_lock:
            self._state.setdefault(node.endpoint, _NodeState())

    def remove_server(self, endpoint: EndPoint) -> None:
        def apply(lst):
            lst[:] = [n for n in lst if n.endpoint != endpoint]

        self._servers.modify(apply)

    def server_count(self) -> int:
        with self._servers.read() as lst:
            return len(lst)

    def usable_count(self) -> int:
        """Instances not parked by feedback/breaker (cluster-recover input).
        Cached ~10ms: it sits on the per-request path while recovering
        (the reference caches for detect_available_server_interval_ms,
        cluster_recover_policy.cpp GetUsableServerCount)."""
        now = time.monotonic()
        expires, count = self._usable_cache
        if now < expires:
            return count
        with self._servers.read() as lst:
            count = sum(1 for n in lst
                        if not self._node_state(n.endpoint).is_down)
        self._usable_cache = (now + 0.01, count)
        return count

    # ------------------------------------------------------------ feedback
    def feedback(self, endpoint: EndPoint, error_code: int,
                 latency_us: float) -> None:
        with self._state_lock:
            st = self._state.get(endpoint)
        if st is not None:
            st.on_feedback(error_code, latency_us)

    def _node_state(self, ep: EndPoint) -> _NodeState:
        with self._state_lock:
            return self._state.setdefault(ep, _NodeState())

    def _alive(self, nodes: List[ServerNode]) -> List[ServerNode]:
        alive = [n for n in nodes if not self._node_state(n.endpoint).is_down]
        if alive:
            return alive
        if self.recover_policy is not None and nodes:
            # selection exhausted every candidate — the cluster is down;
            # arm de-thundered recovery (the reference arms whenever
            # selection exhausts, round_robin_load_balancer.cpp:128-132)
            self.recover_policy.start_recover()
        return list(nodes)  # all parked -> try anyway

    # ------------------------------------------------------------- select
    def select_server(self, cntl=None) -> Optional[EndPoint]:
        raise NotImplementedError


class RoundRobinLB(LoadBalancer):
    name = "rr"

    def __init__(self):
        super().__init__()
        self._counter = itertools.count()

    def select_server(self, cntl=None) -> Optional[EndPoint]:
        with self._servers.read() as lst:
            nodes = self._alive(lst)
            if not nodes:
                return None
            return nodes[next(self._counter) % len(nodes)].endpoint


class RandomLB(LoadBalancer):
    name = "random"

    def select_server(self, cntl=None) -> Optional[EndPoint]:
        with self._servers.read() as lst:
            nodes = self._alive(lst)
            if not nodes:
                return None
            return nodes[fast_rand_less_than(len(nodes))].endpoint


class WeightedRoundRobinLB(LoadBalancer):
    name = "wrr"

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()
        self._current: Dict[EndPoint, float] = {}

    def select_server(self, cntl=None) -> Optional[EndPoint]:
        # smooth weighted rr (nginx-style): current += weight; pick max;
        # picked -= total
        with self._servers.read() as lst:
            nodes = self._alive(lst)
            if not nodes:
                return None
            with self._lock:
                total = 0
                best, best_cur = None, float("-inf")
                for n in nodes:
                    w = max(1, n.weight)
                    total += w
                    cur = self._current.get(n.endpoint, 0.0) + w
                    self._current[n.endpoint] = cur
                    if cur > best_cur:
                        best, best_cur = n, cur
                self._current[best.endpoint] -= total
                return best.endpoint


class WeightedRandomLB(LoadBalancer):
    name = "wr"

    def select_server(self, cntl=None) -> Optional[EndPoint]:
        with self._servers.read() as lst:
            nodes = self._alive(lst)
            if not nodes:
                return None
            total = sum(max(1, n.weight) for n in nodes)
            pick = fast_rand_less_than(total)
            acc = 0
            for n in nodes:
                acc += max(1, n.weight)
                if pick < acc:
                    return n.endpoint
            return nodes[-1].endpoint


class LocalityAwareLB(LoadBalancer):
    """Latency-feedback balancer (policy/locality_aware_load_balancer.cpp):
    a node's share ~ weight / (EWMA latency x (1 + in-flight)). The
    in-flight term is the reference's queueing punishment: every selected-
    but-unanswered call charges the node its expected latency again, so a
    stalling replica sheds load IMMEDIATELY (before any response confirms
    the stall), and traffic returns as feedback lands. The reference's
    divide-tree makes the weighted pick O(log n) at its 10k-server scale;
    cluster sizes here make the O(n) prefix walk the simpler win (the
    server list already lives in DoublyBufferedData for lock-free reads)."""

    name = "la"

    # in-flight charges are repaid by feedback, but selections that never
    # complete (retry re-picks, recovery shedding, connect failures) would
    # leak theirs forever — a periodic half-life decay forgives stale
    # charges so a once-punished node always earns its way back
    _DECAY_S = 0.5

    def __init__(self):
        super().__init__()
        self._last_decay = time.monotonic()

    def _decay_inflight(self) -> None:
        now = time.monotonic()
        if now - self._last_decay < self._DECAY_S:
            return
        self._last_decay = now
        with self._state_lock:
            for st in self._state.values():
                if st.inflight > 0:
                    st.inflight //= 2

    def select_server(self, cntl=None) -> Optional[EndPoint]:
        self._decay_inflight()
        with self._servers.read() as lst:
            nodes = self._alive(lst)
            if not nodes:
                return None
            states = [self._node_state(n.endpoint) for n in nodes]
            inv = [
                max(1, n.weight)
                / (max(1.0, st.latency_ewma_us) * (1 + max(0, st.inflight)))
                for n, st in zip(nodes, states)
            ]
            total = sum(inv)
            # weighted-random draw over punished inverse latencies
            r = (fast_rand_less_than(1 << 30) / float(1 << 30)) * total
            acc = 0.0
            chosen = nodes[-1]
            chosen_st = states[-1]
            for n, st, w in zip(nodes, states, inv):
                acc += w
                if r < acc:
                    chosen, chosen_st = n, st
                    break
            chosen_st.inflight += 1  # repaid by the call's feedback
            return chosen.endpoint


class ConsistentHashingLB(LoadBalancer):
    """Ketama-style ring (policy/consistent_hashing_load_balancer.cpp).
    The request code (cntl.log_id by default) picks the ring position, so
    one key consistently lands on one server, with minimal movement on
    membership change."""

    name = "c_hash"
    VIRTUAL_NODES = 64

    def __init__(self):
        super().__init__()
        self._ring_lock = threading.Lock()
        self._ring: List[int] = []
        self._ring_eps: List[EndPoint] = []

    def reset_servers(self, nodes: List[ServerNode]) -> None:
        super().reset_servers(nodes)
        ring = []
        for n in nodes:
            for v in range(self.VIRTUAL_NODES * max(1, n.weight)):
                h = int.from_bytes(
                    hashlib.md5(f"{n.endpoint}#{v}".encode()).digest()[:8],
                    "big")
                ring.append((h, n.endpoint))
        ring.sort(key=lambda he: he[0])
        with self._ring_lock:
            self._ring = [h for h, _ in ring]
            self._ring_eps = [e for _, e in ring]

    def select_server(self, cntl=None) -> Optional[EndPoint]:
        code = getattr(cntl, "log_id", 0) if cntl is not None else 0
        h = int.from_bytes(
            hashlib.md5(str(code).encode()).digest()[:8], "big")
        with self._ring_lock:
            if not self._ring:
                return None
            idx = bisect.bisect(self._ring, h) % len(self._ring)
            return self._ring_eps[idx]


_registry: Dict[str, Callable[[], LoadBalancer]] = {
    "rr": RoundRobinLB,
    "random": RandomLB,
    "wrr": WeightedRoundRobinLB,
    "wr": WeightedRandomLB,
    "la": LocalityAwareLB,
    "c_hash": ConsistentHashingLB,
}


def register_load_balancer(name: str, factory: Callable[[], LoadBalancer]) -> None:
    _registry[name] = factory


def create_load_balancer(name: str) -> LoadBalancer:
    """``name`` or ``name:params``. Params currently configure the
    cluster-recover policy (reference LB spec strings, e.g.
    ``"rr:min_working_instances=3 hold_seconds=2"``)."""
    base, _, params = name.partition(":")
    try:
        lb = _registry[base]()
    except KeyError:
        raise ValueError(f"unknown load balancer {base!r}; "
                         f"have {sorted(_registry)}")
    if params:
        from brpc_tpu_torch.policy.cluster_recover import parse_recover_params

        lb.recover_policy = parse_recover_params(params)
    return lb
