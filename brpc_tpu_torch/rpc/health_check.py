"""Health check — periodic re-probe of parked endpoints.

Rebuild of ``details/health_check.cpp:140`` (HealthCheckTask: failed sockets
re-probed every health_check_interval_s with backoff; optional app-level RPC
probe :34-107). Ours probes with a TCP connect (or an EchoService RPC when
``app_check`` is set) and un-parks the node in every registered load
balancer on success.

The port's copy of ``brpc_tpu/rpc/health_check.py``: a local
``tpu://host/n`` resolves through ``tpu/mesh.py`` (a missing ordinal, or
no card without ``use_cpu``, stays parked), a tunnel endpoint through the
port's ``tpu/transport.py``.
"""

from __future__ import annotations

import socket as _socket
import threading
import time
from typing import Callable, List, Optional

from brpc_tpu_torch.butil.endpoint import EndPoint


def tcp_probe(ep: EndPoint, timeout: float = 1.0) -> bool:
    if ep.is_tpu():
        # scheme-dispatch kept for direct callers; a tpu endpoint is never
        # probed with a raw TCP connect (accepting the bootstrap socket
        # says nothing about the tunnel handshake)
        return tpu_probe(ep, timeout)
    try:
        fam, addr = ep.sockaddr()
        with _socket.socket(fam, _socket.SOCK_STREAM) as s:
            s.settimeout(timeout)
            s.connect(addr)
        return True
    except OSError:
        return False


def tpu_probe(ep: EndPoint, timeout: float = 1.0) -> bool:
    """tpu:// probe: a local device endpoint must resolve; a remote tunnel
    endpoint must hold (or re-establish) a completed TPUC handshake — the
    same connect_tpu path RPCs take, so a successful probe leaves a live
    healed tunnel behind and resets the endpoint's reconnect breaker."""
    if not ep.port:
        from brpc_tpu_torch.tpu.mesh import resolve_device

        try:
            resolve_device(ep)
            return True
        except (ValueError, RuntimeError):
            return False
    try:
        from brpc_tpu_torch.tpu.transport import _healer_for, connect_tpu

        if connect_tpu(ep, connect_timeout=timeout).failed:
            return False
        # a verified-live tunnel is a full pardon for the reconnect breaker
        _healer_for((ep.host, ep.port, ep.device_ordinal)).breaker.reset()
        return True
    except Exception:
        return False


def probe_for_endpoint(ep: EndPoint) -> Callable[[EndPoint], bool]:
    """Default probe selection by endpoint scheme."""
    return tpu_probe if ep.is_tpu() else tcp_probe


class HealthChecker:
    """One background loop probing every parked node of a load balancer.

    Mass-recovery is rationed through a ClusterRecoverGuard: when most of
    the cluster is parked, healthy probes un-park one node per guard
    interval instead of all at once (the reference's
    cluster_recover_policy.cpp de-thundering)."""

    def __init__(self, lb, interval_s: Optional[float] = None,
                 probe: Optional[Callable[[EndPoint], bool]] = None,
                 recover_guard=None):
        from brpc_tpu_torch import flags as _flags
        from brpc_tpu_torch.rpc.circuit_breaker import ClusterRecoverGuard

        if interval_s is None:  # default rides the reloadable flag
            interval_s = _flags.get("health_check_interval_s")
        self._lb = lb
        self._interval = interval_s
        # None: pick per node by scheme (tpu:// nodes get tpu_probe, the
        # rest tcp_probe) — a mixed cluster must not TCP-probe its tunnels
        self._probe = probe
        self._guard = recover_guard or ClusterRecoverGuard(
            interval_s=interval_s)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="health-check", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        from brpc_tpu_torch.profiling import registry as _prof

        _prof.register_current_thread(_prof.ROLE_HEALER)
        while not self._stop.wait(self._interval):
            try:
                self._check_once()
            except Exception:
                pass

    def _check_once(self) -> None:
        with self._lb._state_lock:
            states = list(self._lb._state.items())
        parked = [(ep, st) for ep, st in states if st.is_down]
        total = len(states)
        recovered = 0
        for ep, st in parked:
            probe = self._probe or probe_for_endpoint(ep)
            if not probe(ep):
                continue
            if not self._guard.may_recover(len(parked) - recovered, total):
                break  # rationed: next interval takes the next node
            st.fail_streak = 0
            st.down_until = 0.0  # back in rotation
            st.breaker.reset()
            recovered += 1

    def stop(self) -> None:
        self._stop.set()


def http_probe(path: str = "/health", timeout: float = 1.0):
    """App-level probe factory (reference details/health_check.cpp:34-107
    HealthCheckChannel: an RPC on the endpoint must SUCCEED — a machine
    that accepts TCP but serves errors stays parked). Success = HTTP 2xx
    on ``path``."""

    def probe(ep: EndPoint) -> bool:
        try:
            fam, addr = ep.sockaddr()
            with _socket.socket(fam, _socket.SOCK_STREAM) as s:
                s.settimeout(timeout)
                s.connect(addr)
                host = ep.host or "localhost"
                s.sendall(f"GET {path} HTTP/1.1\r\nHost: {host}\r\n"
                          f"Connection: close\r\n\r\n".encode())
                head = b""
                while b"\r\n" not in head and len(head) < 256:
                    chunk = s.recv(256)
                    if not chunk:
                        break
                    head += chunk
            parts = head.split(None, 2)
            return len(parts) >= 2 and parts[1][:1] == b"2"
        except (OSError, ValueError):
            return False

    return probe
