"""Naming services — cluster membership -> load balancer.

Rebuild of the reference's interface (naming_service.h:36-61: RunNamingService
pushes ResetServers), the periodic base class, and the per-url shared thread
(details/naming_service_thread.cpp). Schemes (reference global.cpp:370-381
has bns/file/list/http/consul/...; ours):

  list://h1:p1,h2:p2 w=3     static list, optional w= weight and tag
  file:///path               re-read periodically, one server per line
  dns://host:port            resolve A records each refresh
  tpu://[host]               the device mesh as a server list — one node
                             per local device (the TPU-native "cluster")

Threads are shared per url: channels naming the same url reuse one watcher.

The port's copy of ``brpc_tpu/policy/naming.py``; ``tpu://`` lists the
positions of ``tpu/mesh.py`` (one per card, or ``use_cpu(n)``'s n), and
``consul://`` and ``remotefile://`` speak HTTP through the standard
library's ``http.client``, as the reference's do.
"""

from __future__ import annotations

import os
import socket as _socket
import threading
from typing import Callable, Dict, List, Optional

from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.policy.load_balancers import ServerNode

DEFAULT_INTERVAL_S = 5.0


def parse_server_item(item: str) -> Optional[ServerNode]:
    """'host:port', 'host:port w=3', 'host:port w=3 tag'."""
    parts = item.strip().split()
    if not parts:
        return None
    ep = EndPoint.parse(parts[0])
    weight, tag = 1, ""
    for p in parts[1:]:
        if p.startswith("w="):
            weight = int(p[2:])
        else:
            tag = p
    return ServerNode(ep, weight=weight, tag=tag)


class NamingService:
    """Subclass: implement get_servers() -> List[ServerNode].

    Watch-style services (consul blocking queries etc.) additionally set
    ``supports_watch = True`` and implement ``watch(push, stop_event)`` — a
    blocking loop calling ``push(nodes)`` on every membership change; the
    NamingServiceThread then pushes changes the moment they happen instead
    of on a polling interval."""

    scheme = "base"
    supports_watch = False

    def __init__(self, path: str):
        self.path = path

    def get_servers(self) -> List[ServerNode]:
        raise NotImplementedError

    def watch(self, push, stop_event) -> None:
        raise NotImplementedError


class ListNamingService(NamingService):
    scheme = "list"

    def get_servers(self) -> List[ServerNode]:
        nodes = []
        for item in self.path.split(","):
            node = parse_server_item(item)
            if node is not None:
                nodes.append(node)
        return nodes


class FileNamingService(NamingService):
    scheme = "file"

    def get_servers(self) -> List[ServerNode]:
        nodes = []
        with open(self.path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                node = parse_server_item(line)
                if node is not None:
                    nodes.append(node)
        return nodes


class DnsNamingService(NamingService):
    scheme = "dns"

    def get_servers(self) -> List[ServerNode]:
        host, _, port = self.path.partition(":")
        port = int(port or 80)
        infos = _socket.getaddrinfo(host, port, _socket.AF_INET,
                                    _socket.SOCK_STREAM)
        seen, nodes = set(), []
        for _, _, _, _, addr in infos:
            ep = EndPoint.from_ip_port(addr[0], addr[1])
            if ep not in seen:
                seen.add(ep)
                nodes.append(ServerNode(ep))
        return nodes


class TpuNamingService(NamingService):
    """The device mesh as a cluster: every local chip is a server."""

    scheme = "tpu"

    def get_servers(self) -> List[ServerNode]:
        from brpc_tpu_torch.tpu.mesh import list_device_endpoints

        host = self.path.strip("/") or "localhost"
        return [ServerNode(ep) for ep in list_device_endpoints(host)]


_schemes: Dict[str, Callable[[str], NamingService]] = {
    "list": ListNamingService,
    "file": FileNamingService,
    "dns": DnsNamingService,
    "tpu": TpuNamingService,
}


class ConsulNamingService(NamingService):
    """Watch-style membership via consul's blocking queries (reference
    policy/consul_naming_service.cpp: GET /v1/health/service/<name> with
    index/wait long-poll; changes push IMMEDIATELY, no polling interval).

    url: consul://host:port/service_name
    """

    scheme = "consul"
    supports_watch = True
    WAIT = "10s"

    def __init__(self, path: str):
        super().__init__(path)
        authority, _, service = path.partition("/")
        host, _, port = authority.partition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port or 8500)
        self.service = service
        self._index = 0

    def _query(self, index: int, wait: str = "") -> tuple:
        import http.client
        import json

        conn = http.client.HTTPConnection(self.host, self.port, timeout=30)
        try:
            q = f"/v1/health/service/{self.service}?passing=1&index={index}"
            if wait:
                q += f"&wait={wait}"
            conn.request("GET", q)
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise RuntimeError(f"consul HTTP {resp.status}")
            new_index = int(resp.headers.get("X-Consul-Index", "0") or 0)
            nodes = []
            for entry in json.loads(body.decode() or "[]"):
                svc = entry.get("Service", {})
                addr = svc.get("Address") or \
                    entry.get("Node", {}).get("Address", "")
                port_num = int(svc.get("Port", 0))
                if not addr or not port_num:
                    continue
                tags = svc.get("Tags") or []
                nodes.append(ServerNode(EndPoint.from_ip_port(addr, port_num),
                                        tag=tags[0] if tags else ""))
            return nodes, new_index
        finally:
            conn.close()

    def get_servers(self) -> List[ServerNode]:
        nodes, self._index = self._query(0)
        return nodes

    def watch(self, push, stop_event) -> None:
        """Blocking-query loop: each call hangs until membership changes
        (or the wait expires); every change pushes instantly."""
        while not stop_event.is_set():
            nodes, new_index = self._query(self._index, wait=self.WAIT)
            if stop_event.is_set():
                return
            if new_index <= 0:
                # a 200 without X-Consul-Index isn't consul — raising lets
                # the watch thread back off instead of busy-looping
                # immediate index=0 queries
                raise RuntimeError(
                    "consul response missing X-Consul-Index "
                    "(is the endpoint really a consul agent?)")
            if new_index != self._index:
                self._index = new_index
                push(nodes)


class RemoteFileNamingService(NamingService):
    """Server list fetched from an HTTP URL, refreshed periodically
    (reference policy/remote_file_naming_service.cpp).

    url: remotefile://host:port/path
    """

    scheme = "remotefile"

    def __init__(self, path: str):
        super().__init__(path)
        authority, _, rel = path.partition("/")
        host, _, port = authority.partition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port or 80)
        self.rel = "/" + rel

    def get_servers(self) -> List[ServerNode]:
        import http.client

        conn = http.client.HTTPConnection(self.host, self.port, timeout=10)
        try:
            conn.request("GET", self.rel)
            resp = conn.getresponse()
            if resp.status != 200:
                raise RuntimeError(f"remotefile HTTP {resp.status}")
            nodes = []
            for line in resp.read().decode().splitlines():
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                node = parse_server_item(line)
                if node is not None:
                    nodes.append(node)
            return nodes
        finally:
            conn.close()


def register_naming_service(scheme: str,
                            factory: Callable[[str], NamingService]) -> None:
    _schemes[scheme] = factory


_schemes["consul"] = ConsulNamingService
_schemes["remotefile"] = RemoteFileNamingService


class NamingServiceThread:
    """Periodic watcher pushing reset_servers to its listeners.

    Shared per url (reference details/naming_service_thread.cpp): all
    channels on the same url observe one refresh loop.
    """

    def __init__(self, ns: NamingService, interval_s: float):
        self._ns = ns
        self._interval = interval_s
        self._listeners = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.last_servers: List[ServerNode] = []
        self.last_error: Optional[str] = None
        self._refresh()  # first resolution is synchronous (like Init)
        self._thread = threading.Thread(
            target=self._run, name=f"ns-{ns.scheme}", daemon=True)
        self._thread.start()

    def add_listener(self, lb) -> None:
        with self._lock:
            self._listeners.append(lb)
            lb.reset_servers(self.last_servers)

    def _refresh(self) -> None:
        try:
            nodes = self._ns.get_servers()
        except Exception as e:
            self.last_error = str(e)
            return  # keep the previous list on resolution failure
        self._push(nodes)

    def _run(self) -> None:
        if self._ns.supports_watch:
            # watch loop: changes push instantly; reconnect with backoff
            backoff = 0.1
            while not self._stop.is_set():
                try:
                    self._ns.watch(self._push, self._stop)
                    backoff = 0.1
                except Exception as e:
                    self.last_error = str(e)
                    self._stop.wait(backoff)
                    backoff = min(backoff * 2, 5.0)
            return
        while not self._stop.wait(self._interval):
            self._refresh()

    def _push(self, nodes: List[ServerNode]) -> None:
        """Watch callback: deliver a membership change to every listener."""
        self.last_error = None
        with self._lock:
            self.last_servers = nodes
            listeners = list(self._listeners)
        for lb in listeners:
            lb.reset_servers(nodes)

    def stop(self) -> None:
        self._stop.set()


_threads: Dict[str, NamingServiceThread] = {}
_threads_lock = threading.Lock()


def start_naming_service(url: str, lb,
                         interval_s: float = DEFAULT_INTERVAL_S
                         ) -> NamingServiceThread:
    """url 'scheme://path' -> shared watcher thread feeding the lb."""
    scheme, sep, path = url.partition("://")
    if not sep:
        raise ValueError(f"naming url needs scheme://, got {url!r}")
    factory = _schemes.get(scheme)
    if factory is None:
        raise ValueError(f"unknown naming scheme {scheme!r}; "
                         f"have {sorted(_schemes)}")
    with _threads_lock:
        thread = _threads.get(url)
        if thread is None or thread._stop.is_set():
            thread = NamingServiceThread(factory(path), interval_s)
            _threads[url] = thread
    thread.add_listener(lb)
    return thread
