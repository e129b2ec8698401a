"""EndPoint — addressable peer, extended with the ``tpu://`` scheme.

Rebuild of the reference's ``butil/endpoint.h`` (ip:port value type with
parsing; unix-socket extension in ``details/extended_endpoint.hpp``). The TPU
build adds first-class device endpoints: ``tpu://<host>/<device_ordinal>``
names one chip of a mesh, and ``tpu://mesh/<axis-spec>`` names a whole mesh
axis (the target of ParallelChannel/PartitionChannel lowering, SURVEY §5.8).
"""

from __future__ import annotations

import re
import socket as _socket
from dataclasses import dataclass
from typing import Optional, Tuple


class EndPointError(ValueError):
    pass


@dataclass(frozen=True)
class EndPoint:
    """A peer address.

    kind:
      - "ip":   host:port TCP endpoint (the bootstrap/control transport)
      - "unix": unix domain socket path
      - "tpu":  device endpoint — host names the process, ordinal the chip
    """

    kind: str = "ip"
    host: str = ""
    port: int = 0
    path: str = ""          # unix path
    device_ordinal: int = -1  # tpu: which local device
    mesh_axis: str = ""       # tpu: optional axis name for collective targets

    # ------------------------------------------------------------- factories
    @staticmethod
    def from_ip_port(host: str, port: int) -> "EndPoint":
        return EndPoint(kind="ip", host=host, port=int(port))

    @staticmethod
    def from_unix(path: str) -> "EndPoint":
        return EndPoint(kind="unix", path=path)

    @staticmethod
    def from_tpu(host: str, device_ordinal: int, port: int = 0,
                 mesh_axis: str = "") -> "EndPoint":
        return EndPoint(kind="tpu", host=host, port=int(port),
                        device_ordinal=int(device_ordinal), mesh_axis=mesh_axis)

    # --------------------------------------------------------------- parsing
    _HOSTPORT_RE = re.compile(r"^(?P<host>\[[0-9a-fA-F:]+\]|[^:/]+):(?P<port>\d+)$")

    @staticmethod
    def parse(text: str) -> "EndPoint":
        """Parse "host:port", "unix:/path", "tpu://host:port/ordinal"."""
        text = text.strip()
        if text.startswith("unix:"):
            return EndPoint.from_unix(text[len("unix:"):])
        if text.startswith("tpu://"):
            rest = text[len("tpu://"):]
            # tpu://host[:port]/ordinal | tpu://host[:port] (ordinal 0)
            # | tpu://mesh/<axis-name>  (collective target: a whole mesh axis)
            had_slash = "/" in rest
            if had_slash:
                hostpart, _, ordpart = rest.partition("/")
            else:
                hostpart, ordpart = rest, "0"
            if hostpart == "mesh" and had_slash:
                if not ordpart:
                    raise EndPointError(f"missing mesh axis in {text!r}")
                return EndPoint(kind="tpu", host="mesh", mesh_axis=ordpart)
            host, port = EndPoint._split_hostport(hostpart, default_port=0)
            if not host:
                raise EndPointError(f"missing host in tpu endpoint {text!r}")
            try:
                ordinal = int(ordpart)
            except ValueError:
                raise EndPointError(f"bad tpu device ordinal in {text!r}")
            return EndPoint.from_tpu(host, ordinal, port=port)
        host, port = EndPoint._split_hostport(text, default_port=None)
        if port is None:
            raise EndPointError(f"missing port in endpoint {text!r}")
        return EndPoint.from_ip_port(host, port)

    @staticmethod
    def _split_hostport(text: str, default_port) -> Tuple[str, Optional[int]]:
        m = EndPoint._HOSTPORT_RE.match(text)
        if m:
            host = m.group("host")
            if host.startswith("["):
                host = host[1:-1]
            port = int(m.group("port"))
            if port > 65535:
                raise EndPointError(f"port out of range in {text!r}")
            return host, port
        if text.startswith("[") and text.endswith("]"):
            return text[1:-1], default_port  # bare bracketed ipv6
        if ":" in text:
            # has a colon but didn't match host:port -> malformed, never
            # fold junk into the hostname
            raise EndPointError(f"cannot parse endpoint {text!r}")
        return text, default_port

    # ----------------------------------------------------------------- sugar
    def is_tpu(self) -> bool:
        return self.kind == "tpu"

    def is_unix(self) -> bool:
        return self.kind == "unix"

    def sockaddr(self):
        """(family, address) usable with the socket module (ip/unix only)."""
        if self.kind == "ip":
            fam = _socket.AF_INET6 if ":" in self.host else _socket.AF_INET
            return fam, (self.host, self.port)
        if self.kind == "unix":
            return _socket.AF_UNIX, self.path
        raise EndPointError("tpu endpoints have no sockaddr; use the device transport")

    def __str__(self) -> str:
        if self.kind == "ip":
            host = f"[{self.host}]" if ":" in self.host else self.host
            return f"{host}:{self.port}"
        if self.kind == "unix":
            return f"unix:{self.path}"
        if self.mesh_axis:
            return f"tpu://mesh/{self.mesh_axis}"
        hostpart = self.host if not self.port else f"{self.host}:{self.port}"
        return f"tpu://{hostpart}/{self.device_ordinal}"


def str2endpoint(text: str) -> EndPoint:
    return EndPoint.parse(text)
