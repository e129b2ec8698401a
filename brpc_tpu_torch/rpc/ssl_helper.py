"""SSL/TLS support — context constructors + options (reference
details/ssl_helper.cpp, ssl_options.h).

Design points carried over from the reference:
  - ONE server port serves TLS and plaintext simultaneously: the first
    byte of a new connection is sniffed (0x16 = TLS handshake record) and
    only then is the connection wrapped (reference sniffs in
    Socket::ProcessEvent; ours peeks in a fiber before registering the
    socket so the dispatcher never blocks on a handshake).
  - ALPN drives h2 selection (ssl_options.h alpn; grpc channels offer
    "h2" and require the peer to agree).
  - After the (blocking, timeout-bounded) handshake the socket returns to
    nonblocking mode; SSLWantRead/WriteError map onto the normal
    EAGAIN-style event flow in Socket.drain_recv/_drain_write_queue.
"""

from __future__ import annotations

import ssl
from dataclasses import dataclass, field
from typing import List, Optional

TLS_HANDSHAKE_BYTE = 0x16


@dataclass
class ServerSslOptions:
    """reference ssl_options.h ServerSSLOptions (subset)."""

    certfile: str = ""
    keyfile: str = ""
    alpn_protocols: List[str] = field(default_factory=lambda: ["h2",
                                                               "http/1.1"])
    # when set, require and verify client certificates against this CA
    verify_client_ca: str = ""


@dataclass
class ClientSslOptions:
    """reference ssl_options.h ChannelSSLOptions (subset)."""

    # CA bundle to verify the server against; empty = no verification
    # (self-signed dev certs, like the reference's default verify.ca_file "")
    ca_file: str = ""
    server_hostname: str = ""
    alpn_protocols: List[str] = field(default_factory=list)
    certfile: str = ""   # client cert (mutual TLS)
    keyfile: str = ""

    def cache_key(self) -> str:
        return (f"ssl:{self.ca_file}:{self.server_hostname}:"
                f"{','.join(self.alpn_protocols)}:{self.certfile}")


def build_server_context(opts: ServerSslOptions) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(opts.certfile, opts.keyfile or None)
    if opts.alpn_protocols:
        ctx.set_alpn_protocols(opts.alpn_protocols)
    if opts.verify_client_ca:
        ctx.load_verify_locations(opts.verify_client_ca)
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def build_client_context(opts: ClientSslOptions) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    if opts.ca_file:
        ctx.load_verify_locations(opts.ca_file)
        ctx.check_hostname = bool(opts.server_hostname)
    else:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    if opts.alpn_protocols:
        ctx.set_alpn_protocols(opts.alpn_protocols)
    if opts.certfile:
        ctx.load_cert_chain(opts.certfile, opts.keyfile or None)
    return ctx


def wrap_client_socket(raw_sock, opts: ClientSslOptions,
                       timeout: float = 3.0):
    """Blocking handshake (bounded by timeout), then back to nonblocking.
    Returns the wrapped socket; raises ssl.SSLError/OSError on failure."""
    ctx = build_client_context(opts)
    raw_sock.settimeout(timeout)
    tls = ctx.wrap_socket(
        raw_sock, server_side=False,
        server_hostname=opts.server_hostname or None)
    tls.setblocking(False)
    return tls


def wrap_server_socket(raw_sock, ctx: ssl.SSLContext, timeout: float = 5.0):
    raw_sock.settimeout(timeout)
    tls = ctx.wrap_socket(raw_sock, server_side=True)
    tls.setblocking(False)
    return tls


def alpn_selected(sock) -> Optional[str]:
    try:
        return sock.selected_alpn_protocol()
    except (AttributeError, ssl.SSLError):
        return None
