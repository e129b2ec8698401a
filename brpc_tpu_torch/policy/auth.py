"""Authentication — pluggable credential exchange per connection.

Rebuild of the reference's ``Authenticator`` interface (authenticator.h;
per-socket "fight" resolved in controller.cpp:1186-1199): the client
generates credentials once per channel, sends them in ``RpcMeta.auth_token``
(trpc_std) or the ``Authorization`` header (http); the server verifies and
may attach an AuthContext the service reads via ``cntl.auth_context``.

Our simplification, stated up front: the reference authenticates once per
*connection* (first RPC carries credentials, later ones inherit); we carry
the token on every request — stateless, replay-window-free, and immune to
the connection-pool sharing races the reference's per-socket fight exists
to resolve.
"""

from __future__ import annotations

import hashlib
import hmac
import time
from typing import Optional


class AuthContext:
    """What a successful verification learned (reference auth_context.h)."""

    __slots__ = ("user", "group", "roles", "is_service")

    def __init__(self, user: str = "", group: str = "", roles=(),
                 is_service: bool = False):
        self.user = user
        self.group = group
        self.roles = tuple(roles)
        self.is_service = is_service


class Authenticator:
    """Subclass and pass to ChannelOptions.auth / ServerOptions.auth."""

    def generate_credential(self) -> str:
        """Client side: the token sent with each request."""
        raise NotImplementedError

    def verify_credential(self, token: str,
                          peer) -> Optional[AuthContext]:
        """Server side — THE framework entry point: return an AuthContext
        to accept (it becomes ``cntl.auth_context``), None to reject.
        Called concurrently from request-processing fibers; implementations
        must be thread-safe and must not stash per-request state on self."""
        raise NotImplementedError


class SharedSecretAuthenticator(Authenticator):
    """HMAC over a timestamp with a pre-shared key — a usable default (the
    reference ships the interface only; this is our batteries-included
    implementation for tests/examples)."""

    def __init__(self, secret: bytes, user: str = "default",
                 max_skew_s: float = 300.0):
        self.secret = secret if isinstance(secret, bytes) else secret.encode()
        self.user = user
        self.max_skew_s = max_skew_s

    def generate_credential(self) -> str:
        ts = str(int(time.time()))
        mac = hmac.new(self.secret, f"{self.user}:{ts}".encode(),
                       hashlib.sha256).hexdigest()
        return f"{self.user}:{ts}:{mac}"

    def verify_credential(self, token: str, peer) -> Optional[AuthContext]:
        try:
            user, ts, mac = token.split(":")
            if abs(time.time() - int(ts)) > self.max_skew_s:
                return None
            expect = hmac.new(self.secret, f"{user}:{ts}".encode(),
                              hashlib.sha256).hexdigest()
            if not hmac.compare_digest(mac, expect):
                return None
            return AuthContext(user=user)
        except (ValueError, AttributeError):
            return None
