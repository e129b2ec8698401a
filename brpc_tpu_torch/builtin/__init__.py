"""builtin — observability HTTP services mounted on every server.

Counterpart of the reference's ``src/brpc/builtin/*`` (~40 services wired at
``server.cpp:499-601``): the same port that serves RPC answers ``/status``,
``/vars``, ``/flags``, ``/connections``, ``/health``, ``/rpcz``, … to
browsers and curl. Handlers are plain functions ``(server, request) ->
(status, content_type, body)`` registered by name; the HTTP protocol routes
the first path segment here before trying pb services.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

# handler(server, http_request) -> (status, content_type, body[, extra_headers])
Handler = Callable

_services: Dict[str, "BuiltinService"] = {}
_lock = threading.Lock()


class BuiltinService:
    __slots__ = ("name", "handler", "help")

    def __init__(self, name: str, handler: Handler, help: str = ""):
        self.name = name
        self.handler = handler
        self.help = help


def register_builtin(name: str, handler: Handler, help: str = "") -> None:
    with _lock:
        _services[name] = BuiltinService(name, handler, help)


def list_builtin() -> List[BuiltinService]:
    with _lock:
        return sorted(_services.values(), key=lambda s: s.name)


def dispatch(server, http) -> Optional[Tuple[int, str, bytes, Optional[dict]]]:
    """Route one HTTP request to a builtin service.

    Returns None when the path is not a builtin (the caller then tries pb
    services), else (status, content_type, body, extra_headers).

    A server may carry ``builtin_overrides`` ({page -> handler}) that win
    over the process-global registry FOR THAT SERVER ONLY — this is how
    tools/rpc_view's proxy forwards pages without hijacking the builtin
    pages of every other server in the process.
    """
    ensure_builtin_registered()
    seg = http.path.strip("/").split("/", 1)[0]
    if seg == "" :
        seg = "index"
    handler = None
    overrides = getattr(server, "builtin_overrides", None)
    if overrides is not None:
        handler = overrides.get(seg)
    if handler is None:
        with _lock:
            svc = _services.get(seg)
        if svc is None:
            return None
        handler = svc.handler
    out = handler(server, http)
    if len(out) == 3:
        status, ctype, body = out
        return status, ctype, body, None
    return out


_registered = False
_reg_lock = threading.Lock()


def ensure_builtin_registered() -> None:
    global _registered
    with _reg_lock:
        if _registered:
            return
        from brpc_tpu_torch.builtin import profiling, services  # noqa: F401

        _registered = True
