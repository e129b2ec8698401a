"""Redis protocol (RESP) — pipelined client + server-side RedisService.

Counterpart of the reference's ``policy/redis_protocol.cpp`` +
``redis_command.cpp`` + ``redis.h`` (RedisRequest/RedisResponse/RedisReply)
and the server half that lets a Server answer redis-cli directly
(``ServerOptions.redis_service``).

Client model (same as the reference): one RPC = N pipelined commands = N
replies, strictly ordered on the connection. Correlation is positional — a
per-socket FIFO of (call id, expected reply count) — so timeouts/retries
rely on the engine's stale-attempt rejection while later replies keep
popping in order. Server model: commands dispatch to a ``RedisService``'s
command handlers through a per-connection ExecutionQueue (responses must be
emitted in arrival order even when handlers run in fibers).

The port's copy of the JAX package's ``policy/redis_protocol.py``: the same
bytes on the wire, so either package's client talks to the other's server.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.fiber import runtime
from brpc_tpu_torch.proto import rpc_meta_pb2
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.protocol import (
    PARSE_BAD,
    PARSE_NOT_ENOUGH_DATA,
    PARSE_TRY_OTHERS,
    ParsedMessage,
    Protocol,
    dispatch_response,
    init_socket_state,
)

CRLF = b"\r\n"

# ---------------------------------------------------------------- RESP codec
REPLY_STRING = 1    # + simple string
REPLY_ERROR = 2     # - error
REPLY_INTEGER = 3   # : integer
REPLY_BULK = 4      # $ bulk string (None = nil)
REPLY_ARRAY = 5     # * array (None = nil array)


class RedisReply:
    __slots__ = ("type", "value")

    def __init__(self, type_: int, value):
        self.type = type_
        self.value = value

    def is_nil(self) -> bool:
        return self.value is None

    def is_error(self) -> bool:
        return self.type == REPLY_ERROR

    def __repr__(self) -> str:
        return f"RedisReply({self.type}, {self.value!r})"

    def __eq__(self, other) -> bool:
        if isinstance(other, RedisReply):
            return self.type == other.type and self.value == other.value
        return self.value == other


def pack_command(*args) -> bytes:
    """One command -> RESP array of bulk strings."""
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        if isinstance(a, str):
            a = a.encode()
        elif isinstance(a, (int, float)):
            a = str(a).encode()
        out.append(b"$%d\r\n%s\r\n" % (len(a), a))
    return b"".join(out)


def pack_reply(reply: RedisReply) -> bytes:
    """Serialize one reply (server side)."""
    t, v = reply.type, reply.value
    if t == REPLY_STRING:
        return b"+%s\r\n" % (v.encode() if isinstance(v, str) else v)
    if t == REPLY_ERROR:
        return b"-%s\r\n" % (v.encode() if isinstance(v, str) else v)
    if t == REPLY_INTEGER:
        return b":%d\r\n" % v
    if t == REPLY_BULK:
        if v is None:
            return b"$-1\r\n"
        if isinstance(v, str):
            v = v.encode()
        return b"$%d\r\n%s\r\n" % (len(v), v)
    if t == REPLY_ARRAY:
        if v is None:
            return b"*-1\r\n"
        return b"*%d\r\n" % len(v) + b"".join(pack_reply(r) for r in v)
    raise ValueError(f"bad reply type {t}")


def parse_reply(data: bytes, pos: int) -> Tuple[Optional[RedisReply], int]:
    """Parse one reply at pos. Returns (reply, new_pos); (None, pos) when
    incomplete. Raises ValueError on malformed bytes."""
    if pos >= len(data):
        return None, pos
    marker = data[pos:pos + 1]
    nl = data.find(CRLF, pos + 1)
    if nl < 0:
        return None, pos
    line = data[pos + 1:nl]
    after = nl + 2
    if marker == b"+":
        return RedisReply(REPLY_STRING, line.decode("utf-8", "replace")), after
    if marker == b"-":
        return RedisReply(REPLY_ERROR, line.decode("utf-8", "replace")), after
    if marker == b":":
        return RedisReply(REPLY_INTEGER, int(line)), after
    if marker == b"$":
        n = int(line)
        if n < 0:
            return RedisReply(REPLY_BULK, None), after
        if len(data) < after + n + 2:
            return None, pos
        return RedisReply(REPLY_BULK, bytes(data[after:after + n])), after + n + 2
    if marker == b"*":
        n = int(line)
        if n < 0:
            return RedisReply(REPLY_ARRAY, None), after
        items = []
        p = after
        for _ in range(n):
            item, p2 = parse_reply(data, p)
            if item is None:
                return None, pos
            items.append(item)
            p = p2
        return RedisReply(REPLY_ARRAY, items), p
    raise ValueError(f"bad RESP marker {marker!r}")


def first_needed(window: bytes, pos: int = 0) -> Optional[int]:
    """Minimum ABSOLUTE length the buffer must reach for the reply at pos
    to be complete, derived from the prefix alone — or None when the prefix
    itself is still too short to tell. Lets the parse paths skip flattening
    a large buffer whose (bulk-heavy) head reply is known-incomplete."""
    if pos >= len(window):
        return None
    marker = window[pos:pos + 1]
    nl = window.find(CRLF, pos + 1)
    if nl < 0:
        return None
    after = nl + 2
    if marker in (b"+", b"-", b":"):
        return after
    try:
        n = int(window[pos + 1:nl])
    except ValueError:
        return after  # malformed: let the real parser report it
    if marker == b"$":
        return after if n < 0 else after + n + 2
    if marker == b"*":
        p = after
        for _ in range(max(n, 0)):
            need = first_needed(window, p)
            if need is None or need > len(window):
                return need  # element extends past the window
            p = need
        return p
    return after


# ------------------------------------------------------- request / response
class RedisRequest:
    """Pipelined command batch; duck-types the pb message surface so it
    rides the normal Channel.call_method path."""

    def __init__(self):
        self._commands: List[bytes] = []

    def add_command(self, *args) -> "RedisRequest":
        if not args:
            raise ValueError("empty redis command")
        self._commands.append(pack_command(*args))
        return self

    @property
    def command_count(self) -> int:
        return len(self._commands)

    def clear(self) -> None:
        self._commands.clear()

    def SerializeToString(self) -> bytes:
        return b"".join(self._commands)

    def ParseFromString(self, data: bytes) -> None:  # for rpc_replay
        self._commands = [bytes(data)] if data else []


class RedisResponse:
    def __init__(self):
        self._replies: List[RedisReply] = []

    def reply(self, i: int) -> RedisReply:
        return self._replies[i]

    @property
    def reply_size(self) -> int:
        return len(self._replies)

    def ParseFromString(self, data: bytes) -> None:
        self._replies = []
        pos = 0
        while pos < len(data):
            r, pos2 = parse_reply(data, pos)
            if r is None:
                break
            self._replies.append(r)
            pos = pos2

    def SerializeToString(self) -> bytes:
        return b"".join(pack_reply(r) for r in self._replies)


# the pseudo-method redis calls ride on (service/method never hit the wire)
def redis_method():
    from brpc_tpu_torch.rpc.channel import MethodDescriptor

    return MethodDescriptor("redis", "command", RedisRequest, RedisResponse)


def count_commands(payload: bytes) -> int:
    """Count top-level RESP arrays (= expected replies) in a request blob."""
    n = 0
    pos = 0
    while pos < len(payload):
        r, pos2 = parse_reply(payload, pos)
        if r is None:
            break
        n += 1
        pos = pos2
    return n


# ------------------------------------------------------------ server service
class RedisService:
    """Server half: register command handlers; unknown commands get -ERR.

    handler(args: List[bytes]) -> RedisReply  (args[0] = command name)
    """

    def __init__(self):
        self._handlers: Dict[str, Callable] = {}

    def add_command_handler(self, name: str, handler: Callable) -> "RedisService":
        self._handlers[name.lower()] = handler
        return self

    def handle(self, args: List[bytes]) -> RedisReply:
        if not args or args[0] is None:
            return RedisReply(REPLY_ERROR, "ERR empty command")
        name = args[0].decode("utf-8", "replace").lower()
        if name == "ping" and name not in self._handlers:
            return RedisReply(REPLY_STRING, "PONG")
        h = self._handlers.get(name)
        if h is None:
            return RedisReply(REPLY_ERROR, f"ERR unknown command '{name}'")
        try:
            return h(args)
        except Exception as e:
            return RedisReply(REPLY_ERROR, f"ERR handler failed: {e}")


class _RedisClientState:
    __slots__ = ("fifo", "lock", "acc")

    def __init__(self):
        self.fifo = deque()   # (cid, attempt_version, n_expected)
        self.lock = threading.Lock()
        self.acc: List[bytes] = []  # serialized replies for the FIFO head


class _RedisServerState:
    __slots__ = ("queue",)

    def __init__(self, sock, service):
        def consume(items):
            if items is None:
                return
            out = IOBuf()
            for args in items:
                # one bad command must not drop the whole batch's replies —
                # positional correlation would desync for every client
                try:
                    reply = service.handle(args)
                except Exception as e:
                    reply = RedisReply(REPLY_ERROR, f"ERR {e}")
                try:
                    out.append(pack_reply(reply))
                except Exception:
                    out.append(pack_reply(
                        RedisReply(REPLY_ERROR, "ERR unserializable reply")))
            sock.write(out)

        from brpc_tpu_torch.fiber.execution_queue import ExecutionQueue

        self.queue = ExecutionQueue(consume)


class RedisProtocol(Protocol):
    """RESP on both sides, positional correlation (see module docstring)."""

    name = "redis"
    stateful = True

    # ------------------------------------------------------------- recv path
    def parse(self, buf: IOBuf, sock=None):
        cst: Optional[_RedisClientState] = getattr(sock, "redis_client", None)
        if cst is not None:
            return self._parse_client(buf, sock, cst)
        srv = sock.owner_server
        service = getattr(srv.options, "redis_service", None) if srv else None
        sst: Optional[_RedisServerState] = getattr(sock, "redis_server", None)
        if sst is not None:
            return self._parse_server(buf, sock, sst)
        if service is not None and buf.fetch(1) in (b"*",):
            sst = _RedisServerState(sock, service)
            sock.redis_server = sst
            sock.preferred_protocol = self
            return self._parse_server(buf, sock, sst)
        return PARSE_TRY_OTHERS, None

    @staticmethod
    def _head_incomplete(buf: IOBuf) -> bool:
        """True when the first reply/command provably extends past the
        buffered bytes — skip the full flatten (quadratic on big values)."""
        window = buf.fetch(min(len(buf), 65536))
        need = first_needed(window)
        return need is not None and need > len(buf)

    def _parse_server(self, buf: IOBuf, sock, sst: _RedisServerState):
        if self._head_incomplete(buf):
            return PARSE_NOT_ENOUGH_DATA, None
        data = buf.fetch(len(buf))
        pos = 0
        while pos < len(data):
            try:
                r, pos2 = parse_reply(data, pos)  # commands are RESP arrays
            except (ValueError, IndexError):
                buf.pop_front(pos)
                return PARSE_BAD, None
            if r is None:
                break
            if r.type != REPLY_ARRAY or r.value is None:
                buf.pop_front(pos)
                return PARSE_BAD, None
            args = [item.value if item.type == REPLY_BULK else
                    str(item.value).encode() for item in r.value]
            sock.in_messages += 1
            sst.queue.execute(args)  # ordered per-connection execution
            pos = pos2
        buf.pop_front(pos)
        return PARSE_NOT_ENOUGH_DATA, None

    def _parse_client(self, buf: IOBuf, sock, cst: _RedisClientState):
        if self._head_incomplete(buf):
            return PARSE_NOT_ENOUGH_DATA, None
        data = buf.fetch(len(buf))
        pos = 0
        completed = []  # (cid, ver, reply_bytes)
        with cst.lock:
            while pos < len(data) and cst.fifo:
                cid, ver, need = cst.fifo[0]
                try:
                    r, pos2 = parse_reply(data, pos)
                except (ValueError, IndexError):
                    buf.pop_front(pos)
                    return PARSE_BAD, None
                if r is None:
                    break
                cst.acc.append(data[pos:pos2])
                pos = pos2
                if len(cst.acc) >= need:
                    completed.append((cid, ver, b"".join(cst.acc)))
                    cst.acc = []
                    cst.fifo.popleft()
        buf.pop_front(pos)
        with cst.lock:
            unsolicited = not cst.fifo and pos < len(data)
        if unsolicited:
            # bytes with no outstanding request: protocol confusion — fail
            # the connection rather than buffering forever
            return PARSE_BAD, None
        for cid, ver, body in completed:
            meta = rpc_meta_pb2.RpcMeta()
            meta.correlation_id = cid
            meta.attempt_version = ver
            msg = ParsedMessage(self, meta, IOBuf(body))
            msg.socket = sock
            sock.in_messages += 1
            runtime.start_background(dispatch_response, msg)
        return PARSE_NOT_ENOUGH_DATA, None

    # ------------------------------------------------------------- send path
    def issue_request(self, sock, meta, payload: bytes,
                      attachment: bytes = b"", checksum: bool = False,
                      id_wait=None) -> int:
        cst: _RedisClientState = init_socket_state(
            sock, "redis_client", _RedisClientState, self)
        n = count_commands(payload)
        if n == 0:
            return errors.EREQUEST
        entry = (meta.correlation_id, meta.attempt_version, n)
        with cst.lock:
            # registration and write must be atomic: FIFO order IS the wire
            # order, so a second writer must not slip its bytes in between
            cst.fifo.append(entry)
            rc = sock.write(IOBuf(payload), id_wait=id_wait)
            if rc != 0:
                try:
                    cst.fifo.remove(entry)
                except ValueError:
                    pass
        return rc

    # ------------------------------------------------------ engine contracts
    @staticmethod
    def split_attachment(msg: ParsedMessage) -> Tuple[bytes, bytes]:
        return msg.body.tobytes(), b""

    @staticmethod
    def verify_checksum(meta, payload: bytes) -> bool:
        return True
