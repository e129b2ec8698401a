"""Protocol registry — pluggable wire protocols tried in order.

Rebuild of the reference's ``protocol.h:77-172`` struct-of-function-pointers +
registration at GlobalInitializeOrDie (``global.cpp:421-601``): a Protocol
knows how to (a) cut one message out of a read buffer, (b) pack a request,
(c) process a request server-side, (d) process a response client-side. The
InputMessenger tries registered protocols in order and remembers each
socket's preferred protocol after the first match.
"""

from __future__ import annotations

import threading
import time as _time
from typing import Dict, List, Optional, Tuple

from brpc_tpu_torch.butil.iobuf import IOBuf

# parse results (reference ParseResult/ParseError)
PARSE_OK = 0
PARSE_NOT_ENOUGH_DATA = 1
PARSE_TRY_OTHERS = 2
PARSE_BAD = 3


def stream_body_min() -> int:
    """Bodies at least this large stream through a PendingBodyCursor."""
    from brpc_tpu_torch import flags

    return int(flags.get("stream_body_min_bytes"))


def can_stream_body(sock) -> bool:
    """True when ``sock`` accepts a pending-body cursor right now.

    Only sockets that declare a ``pending_body`` slot participate (Socket and
    the tunnel's virtual socket); plain IOBuf fuzzing harnesses and foreign
    objects fall back to whole-message buffering. A slot already holding a
    cursor also refuses — one in-flight body per connection, matching the
    serial cut loop.
    """
    return sock is not None and getattr(sock, "pending_body", False) is None


class PendingBodyCursor:
    """Mid-message consumption state for one declared-length body.

    A protocol that has cracked a message header but whose body has not fully
    arrived may pop the header, register a cursor on the socket
    (``sock.pending_body = cursor``) and return PARSE_NOT_ENOUGH_DATA. From
    then on ``InputMessenger.cut_messages`` feeds arriving bytes straight from
    ``read_buf`` into the cursor without re-running ``parse``; when the last
    byte lands the cut loop calls ``finish()`` and dispatches the returned
    ParsedMessage through the normal per-message path.

    Why this exists: transports that defer flow-control credits to actual
    consumption (the tpu tunnel's borrowed registered blocks) otherwise hold
    every block of a large message hostage until the *whole* message parses.
    With a cursor, each arriving chunk is consumed on arrival, so block
    release hooks — and therefore FT_ACK credits — fire mid-message and the
    negotiated window can stay small.

    Two consumption modes:

    * ``claim=True`` (default): bytes are copied into a preallocated
      contiguous buffer and the source refs dropped immediately — the copy IS
      the consumption signal. Not an extra copy in practice: protocols
      materialize the body contiguously at deserialize time anyway
      (``tobytes``); claiming merely moves that copy to arrival time, where
      it buys credit return.
    * ``claim=False``: refs move zero-copy (``cutn_into``) into an internal
      IOBuf; consumption signals fire only when the finished message drops
      them. For framing layers whose bodies carry no deferred credits (TPUC
      inline frames).
    """

    __slots__ = ("protocol", "total", "remaining", "_view", "_out", "_finish")

    def __init__(self, protocol: "Protocol", total: int, finish,
                 claim: bool = True):
        self.protocol = protocol
        self.total = total
        self.remaining = total
        self._finish = finish
        if claim:
            self._view = memoryview(bytearray(total))
            self._out = None
        else:
            self._view = None
            self._out = IOBuf()

    def feed(self, buf: IOBuf) -> int:
        """Consume up to ``remaining`` bytes from buf; returns bytes taken."""
        n = min(self.remaining, len(buf))
        if n <= 0:
            return 0
        if self._out is not None:
            buf.cutn_into(n, self._out)
        else:
            off = self.total - self.remaining
            buf.cutn_into_buffer(n, self._view[off:off + n])
        self.remaining -= n
        return n

    @property
    def done(self) -> bool:
        return self.remaining == 0

    def body(self) -> IOBuf:
        """The completed body as an IOBuf (zero-copy over the claim buffer)."""
        if self._out is not None:
            return self._out
        out = IOBuf()
        out.append(self._view)
        return out

    def claimed(self) -> memoryview:
        """The claim-mode destination buffer (claim=True cursors only)."""
        return self._view

    def finish(self) -> Optional["ParsedMessage"]:
        """Build the completed message; called once by the cut loop."""
        return self._finish(self)


class ParsedMessage:
    """One complete wire message, protocol-tagged."""

    __slots__ = ("protocol", "meta", "body", "socket", "arrival")

    def __init__(self, protocol: "Protocol", meta, body: IOBuf):
        self.protocol = protocol
        self.meta = meta
        self.body = body
        self.socket = None
        # parse-time monotonic stamp: server-side deadline enforcement
        # measures queueing delay from here (the client's clock never
        # crosses the wire, only its timeout_ms budget does)
        self.arrival = _time.monotonic()


class Protocol:
    """Subclass per protocol. name must be unique."""

    name = "base"
    # protocols whose first bytes are a fixed magic can be probed cheaply
    magic: Optional[bytes] = None
    # True: parse(buf, sock) receives the socket — connection-scoped
    # protocols (h2/grpc) keep per-socket state (HPACK tables, windows)
    stateful = False
    # True: process() runs inline on the parse loop (serial per socket).
    # Frame protocols that depend on arrival order need this — fanning out
    # to fiber tasks first would lose ordering before any downstream queue
    # can restore it. Inline handlers must be cheap/non-blocking.
    inline_process = False

    def parse(self, buf: IOBuf) -> Tuple[int, Optional[ParsedMessage]]:
        """Try to cut ONE message from buf. Returns (PARSE_*, msg|None)."""
        raise NotImplementedError

    def claim_cid(self, msg: ParsedMessage):
        """Correlation id this RESPONSE completes, or None.

        Called at cut time, before processing is queued: the cutter removes
        the id from the socket's pending set so a close-after-reply cannot
        error a call whose reply is already off the wire (the reply's
        processing task owns the call's fate from here; the RPC timeout
        still covers a processing crash)."""
        return None

    def pack_request(self, meta, payload: bytes) -> IOBuf:
        raise NotImplementedError

    def pack_response(self, meta, payload: bytes) -> IOBuf:
        raise NotImplementedError

    def process_request(self, msg: ParsedMessage, server) -> None:
        raise NotImplementedError

    def process_response(self, msg: ParsedMessage) -> None:
        raise NotImplementedError

    def process(self, msg: ParsedMessage, server) -> None:
        """Route one parsed message. RPC protocols split request/response by
        meta; frame protocols (streams) override entirely."""
        if msg.meta.HasField("request"):
            self.process_request(msg, server)
        else:
            self.process_response(msg)


_protocols: List[Protocol] = []
_by_name: Dict[str, Protocol] = {}
_lock = threading.Lock()

def register_protocol(proto: Protocol) -> None:
    with _lock:
        if proto.name in _by_name:
            raise ValueError(f"protocol {proto.name!r} already registered")
        _by_name[proto.name] = proto
        _protocols.append(proto)


def find_protocol(name: str) -> Optional[Protocol]:
    return _by_name.get(name)


def list_protocols() -> List[Protocol]:
    return list(_protocols)
