"""InputMessenger — cuts messages from the byte stream, routes to protocols.

Rebuild of ``input_messenger.cpp:360`` (OnNewMessages): drain the fd, loop
cutting complete messages, remember the socket's preferred protocol after the
first successful parse, then fan processing out one fiber task per message
(the reference's per-message bthreads). Cutting is serial per socket (the
dispatcher thread); PROCESSING IS UNORDERED across a connection's pipelined
messages — RPC responses are correlation-id addressed so order is
irrelevant, and protocols that do need ordering (stream frames) re-serialize
in their own per-stream ExecutionQueue.

The port's copy of the JAX package's ``rpc/input_messenger.py`` takes the
reference's pure-Python cut path (its branch when the C++ frame scanner is
not built, which cuts the same frames from the same bytes).
"""

from __future__ import annotations

import logging
from typing import Optional

from brpc_tpu_torch import flags
from brpc_tpu_torch.fiber import runtime
from brpc_tpu_torch.rpc.protocol import (
    PARSE_BAD,
    PARSE_NOT_ENOUGH_DATA,
    PARSE_TRY_OTHERS,
    ParsedMessage,
    list_protocols,
)
from brpc_tpu_torch.profiling import registry as _prof
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc import run_to_completion as _rtc
from brpc_tpu_torch.rpc.socket import Socket

log = logging.getLogger("brpc_tpu_torch.input_messenger")


def _inline_cut_max() -> int:
    return int(flags.get("inline_cut_max_bytes"))


class InputMessenger:
    def __init__(self, server=None):
        self._server = server

    def make_on_readable(self, sock: Socket):
        """The dispatcher callback for this socket's read events.

        Small bursts are cut inline on the event loop; once the buffered
        bytes exceed ``inline_cut_max_bytes`` the socket's read interest is
        suspended and a fiber worker takes over drain+cut, so one
        connection flooding large messages can't stall every other socket
        on this dispatcher (reference hands off at the first atomic,
        socket.cpp:2256; multiple loops via event_dispatcher_num)."""

        def on_readable():
            n = sock.drain_recv()
            if n < 0:
                return
            if len(sock.read_buf) <= _inline_cut_max():
                self.cut_messages(sock)
                if sock._eof and not sock.failed:
                    # close-after-reply: replies parsed above already claimed
                    # their call ids (cut_messages); failing now only errors
                    # calls whose reply never arrived
                    sock.set_failed(errors.EFAILEDSOCKET, "peer closed")
                return
            # over budget — even at EOF the final burst parses off-loop so a
            # flood-then-close peer can't stall this dispatcher's sockets
            sock.suspend_read()
            runtime.start_background(self._cut_offloaded, sock)

        return on_readable

    def _cut_offloaded(self, sock: Socket) -> None:
        """Fiber-side drain+cut loop while the socket's read interest is
        suspended. Only one cutter runs at a time: the dispatcher can't
        deliver more read events until resume_read."""
        try:
            while True:
                self.cut_messages(sock)
                if sock.failed:
                    return
                if sock._eof:
                    sock.set_failed(errors.EFAILEDSOCKET, "peer closed")
                    return
                n = sock.drain_recv()
                if n < 0:
                    return
                if n == 0 and not sock._eof:
                    # kernel buffer empty; leftover bytes (if any) are an
                    # incomplete message — wait for the next event
                    return
        finally:
            sock.resume_read()

    def cut_messages(self, sock: Socket) -> int:
        """Parse complete messages in arrival order, then fan processing out
        to fiber workers — one task per message, like the reference's
        per-message bthreads (input_messenger.cpp:194-239). Cutting stays
        serial on the dispatcher thread; processing is parallel so one slow
        handler never blocks the connection (protocols needing strict order,
        e.g. stream frames, re-serialize in their own ExecutionQueue)."""
        count = 0
        server = self._server
        # profiler phase marker: cutting/framing cost on this thread is
        # "parse"; inline (run-to-completion) dispatch re-stamps its own
        # phases and restores back here
        prev_ph = _prof.set_phase("parse")
        # transports that defer flow-control credits (the tpu tunnel's
        # borrowed registered blocks) bracket the cut loop so every credit
        # released while this batch parses coalesces into one ACK frame
        batch_hook = getattr(sock, "cut_batch_hook", None)
        if batch_hook is not None:
            batch_hook.cut_batch_begin()
        try:
            while True:
                # streaming parse: a protocol that cracked a header but saw
                # an incomplete body registered a pending-body cursor; feed
                # it FIRST, byte-for-byte from read_buf, without re-running
                # parse — each feed consumes the arriving refs, so borrowed
                # blocks release (and their credits return) mid-message
                cursor = getattr(sock, "pending_body", None)
                if cursor is not None:
                    if len(sock.read_buf):
                        cursor.feed(sock.read_buf)
                    if not cursor.done:
                        break  # mid-body: wait for the next read burst
                    sock.pending_body = None
                    if batch_hook is not None:
                        # end-of-body wakeup: the body's final borrowed
                        # blocks released at feed time — flush their
                        # credits now (not at batch end) so a peer sender
                        # parked on the window wakes immediately
                        eob = getattr(batch_hook, "cut_body_complete", None)
                        if eob is not None:
                            eob()
                    msg = cursor.finish()
                    if msg is None:
                        continue  # protocol consumed the body internally
                    msgs = (msg,)
                elif not len(sock.read_buf):
                    break
                else:
                    msg = self._cut_one(sock)
                    if msg is None:
                        if getattr(sock, "pending_body", None) is not None:
                            continue  # parse just registered a cursor
                        break
                    msgs = (msg,)
                for msg in msgs:
                    msg.socket = sock
                    sock.in_messages += 1
                    count += 1
                    cid = msg.protocol.claim_cid(msg)
                    if cid is not None:
                        sock.remove_pending_id(cid)
                    if msg.protocol.inline_process:
                        # order-sensitive frames (streams): handle on the
                        # serial parse loop; the handler only enqueues to
                        # per-stream queues
                        _process_one(msg, server)
                    elif _rtc.dispatch(msg, server):
                        pass  # ran to completion on this thread
                    else:
                        runtime.start_background(
                            _rtc.observe_queued, msg, server)
        finally:
            if batch_hook is not None:
                batch_hook.cut_batch_end()
            _prof.set_phase(prev_ph)
        return count

    def _cut_one(self, sock: Socket) -> Optional[ParsedMessage]:
        protocols = list_protocols()
        # preferred protocol first (input_messenger.cpp preferred_index)
        if sock.preferred_protocol is not None:
            protocols = [sock.preferred_protocol] + [
                p for p in protocols if p is not sock.preferred_protocol
            ]
        for proto in protocols:
            if proto.stateful:
                rc, msg = proto.parse(sock.read_buf, sock)
            else:
                rc, msg = proto.parse(sock.read_buf)
            if rc == PARSE_NOT_ENOUGH_DATA:
                if getattr(sock, "pending_body", None) is not None:
                    # the parse cracked a header and registered a streaming
                    # cursor — this protocol owns the connection from here
                    sock.preferred_protocol = proto
                return None
            if rc == PARSE_TRY_OTHERS:
                continue
            if rc == PARSE_BAD:
                sock.set_failed(errors.EREQUEST, f"bad {proto.name} message")
                return None
            sock.preferred_protocol = proto
            return msg
        # no protocol recognises these bytes
        sock.set_failed(errors.EREQUEST, "unknown protocol")
        return None


def _process_one(msg, server) -> None:
    try:
        msg.protocol.process(msg, server or msg.socket.owner_server)
    except Exception:
        log.exception("%s handler failed (socket=%r)",
                      msg.protocol.name, msg.socket)
