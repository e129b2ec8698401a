"""InputMessenger — cuts messages from the byte stream, routes to protocols.

Rebuild of ``input_messenger.cpp:360`` (OnNewMessages): drain the fd, loop
cutting complete messages, remember the socket's preferred protocol after the
first successful parse, then fan processing out one fiber task per message
(the reference's per-message bthreads). Cutting is serial per socket (the
dispatcher thread); PROCESSING IS UNORDERED across a connection's pipelined
messages — RPC responses are correlation-id addressed so order is
irrelevant, and protocols that do need ordering (stream frames) re-serialize
in their own per-stream ExecutionQueue.

The port's copy of the JAX package's ``rpc/input_messenger.py``: a socket
that speaks the TRPC frame family cuts whole batches of frames per
interpreter round trip with the port's C++ frame scanner
(``native.FrameScanner``), as the reference does.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from brpc_tpu_torch import flags
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.fiber import runtime
from brpc_tpu_torch.proto import rpc_meta_pb2
from brpc_tpu_torch.rpc.protocol import (
    PARSE_BAD,
    PARSE_NOT_ENOUGH_DATA,
    PARSE_TRY_OTHERS,
    ParsedMessage,
    find_protocol,
    list_protocols,
)
from brpc_tpu_torch.profiling import registry as _prof
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc import run_to_completion as _rtc
from brpc_tpu_torch.rpc.socket import Socket

log = logging.getLogger("brpc_tpu_torch.input_messenger")

_tls = threading.local()

# Poll-batch boundary hook (brpc_tpu_torch.batch installs flush_poll_batch
# here): called after each cut loop so request batchers can flush
# everything the last read batch admitted. None until a BatchQueue first
# registers.
poll_batch_hook = None


def _inline_cut_max() -> int:
    return int(flags.get("inline_cut_max_bytes"))


def _thread_scanner():
    """Per-thread native frame scanner (raises when the core cannot be
    built)."""
    sc = getattr(_tls, "scanner", None)
    if sc is None:
        from brpc_tpu_torch import native

        sc = _tls.scanner = native.FrameScanner(max_frames=256)
    return sc


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
            # sharded dispatch plane: an adopted tunnel endpoint skims
            # complete cid-addressed request frames to worker processes
            # BEFORE the in-process parser sees them (never mid-body —
            # a pending cursor owns the stream until it completes). The
            # pump never blocks: it pushes to a shm ring or declines.
            lane = getattr(sock, "shard_lane", None)
            if lane is not None and getattr(sock, "pending_body",
                                            None) is None:
                count += lane.pump(sock)
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
                    if getattr(cursor, "failed", False):
                        # mid-body framing error (chunked cursor): the
                        # stream is unrecoverable, same verdict as a
                        # PARSE_BAD from parse()
                        sock.pending_body = None
                        sock.set_failed(errors.EREQUEST,
                                        f"bad streaming body: "
                                        f"{getattr(cursor, 'error', '')}")
                        break
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
                    batch = self._cut_batch_native(sock)
                    if batch:
                        msgs = batch
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
            hook = poll_batch_hook
            if hook is not None:
                hook()
        return count

    def _cut_batch_native(self, sock: Socket):
        """Fast path: when the socket already speaks the TRPC frame family,
        batch-scan all complete frame boundaries in one native call (the
        reference's CutInputMessage inner loop, input_messenger.cpp:84) and
        cut N messages per interpreter round trip. Returns a list of
        ParsedMessages, or None to fall back to the generic path."""
        proto = sock.preferred_protocol
        if proto is None or proto.magic not in (b"TRPC", b"TSTR"):
            return None
        if getattr(sock, "pending_body", None) is not None:
            # mid-body bytes belong to the cursor, never to a fresh scan
            # (the cut loop feeds the cursor before reaching here; this
            # guards any other caller)
            return None
        scanner = _thread_scanner()
        buf = sock.read_buf
        if len(buf) < 12:
            return None
        if buf.has_owned_blocks():
            # borrowed registered-block views (tpu tunnel zero-copy receive)
            # must move by ref through the generic cut path — this path's
            # wholesale fetch() snapshot would re-copy the whole payload
            return None
        # cheap peek: don't snapshot a big buffer that holds only one
        # still-incomplete frame (a large payload arriving in chunks would
        # otherwise be re-copied per readable event)
        head = buf.fetch(12)
        if head[0:4] not in (b"TRPC", b"TSTR"):
            return None  # let the generic path route/fail it
        first_total = 12 + int.from_bytes(head[4:8], "big") \
            + int.from_bytes(head[8:12], "big")
        if len(buf) < first_total:
            return None
        data = buf.fetch(min(len(buf), 8 << 20))
        from brpc_tpu_torch.policy.trpc_std import max_body_size

        frames, consumed, bad = scanner.scan(data, max_body_size())
        if not frames and not bad:
            return None  # incomplete head frame: let the generic path wait
        trpc = find_protocol("trpc_std")
        tstr = find_protocol("trpc_stream")
        msgs = []
        for start, meta_size, body_size in frames:
            meta_start = start + 12
            body_start = meta_start + meta_size
            meta_bytes = data[meta_start:body_start]
            body = data[body_start:body_start + body_size]
            is_stream = data[start:start + 4] == b"TSTR"
            try:
                if is_stream:
                    meta = rpc_meta_pb2.StreamFrameMeta.FromString(meta_bytes)
                else:
                    meta = rpc_meta_pb2.RpcMeta.FromString(meta_bytes)
            except Exception:
                bad = True
                consumed = start  # drop everything from the bad frame on
                break
            msgs.append(ParsedMessage(tstr if is_stream else trpc,
                                      meta, IOBuf(body)))
        buf.pop_front(consumed)
        if bad:
            sock.set_failed(errors.EREQUEST, "bad TRPC frame in batch")
        return msgs

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
