"""Chunked transfer-encoding streaming parse on the port
(brpc_tpu_torch/rpc/protocol.py's ChunkedBodyCursor): every case of the
JAX package's ``tests/test_chunked.py`` with each server the port's, and
the port's cursor fed the same numpy-seeded fragmentations as the JAX
package's, taking the same bytes and ending in the same state.

The PendingBodyCursor machinery handled only declared-length bodies;
ChunkedBodyCursor extends streaming consumption to Transfer-Encoding:
chunked, where the total is unknown until the 0-size chunk. Three levels:
the cursor state machine fed adversarially fragmented bytes, cursor
registration through parse_http_message, and an end-to-end chunked POST
against a live server with the body dripped across many writes."""

import json
import socket
import time
import types

import pytest

from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.policy.http_protocol import HttpProtocol, parse_http_message
from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import Server, Service
from brpc_tpu_torch.rpc.protocol import (
    PARSE_BAD,
    PARSE_NOT_ENOUGH_DATA,
    ChunkedBodyCursor,
)

ECHO_DESC = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]


class EchoServiceImpl(Service):
    DESCRIPTOR = ECHO_DESC

    def Echo(self, cntl, request, done):
        return echo_pb2.EchoResponse(message=request.message,
                                     payload=request.payload)


@pytest.fixture()
def http_server():
    server = Server().add_service(EchoServiceImpl()).start("127.0.0.1:0")
    yield server
    server.stop()
    server.join(timeout=2)


def _chunked(*parts, trailers=b""):
    out = b""
    for p in parts:
        out += f"{len(p):x}".encode() + b"\r\n" + p + b"\r\n"
    return out + b"0\r\n" + trailers + b"\r\n"


def _cursor(collected):
    return ChunkedBodyCursor(
        types.SimpleNamespace(name="http"),
        finish=lambda cur: collected.append(cur.body()))


# ------------------------------------------------------------- state machine
class TestCursorStateMachine:
    def test_whole_body_single_feed(self):
        got = []
        cur = _cursor(got)
        buf = IOBuf(_chunked(b"Wiki", b"pedia"))
        cur.feed(buf)
        assert cur.done and not cur.failed
        assert len(buf) == 0
        cur.finish()
        assert got == [b"Wikipedia"]

    def test_byte_by_byte_feed(self):
        got = []
        cur = _cursor(got)
        wire = _chunked(b"hello ", b"chunked", b" world")
        for i in range(len(wire)):
            assert not cur.done
            cur.feed(IOBuf(wire[i:i + 1]))
        assert cur.done
        cur.finish()
        assert got == [b"hello chunked world"]

    def test_split_inside_size_line_and_chunk(self):
        got = []
        cur = _cursor(got)
        body = b"\xaa" * 1000
        wire = _chunked(body)
        # split mid size-line, mid data, mid trailing CRLF
        for cutpoints in ((1, 500, len(wire) - 1),):
            prev = 0
            for cp in cutpoints + (len(wire),):
                cur.feed(IOBuf(wire[prev:cp]))
                prev = cp
        assert cur.done
        cur.finish()
        assert got == [body]

    def test_chunk_extension_ignored(self):
        got = []
        cur = _cursor(got)
        cur.feed(IOBuf(b"4;ext=1\r\nWiki\r\n0\r\n\r\n"))
        assert cur.done
        cur.finish()
        assert got == [b"Wiki"]

    def test_trailer_headers_consumed(self):
        got = []
        cur = _cursor(got)
        wire = _chunked(b"data", trailers=b"X-Sum: 1\r\nX-N: 2\r\n")
        cur.feed(IOBuf(wire))
        assert cur.done
        cur.finish()
        assert got == [b"data"]

    def test_consumed_counts_framing_and_payload(self):
        cur = _cursor([])
        wire = _chunked(b"abcd")
        extra = b"GET / HTTP/1.1\r\n"   # next pipelined message stays put
        buf = IOBuf(wire + extra)
        cur.feed(buf)
        assert cur.done
        assert cur.consumed == len(wire)
        assert buf.tobytes() == extra

    def test_malformed_size_fails(self):
        cur = _cursor([])
        cur.feed(IOBuf(b"zz\r\nWiki\r\n"))
        assert cur.failed and "size" in cur.error
        assert not cur.done

    def test_missing_chunk_terminator_fails(self):
        cur = _cursor([])
        cur.feed(IOBuf(b"4\r\nWikiXX\r\n"))
        assert cur.failed and "terminator" in cur.error

    def test_oversized_framing_line_fails(self):
        cur = _cursor([])
        cur.feed(IOBuf(b"1" * 400))
        assert cur.failed and "oversized" in cur.error

    def test_bare_lf_fails(self):
        cur = _cursor([])
        cur.feed(IOBuf(b"4\nWiki\r\n"))
        assert cur.failed


# -------------------------------------------------- parse-level registration
class TestParseRegistration:
    HEAD = b"POST /x HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n"

    def _sock(self):
        return types.SimpleNamespace(pending_body=None)

    def test_incomplete_body_registers_cursor(self):
        sock = self._sock()
        buf = IOBuf(self.HEAD + b"4\r\nWi")
        rc, _ = parse_http_message(buf, sock=sock, proto=HttpProtocol())
        assert rc == PARSE_NOT_ENOUGH_DATA
        cur = sock.pending_body
        assert isinstance(cur, ChunkedBodyCursor)
        assert len(buf) == 0                    # partial chunk claimed
        # drip the rest; finish() produces the message
        cur.feed(IOBuf(b"ki\r\n5\r\npedia\r\n0\r\n\r\n"))
        assert cur.done
        msg = cur.finish()
        assert msg.meta.body == b"Wikipedia"
        assert msg.meta.path == "/x"

    def test_complete_body_keeps_whole_message_path(self):
        sock = self._sock()
        buf = IOBuf(self.HEAD + _chunked(b"Wiki", b"pedia"))
        rc, msg = parse_http_message(buf, sock=sock, proto=HttpProtocol())
        assert rc == 0 and msg.body == b"Wikipedia"
        assert sock.pending_body is None

    def test_no_sock_keeps_whole_message_semantics(self):
        # standalone callers (http_fetch) never get a cursor
        rc, _ = parse_http_message(IOBuf(self.HEAD + b"4\r\nWi"))
        assert rc == PARSE_NOT_ENOUGH_DATA

    def test_busy_socket_not_double_registered(self):
        sock = types.SimpleNamespace(pending_body=object())
        rc, _ = parse_http_message(IOBuf(self.HEAD + b"4\r\nWi"),
                                   sock=sock, proto=HttpProtocol())
        assert rc == PARSE_NOT_ENOUGH_DATA

    def test_malformed_mid_stream_fails_socket_via_cut_loop(self):
        from test_stream_parse import _FakeParseSock

        from brpc_tpu_torch.policy import ensure_registered
        from brpc_tpu_torch.rpc.input_messenger import InputMessenger

        ensure_registered()
        sock = _FakeParseSock()
        messenger = InputMessenger()
        sock.read_buf.append(self.HEAD + b"4\r\nWi")
        messenger.cut_messages(sock)
        assert isinstance(sock.pending_body, ChunkedBodyCursor)
        sock.read_buf.append(b"ki\r\nNOT-HEX\r\n")
        messenger.cut_messages(sock)
        assert sock.failed
        assert sock.pending_body is None


# ------------------------------------------------------------------ e2e wire
class TestEndToEnd:
    def test_chunked_json_post_dripped_across_writes(self, http_server):
        """A chunked POST whose frames arrive over many separate writes:
        the server's cut loop must stream them through the cursor and
        dispatch one complete JSON-RPC call."""
        body = json.dumps({"message": "chunky",
                           "payload": "QUJD" * 2000}).encode()
        step = 97
        chunks = [body[i:i + step] for i in range(0, len(body), step)]
        wire = (b"POST /EchoService/Echo HTTP/1.1\r\n"
                b"Content-Type: application/json\r\n"
                b"Transfer-Encoding: chunked\r\n\r\n")
        ep = http_server.listen_endpoint()
        with socket.create_connection((ep.host, ep.port), timeout=10) as s:
            s.sendall(wire)
            for c in chunks:
                s.sendall(f"{len(c):x}".encode() + b"\r\n")
                s.sendall(c + b"\r\n")
                time.sleep(0.002)           # force separate read bursts
            s.sendall(b"0\r\n\r\n")
            s.settimeout(10)
            resp = b""
            while b"\r\n\r\n" not in resp:
                resp += s.recv(65536)
            head, _, rest = resp.partition(b"\r\n\r\n")
            assert b"200" in head.split(b"\r\n")[0]
            clen = int([h for h in head.split(b"\r\n")
                        if h.lower().startswith(b"content-length")][0]
                       .split(b":")[1])
            while len(rest) < clen:
                rest += s.recv(65536)
        data = json.loads(rest)
        assert data["message"] == "chunky"
        assert data["payload"] == "QUJD" * 2000


# --------------------------------------------- the cursor against the JAX's
@pytest.mark.parametrize("seed", range(4))
def test_cursor_equals_the_jax_cursor_on_seeded_fragments(seed):
    import numpy as np

    from brpc_tpu.butil.iobuf import IOBuf as JaxIOBuf
    from brpc_tpu.rpc.protocol import ChunkedBodyCursor as JaxCursor

    rng = np.random.default_rng(seed)
    for _ in range(30):
        parts = [rng.bytes(int(rng.integers(1, 400)))
                 for _ in range(int(rng.integers(1, 6)))]
        wire = _chunked(*parts, trailers=b"X-T: 1\r\n"
                        if rng.integers(2) else b"")
        if rng.integers(4) == 0:  # a malformed size line
            wire = wire.replace(b"\r\n", b"\r\nzz", 1)
        cuts = sorted({int(c) for c in rng.integers(1, len(wire),
                                                    size=int(rng.integers(
                                                        1, 8)))})
        pieces = [wire[a:b] for a, b in zip([0] + cuts, cuts + [len(wire)])]
        got, want = [], []
        port = _cursor(got)
        ref = JaxCursor(types.SimpleNamespace(name="http"),
                        finish=lambda cur: want.append(cur.body()))
        buf, jbuf = IOBuf(), JaxIOBuf()
        for piece in pieces:
            buf.append(piece)
            jbuf.append(piece)
            assert port.feed(buf) == ref.feed(jbuf)
            assert (port.done, port.failed, port.error, len(buf)) == \
                (ref.done, ref.failed, ref.error, len(jbuf))
        if port.done:
            port.finish()
            ref.finish()
            assert got == want == [b"".join(parts)]
