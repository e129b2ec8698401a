#!/usr/bin/env python
"""Mutational fuzzer for every parser of the port that eats untrusted
wire bytes.

Counterpart of bRPC's libFuzzer harnesses (test/fuzzing/fuzz_http.cpp,
fuzz_hpack.cpp, fuzz_redis.cpp, fuzz_shead.cpp, fuzz_json.cpp and their
seed corpora): each target gets a seed corpus of VALID packets built with
the port's own packers, then mutated bytes (bit flips, length-field
corruption, truncation, splicing, interesting constants) are fed through
the parser.

Contract: a parser confronted with hostile bytes must either return its
normal (PARSE_*, msg) result or raise one of its DECLARED error types
(HpackError, H2Error, BsonError, Amf0Error, ValueError for RESP). Any
other exception — struct.error, IndexError, KeyError, UnicodeDecodeError,
RecursionError — is a crash; the harness prints the repro (seed + hex)
and fails.

The two native targets run on the port's C++ engine, built by g++ on
first use: ``native_scanner`` on ``native.FrameScanner``, ``h2_native``
on a fast-path listener of ``native/dataplane.cpp`` through real
accepted sockets. An engine that cannot be built raises
``NativeBuildError`` and the run fails; nothing is skipped.

    python -m brpc_tpu_torch.tools.fuzz --iters 100000      # all targets
    python -m brpc_tpu_torch.tools.fuzz --target hpack --iters 5000

CI runs a smaller budget via tests/test_torch_fuzz.py.

Campaign log (``chip_smoke.py`` phase 22, on the host of an NVIDIA H100
80GB HBM3 at a 700.00 W power limit): ``--iters 20000`` over all 15
targets, the native ones on the engine g++ built there, 300,000 cases
with zero crashes; 16,268 cases/s over the phase's 18.44 s of wall time
(its interpreters' start and the engine's load included).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import random
import socket
import struct
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from brpc_tpu_torch.butil.iobuf import IOBuf  # noqa: E402

INTERESTING = [
    b"\x00", b"\xff", b"\x7f", b"\x80",
    b"\x00\x00\x00\x00", b"\xff\xff\xff\xff",
    b"\x7f\xff\xff\xff", b"\x80\x00\x00\x00",
    b"\x00\x00\x00\x01", b"\x00\x10\x00\x00",
]


class Mutator:
    def __init__(self, seeds, rng: random.Random):
        self.seeds = [bytes(s) for s in seeds if s]
        self.rng = rng

    def next_case(self) -> bytes:
        rng = self.rng
        data = bytearray(rng.choice(self.seeds))
        for _ in range(rng.randint(1, 8)):
            op = rng.randrange(7)
            if not data:
                data = bytearray(rng.choice(self.seeds))
            if op == 0:  # bit flip
                i = rng.randrange(len(data))
                data[i] ^= 1 << rng.randrange(8)
            elif op == 1:  # random byte
                data[rng.randrange(len(data))] = rng.randrange(256)
            elif op == 2:  # truncate
                data = data[:rng.randrange(len(data) + 1)]
            elif op == 3:  # insert interesting constant
                i = rng.randrange(len(data) + 1)
                data[i:i] = rng.choice(INTERESTING)
            elif op == 4:  # overwrite with interesting constant
                c = rng.choice(INTERESTING)
                i = rng.randrange(len(data) + 1)
                data[i:i + len(c)] = c
            elif op == 5:  # splice with another seed
                other = rng.choice(self.seeds)
                i = rng.randrange(len(data) + 1)
                j = rng.randrange(len(other) + 1)
                data = data[:i] + bytearray(other[j:])
            else:  # duplicate a chunk
                if len(data) >= 2:
                    i = rng.randrange(len(data) - 1)
                    n = rng.randint(1, min(64, len(data) - i))
                    data[i:i] = data[i:i + n]
        return bytes(data[:1 << 16])  # bound case size


# --------------------------------------------------------------------- seeds
def _meta(request=True):
    from brpc_tpu_torch.proto import rpc_meta_pb2

    m = rpc_meta_pb2.RpcMeta()
    if request:
        m.request.service_name = "EchoService"
        m.request.method_name = "Echo"
        m.request.timeout_ms = 1000
    else:
        m.response.error_code = 0
    m.correlation_id = 12345
    m.attempt_version = 1
    return m


def seeds_trpc():
    from brpc_tpu_torch.policy.trpc_std import TrpcStdProtocol

    p = TrpcStdProtocol()
    return [
        p.pack_request(_meta(True), b"hello world", b"attach").tobytes(),
        p.pack_response(_meta(False), b"resp payload").tobytes(),
        p.pack_request(_meta(True), b"", b"").tobytes(),
        p.pack_request(_meta(True), b"x" * 300, b"y" * 100,
                       checksum=True).tobytes(),
    ]


def seeds_tpu_ctrl():
    from brpc_tpu_torch.tpu import transport as t

    hello = json.dumps({"v": t.HANDSHAKE_VERSION, "pool": "brpctpu_x",
                        "bs": 4096, "bc": 4, "ordinal": 0, "pid": 1,
                        "gen": 1}).encode()
    data = struct.pack(t.DATA_BODY_HDR, 0, 5, 1) + b"hi!!!" + \
        struct.pack(t.SEG_FMT, 0, 16)
    # v2 ACK body: (epoch, count, *indices)
    ack = struct.pack("!4I", 0, 2, 0, 1)
    return [
        t._pack_frame(t.FT_HELLO, hello),
        t._pack_frame(t.FT_HELLO_ACK, hello),
        t._pack_frame(t.FT_DATA, data),
        t._pack_frame(t.FT_ACK, ack),
        t._pack_frame(t.FT_BYE),
    ]


def seeds_hpack():
    from brpc_tpu_torch.policy.hpack import HpackEncoder

    e = HpackEncoder()
    s1 = e.encode([(":method", "POST"), (":path", "/EchoService/Echo"),
                   ("content-type", "application/grpc"),
                   ("x-custom", "v" * 40)])
    s2 = e.encode([(":status", "200"), ("grpc-status", "0")])
    e2 = HpackEncoder()
    s3 = e2.encode([(":authority", "héllo.example"),
                    ("cookie", "a=b; c=d")])
    return [s1, s2, s3]


def seeds_h2():
    from brpc_tpu_torch.policy.h2 import (PREFACE, WINDOW_UPDATE, pack_frame,
                                          pack_settings)
    from brpc_tpu_torch.policy.hpack import HpackEncoder

    enc = HpackEncoder()
    hdrs = enc.encode([(":method", "POST"), (":scheme", "http"),
                       (":path", "/x"), (":authority", "a")])
    return [
        PREFACE + pack_settings([(3, 100), (4, 65535)]) +
        pack_frame(1, 0x4 | 0x1, 1, hdrs),            # HEADERS end+complete
        PREFACE + pack_settings([]) + pack_frame(0, 0x1, 1, b"data") +
        pack_frame(WINDOW_UPDATE, 0, 0, struct.pack("!I", 100)),
        PREFACE + pack_settings([], ack=True) +
        pack_frame(6, 0, 0, b"12345678"),             # PING
        PREFACE + pack_frame(7, 0, 0, struct.pack("!IIi", 1, 0, 0)),  # GOAWAY
    ]


def seeds_resp():
    from brpc_tpu_torch.policy.redis_protocol import (REPLY_ARRAY, REPLY_BULK,
                                                      REPLY_ERROR,
                                                      REPLY_INTEGER,
                                                      REPLY_STRING,
                                                      RedisReply, pack_reply)

    return [
        pack_reply(RedisReply(REPLY_STRING, "OK")),
        pack_reply(RedisReply(REPLY_ERROR, "ERR nope")),
        pack_reply(RedisReply(REPLY_INTEGER, -42)),
        pack_reply(RedisReply(REPLY_BULK, b"bulk\r\nbytes")),
        pack_reply(RedisReply(REPLY_ARRAY, [
            RedisReply(REPLY_BULK, b"GET"), RedisReply(REPLY_BULK, b"k")])),
        b"*-1\r\n", b"$-1\r\n",
    ]


def seeds_http():
    return [
        b"GET /vars HTTP/1.1\r\nHost: a\r\nAccept: */*\r\n\r\n",
        b"POST /EchoService/Echo HTTP/1.1\r\nContent-Length: 5\r\n"
        b"Content-Type: application/json\r\n\r\nhello",
        b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nok",
        b"HTTP/1.1 404 Not Found\r\nTransfer-Encoding: chunked\r\n\r\n"
        b"4\r\nbody\r\n0\r\n\r\n",
    ]


def seeds_memcache():
    from brpc_tpu_torch.policy.memcache import pack_op

    return [
        pack_op(0x00, key=b"k"),                       # GET
        pack_op(0x01, key=b"k", extras=b"\x00" * 8, value=b"v"),  # SET
        pack_op(0x0a),                                 # NOOP
    ]


def seeds_nshead():
    from brpc_tpu_torch.policy.nshead import NsheadMessage

    return [NsheadMessage(b"body-bytes").SerializeToString(),
            NsheadMessage(b"", id=3, version=1).SerializeToString()]


def seeds_mongo():
    from brpc_tpu_torch.policy.mongo_protocol import pack_msg

    return [
        pack_msg(1, 0, {"ping": 1, "$db": "admin"}),
        pack_msg(2, 1, {"ok": 1.0, "cursor": {"id": 0,
                                              "firstBatch": [{"a": 1}]}}),
        pack_msg(3, 0, {"insert": "c", "documents": [
            {"x": [1, None, "s"], "b": b"\x00\x01"}]}),
    ]


def seeds_bson():
    # the raw body documents: OP_MSG's 16-byte header, flag bits, kind 0
    return [s[21:] for s in seeds_mongo()]


def seeds_thrift():
    from brpc_tpu_torch.policy.thrift_protocol import pack_message

    return [
        pack_message(1, "Echo", 7, b"\x0b\x00\x01\x00\x00\x00\x02hi\x00"),
        pack_message(2, "Echo", 7, b"\x00"),
    ]


def seeds_rtmp_chunks():
    from brpc_tpu_torch.policy import amf0
    from brpc_tpu_torch.policy.rtmp import (MSG_AUDIO, MSG_COMMAND_AMF0,
                                            MSG_SET_CHUNK_SIZE, pack_chunks)

    return [
        pack_chunks(2, MSG_SET_CHUNK_SIZE, 0, struct.pack(">I", 4096)),
        pack_chunks(3, MSG_COMMAND_AMF0, 0,
                    amf0.encode("connect", 1.0, {"app": "live"})),
        pack_chunks(4, MSG_AUDIO, 1, b"a" * 300),
        pack_chunks(3, MSG_COMMAND_AMF0, 1,
                    amf0.encode("publish", 2.0, None, "cam", "live")),
    ]


def seeds_amf0():
    from brpc_tpu_torch.policy import amf0

    return [
        amf0.encode("_result", 1.0, {"a": [1.0, "x", None], "b": True}),
        amf0.encode("onStatus", 0.0, None, {"level": "status"}),
        amf0.encode("long", "y" * 70000),
    ]


def seeds_h2_native():
    """Valid post-preface h2 conversations (grpc + plain), built with the
    Python stack's encoders: the two stacks share the RFC tables."""
    from brpc_tpu_torch.policy import h2 as _h2
    from brpc_tpu_torch.policy.hpack import HpackEncoder

    out = []
    for path, ctype in (("/pkg.EchoService/Echo", "application/grpc"),
                        ("/status", "text/plain")):
        enc = HpackEncoder()
        block = enc.encode([
            (":method", "POST"), (":scheme", "http"), (":path", path),
            (":authority", "x"), ("content-type", ctype),
            ("te", "trailers"), ("grpc-timeout", "100m"),
        ])
        body = b"\x00" + (12).to_bytes(4, "big") + b"\x0a\x0a0123456789"
        out.append(
            _h2.pack_settings([(0x4, 1 << 20), (0x1, 4096)])
            + _h2.pack_frame(_h2.WINDOW_UPDATE, 0, 0,
                             (1 << 20).to_bytes(4, "big"))
            + _h2.pack_frame(_h2.HEADERS, _h2.FLAG_END_HEADERS, 1, block)
            + _h2.pack_frame(_h2.DATA, _h2.FLAG_END_STREAM, 1, body)
            + _h2.pack_frame(_h2.PING, 0, 0, b"12345678")
            + _h2.pack_frame(_h2.RST_STREAM, 0, 1,
                             (8).to_bytes(4, "big")))
    # CONTINUATION split + padded DATA + GOAWAY
    enc = HpackEncoder()
    blk = enc.encode([(":method", "POST"), (":scheme", "http"),
                      (":path", "/S/M"), ("content-type",
                                          "application/grpc")])
    half = len(blk) // 2
    out.append(
        _h2.pack_frame(_h2.HEADERS, 0, 3, blk[:half])
        + _h2.pack_frame(_h2.CONTINUATION, _h2.FLAG_END_HEADERS, 3,
                         blk[half:])
        + _h2.pack_frame(_h2.DATA, _h2.FLAG_END_STREAM | 0x8, 3,
                         b"\x02" + b"\x00\x00\x00\x00\x05hello" + b"\0\0")
        + _h2.pack_frame(_h2.GOAWAY, 0, 0, b"\0" * 8))
    return out


# ------------------------------------------------------------------- targets
class _FakeSock:
    """Just enough socket surface for stateful parsers."""

    def __init__(self):
        self.read_buf = IOBuf()
        self.preferred_protocol = None
        self.failed = False
        self.user_data = None
        self.owner_server = None
        self.remote = None

    def write(self, data, id_wait=None):
        return 0

    def set_failed(self, code, reason=""):
        self.failed = True


def target_trpc(data: bytes) -> None:
    from brpc_tpu_torch.policy.trpc_std import TrpcStdProtocol

    TrpcStdProtocol().parse(IOBuf(data))


def target_native_scanner(data: bytes) -> None:
    from brpc_tpu_torch import native

    frames, consumed, bad = native.FrameScanner(max_frames=32).scan(
        data, 64 << 20)
    assert consumed <= len(data)
    for start, meta, body in frames:
        assert start + 12 + meta + body <= len(data)


def target_tpu_ctrl(data: bytes) -> None:
    from brpc_tpu_torch.tpu.transport import TpuCtrlProtocol

    TpuCtrlProtocol().parse(IOBuf(data), _FakeSock())


def target_hpack(data: bytes) -> None:
    from brpc_tpu_torch.policy.hpack import HpackDecoder

    HpackDecoder().decode(data)


def target_h2(data: bytes) -> None:
    from brpc_tpu_torch.policy.h2 import H2Conn

    conn = H2Conn(_FakeSock(), "server",
                  on_stream_complete=lambda *a, **k: None)
    conn.feed(IOBuf(data))


_h2n = None


def _h2_native_ctx():
    """One engine runtime and fast-path listener for the whole campaign
    (the native h2 parser under test lives in dataplane.cpp)."""
    global _h2n
    if _h2n is None:
        from brpc_tpu_torch import native

        lib = native.load_dataplane()
        rt = lib.dp_rt_create(1, 0)
        lid = lib.dp_listen(rt, b"127.0.0.1", 0)
        assert lid >= 0, lid
        lib.dp_listener_set_fastpath(rt, lid, 1)
        _h2n = (lib, rt, lib.dp_listen_port(rt, lid))
    return _h2n


def close_h2_native() -> None:
    """Shut the campaign's engine runtime down (its listener with it)."""
    global _h2n
    if _h2n is not None:
        lib, rt, _ = _h2n
        _h2n = None
        lib.dp_rt_shutdown(rt)


def target_h2_native(data: bytes) -> None:
    """The engine's h2/HPACK/grpc parser (native/dataplane.cpp): mutated
    frame streams after a valid preface, through a real accepted socket.
    A crash here kills the process, which is what this target exists to
    catch. Cases are fire-and-forget (the parse runs on the engine's loop
    thread; a crash surfaces within a case or two)."""
    from brpc_tpu_torch import native

    lib, rt, port = _h2_native_ctx()
    s = socket.create_connection(("127.0.0.1", port), timeout=2)
    try:
        s.sendall(b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n" + data)
    except OSError:
        pass  # the engine failed the conn mid-send: a valid outcome
    finally:
        s.close()
    # drain the engine's events: EV_REQUEST blocks must be freed and
    # detached fds closed, or a long campaign exhausts memory and fds,
    # not bugs
    evs = (native.DpEventStruct * 64)()
    while True:
        n = lib.dp_poll(rt, evs, 64, 0)
        if n <= 0:
            break
        for i in range(n):
            ev = evs[i]
            if ev.kind == 4 and ev.aux >= 0:  # EV_DETACHED: we own the fd
                try:
                    os.close(int(ev.aux))
                except OSError:
                    pass
            if ev.base:
                lib.dp_free(ctypes.c_void_p(ev.base))


def target_resp(data: bytes) -> None:
    from brpc_tpu_torch.policy.redis_protocol import parse_reply

    pos = 0
    for _ in range(64):  # bounded walk through pipelined replies
        reply, new_pos = parse_reply(data, pos)
        if reply is None or new_pos <= pos:
            break
        pos = new_pos


def target_http(data: bytes) -> None:
    from brpc_tpu_torch.policy.http_protocol import parse_http_message

    parse_http_message(IOBuf(data))


def target_memcache(data: bytes) -> None:
    from brpc_tpu_torch.policy.memcache import MemcacheProtocol

    MemcacheProtocol().parse(IOBuf(data), _FakeSock())


def target_nshead(data: bytes) -> None:
    from brpc_tpu_torch.policy.nshead import NsheadProtocol

    NsheadProtocol().parse(IOBuf(data), _FakeSock())


def target_mongo(data: bytes) -> None:
    from brpc_tpu_torch.policy.mongo_protocol import MongoProtocol

    sock = _FakeSock()
    sock.mongo_server = True  # route past the ownership probe
    MongoProtocol().parse(IOBuf(data), sock)


def target_bson(data: bytes) -> None:
    from brpc_tpu_torch.policy import bson

    bson.decode(data)


def target_rtmp_chunks(data: bytes) -> None:
    from brpc_tpu_torch.policy.rtmp import ChunkReader

    try:
        ChunkReader().feed(IOBuf(data))
    except ValueError:
        pass  # declared error contract


def target_amf0(data: bytes) -> None:
    from brpc_tpu_torch.policy import amf0

    amf0.decode_all(data)


def target_thrift(data: bytes) -> None:
    from brpc_tpu_torch.policy.thrift_protocol import ThriftProtocol

    ThriftProtocol().parse(IOBuf(data), _FakeSock())


def _allowed():
    """Each target's name -> (target, its seeds' function, declared
    errors)."""
    from brpc_tpu_torch.policy.amf0 import Amf0Error
    from brpc_tpu_torch.policy.bson import BsonError
    from brpc_tpu_torch.policy.h2 import H2Error
    from brpc_tpu_torch.policy.hpack import HpackError

    return {
        "trpc": (target_trpc, seeds_trpc, ()),
        "native_scanner": (target_native_scanner, seeds_trpc, ()),
        "tpu_ctrl": (target_tpu_ctrl, seeds_tpu_ctrl, ()),
        "hpack": (target_hpack, seeds_hpack, (HpackError,)),
        "h2": (target_h2, seeds_h2, (H2Error, HpackError)),
        "h2_native": (target_h2_native, seeds_h2_native, ()),
        "resp": (target_resp, seeds_resp, (ValueError,)),
        "http": (target_http, seeds_http, ()),
        "memcache": (target_memcache, seeds_memcache, ()),
        "nshead": (target_nshead, seeds_nshead, ()),
        "thrift": (target_thrift, seeds_thrift, ()),
        "mongo": (target_mongo, seeds_mongo, ()),
        "rtmp_chunks": (target_rtmp_chunks, seeds_rtmp_chunks, ()),
        "amf0": (target_amf0, seeds_amf0, (Amf0Error,)),
        "bson": (target_bson, seeds_bson, (BsonError,)),
    }


def run_target(name: str, iters: int, seed: int = 0,
               progress: bool = False) -> int:
    """Returns the number of executed cases; raises AssertionError with a
    repro on the first crash."""
    fn, seed_fn, allowed = _allowed()[name]
    rng = random.Random(seed or 0xB127C)
    mut = Mutator(seed_fn(), rng)
    # seeds themselves must parse crash-free
    for s in mut.seeds:
        try:
            fn(s)
        except allowed:
            pass
    executed = 0
    for i in range(iters):
        case = mut.next_case()
        try:
            fn(case)
        except allowed:
            pass
        except Exception as e:
            raise AssertionError(
                f"fuzz[{name}] crash after {i} cases: "
                f"{type(e).__name__}: {e}\n"
                f"seed={seed or 0xB127C} repro_hex={case.hex()}") from e
        executed += 1
        if progress and executed % 20000 == 0:
            print(f"  {name}: {executed}/{iters}", file=sys.stderr)
    return executed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", default="all",
                    choices=["all", *_allowed().keys()])
    ap.add_argument("--iters", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    names = list(_allowed()) if args.target == "all" else [args.target]
    for name in names:
        n = run_target(name, args.iters, args.seed, progress=True)
        print(f"fuzz[{name}]: {n} cases ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
