"""The port's wire protocols against the JAX package's, byte for byte.

The same inputs, made from a numpy seed, go through both packages'
codecs: HPACK (sequences of header lists, so the dynamic table's history
counts), h2 frames, gRPC length-prefixed messages, RESP, BSON, AMF0,
thrift's binary encoding, memcache binary, nshead heads and RTMP chunks
render the same bytes and decode to the same values. Then both packages'
parsers cut the same messages from the same bytes split at every point:
each protocol's ``parse`` on a stand-in socket (its dispatches recorded
instead of run), the stream fed in two reads. The one difference on the
wire is the port's h2 SETTINGS preamble, which advertises the
MAX_CONCURRENT_STREAMS it enforces (1024, as the port's engine does)
where the reference advertises 2^20 and enforces nothing.
"""

import datetime
import struct
import types

import numpy as np
import pytest

import brpc_tpu.butil.iobuf as j_iobuf
import brpc_tpu.fiber.execution_queue as j_eq
import brpc_tpu.policy.amf0 as j_amf0
import brpc_tpu.policy.bson as j_bson
import brpc_tpu.policy.grpc_protocol as j_grpc
import brpc_tpu.policy.h2 as j_h2
import brpc_tpu.policy.hpack as j_hpack
import brpc_tpu.policy.memcache as j_mc
import brpc_tpu.policy.mongo_protocol as j_mongo
import brpc_tpu.policy.nshead as j_nshead
import brpc_tpu.policy.redis_protocol as j_redis
import brpc_tpu.policy.rtmp as j_rtmp
import brpc_tpu.policy.thrift_protocol as j_thrift
import brpc_tpu.proto.rpc_meta_pb2 as j_meta
import brpc_tpu_torch.butil.iobuf as p_iobuf
import brpc_tpu_torch.fiber.execution_queue as p_eq
import brpc_tpu_torch.policy.amf0 as p_amf0
import brpc_tpu_torch.policy.bson as p_bson
import brpc_tpu_torch.policy.grpc_protocol as p_grpc
import brpc_tpu_torch.policy.h2 as p_h2
import brpc_tpu_torch.policy.hpack as p_hpack
import brpc_tpu_torch.policy.memcache as p_mc
import brpc_tpu_torch.policy.mongo_protocol as p_mongo
import brpc_tpu_torch.policy.nshead as p_nshead
import brpc_tpu_torch.policy.redis_protocol as p_redis
import brpc_tpu_torch.policy.rtmp as p_rtmp
import brpc_tpu_torch.policy.thrift_protocol as p_thrift
import brpc_tpu_torch.proto.rpc_meta_pb2 as p_meta

PKGS = {
    "jax": types.SimpleNamespace(
        iobuf=j_iobuf, eq=j_eq, amf0=j_amf0, bson=j_bson, grpc=j_grpc,
        h2=j_h2, hpack=j_hpack, mc=j_mc, mongo=j_mongo, nshead=j_nshead,
        redis=j_redis, rtmp=j_rtmp, thrift=j_thrift, meta=j_meta),
    "port": types.SimpleNamespace(
        iobuf=p_iobuf, eq=p_eq, amf0=p_amf0, bson=p_bson, grpc=p_grpc,
        h2=p_h2, hpack=p_hpack, mc=p_mc, mongo=p_mongo, nshead=p_nshead,
        redis=p_redis, rtmp=p_rtmp, thrift=p_thrift, meta=p_meta),
}


def _both(fn):
    """fn(pkg namespace) on both packages: the results, port first."""
    return fn(PKGS["port"]), fn(PKGS["jax"])


def _text(rng, lo, hi, alphabet="abcdefghijklmnopqrstuvwxyz0123456789-_./"):
    n = int(rng.integers(lo, hi + 1))
    return "".join(alphabet[i] for i in rng.integers(0, len(alphabet), n))


def _blob(rng, lo, hi):
    return rng.integers(0, 256, int(rng.integers(lo, hi + 1)),
                        dtype=np.uint8).tobytes()


# ---------------------------------------------------------------------------
#  Stand-ins for the socket, the server and the dispatch fibers
# ---------------------------------------------------------------------------
class _Sock:
    """What a protocol's parse and send paths touch on a Socket: the
    written bytes are kept, nothing goes anywhere."""

    def __init__(self, options=None):
        self.owner_server = (types.SimpleNamespace(options=options)
                             if options is not None else None)
        self.in_messages = 0
        self.preferred_protocol = None
        self.remote = "peer"
        self.failed = False
        self.out = bytearray()

    def write(self, buf, id_wait=None):
        self.out += buf.tobytes() if hasattr(buf, "tobytes") else bytes(buf)
        return 0

    def set_failed(self, *a):
        self.failed = True


class _Fibers:
    """A module's ``runtime`` replaced: response and request dispatches
    are recorded as (function name, meta bytes, body bytes); other work
    (a server's reply) runs inline."""

    def __init__(self):
        self.calls = []

    def start_background(self, fn, *args):
        name = getattr(fn, "__name__", "")
        msg = next((a for a in args if hasattr(a, "meta")
                    and hasattr(a, "body")), None)
        if msg is not None:
            self.calls.append((name, msg.meta.SerializeToString(),
                               msg.body.tobytes()))
        else:
            fn(*args)


class _InlineQueue:
    """ExecutionQueue stand-in: each item runs at once, in order."""

    def __init__(self, consume):
        self._consume = consume

    def execute(self, item):
        self._consume([item])


_FIBERS = {}  # package -> its recorder, while a ``fibers`` test runs


@pytest.fixture()
def fibers(monkeypatch):
    """Per package: the recorder installed in every protocol module, the
    execution queue run inline, mongo's request ids from 1."""
    for name, ns in PKGS.items():
        rec = _FIBERS[name] = _Fibers()
        for mod in (ns.grpc, ns.redis, ns.mongo, ns.thrift, ns.mc,
                    ns.nshead):
            monkeypatch.setattr(mod, "runtime", rec)
        monkeypatch.setattr(ns.eq, "ExecutionQueue", _InlineQueue)
        monkeypatch.setattr(ns.mongo, "_next_request_id", [1])
    yield _FIBERS
    _FIBERS.clear()


def _feed(ns, proto, sock, data, split):
    """data in two reads (split at ``split``) through proto.parse as the
    messenger drives a stateful protocol: parse until it asks for more."""
    buf = ns.iobuf.IOBuf()
    codes = []
    for part in (data[:split], data[split:]):
        buf.append(part)
        codes.append(proto.parse(buf, sock)[0])
    return codes, len(buf)


def _cuts(name, make, data, step=1):
    """For every split point: (parse codes, bytes left, recorded
    dispatches, bytes written) of package ``name``; ``make(ns)`` gives a
    fresh (protocol, socket)."""
    ns = PKGS[name]
    out = []
    for split in range(0, len(data) + 1, step):
        proto, sock = make(ns)
        before = len(_FIBERS[name].calls)
        codes, left = _feed(ns, proto, sock, data, split)
        out.append((codes, left, _FIBERS[name].calls[before:],
                    bytes(sock.out)))
    return out


def _same_at_every_split(make, data, step=1):
    """Both packages cut the same messages at every split, and every
    split cuts what the whole stream cuts. Returns the port's cut of the
    whole stream."""
    port = _cuts("port", make, data, step)
    jax = _cuts("jax", make, data, step)
    assert len(port) == len(jax)
    for k, (a, b) in enumerate(zip(port, jax)):
        assert a[2:] == b[2:], f"split {k * step}"
        assert a[1] == b[1] == 0, f"split {k * step}"
        assert a[2:] == port[-1][2:], f"split {k * step}"
    return port[-1]


# ---------------------------------------------------------------------------
#  HPACK
# ---------------------------------------------------------------------------
_NAMES = [":method", ":path", ":authority", ":status", "content-type",
          "grpc-timeout", "grpc-encoding", "te", "user-agent",
          "x-brpc-log-id", "x-request-id", "cookie", "accept-encoding",
          "x-custom-a", "x-custom-b", "grpc-status", "grpc-message"]


def _header_lists(seed, n_lists, big=False):
    rng = np.random.default_rng(seed)
    seen = []
    lists = []
    for _ in range(n_lists):
        hdrs = []
        for _ in range(int(rng.integers(1, 9))):
            if seen and rng.random() < 0.4:
                hdrs.append(seen[int(rng.integers(0, len(seen)))])
                continue
            name = _NAMES[int(rng.integers(0, len(_NAMES)))]
            if rng.random() < 0.2:
                name = "x-" + _text(rng, 1, 12, "abcdefghij-")
            value = _text(rng, 0, 300 if big and rng.random() < 0.3 else 40,
                          "abcdefghijklmnopqrstuvwxyzABCDEFG0123456789 %/=:")
            hdrs.append((name, value))
            seen.append((name, value))
        lists.append(hdrs)
    return lists


@pytest.mark.parametrize("seed,big", [(0, False), (1, False), (2, True),
                                      (3, True)])
def test_hpack_sequence_bytes_equal(seed, big):
    lists = _header_lists(seed, 60, big)

    def run(ns):
        enc = ns.hpack.HpackEncoder()
        return [bytes(enc.encode(h)) for h in lists]

    port, jax = _both(run)
    assert port == jax
    # both decoders, each fed the whole sequence, give back every list
    for ns in PKGS.values():
        dec = ns.hpack.HpackDecoder()
        assert [dec.decode(b) for b in port] == lists


def test_hpack_table_resize_mid_sequence():
    lists = _header_lists(7, 30, big=True)

    def run(ns):
        enc = ns.hpack.HpackEncoder()
        out = []
        for i, h in enumerate(lists):
            if i in (10, 20):
                enc.table.resize(256 if i == 10 else 4096)
            out.append(bytes(enc.encode(h)))
        return out

    port, jax = _both(run)
    assert port == jax


@pytest.mark.parametrize("seed", range(3))
def test_huffman_and_integers_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        raw = _blob(rng, 0, 200)
        port, jax = _both(lambda ns: ns.hpack.huffman_encode(raw))
        assert port == jax
        assert p_hpack.huffman_decode(jax) == j_hpack.huffman_decode(port) \
            == raw
        v, prefix = int(rng.integers(0, 1 << 30)), int(rng.integers(1, 9))
        port, jax = _both(lambda ns: bytes(ns.hpack.encode_int(v, prefix)))
        assert port == jax
        assert p_hpack.decode_int(port, 0, prefix) == \
            j_hpack.decode_int(port, 0, prefix)


# ---------------------------------------------------------------------------
#  h2 frames and gRPC messages
# ---------------------------------------------------------------------------
def test_h2_frames_bytes_equal():
    rng = np.random.default_rng(11)
    for _ in range(50):
        ftype, flags = int(rng.integers(0, 10)), int(rng.integers(0, 256))
        sid, payload = int(rng.integers(0, 1 << 31)), _blob(rng, 0, 300)
        port, jax = _both(lambda ns: ns.h2.pack_frame(ftype, flags, sid,
                                                      payload))
        assert port == jax
    pairs = [(int(k), int(v)) for k, v in zip(
        rng.integers(1, 7, 5), rng.integers(0, 1 << 31, 5))]
    for ack in (False, True):
        port, jax = _both(lambda ns: ns.h2.pack_settings(pairs, ack=ack))
        assert port == jax


def test_h2_preamble_differs_only_in_max_concurrent_streams():
    def run(ns):
        for role in ("client", "server"):
            sock = _Sock()
            ns.h2.H2Conn(sock, role, lambda *a, **k: None).send_preamble()
            yield bytes(sock.out)

    port, jax = (list(x) for x in _both(run))
    for p, j in zip(port, jax):
        assert len(p) == len(j)
        want = j.replace(struct.pack("!HI", 3, 1 << 20),
                         struct.pack("!HI", 3, 1024))
        assert want != j and p == want


@pytest.mark.parametrize("seed", range(3))
def test_grpc_messages_and_timeouts_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(30):
        body, comp = _blob(rng, 0, 5000), bool(rng.integers(0, 2))
        port, jax = _both(lambda ns: ns.grpc._prefix(body, comp) + body)
        assert port == jax
        assert p_grpc._split_message(port) == j_grpc._split_message(jax) \
            == (comp, body)
        ms = int(rng.integers(1, 1 << 40))
        port, jax = _both(lambda ns: ns.grpc.encode_timeout(ms))
        assert port == jax
        assert p_grpc.decode_timeout(port) == j_grpc.decode_timeout(jax)
    assert p_grpc.BRPC_TO_GRPC == j_grpc.BRPC_TO_GRPC
    assert p_grpc.GRPC_TO_BRPC == j_grpc.GRPC_TO_BRPC


def _grpc_calls(seed, n=3):
    rng = np.random.default_rng(seed)
    calls = []
    for i in range(n):
        calls.append(dict(
            cid=int(rng.integers(1, 1 << 40)), svc="EchoService",
            method=["Echo", "Generate", "Check"][i % 3],
            timeout=int(rng.integers(0, 5000)), log_id=int(rng.integers(0, 99)),
            payload=_blob(rng, 0, 120)))
    return calls


def _client_requests(ns, calls):
    """The gRPC client's bytes for ``calls`` on one connection."""
    proto, sock = ns.grpc.GrpcProtocol(), _Sock()
    for c in calls:
        meta = ns.meta.RpcMeta()
        meta.correlation_id = c["cid"]
        meta.request.service_name = c["svc"]
        meta.request.method_name = c["method"]
        if c["timeout"]:
            meta.request.timeout_ms = c["timeout"]
        if c["log_id"]:
            meta.request.log_id = c["log_id"]
        assert proto.issue_request(sock, meta, c["payload"]) == 0
    return proto, sock


def _strip_preamble(name, data, client):
    """The stream past the role's preamble, the one place the packages
    differ."""
    sock = _Sock()
    PKGS[name].h2.H2Conn(sock, "client" if client else "server",
                         lambda *a, **k: None).send_preamble()
    assert data.startswith(bytes(sock.out))
    return data[len(sock.out):]


def test_grpc_client_requests_equal(fibers):
    calls = _grpc_calls(5, n=6)
    (_, port), (_, jax) = _both(lambda ns: _client_requests(ns, calls))
    assert _strip_preamble("port", bytes(port.out), True) == \
        _strip_preamble("jax", bytes(jax.out), True)


def test_grpc_server_cuts_every_split(fibers):
    """The client's stream (preface, SETTINGS, three requests) cut by the
    server side of both packages at every split: the same three requests
    dispatched (meta and message bytes), the same replies written."""
    calls = _grpc_calls(6)
    _, sock = _client_requests(PKGS["port"], calls)
    data = bytes(sock.out)

    def make(ns):
        return ns.grpc.GrpcProtocol(), _Sock(options=types.SimpleNamespace())

    port = _cuts("port", make, data)
    jax = _cuts("jax", make, data)
    for k, (a, b) in enumerate(zip(port, jax)):
        assert a[2] == b[2] == port[-1][2], f"split {k}"
        assert _strip_preamble("port", a[3], False) == \
            _strip_preamble("jax", b[3], False), f"split {k}"
    got = port[-1][2]
    assert [g[0] for g in got] == ["process_rpc_request"] * 3
    for (_, meta_b, body), c in zip(got, calls):
        meta = p_meta.RpcMeta.FromString(meta_b)
        assert (meta.request.service_name, meta.request.method_name) == \
            (c["svc"], c["method"])
        assert body == c["payload"]


def _server_conn(ns, calls):
    """A server connection that has read ``calls``: (sock, the response
    shims in request order)."""
    _, csock = _client_requests(ns, calls)
    proto, sock = ns.grpc.GrpcProtocol(), _Sock(options=types.SimpleNamespace())
    shims = []

    class _Keep(_Fibers):
        def start_background(self, fn, *args):
            if getattr(fn, "__name__", "") == "process_rpc_request":
                shims.append(args[0])
            else:
                fn(*args)

    saved = ns.grpc.runtime
    ns.grpc.runtime = _Keep()
    try:
        buf = ns.iobuf.IOBuf()
        buf.append(bytes(csock.out))
        proto.parse(buf, sock)
    finally:
        ns.grpc.runtime = saved
    assert len(shims) == len(calls)
    return sock, shims


def test_grpc_server_responses_equal(fibers):
    """Responses packed on the server's streams (OK with a message, OK
    compressed, an error with its text): the same HEADERS, DATA and
    trailers, HPACK table included."""
    calls = _grpc_calls(8)
    rng = np.random.default_rng(8)
    bodies = [_blob(rng, 0, 400) for _ in calls]

    def run(ns):
        sock, shims = _server_conn(ns, calls)
        mark = len(sock.out)
        for i, shim in enumerate(shims):
            meta = ns.meta.RpcMeta()
            if i == 2:
                meta.response.error_code = 1002  # EREQUEST
                meta.response.error_text = "missing prompt / 100%"
            elif i == 1:
                meta.compress_type = 1
            shim.pack_response(meta, bodies[i])
        return bytes(sock.out[mark:])

    port, jax = _both(run)
    assert port == jax and port


def test_grpc_client_cuts_every_split(fibers):
    """The server's responses cut by the client side at every split: the
    same completions (meta and message bytes) in both packages."""
    calls = _grpc_calls(9)
    rng = np.random.default_rng(9)
    bodies = [_blob(rng, 0, 200) for _ in calls]
    ssock, shims = _server_conn(PKGS["port"], calls)
    mark = len(ssock.out)
    for i, shim in enumerate(shims):
        meta = p_meta.RpcMeta()
        if i == 1:
            meta.response.error_code = 1002
            meta.response.error_text = "bad"
        shim.pack_response(meta, bodies[i])
    data = bytes(ssock.out[mark:])

    def make(ns):
        proto, sock = _client_requests(ns, calls)
        return proto, sock

    port = _cuts("port", make, data)
    jax = _cuts("jax", make, data)
    for k, (a, b) in enumerate(zip(port, jax)):
        assert a[2] == b[2] == port[-1][2], f"split {k}"
    got = port[-1][2]
    assert [g[0] for g in got] == ["handle_response_message"] * 3
    metas = [p_meta.RpcMeta.FromString(g[1]) for g in got]
    assert [m.correlation_id for m in metas] == [c["cid"] for c in calls]
    assert [m.response.error_code for m in metas] == [0, 1002, 0]
    assert got[0][2] == bodies[0] and got[2][2] == bodies[2]


# ---------------------------------------------------------------------------
#  RESP
# ---------------------------------------------------------------------------
def _replies(ns, rng, depth=0):
    R = ns.redis
    kind = int(rng.integers(0, 6 if depth < 2 else 5))
    if kind == 0:
        return R.RedisReply(R.REPLY_STRING, _text(rng, 0, 20))
    if kind == 1:
        return R.RedisReply(R.REPLY_ERROR, "ERR " + _text(rng, 0, 20))
    if kind == 2:
        return R.RedisReply(R.REPLY_INTEGER,
                            int(rng.integers(-(1 << 62), 1 << 62)))
    if kind == 3:
        return R.RedisReply(R.REPLY_BULK, _blob(rng, 0, 300))
    if kind == 4:
        return R.RedisReply(R.REPLY_BULK, None)
    return R.RedisReply(R.REPLY_ARRAY, [_replies(ns, rng, depth + 1)
                                        for _ in range(int(rng.integers(0, 4)))])


@pytest.mark.parametrize("seed", range(3))
def test_resp_bytes_equal(seed):
    def run(ns):
        rng = np.random.default_rng(seed)
        cmds = [ns.redis.pack_command(*[_blob(rng, 0, 200) for _ in range(
            int(rng.integers(1, 5)))]) for _ in range(20)]
        reps = [ns.redis.pack_reply(_replies(ns, rng)) for _ in range(40)]
        return cmds, reps

    port, jax = _both(run)
    assert port == jax
    stream = b"".join(port[1])
    for ns in PKGS.values():
        pos, n = 0, 0
        while pos < len(stream):
            _, pos = ns.redis.parse_reply(stream, pos)
            n += 1
        assert n == 40


def test_resp_server_cuts_every_split(fibers):
    rng = np.random.default_rng(21)
    data = b"".join(p_redis.pack_command(b"SET", _blob(rng, 1, 8),
                                         _blob(rng, 0, 60))
                    for _ in range(4)) + p_redis.pack_command(b"GET", b"k")

    class Kv:
        def __init__(self, ns):
            self.ns, self.store = ns, {}

        def handle(self, args):
            R = self.ns.redis
            if args[0] == b"SET":
                self.store[args[1]] = args[2]
                return R.RedisReply(R.REPLY_STRING, "OK")
            return R.RedisReply(R.REPLY_BULK, self.store.get(args[1]))

    def make(ns):
        return ns.redis.RedisProtocol(), _Sock(
            options=types.SimpleNamespace(redis_service=Kv(ns)))

    whole = _same_at_every_split(make, data)
    assert whole[3] == b"+OK\r\n" * 4 + b"$-1\r\n"


def test_resp_client_cuts_every_split(fibers):
    rng = np.random.default_rng(22)
    reps = [_replies(PKGS["port"], rng) for _ in range(6)]
    data = b"".join(p_redis.pack_reply(r) for r in reps)

    def make(ns):
        proto, sock = ns.redis.RedisProtocol(), _Sock()
        cst = ns.redis._RedisClientState()
        for cid, need in ((7, 2), (8, 1), (9, 3)):  # replies per call
            cst.fifo.append((cid, 0, need))
        sock.redis_client = cst
        return proto, sock

    whole = _same_at_every_split(make, data)
    assert [p_meta.RpcMeta.FromString(c[1]).correlation_id
            for c in whole[2]] == [7, 8, 9]
    assert b"".join(c[2] for c in whole[2]) == data


# ---------------------------------------------------------------------------
#  BSON and mongo
# ---------------------------------------------------------------------------
def _doc(ns, rng, depth=0):
    doc = {}
    for i in range(int(rng.integers(1, 7))):
        key = _text(rng, 1, 10, "abcdefgh$_") + str(i)
        kind = int(rng.integers(0, 11 if depth < 2 else 9))
        if kind == 0:
            doc[key] = float(rng.normal())
        elif kind == 1:
            doc[key] = _text(rng, 0, 50)
        elif kind == 2:
            doc[key] = _blob(rng, 0, 40)
        elif kind == 3:
            doc[key] = ns.bson.ObjectId(_blob(rng, 12, 12))
        elif kind == 4:
            doc[key] = bool(rng.integers(0, 2))
        elif kind == 5:
            doc[key] = datetime.datetime(
                2020, 1, 1, tzinfo=datetime.timezone.utc) + \
                datetime.timedelta(milliseconds=int(rng.integers(0, 1 << 40)))
        elif kind == 6:
            doc[key] = None
        elif kind == 7:
            doc[key] = int(rng.integers(-(1 << 31), 1 << 31))
        elif kind == 8:
            doc[key] = int(rng.integers(1 << 31, 1 << 62))
        elif kind == 9:
            doc[key] = _doc(ns, rng, depth + 1)
        else:
            doc[key] = [int(x) for x in rng.integers(0, 100, 3)] + \
                [_doc(ns, rng, depth + 1)]
    return doc


@pytest.mark.parametrize("seed", range(4))
def test_bson_bytes_equal(seed):
    def run(ns):
        rng = np.random.default_rng(seed)
        return [ns.bson.encode(_doc(ns, rng)) for _ in range(20)]

    port, jax = _both(run)
    assert port == jax
    for raw in port:
        a, b = p_bson.decode(raw), j_bson.decode(raw)
        assert p_bson.encode(a) == j_bson.encode(b) == raw


def test_mongo_server_cuts_every_split(fibers):
    rng = np.random.default_rng(31)
    data = b"".join(p_mongo.pack_msg(100 + i, 0, {"find": "kv", "$db": "d",
                                                  "k": _text(rng, 0, 30)})
                    for i in range(3))

    class Svc:
        def handle(self, doc):
            return {"ok": 1.0, "echo": doc["k"]}

    def make(ns):
        ns.mongo._next_request_id[0] = 1
        return ns.mongo.MongoProtocol(), _Sock(
            options=types.SimpleNamespace(mongo_service=Svc()))

    whole = _same_at_every_split(make, data)
    assert len(whole[3]) > 3 * 16


def test_mongo_client_cuts_every_split(fibers):
    rng = np.random.default_rng(32)
    docs = [_doc(PKGS["port"], rng) for _ in range(3)]
    data = b"".join(p_mongo.pack_msg(50 + i, 10 + i, d)
                    for i, d in enumerate(docs))

    def make(ns):
        proto, sock = ns.mongo.MongoProtocol(), _Sock()
        cst = ns.mongo._MongoClientState()
        cst.inflight.update({10: (70, 0), 11: (71, 1), 12: (72, 0)})
        sock.mongo_client = cst
        return proto, sock

    whole = _same_at_every_split(make, data, step=3)
    assert [p_meta.RpcMeta.FromString(c[1]).correlation_id
            for c in whole[2]] == [70, 71, 72]


# ---------------------------------------------------------------------------
#  AMF0 and RTMP chunks
# ---------------------------------------------------------------------------
def _amf(rng, depth=0):
    kind = int(rng.integers(0, 7 if depth < 2 else 5))
    if kind == 0:
        return float(rng.normal() * 1000)
    if kind == 1:
        return bool(rng.integers(0, 2))
    if kind == 2:
        return _text(rng, 0, 60)
    if kind == 3:
        return None
    if kind == 4:
        return int(rng.integers(0, 1 << 40))
    if kind == 5:
        return {_text(rng, 1, 8): _amf(rng, depth + 1)
                for _ in range(int(rng.integers(0, 4)))}
    return [_amf(rng, depth + 1) for _ in range(int(rng.integers(0, 4)))]


@pytest.mark.parametrize("seed", range(3))
def test_amf0_bytes_equal(seed):
    rng = np.random.default_rng(seed)
    values = [_amf(rng) for _ in range(30)] + ["x" * 70000]
    port, jax = _both(lambda ns: ns.amf0.encode(*values))
    assert port == jax
    assert p_amf0.decode_all(port) == j_amf0.decode_all(jax)


def test_rtmp_chunks_cut_every_split():
    rng = np.random.default_rng(41)
    msgs = [(3, 20, 0, p_amf0.encode("connect", 1.0, {"app": "live"}), 0),
            (2, 1, 0, struct.pack(">I", 300), 0),  # set chunk size
            (6, 9, 1, _blob(rng, 500, 900), 33),
            (4, 8, 1, _blob(rng, 50, 90), 0xFFFFFF + 5),
            (6, 9, 1, _blob(rng, 1, 40), 66)]
    chunk = [128, 128, 300, 300, 300]

    def render(ns):
        return b"".join(ns.rtmp.pack_chunks(c, t, s, p, ts, chunk_size=cs)
                        for (c, t, s, p, ts), cs in zip(msgs, chunk))

    port, jax = _both(render)
    assert port == jax

    def cut(ns, split):
        reader, buf, got = ns.rtmp.ChunkReader(), ns.iobuf.IOBuf(), []
        for part in (port[:split], port[split:]):
            buf.append(part)
            got += reader.feed(buf)
        return got, len(buf)

    for split in range(0, len(port) + 1, 7):
        a, b = cut(PKGS["port"], split), cut(PKGS["jax"], split)
        assert a == b
        assert [m[3] for m in a[0]] == [m[3] for m in msgs]
        assert a[1] == 0


# ---------------------------------------------------------------------------
#  thrift, memcache, nshead
# ---------------------------------------------------------------------------
def _thrift_body(ns, rng):
    w = ns.thrift.ThriftBinaryWriter()
    for fid in range(1, int(rng.integers(2, 9))):
        kind = int(rng.integers(0, 7))
        if kind == 0:
            w.write_bool(fid, bool(rng.integers(0, 2)))
        elif kind == 1:
            w.write_byte(fid, int(rng.integers(-128, 128)))
        elif kind == 2:
            w.write_i16(fid, int(rng.integers(-(1 << 15), 1 << 15)))
        elif kind == 3:
            w.write_i32(fid, int(rng.integers(-(1 << 31), 1 << 31)))
        elif kind == 4:
            w.write_i64(fid, int(rng.integers(-(1 << 62), 1 << 62)))
        elif kind == 5:
            w.write_double(fid, float(rng.normal()))
        else:
            w.write_string(fid, _blob(rng, 0, 60))
    inner = ns.thrift.ThriftBinaryWriter().write_i32(1, 7).field_stop()
    return w.write_struct(99, inner.bytes()).field_stop().bytes()


@pytest.mark.parametrize("seed", range(3))
def test_thrift_bytes_equal(seed):
    def run(ns):
        rng = np.random.default_rng(seed)
        out = []
        for i in range(10):
            body = _thrift_body(ns, rng)
            out.append(ns.thrift.pack_message(
                int(rng.integers(1, 5)), _text(rng, 1, 20), i, body))
        out.append(ns.thrift.pack_application_exception("m", 3, 1, "boom"))
        return out

    port, jax = _both(run)
    assert port == jax
    for frame in port:
        a = p_thrift.unpack_message(frame[4:])
        assert a == j_thrift.unpack_message(frame[4:])
        if a[0] != p_thrift.MT_EXCEPTION:
            assert p_thrift.ThriftBinaryReader(a[3]).read_struct() == \
                j_thrift.ThriftBinaryReader(a[3]).read_struct()


def test_thrift_server_cuts_every_split(fibers):
    rng = np.random.default_rng(51)
    data = b"".join(p_thrift.pack_message(
        p_thrift.MT_CALL, ["Add", "Nope"][i % 2], i,
        _thrift_body(PKGS["port"], rng)) for i in range(3))

    def make(ns):
        svc = ns.thrift.ThriftService()
        svc.add_method("Add", lambda body: body[:8] + b"\x00")
        return ns.thrift.ThriftProtocol(), _Sock(
            options=types.SimpleNamespace(thrift_service=svc))

    whole = _same_at_every_split(make, data)
    assert len(whole[3]) > 0


def test_thrift_client_cuts_every_split(fibers):
    rng = np.random.default_rng(52)
    data = b"".join([
        p_thrift.pack_message(p_thrift.MT_REPLY, "Add", 1,
                              _thrift_body(PKGS["port"], rng)),
        p_thrift.pack_application_exception("Add", 2, 6, "failed"),
        p_thrift.pack_message(p_thrift.MT_REPLY, "Add", 3, b"\x00")])

    def make(ns):
        proto, sock = ns.thrift.ThriftProtocol(), _Sock()
        cst = ns.thrift._ThriftClientState()
        cst.calls.update({1: (81, 0), 2: (82, 0), 3: (83, 2)})
        sock.thrift_client = cst
        return proto, sock

    whole = _same_at_every_split(make, data)
    metas = [p_meta.RpcMeta.FromString(c[1]) for c in whole[2]]
    assert [m.correlation_id for m in metas] == [81, 82, 83]
    assert metas[1].response.error_text == "failed"


@pytest.mark.parametrize("seed", range(3))
def test_memcache_bytes_equal(seed):
    def run(ns):
        rng = np.random.default_rng(seed)
        req = ns.mc.MemcacheRequest()
        for _ in range(12):
            key, val = _blob(rng, 1, 30), _blob(rng, 0, 200)
            op = int(rng.integers(0, 5))
            if op == 0:
                req.get(key)
            elif op == 1:
                req.set(key, val, flags=int(rng.integers(0, 99)),
                        exptime=int(rng.integers(0, 999)))
            elif op == 2:
                req.delete(key)
            elif op == 3:
                req.incr(key, int(rng.integers(0, 1 << 40)))
            else:
                req.append(key, val)
        return req.SerializeToString()

    port, jax = _both(run)
    assert port == jax
    assert p_mc.count_ops(port) == j_mc.count_ops(jax) == 12


def _mc_response(opcode, status, key=b"", value=b"", extras=b"", opaque=0):
    body = extras + key + value
    return struct.pack(p_mc.HEADER_FMT, p_mc.MAGIC_RESPONSE, opcode,
                       len(key), len(extras), 0, status, len(body), opaque,
                       0) + body


def test_memcache_client_cuts_every_split(fibers):
    rng = np.random.default_rng(61)
    data = b"".join(_mc_response(p_mc.OP_GET, 0, value=_blob(rng, 0, 80),
                                 extras=b"\x00\x00\x00\x01", opaque=i)
                    for i in range(4)) + _mc_response(
        p_mc.OP_SET, p_mc.STATUS_KEY_EXISTS, value=b"exists", opaque=5)

    def make(ns):
        proto, sock = ns.mc.MemcacheProtocol(), _Sock()
        cst = ns.mc._McClientState()
        cst.fifo.extend([(91, 0, 3), (92, 0, 2)])
        sock.memcache_client = cst
        return proto, sock

    whole = _same_at_every_split(make, data)
    assert [p_meta.RpcMeta.FromString(c[1]).correlation_id
            for c in whole[2]] == [91, 92]


@pytest.mark.parametrize("seed", range(3))
def test_nshead_bytes_equal(seed):
    def run(ns):
        rng = np.random.default_rng(seed)
        return [ns.nshead.NsheadMessage(
            _blob(rng, 0, 300), id=int(rng.integers(0, 1 << 16)),
            version=int(rng.integers(0, 1 << 16)),
            log_id=int(rng.integers(0, 1 << 32)),
            provider=_blob(rng, 0, 20)).SerializeToString()
            for _ in range(20)]

    port, jax = _both(run)
    assert port == jax
    for raw in port:
        a, b = p_nshead.NsheadMessage(), j_nshead.NsheadMessage()
        a.ParseFromString(raw)
        b.ParseFromString(raw)
        assert (a.id, a.version, a.log_id, a.provider, a.body) == \
            (b.id, b.version, b.log_id, b.provider, b.body)


def test_nshead_server_cuts_every_split(fibers):
    rng = np.random.default_rng(71)
    data = b"".join(p_nshead.NsheadMessage(
        _blob(rng, 0, 50), id=i, log_id=100 + i).SerializeToString()
        for i in range(3))

    def make(ns):
        class Svc(ns.nshead.NsheadService):
            def process(self, peer, req):
                return ns.nshead.NsheadMessage(req.body[::-1], id=req.id,
                                               log_id=req.log_id)

        return ns.nshead.NsheadProtocol(), _Sock(
            options=types.SimpleNamespace(nshead_service=Svc()))

    whole = _same_at_every_split(make, data)
    assert len(whole[3]) == len(data)


def test_nshead_client_cuts_every_split(fibers):
    rng = np.random.default_rng(72)
    data = b"".join(p_nshead.NsheadMessage(
        _blob(rng, 0, 50), id=i).SerializeToString() for i in range(3))

    def make(ns):
        proto, sock = ns.nshead.NsheadProtocol(), _Sock()
        cst = ns.nshead._NsClientState()
        cst.fifo.extend([(11, 0), (12, 1), (13, 0)])
        sock.nshead_client = cst
        return proto, sock

    whole = _same_at_every_split(make, data)
    assert [p_meta.RpcMeta.FromString(c[1]).correlation_id
            for c in whole[2]] == [11, 12, 13]
