"""The port's counterpart of the JAX package's ``tests/test_memcache_nshead.py``:
every case runs against the port's servers and clients.

Memcache binary client (against an in-test toy memcached) and nshead
client+server tests — the reference's legacy-protocol conformance pattern."""

import socket as pysocket
import struct
import threading

import pytest

from brpc_tpu_torch.policy import memcache as mc
from brpc_tpu_torch.policy.nshead import (
    NsheadMessage,
    NsheadService,
    nshead_method,
)
from brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, ServerOptions


# ------------------------------------------------------------ toy memcached
class ToyMemcached:
    """Minimal memcached speaking the binary protocol (test substrate —
    the reference tests against a real memcached; we craft the peer)."""

    def __init__(self):
        self.store = {}
        self.sock = pysocket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.port = self.sock.getsockname()[1]
        self._stop = False
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        while not self._stop:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._conn, args=(conn,),
                             daemon=True).start()

    def _conn(self, conn):
        buf = b""
        try:
            while True:
                chunk = conn.recv(65536)
                if not chunk:
                    return
                buf += chunk
                out = b""
                while len(buf) >= 24:
                    (magic, op, keylen, extlen, _dt, _vb, bodylen, opaque,
                     cas) = struct.unpack_from(mc.HEADER_FMT, buf, 0)
                    if len(buf) < 24 + bodylen:
                        break
                    extras = buf[24:24 + extlen]
                    key = buf[24 + extlen:24 + extlen + keylen]
                    value = buf[24 + extlen + keylen:24 + bodylen]
                    buf = buf[24 + bodylen:]
                    out += self._handle(op, key, extras, value, opaque)
                if out:
                    conn.sendall(out)
        except OSError:
            pass
        finally:
            conn.close()

    def _resp(self, op, status, opaque, key=b"", extras=b"", value=b"",
              cas=0):
        body = len(extras) + len(key) + len(value)
        return struct.pack(mc.HEADER_FMT, 0x81, op, len(key), len(extras),
                           0, status, body, opaque, cas) + extras + key + value

    def _handle(self, op, key, extras, value, opaque):
        if op == mc.OP_SET:
            self.store[key] = (extras[:4], value)
            return self._resp(op, 0, opaque, cas=1)
        if op == mc.OP_ADD:
            if key in self.store:
                return self._resp(op, mc.STATUS_KEY_EXISTS, opaque,
                                  value=b"exists")
            self.store[key] = (extras[:4], value)
            return self._resp(op, 0, opaque, cas=1)
        if op == mc.OP_GET:
            if key not in self.store:
                return self._resp(op, mc.STATUS_KEY_NOT_FOUND, opaque,
                                  value=b"Not found")
            flags, v = self.store[key]
            return self._resp(op, 0, opaque, extras=flags, value=v, cas=1)
        if op == mc.OP_DELETE:
            ok = key in self.store
            self.store.pop(key, None)
            return self._resp(op, 0 if ok else mc.STATUS_KEY_NOT_FOUND,
                              opaque)
        if op == mc.OP_INCREMENT:
            delta, initial, _ = struct.unpack("!QQI", extras)
            cur = int(self.store.get(key, (b"", str(initial).encode()))[1])
            if key in self.store:
                cur += delta
            self.store[key] = (b"\x00" * 4, str(cur).encode())
            return self._resp(op, 0, opaque, value=struct.pack("!Q", cur))
        if op == mc.OP_VERSION:
            return self._resp(op, 0, opaque, value=b"1.6.0-toy")
        return self._resp(op, mc.STATUS_UNKNOWN_COMMAND, opaque,
                          value=b"unknown")

    def close(self):
        self._stop = True
        self.sock.close()


@pytest.fixture()
def toy_memcached():
    s = ToyMemcached()
    yield s
    s.close()


class TestMemcache:
    def test_set_get_delete_pipeline(self, toy_memcached):
        ch = Channel(ChannelOptions(protocol="memcache")).init(
            f"127.0.0.1:{toy_memcached.port}")
        req = mc.MemcacheRequest()
        req.set("k", "hello", flags=7).get("k").delete("k").get("k")
        resp = ch.call_method(mc.memcache_method(), req,
                              mc.MemcacheResponse())
        assert resp.result_size == 4
        r_set, r_get, r_del, r_get2 = [resp.pop() for _ in range(4)]
        assert r_set.ok and r_set.cas == 1
        assert r_get.ok and r_get.value == b"hello"
        assert struct.unpack("!I", r_get.extras[:4])[0] == 7
        assert r_del.ok
        assert r_get2.status == mc.STATUS_KEY_NOT_FOUND

    def test_incr_and_version(self, toy_memcached):
        ch = Channel(ChannelOptions(protocol="memcache")).init(
            f"127.0.0.1:{toy_memcached.port}")
        req = mc.MemcacheRequest().incr("ctr", 5, initial=10).incr("ctr", 5)
        req.version()
        resp = ch.call_method(mc.memcache_method(), req,
                              mc.MemcacheResponse())
        v1 = struct.unpack("!Q", resp.result(0).value)[0]
        v2 = struct.unpack("!Q", resp.result(1).value)[0]
        assert v2 == v1 + 5
        assert b"toy" in resp.result(2).value

    def test_concurrent_pipelines(self, toy_memcached):
        ch = Channel(ChannelOptions(protocol="memcache",
                                    timeout_ms=5000)).init(
            f"127.0.0.1:{toy_memcached.port}")
        bad = []

        def worker(i):
            for j in range(15):
                try:
                    req = mc.MemcacheRequest()
                    req.set(f"w{i}", f"{i}.{j}").get(f"w{i}")
                    resp = ch.call_method(mc.memcache_method(), req,
                                          mc.MemcacheResponse())
                    if resp.result(1).value != f"{i}.{j}".encode():
                        bad.append((i, j, resp.result(1).value))
                except Exception as e:
                    bad.append((i, j, repr(e)))
                    return

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not bad


# ------------------------------------------------------------------- nshead
class UpperNshead(NsheadService):
    def process(self, peer, request: NsheadMessage) -> NsheadMessage:
        return NsheadMessage(request.body.upper(), id=request.id,
                             log_id=request.log_id)


@pytest.fixture()
def nshead_server():
    server = Server(ServerOptions(
        nshead_service=UpperNshead())).start("127.0.0.1:0")
    yield server
    server.stop()
    server.join(timeout=2)


class TestNshead:
    def test_header_roundtrip(self):
        m = NsheadMessage(b"payload", id=3, version=1, log_id=99)
        raw = m.SerializeToString()
        assert len(raw) == 36 + 7
        m2 = NsheadMessage()
        m2.ParseFromString(raw)
        assert (m2.id, m2.version, m2.log_id) == (3, 1, 99)
        assert m2.body == b"payload"
        assert m2.provider == b"brpc-tpu"

    def test_client_server_echo(self, nshead_server):
        ch = Channel(ChannelOptions(protocol="nshead")).init(
            str(nshead_server.listen_endpoint()))
        resp = ch.call_method(nshead_method(),
                              NsheadMessage(b"hello nshead", log_id=5),
                              NsheadMessage())
        assert resp.body == b"HELLO NSHEAD"
        assert resp.log_id == 5

    def test_pipelined_order(self, nshead_server):
        ch = Channel(ChannelOptions(protocol="nshead",
                                    timeout_ms=5000)).init(
            str(nshead_server.listen_endpoint()))
        bad = []

        def worker(i):
            for j in range(15):
                try:
                    r = ch.call_method(nshead_method(),
                                       NsheadMessage(f"m{i}.{j}".encode()),
                                       NsheadMessage())
                    if r.body != f"M{i}.{j}".upper().encode():
                        bad.append((i, j, r.body))
                except Exception as e:
                    bad.append((i, j, repr(e)))
                    return

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not bad
        assert nshead_server.connection_count() == 1
