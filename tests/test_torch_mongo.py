"""The port's counterpart of the JAX package's ``tests/test_mongo.py``:
every case runs against the port's servers and clients.

Mongo wire protocol + BSON codec tests (reference
policy/mongo_protocol.cpp). Pattern: real loopback server running a
MongoService fake-mongod, client over Channel — no mocks (SURVEY §4)."""

import datetime

import pytest

from brpc_tpu_torch.policy import bson
from brpc_tpu_torch.policy.mongo_protocol import (
    MongoRequest,
    MongoResponse,
    MongoService,
    mongo_method,
    pack_msg,
    unpack_msg_body,
)
from brpc_tpu_torch.rpc import Channel, ChannelOptions, RpcError, Server, ServerOptions


class TestBson:
    def test_roundtrip_all_types(self):
        oid = bson.ObjectId()
        now = datetime.datetime(2026, 7, 30, 12, 0,
                                tzinfo=datetime.timezone.utc)
        doc = {
            "d": 2.5, "s": "héllo", "sub": {"a": 1}, "arr": [1, "two", None],
            "bin": b"\x00\xff", "oid": oid, "flag": True, "ts": now,
            "nil": None, "i32": -5, "i64": 1 << 40,
        }
        assert bson.decode(bson.encode(doc)) == doc

    def test_objectid_uniqueness(self):
        assert bson.ObjectId() != bson.ObjectId()
        fixed = bson.ObjectId(b"\x01" * 12)
        assert bson.decode(bson.encode({"x": fixed}))["x"] == fixed

    def test_malformed_rejected(self):
        good = bson.encode({"a": 1})
        with pytest.raises(bson.BsonError):
            bson.decode(good[:-2])
        with pytest.raises(bson.BsonError):
            bson.decode(b"\x03\x00\x00\x00")
        bad_type = bytearray(good)
        bad_type[4] = 0x7F  # unknown element type
        with pytest.raises(bson.BsonError):
            bson.decode(bytes(bad_type))

    def test_opmsg_roundtrip(self):
        raw = pack_msg(7, 0, {"ping": 1})
        assert unpack_msg_body(raw[16:]) == {"ping": 1}


@pytest.fixture()
def mongod():
    svc = MongoService()
    store = {}

    def insert(doc):
        for d in doc.get("documents", []):
            store[str(d.get("_id"))] = d
        return {"ok": 1.0, "n": len(doc.get("documents", []))}

    def find(doc):
        batch = [d for d in store.values()
                 if all(d.get(k) == v for k, v in
                        doc.get("filter", {}).items())]
        return {"ok": 1.0,
                "cursor": {"id": 0, "ns": f"t.{doc['find']}",
                           "firstBatch": batch}}

    svc.add_command_handler("insert", insert)
    svc.add_command_handler("find", find)
    server = Server(ServerOptions(mongo_service=svc))
    server.start("127.0.0.1:0")
    yield server
    server.stop()
    server.join(timeout=2)


def _call(channel, doc) -> MongoResponse:
    return channel.call_method(mongo_method(), MongoRequest(doc))


class TestMongoClientServer:
    def test_ping_hello(self, mongod):
        ch = Channel(ChannelOptions(protocol="mongo", timeout_ms=5000))
        ch.init(str(mongod.listen_endpoint()))
        assert _call(ch, {"ping": 1, "$db": "admin"}).ok
        hello = _call(ch, {"hello": 1})
        assert hello.document["isWritablePrimary"] is True

    def test_insert_find(self, mongod):
        ch = Channel(ChannelOptions(protocol="mongo", timeout_ms=5000))
        ch.init(str(mongod.listen_endpoint()))
        oid = bson.ObjectId()
        r = _call(ch, {"insert": "users", "$db": "t", "documents": [
            {"_id": oid, "name": "ada", "age": 36},
            {"_id": bson.ObjectId(), "name": "bob", "age": 41},
        ]})
        assert r.ok and r.document["n"] == 2
        found = _call(ch, {"find": "users", "$db": "t",
                           "filter": {"name": "ada"}})
        batch = found.document["cursor"]["firstBatch"]
        assert len(batch) == 1 and batch[0]["_id"] == oid

    def test_unknown_command(self, mongod):
        ch = Channel(ChannelOptions(protocol="mongo", timeout_ms=5000))
        ch.init(str(mongod.listen_endpoint()))
        r = _call(ch, {"frobnicate": 1})
        assert not r.ok and r.document["code"] == 59

    def test_pipelined_commands(self, mongod):
        """requestID/responseTo correlation: many in-flight commands on one
        connection complete correctly."""
        import threading

        ch = Channel(ChannelOptions(protocol="mongo", timeout_ms=5000))
        ch.init(str(mongod.listen_endpoint()))
        errs = []

        def worker(i):
            try:
                for _ in range(20):
                    assert _call(ch, {"ping": 1}).ok
            except Exception as e:  # pragma: no cover
                errs.append(e)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errs, errs

    def test_timeout_on_dead_server(self):
        server = Server(ServerOptions(mongo_service=MongoService()))
        server.start("127.0.0.1:0")
        addr = str(server.listen_endpoint())
        ch = Channel(ChannelOptions(protocol="mongo", timeout_ms=1500,
                                    max_retry=0))
        ch.init(addr)
        assert _call(ch, {"ping": 1}).ok
        server.stop()
        server.join(timeout=2)
        with pytest.raises(RpcError):
            _call(ch, {"ping": 1})
