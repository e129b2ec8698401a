"""Mongo wire-protocol demo: a fake-mongod (MongoService) served by the
framework, driven by the mongo client channel — insert + find over OP_MSG
with our BSON codec (reference example: mongo_c++). The JAX package's
``examples/mongo_kv/client.py`` on the port's RPC stack.

    python -m brpc_tpu_torch.examples.mongo_kv.client [-n 5]
"""

import argparse
import sys

from brpc_tpu_torch.policy import bson
from brpc_tpu_torch.policy.mongo_protocol import (MongoRequest,
                                                  MongoService, mongo_method)
from brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, ServerOptions


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=5)
    args = ap.parse_args(argv)

    store = {}
    svc = MongoService()
    svc.add_command_handler("insert", lambda doc: (
        [store.__setitem__(str(d["_id"]), d)
         for d in doc.get("documents", [])],
        {"ok": 1.0, "n": len(doc.get("documents", []))})[-1])
    svc.add_command_handler("find", lambda doc: {
        "ok": 1.0, "cursor": {"id": 0, "ns": f"demo.{doc['find']}",
                              "firstBatch": [
                                  d for d in store.values()
                                  if all(d.get(k) == v for k, v in
                                         doc.get("filter", {}).items())]}})

    server = Server(ServerOptions(mongo_service=svc))
    server.start("127.0.0.1:0")
    print(f"fake mongod on {server.listen_endpoint()}")

    ch = Channel(ChannelOptions(protocol="mongo", timeout_ms=5000))
    ch.init(str(server.listen_endpoint()))

    def call(doc):
        return ch.call_method(mongo_method(), MongoRequest(doc))

    assert call({"ping": 1, "$db": "admin"}).ok
    docs = [{"_id": bson.ObjectId(), "k": f"key{i}", "v": i * 10}
            for i in range(args.n)]
    r = call({"insert": "kv", "$db": "demo", "documents": docs})
    print(f"inserted n={r.document['n']}")
    for i in range(args.n):
        r = call({"find": "kv", "$db": "demo", "filter": {"k": f"key{i}"}})
        batch = r.document["cursor"]["firstBatch"]
        print(f"find key{i} -> v={batch[0]['v']}")
        assert batch[0]["v"] == i * 10
    server.stop()
    server.join()
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
