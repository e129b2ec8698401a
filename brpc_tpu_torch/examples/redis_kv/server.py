"""Redis-speaking server example (reference example/redis_c++/redis_server):
redis-cli can SET/GET/DEL against this process. The JAX package's
``examples/redis_kv/server.py`` on the port's RPC stack.

    python -m brpc_tpu_torch.examples.redis_kv.server [--port 8030]
    redis-cli -p 8030 set k v ; redis-cli -p 8030 get k
"""

import argparse
import sys
import time

from brpc_tpu_torch.policy.redis_protocol import (
    REPLY_BULK,
    REPLY_INTEGER,
    REPLY_STRING,
    RedisReply,
    RedisService,
)
from brpc_tpu_torch.rpc import Server, ServerOptions


def build_service():
    store = {}
    svc = RedisService()
    svc.add_command_handler(
        "set", lambda a: (store.__setitem__(a[1], a[2]),
                          RedisReply(REPLY_STRING, "OK"))[1])
    svc.add_command_handler(
        "get", lambda a: RedisReply(REPLY_BULK, store.get(a[1])))
    svc.add_command_handler(
        "del", lambda a: RedisReply(
            REPLY_INTEGER, 1 if store.pop(a[1], None) is not None else 0))
    svc.add_command_handler(
        "dbsize", lambda a: RedisReply(REPLY_INTEGER, len(store)))
    return svc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8030)
    ap.add_argument("--run_seconds", type=float, default=0)
    args = ap.parse_args(argv)
    server = Server(ServerOptions(redis_service=build_service()))
    server.start(f"0.0.0.0:{args.port}")
    print(f"redis-compatible server on {server.listen_endpoint()}", flush=True)
    try:
        time.sleep(args.run_seconds or 1e9)
    except KeyboardInterrupt:
        pass
    server.stop()
    server.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
