"""policy — pluggable protocols, limiters, load balancers and naming.

Counterpart of the reference's ``src/brpc/policy`` + the registration moment
``GlobalInitializeOrDie`` (global.cpp:370-626): ``ensure_registered()`` is
idempotent and wires the ported protocols into the registry.

The port registers the reference's eleven protocols in the reference's
order: trpc_std, trpc_stream, the TPUC control protocol of the ``tpu://``
tunnel (``tpu/transport.py``), gRPC over h2 (``grpc_protocol.py`` on
``h2.py`` and ``hpack.py``), redis, mongo, rtmp, thrift, memcache and
nshead, then HTTP/1.1, probed last as the reference probes it. It installs
the C++ core (``native/``: crc32c and fast_rand) first, as the reference
does; a core that cannot be built raises here rather than falling back. The
load balancers (``load_balancers.py``), naming services (``naming.py``)
and the cluster-recover policy (``cluster_recover.py``) are looked up by
name and need no registration.
"""

from __future__ import annotations

import threading

_done = False
_lock = threading.Lock()


def ensure_registered() -> None:
    global _done
    with _lock:
        if _done:
            return
        # activate the C++ core (crc32c/fast_rand) first: a failed build
        # raises here, before anything is registered, and a later call
        # tries again
        from brpc_tpu_torch import native

        native.install()
        from brpc_tpu_torch.rpc.protocol import register_protocol
        from brpc_tpu_torch.policy.trpc_std import TrpcStdProtocol
        from brpc_tpu_torch.policy.trpc_stream import TrpcStreamProtocol
        from brpc_tpu_torch.policy.http_protocol import HttpProtocol
        from brpc_tpu_torch.policy.grpc_protocol import GrpcProtocol

        from brpc_tpu_torch.policy.mongo_protocol import MongoProtocol
        from brpc_tpu_torch.policy.rtmp import RtmpProtocol
        from brpc_tpu_torch.policy.redis_protocol import RedisProtocol
        from brpc_tpu_torch.policy.thrift_protocol import ThriftProtocol
        from brpc_tpu_torch.policy.memcache import MemcacheProtocol
        from brpc_tpu_torch.policy.nshead import NsheadProtocol

        from brpc_tpu_torch.tpu.transport import TpuCtrlProtocol

        register_protocol(TrpcStdProtocol())
        register_protocol(TrpcStreamProtocol())
        # early: TPUC magic must never reach text-probing protocols (redis
        # inline commands would happily eat it)
        register_protocol(TpuCtrlProtocol())
        # grpc before http: the h2 preface ("PRI * HTTP/2.0...") would
        # otherwise parse as an HTTP/1 request-line
        register_protocol(GrpcProtocol())
        register_protocol(RedisProtocol())
        register_protocol(MongoProtocol())
        register_protocol(RtmpProtocol())
        register_protocol(ThriftProtocol())
        register_protocol(MemcacheProtocol())
        register_protocol(NsheadProtocol())
        register_protocol(HttpProtocol())  # probed last: magic-less
        _done = True
