"""policy — pluggable protocols, limiters, load balancers and naming.

Counterpart of the reference's ``src/brpc/policy`` + the registration moment
``GlobalInitializeOrDie`` (global.cpp:370-626): ``ensure_registered()`` is
idempotent and wires the ported protocols into the registry.

The port registers trpc_std, trpc_stream, the TPUC control protocol of
the ``tpu://`` tunnel (``tpu/transport.py``) and HTTP/1.1, probed last as
the reference probes it, and installs the C++ core (``native/``: crc32c
and fast_rand), as the reference does; a core that cannot be built
raises here rather than falling back. h2, gRPC, redis, mongo, rtmp,
thrift, memcache and nshead wait in ROADMAP Queue 1 item 2(b)6. The
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
        from brpc_tpu_torch.tpu.transport import TpuCtrlProtocol

        register_protocol(TrpcStdProtocol())
        register_protocol(TrpcStreamProtocol())
        # early: TPUC magic must never reach text-probing protocols
        register_protocol(TpuCtrlProtocol())
        register_protocol(HttpProtocol())  # probed last: magic-less
        _done = True
