"""policy — pluggable protocols and limiters.

Counterpart of the reference's ``src/brpc/policy`` + the registration moment
``GlobalInitializeOrDie`` (global.cpp:370-626): ``ensure_registered()`` is
idempotent and wires the ported protocols into the registry.

The port registers trpc_std, trpc_stream and the TPUC control protocol
of the ``tpu://`` tunnel (``tpu/transport.py``), and has no C++ core to
install (crc32c runs in Python, as the reference's fallback does). HTTP,
h2, gRPC, redis, mongo, rtmp, thrift, memcache and nshead wait in ROADMAP
Queue 1 item 2(b).
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
        from brpc_tpu_torch.rpc.protocol import register_protocol
        from brpc_tpu_torch.policy.trpc_std import TrpcStdProtocol
        from brpc_tpu_torch.policy.trpc_stream import TrpcStreamProtocol
        from brpc_tpu_torch.tpu.transport import TpuCtrlProtocol

        register_protocol(TrpcStdProtocol())
        register_protocol(TrpcStreamProtocol())
        # early: TPUC magic must never reach text-probing protocols
        register_protocol(TpuCtrlProtocol())
        _done = True
