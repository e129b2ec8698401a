"""Default service factory for shard workers.

A worker process builds its dispatch stack from a factory named as
``"module:attr"`` in the spawn config (``ServerOptions.shard_factory``).
The factory returns the list of Service instances to register — it runs
INSIDE the worker, so services are constructed per-process (no pickled
service objects cross the boundary; the cross-process-ownership lint rule
enforces the spirit of that for the whole package).

This module's ``echo_services`` is the default: the same trpc_std echo
the benchmarks and equivalence tests speak. ``counting_services`` is the
same echo made non-idempotent for the worker-death tests: each run of
its handler appends ``<message> <pid>`` to the file named by
``BRPC_TPU_SHARD_RUNS``, and a message that starts with ``slow`` sleeps
``SLOW_S`` after that line is written.
"""

from __future__ import annotations

import os
import time

from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import Service


class ShardEchoService(Service):
    DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]

    def Echo(self, cntl, request, done):
        cntl.response_attachment = cntl.request_attachment
        return echo_pb2.EchoResponse(message=request.message,
                                     payload=request.payload)


def echo_services():
    return [ShardEchoService()]


SLOW_S = 2.0


class CountingEchoService(ShardEchoService):
    def Echo(self, cntl, request, done):
        fd = os.open(os.environ["BRPC_TPU_SHARD_RUNS"],
                     os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o600)
        try:
            os.write(fd, f"{request.message} {os.getpid()}\n".encode())
        finally:
            os.close(fd)
        if request.message.startswith("slow"):
            time.sleep(SLOW_S)
        return super().Echo(cntl, request, done)


def counting_services():
    return [CountingEchoService()]
